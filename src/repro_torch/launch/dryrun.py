"""Multi-pod dry run of the port: every (arch x shape x mesh) cell runs once
over the production mesh of 256 or 512 H100s, on fake tensors in one CPU
process, and its roofline terms are read from what each device's ops did.

The counterpart of ``repro/launch/dryrun.py``. Where the reference compiles
for 512 emulated XLA devices, this process initialises a ``fake``
``torch.distributed`` group of 256 or 512 ranks (this module is the only
place that does, the counterpart of the reference's ``XLA_FLAGS``; no test
process initialises it), builds the ``DeviceMesh`` over it, places the
parameters, optimizer state, batch and caches as DTensors by
``parallel.sharding``, and runs the cell's step once under a
``FakeTensorMode``: shapes and dtypes propagate, no storage is allocated,
and DTensor issues the collectives its layouts need. The program is the
port's eager step (train step, prefill or decode) with every contraction on
the plain torch lowering (``core.gemm.DISTRIBUTED_LOWERINGS``): a model of
the program, not a measurement of the card.

What a cell records (``results/dryrun_torch/<arch>--<shape>--<mesh>.json``):
  * ``flops_per_device``: ``torch.utils.flop_counter``'s formulas (matmuls,
    attention, convolutions; elementwise ops count none, as the reference's
    HLO cost model counts dots) over the LOCAL ops of one rank (rank 0):
    :class:`CostMode` lets DTensor turn each global op into local ones and
    counts those, so no division by the chip count is needed;
  * ``bytes_per_device``: the bytes each local op reads and writes (its
    tensor inputs and outputs, views and metadata ops excluded);
  * each collective's op, group size, result bytes and link, through the
    reference's ring model (``roofline.analysis._collective_traffic``);
  * ``argument_bytes``: the exact local bytes of params, optimizer state,
    batch and caches, from their specs;
  * ``peak_per_device``: the peak of the bytes one rank's live local
    storages hold over the step, the arguments included (counted by
    :class:`CostMode`: ``MemTracker`` would also count the global-shape
    fake tensors DTensor's sharding propagation makes, which no device
    holds);
  * ``model_flops`` by the reference's formula, ``fits_hbm`` of the peak
    against the H100's 80 GB, ``status`` / ``error`` / ``traceback`` /
    ``wall_s``.
A cell whose op has no DTensor sharding rule (or fails otherwise) is
recorded ``failed`` with the op's name in ``op``; none is skipped quietly.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --all            # every cell, a process each
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.roofline.report               # the tables
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, iter_cells, shape_applicability
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build
from repro_torch.parallel import sharding as shard_rules
from repro_torch.parallel.mesh import (axis_sizes, is_dtensor, mesh_size,
                                       use_mesh)
from repro_torch.roofline import analysis
from repro_torch.roofline.hw import H100
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import TrainConfig, _eager_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# The c10d functional collectives DTensor issues, by the reference's op
# names (``roofline.analysis``); ``wait_tensor`` moves nothing.
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "all_reduce": "all-reduce",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "all_to_all_single": "all-to-all"}
_NO_BYTES = {"detach", "device", "alias", "lift_fresh"}


def _model_flops(cfg, shape) -> float:
    n = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class CostMode(TorchDispatchMode):
    """Counts one rank's local ops: FLOPs (``flop_counter``'s registry),
    bytes read and written, collectives, and the peak of the bytes its
    live storages hold. An op on DTensors is handed back
    (``NotImplemented``) so that DTensor runs it as local ops, which come
    through this mode again: every count is local."""

    def __init__(self):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary
        self.live = WeakIdKeyDictionary()   # storage -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = analysis.CollectiveStats()
        # Set while DTensor's sharding propagation runs an op on fake
        # tensors of the global shapes to learn its output's: no device
        # does that work.
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            if name in _COLLECTIVE_OPS or name.endswith("_coalesced"):
                base = _COLLECTIVE_OPS.get(name.replace("_coalesced", ""),
                                           "collective-permute")
                self.collectives.add(base, _nbytes(out), _group_ranks(args))
            return out
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or name in _NO_BYTES):
            self.bytes += _nbytes(list(args)) + _nbytes(out)
        self.track(out)
        return out

    def track(self, x) -> None:
        """Count each new storage among ``x``'s tensors as live until it is
        freed, and the peak of the live bytes."""
        if isinstance(x, (list, tuple)):
            for v in x:
                self.track(v)
            return
        if not isinstance(x, torch.Tensor):
            return
        st = x.untyped_storage()
        if st in self.live:
            return
        n = st.nbytes()
        self.live[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n


def _group_ranks(args) -> list:
    """The global ranks of the group a functional collective names (its
    last string argument; a reduce op's name comes before it)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    if not names:
        raise ValueError(f"no group name among a collective's arguments: "
                         f"{args}")
    return dist.get_process_group_ranks(_resolve_process_group(names[-1]))


@contextlib.contextmanager
def _fake_safe_dtensor(cost: "CostMode"):
    """Run DTensor's shard-offset arithmetic outside the fake mode. It builds
    small index tensors (``torch.arange``) and reads them back, which a
    ``FakeTensorMode`` refuses (torch 2.13: ``_StridedShard`` sizes, the
    local offsets of an arg-max); the arithmetic is the same either way.
    And pause ``cost`` while DTensor propagates an op's output shape on
    global fake tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    def unfaked(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with unset_fake_temporarily():
                return fn(*a, **k)
        return wrapper

    def uncounted(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            cost.paused += 1
            try:
                return fn(*a, **k)
            finally:
                cost.paused -= 1
        return wrapper

    patched = ((_StridedShard, "local_shard_size_and_offset", unfaked),
               (_utils, "_compute_local_shape_and_global_offset", unfaked),
               (ShardingPropagator, "_propagate_tensor_meta_non_cached",
                uncounted))
    saved = [getattr(obj, attr) for obj, attr, _ in patched]
    for (obj, attr, wrap), fn in zip(patched, saved):
        setattr(obj, attr, wrap(fn))
    try:
        yield
    finally:
        for (obj, attr, _), fn in zip(patched, saved):
            setattr(obj, attr, fn)


def _init_fake_world(n: int) -> None:
    """The process's default group: ``n`` fake ranks, this one rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"this process's group has "
                               f"{dist.get_world_size()} ranks, not {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _drop_data(spec: tuple) -> tuple:
    parts = []
    for ax in spec:
        if isinstance(ax, tuple):
            kept = tuple(a for a in ax if a != "data")
            parts.append(kept if kept else None)
        else:
            parts.append(None if ax == "data" else ax)
    return tuple(parts)


def build_cell(arch: str, shape_name: str, mesh_kind: str,
               decode_params_mode: str = "2d", serve_dtype: str = "bf16",
               mode=None, mesh=None):
    """Returns (cfg, shape, mesh, fn, argument_bytes): ``fn()`` runs the
    cell's step on the placed stand-ins. Call under ``mode`` (the
    ``FakeTensorMode`` the stand-ins are made in) with the fake group up;
    ``mesh`` (the production mesh, made outside the fake mode) is made
    here when None."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = shape_applicability(cfg, shape)
    if skip:
        raise RuntimeError(f"cell skipped by assignment: {skip}")
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    model = build(cfg, device="cpu")
    params = specs_mod.params_specs(model, mode)
    p_specs = shard_rules.param_specs(cfg, params, mesh)

    def local(tree, specs):
        return shard_rules.local_bytes(tree, specs, mesh)

    if shape.kind == "train":
        batch = specs_mod.train_batch_specs(cfg, shape, mode)
        b_specs = shard_rules.batch_specs(batch, mesh)
        # The reference's microbatch rule: 1M-token steps accumulate over 8
        # microbatches for the SSD mixers, 4 elsewhere.
        if shape.global_batch * shape.seq_len >= 2 ** 20:
            micro = 8 if cfg.has_ssm else 4
        else:
            micro = 1
        arg_bytes = 3 * local(params, p_specs) + local(batch, b_specs) + 4
        params = shard_rules.place(params, p_specs, mesh)
        opt_state = opt.init_state(params)
        batch = shard_rules.place(batch, b_specs, mesh)
        step = _eager_step(model, TrainConfig(microbatches=micro))
        fn = functools.partial(step, params, opt_state, batch)
    elif shape.kind == "prefill":
        batch = specs_mod.train_batch_specs(cfg, shape, mode)
        batch.pop("labels")
        b_specs = shard_rules.batch_specs(batch, mesh)
        arg_bytes = local(params, p_specs) + local(batch, b_specs)
        params = shard_rules.place(params, p_specs, mesh)
        batch = shard_rules.place(batch, b_specs, mesh)
        fn = functools.partial(model.prefill, params, batch,
                               max_len=shape.seq_len,
                               cache_dtype=torch.bfloat16)
    else:  # decode
        # Serving deployments load bf16 (or int8) weights: replicating f32
        # masters across the FSDP axis would blow HBM.
        serve_dt = torch.int8 if serve_dtype == "int8" else torch.bfloat16
        params = shard_rules.map_tree(
            lambda p: p.to(serve_dt) if p.ndim >= 2
            and p.dtype == torch.float32 else p, params)
        caches, token, pos = specs_mod.decode_state_specs(
            model, cfg, shape, mode=mode, params=params)
        c_specs = shard_rules.cache_specs(cfg, caches, mesh)
        # "2d" (default) keeps the (data x model) layout of the weights;
        # "tp_only" replicates them across data; "fsdp" is the reference's
        # f32 baseline name for the same layout as "2d".
        if decode_params_mode == "tp_only":
            p_specs = shard_rules.map_tree(_drop_data, p_specs)
        t_specs = shard_rules.batch_specs(token, mesh)
        q_specs = shard_rules.batch_specs(pos, mesh)
        arg_bytes = (local(params, p_specs) + local(caches, c_specs)
                     + local(token, t_specs) + local(pos, q_specs))
        params = shard_rules.place(params, p_specs, mesh)
        caches = shard_rules.place(caches, c_specs, mesh)
        token = shard_rules.place(token, t_specs, mesh)
        pos = shard_rules.place(pos, q_specs, mesh)
        fn = functools.partial(model.decode, params, caches, token, pos)
    return cfg, shape, mesh, fn, arg_bytes


_OP_RE = re.compile(r"((?:aten|prims|_c10d_functional|c10d)\.[\w]+(?:\.[\w]+)?)")


def failing_op(exc: BaseException) -> Optional[str]:
    """The op a failure names (a DTensor sharding failure names the aten
    op it could not propagate), searching the exception's causes too."""
    seen = exc
    while seen is not None:
        m = _OP_RE.search(str(seen))
        if m:
            return m.group(1)
        seen = seen.__cause__ or seen.__context__
    return None


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str = RESULTS_DIR, force: bool = False,
             decode_params_mode: str = "2d", serve_dtype: str = "bf16",
             tag: str = "") -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"--{tag}" if tag else ""
    out_path = os.path.join(out_dir,
                            f"{arch}--{shape_name}--{mesh_kind}{suffix}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    result: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "tag": tag, "status": "running"}
    t0 = time.time()
    try:
        _init_fake_world(512 if mesh_kind == "multi" else 256)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        cost = CostMode()
        with _fake_safe_dtensor(cost), mode:
            cfg, shape, mesh, fn, arg_bytes = build_cell(
                arch, shape_name, mesh_kind, decode_params_mode,
                serve_dtype, mode, mesh)
            t_build = time.time()
            shard_rules.map_tree(
                lambda x: cost.track(x.to_local() if is_dtensor(x) else x),
                list(fn.args))
            with cost, use_mesh(mesh), implicit_replication():
                fn()
            peak_bytes = cost.peak_bytes
        t_run = time.time()
        chips = mesh_size(mesh)
        roof = analysis.analyze(
            arch=arch, shape=shape_name, mesh_name=mesh_kind, chips=chips,
            flops_per_device=cost.flops, bytes_per_device=cost.bytes,
            collectives=cost.collectives,
            model_flops=_model_flops(cfg, shape),
            compute_dtype=cfg.compute_dtype, argument_bytes=arg_bytes)
        result.update(
            status="ok", chips=chips, mesh_shape=axis_sizes(mesh),
            build_s=round(t_build - t0, 2), run_s=round(t_run - t_build, 2),
            memory=dict(argument_bytes=arg_bytes, peak_per_device=peak_bytes,
                        peak_source="live local storages over fake tensors"),
            collectives=dict(counts=cost.collectives.op_counts,
                             bytes=cost.collectives.op_bytes,
                             nvlink_bytes=cost.collectives.nvlink_bytes,
                             by_group=cost.collectives.by_group),
            roofline=roof.to_dict(), target=H100.name)
        result["fits_hbm"] = bool(peak_bytes <= H100.hbm_bytes)
    except Exception as e:  # noqa: BLE001 — recorded, cell marked failed
        result.update(status="failed", error=f"{type(e).__name__}: {e}"[:2000],
                      op=failing_op(e),
                      traceback=traceback.format_exc()[-4000:])
    result["wall_s"] = round(time.time() - t0, 2)
    with open(out_path + ".tmp", "w") as f:
        json.dump(result, f, indent=2, default=str)
    os.replace(out_path + ".tmp", out_path)
    status = result["status"]
    print(f"[{status:6s}] {arch} x {shape_name} x {mesh_kind}{suffix} "
          f"({result['wall_s']}s)" + (f" op {result.get('op')}"
                                      if status != "ok" else ""))
    return result


def all_cells():
    for cfg, shape, skip in iter_cells([get_config(a) for a in ARCH_IDS]):
        for mesh_kind in ("single", "multi"):
            yield cfg.name, shape.name, mesh_kind, skip


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--serve-dtype", default="bf16",
                    choices=("bf16", "int8"))
    ap.add_argument("--decode-params", default="2d",
                    help="fsdp variant kept for the reference's before/after",
                    choices=("fsdp", "tp_only", "2d"))
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    if args.list:
        for arch, shp, mesh_kind, skip in all_cells():
            note = f"SKIP ({skip})" if skip else "run"
            print(f"{arch:26s} {shp:12s} {mesh_kind:7s} {note}")
        return 0

    if args.all:
        failures = 0
        for arch, shp, mesh_kind, skip in all_cells():
            if skip:
                continue
            out_path = os.path.join(
                args.out, f"{arch}--{shp}--{mesh_kind}.json")
            if os.path.exists(out_path) and not args.force:
                with open(out_path) as f:
                    if json.load(f).get("status") == "ok":
                        print(f"[cached] {arch} x {shp} x {mesh_kind}")
                        continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shp, "--mesh", mesh_kind,
                   "--out", args.out]
            if args.force:
                cmd.append("--force")
            try:
                rc = subprocess.run(cmd, timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = -1
                print(f"[timeout] {arch} x {shp} x {mesh_kind}")
            failures += (rc != 0)
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all / --list)")
    result = run_cell(args.arch, args.shape, args.mesh, args.out,
                      force=args.force, decode_params_mode=args.decode_params,
                      serve_dtype=args.serve_dtype, tag=args.tag)
    return 0 if result["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
