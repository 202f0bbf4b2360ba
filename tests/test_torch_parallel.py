"""The port's multi-device layer against the JAX reference: the sharding
rules at published widths, the sequence-parallel decode collective over 1
and 4 gloo ranks, the sharded train launcher over 2 gloo ranks, elastic
restore, the roofline terms, the dry run and ``configs/paper_gemm``.

Trees are built without storage on both sides: ``jax.eval_shape`` for the
reference, ``launch.specs`` (fake tensors) for the port."""
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_get_config
from repro.configs import paper_gemm as ref_paper_gemm
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import specs as ref_specs
from repro.models import build as ref_build
from repro.parallel import collectives as ref_coll
from repro.parallel import sharding as ref_rules
from repro.parallel.mesh import logical_spec as ref_logical_spec
from repro.parallel.mesh import use_mesh as ref_use_mesh
from repro.roofline import analysis as ref_analysis
from repro.roofline.hw import V5E
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs import paper_gemm
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import preset_config
from repro_torch.models import build
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as rules
from repro_torch.parallel.mesh import AbstractMesh, logical_spec, use_mesh
from repro_torch.roofline import analysis
from repro_torch.roofline.hw import H100
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import TrainConfig, _eager_step
from repro_torch.train.optimizer import AdamWConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_mesh(shape, names):
    from jax.sharding import AbstractMesh as RefAbstractMesh
    try:
        return RefAbstractMesh(tuple(shape), tuple(names))
    except TypeError:  # older jax: one shape_tuple of (name, size) pairs
        return RefAbstractMesh(tuple(zip(names, shape)))


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference eval_shape params, port fake params) at published widths."""
    ref = jax.eval_shape(ref_build(ref_get_config(arch)).init,
                         jax.random.PRNGKey(0))
    port = specs.params_specs(build(get_config(arch), device="cpu"))
    return ref, port


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))
    else:
        yield path, tree


def _ref_at(tree, path):
    """The reference's entry for a port path, and whether it is stacked
    (the port path passed a list index)."""
    stacked = any(isinstance(p, int) for p in path)
    for p in path:
        if not isinstance(p, int):
            tree = tree[p]
    return tree, stacked


def _unstack(ref_spec, stacked):
    parts = tuple(ref_spec)
    if stacked:
        assert parts[0] is None, parts
        return parts[1:]
    return parts


def _assert_specs_equal(ref_specs_tree, port_specs_tree):
    """Every port leaf's spec is the reference's (stacked ``None``
    dropped); returns how many leaves were compared."""
    n = 0
    for path, spec in _port_leaves(port_specs_tree):
        want, stacked = _ref_at(ref_specs_tree, path)
        assert _unstack(want, stacked) == spec, (path, want, spec)
        n += 1
    assert n > 0
    return n


# -- the rules ----------------------------------------------------------------

@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference_at_published_widths(arch, mesh_kind):
    shape, names = MESHES[mesh_kind]
    ref_tree, port_tree = _trees(arch)
    cfg = get_config(arch)
    want = ref_rules.param_specs(ref_get_config(arch), ref_tree,
                                 _ref_mesh(shape, names))
    got = rules.param_specs(cfg, port_tree, AbstractMesh(shape, names))
    for path, leaf in _port_leaves(port_tree):
        ref_leaf, stacked = _ref_at(ref_tree, path)
        want_shape = tuple(ref_leaf.shape)[1:] if stacked \
            else tuple(ref_leaf.shape)
        assert tuple(leaf.shape) == want_shape, path
        assert str(leaf.dtype).split(".")[-1] == str(ref_leaf.dtype), path
    assert _assert_specs_equal(want, got) > 0


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_the_reference(arch, mesh_kind):
    shape, names = MESHES[mesh_kind]
    rmesh, pmesh = _ref_mesh(shape, names), AbstractMesh(shape, names)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    for name in ("train_4k", "prefill_32k"):
        rb = ref_specs.train_batch_specs(rcfg, REF_SHAPES[name])
        pb = specs.train_batch_specs(cfg, SHAPES[name])
        want = ref_rules.batch_specs(rb, rmesh)
        got = rules.batch_specs(pb, pmesh)
        assert {k: tuple(v) for k, v in want.items()} == got
        assert {k: tuple(v.shape) for k, v in rb.items()} == \
            {k: tuple(v.shape) for k, v in pb.items()}
    ref_model = ref_build(rcfg)
    for name in ("decode_32k", "long_500k"):
        if name == "long_500k" and not cfg.subquadratic:
            continue
        rc, rt, rp = ref_specs.decode_state_specs(ref_model, rcfg,
                                                  REF_SHAPES[name])
        model = build(cfg, device="cpu")
        pc, pt, pp = specs.decode_state_specs(model, cfg, SHAPES[name],
                                              params=_trees(arch)[1])
        want = ref_rules.cache_specs(rcfg, rc, rmesh)
        got = rules.cache_specs(cfg, pc, pmesh)
        assert len(pc) == cfg.num_layers
        for path, leaf in _port_leaves(pc):
            ref_leaf, stacked = _ref_at(rc, path)
            assert tuple(leaf.shape) == tuple(ref_leaf.shape)[1:], path
        _assert_specs_equal(want, got)
        assert tuple(ref_rules.batch_specs(rt, rmesh)) == \
            rules.batch_specs(pt, pmesh)
        assert tuple(ref_rules.batch_specs(rp, rmesh)) == \
            rules.batch_specs(pp, pmesh)


def test_logical_spec_divisibility_fallback():
    mesh = AbstractMesh((16, 16), ("data", "model"))
    rmesh = _ref_mesh((16, 16), ("data", "model"))
    mesh3 = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    rmesh3 = _ref_mesh((2, 16, 16), ("pod", "data", "model"))
    with use_mesh(None), ref_use_mesh(None):
        for m, rm, shape, axes in (
                (mesh, rmesh, (32, 96), (None, "model")),
                (mesh, rmesh, (32, 25), (None, "model")),
                (mesh3, rmesh3, (64, 8), ("batch", None)),
                (mesh3, rmesh3, (1, 8), ("batch", None))):
            assert logical_spec(shape, axes, m) == \
                tuple(ref_logical_spec(shape, axes, rm))
        assert logical_spec((32, 96), (None, "model"), mesh) == (None, "model")
        assert logical_spec((32, 25), (None, "model"), mesh) == (None, None)
        assert logical_spec((64, 8), ("batch", None), mesh3) == \
            (("pod", "data"), None)
        assert logical_spec((1, 8), ("batch", None), mesh3) == (None, None)


def test_param_specs_dense_awkward_heads_and_vocab():
    mesh = AbstractMesh((16, 16), ("data", "model"))
    specs_ = rules.param_specs(get_config("olmo-1b"),
                               _trees("olmo-1b")[1], mesh)
    layer = specs_["layers"][0]
    assert layer["attn"]["wq"] == ("data", "model")   # FSDP x TP
    assert layer["attn"]["wo"] == ("model", "data")
    assert layer["mlp"]["wg"] == ("data", "model")
    assert layer["mlp"]["wo"] == ("model", "data")
    assert specs_["embed"]["table"] == ("model", "data")
    # hymba: 25 heads, shard_attention=False; the FFN keeps TP
    hy = rules.param_specs(get_config("hymba-1.5b"),
                           _trees("hymba-1.5b")[1], mesh)["layers"][0]
    assert hy["attn"]["wq"] == ("data", None)
    assert hy["mlp"]["wg"] == ("data", "model")
    # whisper: vocab 51865 is odd -> the table's vocab dim replicates
    wh = rules.param_specs(get_config("whisper-base"),
                           _trees("whisper-base")[1], mesh)
    assert wh["embed"]["table"][0] is None


def test_param_specs_moe_ep_vs_tp():
    mesh = AbstractMesh((16, 16), ("data", "model"))
    # llama4: 16 experts % 16 == 0 -> expert-parallel
    l4 = rules.param_specs(get_config("llama4-scout-17b-a16e"),
                           _trees("llama4-scout-17b-a16e")[1], mesh)
    assert l4["layers"][0]["moe"]["wg"] == ("model", "data", None)
    # mixtral: 8 experts % 16 != 0 -> TP over d_ff
    mx = rules.param_specs(get_config("mixtral-8x22b"),
                           _trees("mixtral-8x22b")[1], mesh)
    assert mx["layers"][0]["moe"]["wg"] == (None, "data", "model")


def test_cache_specs_sequence_parallel():
    mesh = AbstractMesh((16, 16), ("data", "model"))
    kv = [{"kv": {"k": torch.empty((128, 32768, 8, 128), device="meta"),
                  "v": torch.empty((128, 32768, 8, 128), device="meta")}}]
    got = rules.cache_specs(get_config("qwen3-4b"), kv, mesh)
    assert got[0]["kv"]["k"] == ("data", "model", None, None)


# -- one-rank group, inline ---------------------------------------------------

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group in this process, for the module's tests."""
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _seq_mesh():
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("model",))


def _sp_data(rng, b=2, s=32, h=4, hkv=2, d=16):
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    kpos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32).copy()
    qpos = np.full((b,), s - 1, np.int32)
    return q, k, v, kpos, qpos


def _ref_mesh_1d(n):
    from repro.launch.mesh import compat_make_mesh
    return compat_make_mesh((n,), ("model",))


@pytest.mark.parametrize("window,invalid", [(None, 0), (8, 4), (24, 0),
                                            (None, 6)])
def test_sp_decode_one_rank_matches_the_reference(world1, rng, window,
                                                  invalid):
    q, k, v, kpos, qpos = _sp_data(rng)
    kpos[:, :invalid] = -1      # unwritten ring slots
    jargs = [jax.numpy.asarray(a) for a in (q, k, v, kpos, qpos)]
    want = np.asarray(ref_coll.sp_decode_attention(
        *jargs, mesh=_ref_mesh_1d(jax.device_count()), window=window))
    oracle = np.asarray(ref_coll.ref_decode_attention(*jargs, window=window))
    targs = [torch.from_numpy(a) for a in (q, k, v, kpos, qpos)]
    got = coll.sp_decode_attention(*targs, mesh=_seq_mesh(), window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        coll.ref_decode_attention(*targs, window=window).numpy(), oracle,
        rtol=2e-5, atol=2e-5)


def test_sp_decode_refuses_an_abstract_mesh(rng):
    q, k, v, kpos, qpos = (torch.from_numpy(a) for a in _sp_data(rng))
    with pytest.raises(TypeError):
        coll.sp_decode_attention(q, k, v, kpos, qpos,
                                 mesh=AbstractMesh((1,), ("model",)))


def test_forward_on_a_one_rank_mesh_matches_the_plain_forward(world1, rng):
    """The counterpart of ``test_pjit_forward_matches_single_device``:
    params and batch placed on a (1, 1) DeviceMesh, the forward under it."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = reduced_config("olmo-1b")
    model = build(cfg, device="cpu")
    params = model.init(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    plain, _ = model.forward(params, {"tokens": tokens}, remat=False)
    mesh = make_host_mesh(1)
    placed = rules.place(params, rules.param_specs(cfg, params, mesh), mesh)
    batch = {"tokens": tokens}
    batch = rules.place(batch, rules.batch_specs(batch, mesh), mesh)
    with use_mesh(mesh), implicit_replication():
        sharded, _ = model.forward(placed, batch, remat=False)
    np.testing.assert_allclose(plain.numpy(), sharded.full_tensor().numpy(),
                               rtol=1e-5, atol=1e-5)


def _elastic_cfg():
    return dataclasses.replace(reduced_config("olmo-1b"),
                               compute_dtype="float32", vocab_size=64)


def test_restore_onto_different_sharding(world1, tmp_path):
    cfg = _elastic_cfg()
    params = build(cfg, device="cpu").init(0)
    ckpt.save(str(tmp_path), 5, {"params": params})
    # "new cluster": restore with shardings resolved for the host mesh
    mesh = make_host_mesh(1)
    shardings = {"params": rules.named_shardings(cfg, params, mesh)}
    restored, step = ckpt.restore(str(tmp_path), {"params": params},
                                  shardings=shardings)
    assert step == 5
    from torch.distributed.tensor import DTensor
    got = dict(_port_leaves(restored["params"]))
    for path, want in _port_leaves(params):
        assert isinstance(got[path], DTensor), path
        assert torch.equal(got[path].full_tensor(), want), path
    # a DTensor tree saves mesh-agnostic: its full values, bitwise
    ckpt.save(str(tmp_path / "again"), 6, restored)
    again, _ = ckpt.restore(str(tmp_path / "again"), {"params": params})
    for path, want in _port_leaves(params):
        assert torch.equal(dict(_port_leaves(again["params"]))[path], want)


def test_restore_refuses_placements_a_leaf_cannot_take(world1, tmp_path):
    from torch.distributed.tensor import Shard
    from repro_torch.parallel.mesh import NamedSharding
    cfg = _elastic_cfg()
    params = build(cfg, device="cpu").init(0)
    ckpt.save(str(tmp_path), 1, {"params": params})
    mesh = make_host_mesh(1)
    shardings = {"params": rules.named_shardings(cfg, params, mesh)}
    shardings["params"]["embed"]["table"] = NamedSharding(mesh, (Shard(5),
                                                                 Shard(0)))
    with pytest.raises(ValueError, match="embed/table"):
        ckpt.restore(str(tmp_path), {"params": params}, shardings=shardings)


def test_restored_params_train_identically(world1, tmp_path):
    """Resharded restore must not perturb the trajectory."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import device_batch
    from repro_torch.parallel.mesh import replicated
    cfg = _elastic_cfg()
    model = build(cfg, device="cpu")
    params = model.init(0)
    state = opt.init_state(params)
    step_fn = _eager_step(model, TrainConfig(optim=AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10)))
    data = SyntheticLM(DataConfig(vocab_size=64, seq_len=16, global_batch=4))
    batch = device_batch(data.batch_at(0), "cpu")
    ckpt.save(str(tmp_path), 0, {"params": params, "opt": state})
    mesh = make_host_mesh(1)
    p_sh = rules.named_shardings(cfg, params, mesh)
    restored, _ = ckpt.restore(
        str(tmp_path), {"params": params, "opt": state},
        shardings={"params": p_sh, "opt": {"mu": p_sh, "nu": p_sh,
                                           "step": replicated(mesh)}})
    p1, _, m1 = step_fn(params, state, batch)
    placed = rules.place(batch, rules.batch_specs(batch, mesh), mesh)
    with use_mesh(mesh), implicit_replication():
        p2, _, m2 = step_fn(restored["params"], restored["opt"], placed)
    assert float(m1["loss"]) == float(m2["loss"])
    got = dict(_port_leaves(p2))
    for path, want in _port_leaves(p1):
        assert torch.equal(got[path].full_tensor(), want), path


# -- spawned gloo groups --------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(n, argv, timeout):
    """``n`` processes of ``argv`` as the ranks of one gloo group; each
    process's (rc, stdout, stderr)."""
    port = _free_port()
    env0 = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(n))
    procs = [subprocess.Popen(argv, env=dict(env0, RANK=str(r),
                                             LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# The mesh holds a reference to the gloo group: it is dropped before the
# group is destroyed, so that the group and its threads (gloo's loop, the
# work threads, the store's) end inside ``destroy_process_group``. Left to
# the interpreter's teardown, their end aborted a rank now and then with
# "terminate called without an active exception" (exit -6, after every
# line of the script had run). The script checks that none survives.
SP4_SCRIPT = textwrap.dedent("""
    import glob, sys
    import numpy as np, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.collectives import sp_decode_attention
    dist.init_process_group("gloo")
    args = np.load(sys.argv[1])
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    t = [torch.from_numpy(args[k]) for k in ("q", "k", "v", "kpos", "qpos")]
    out = sp_decode_attention(*t, mesh=mesh, window=int(sys.argv[2]) or None)
    np.save(sys.argv[3] + f".{dist.get_rank()}.npy", out.numpy())
    del mesh
    dist.destroy_process_group()
    names = [open(p).read().strip()
             for p in glob.glob("/proc/self/task/*/comm")]
    left = [n for n in names if "gloo" in n or "tcpstore" in n]
    assert not left, f"threads of the group outlive it: {left}"
""")


@pytest.mark.parametrize("window", [0, 24])
def test_sp_decode_four_gloo_ranks_match_the_reference(tmp_path, window):
    """The combine must be exact under REAL 4-way KV sharding: every rank
    returns the reference's result within 2e-5 (the reference's own
    sp_decode on one device and its oracle)."""
    rng = np.random.default_rng(7)
    q, k, v, kpos, qpos = _sp_data(rng, b=2, s=64, h=4, hkv=2, d=16)
    kpos[:, :5] = -1
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, kpos=kpos, qpos=qpos)
    outs = _spawn(4, [sys.executable, "-c", SP4_SCRIPT,
                      str(tmp_path / "in.npz"), str(window),
                      str(tmp_path / "out")], timeout=240)
    for rc, out, err in outs:
        assert rc == 0, out[-2000:] + err[-3000:]
    jargs = [jax.numpy.asarray(a) for a in (q, k, v, kpos, qpos)]
    win = window or None
    want = np.asarray(ref_coll.ref_decode_attention(*jargs, window=win))
    want_sp = np.asarray(ref_coll.sp_decode_attention(
        *jargs, mesh=_ref_mesh_1d(jax.device_count()), window=win))
    for r in range(4):
        got = np.load(tmp_path / f"out.{r}.npy")
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want_sp, rtol=2e-5, atol=2e-5)


def test_sharded_launcher_two_gloo_ranks_match_one_process(tmp_path):
    """``launch/train.py --model-parallel 2 --device cpu`` over two gloo
    ranks (mesh (1, 2): every weight split over "model") gives the
    one-process run's losses within 1e-5, and its checkpoint (saved from
    DTensors, written by rank 0) resumes in one process."""
    args = ["--arch", "olmo-1b", "--preset", "tiny", "--steps", "3",
            "--batch", "4", "--seq", "32", "--log-every", "1",
            "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--metrics-out", str(tmp_path / "one.json")],
        env=env, capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stdout[-2000:] + one.stderr[-3000:]
    outs = _spawn(2, [sys.executable, "-m", "repro_torch.launch.train", *args,
                      "--model-parallel", "2", "--ckpt-dir",
                      str(tmp_path / "ck"), "--ckpt-every", "3",
                      "--metrics-out", str(tmp_path / "two.json")],
                  timeout=300)
    for rc, out, err in outs:
        assert rc == 0, out[-2000:] + err[-3000:]
        assert "mesh=(1, 2) world=2" in out
    with open(tmp_path / "one.json") as f:
        want = [m["loss"] for m in json.load(f)]
    with open(tmp_path / "two.json") as f:
        got = [m["loss"] for m in json.load(f)]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert ckpt.latest_valid_step(str(tmp_path / "ck")) == 3
    params = build(preset_config("olmo-1b", "tiny"), device="cpu").init(0)
    state, step = ckpt.restore(str(tmp_path / "ck"),
                               {"params": params, "opt": opt.init_state(params)})
    assert step == 3 and int(state["opt"]["step"]) == 3


# -- roofline -----------------------------------------------------------------

@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute"])
@pytest.mark.parametrize("g", [2, 4, 16])
def test_collective_traffic_matches_the_reference(op, g):
    for nbytes in (100, 4096, 123457):
        assert analysis._collective_traffic(op, nbytes, g) == \
            ref_analysis._collective_traffic(op, nbytes, g)


@pytest.mark.parametrize("fracs", [(1.0, 0.5, 0.25, 0.5), (0.2, 1.0, 0.5, 0.1),
                                   (0.1, 0.3, 2.0, 1.2)])
def test_roofline_terms_and_bottleneck_match_the_reference(fracs):
    """The same inputs as fractions of each target's peaks give the
    reference's terms, bottleneck, ratios and fraction (a collective on
    one node's NVLink stands where the reference's ICI link stands)."""
    fc, fm, fl, fu = fracs
    ref = ref_analysis.Roofline(
        arch="a", shape="s", mesh="single", chips=256,
        flops_per_device=V5E.peak_bf16_flops * fc,
        bytes_per_device=V5E.hbm_bw * fm,
        collective_bytes_per_device=V5E.ici_link_bw * fl,
        model_flops=V5E.peak_bf16_flops * 256 * fc * fu)
    got = analysis.Roofline(
        arch="a", shape="s", mesh="single", chips=256,
        flops_per_device=H100.peak_bf16_flops * fc,
        bytes_per_device=H100.hbm_bw * fm,
        collective_bytes_per_device=H100.nvlink_bw * fl,
        collective_bytes_nvlink=H100.nvlink_bw * fl,
        model_flops=H100.peak_bf16_flops * 256 * fc * fu)
    for name in ("compute_s", "memory_s", "collective_s", "step_time_s",
                 "useful_flops_ratio", "roofline_fraction"):
        assert abs(getattr(got, name) - getattr(ref, name)) < 1e-9, name
    assert got.bottleneck == ref.bottleneck
    assert abs(got.compute_s - fc) < 1e-9


def test_collectives_cross_the_nic_unless_one_node_holds_the_group():
    st = analysis.CollectiveStats()
    st.add("all-reduce", 1000, list(range(8)))          # one node: NVLink
    st.add("all-gather", 1000, list(range(0, 256, 16)))  # 16 nodes: NIC
    assert st.nvlink_bytes == 2.0 * 1000 * 7 / 8
    assert st.by_group == {"all-reduce g8 nvlink": [1, 1000],
                           "all-gather g16 nic": [1, 1000]}
    assert st.per_device_bytes == st.nvlink_bytes + 1000
    r = analysis.analyze(arch="a", shape="s", mesh_name="single", chips=256,
                         flops_per_device=0, bytes_per_device=0,
                         collectives=st, model_flops=0)
    assert abs(r.collective_s - (st.nvlink_bytes / 450e9 + 1000 / 50e9)) < 1e-15
    assert r.bottleneck == "collective"
    assert H100.peak_bf16_flops == 989e12 and H100.peak_f32_flops == 67e12
    assert H100.peak_int8_ops == 1979e12 and H100.hbm_bw == 3.35e12
    assert H100.hbm_bytes == 80 * 10**9


# -- the dry run ----------------------------------------------------------------

def _local_bytes(ref_tree, ref_specs_tree, sizes):
    total = 0
    for leaf, spec in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(
            ref_specs_tree, is_leaf=lambda x: isinstance(x, P))):
        n = int(np.prod(leaf.shape))
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes[a]
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def test_dryrun_cell_subprocess(tmp_path):
    """olmo-1b x train_4k x multi over a fake group of 512 ranks, with the
    reference's dry-run assertions (``tests/test_system.py``) and the
    argument bytes the reference's specs give its eval_shape leaves."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo-1b", "--shape", "train_4k", "--mesh", "multi", "--out",
         str(tmp_path), "--force"],
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    with open(tmp_path / "olmo-1b--train_4k--multi.json") as f:
        result = json.load(f)
    assert result["status"] == "ok"
    assert result["chips"] == 512
    assert result["fits_hbm"]
    r = result["roofline"]
    assert r["flops_per_device"] > 0
    assert r["collective_bytes_per_device"] > 0
    assert 0 < r["useful_flops_ratio"] <= 1.5
    # argument bytes: params + AdamW mu / nu (+ its int32 step) + batch,
    # each leaf's local shard by the reference's own specs
    sizes = {"pod": 2, "data": 16, "model": 16}
    rmesh = _ref_mesh((2, 16, 16), ("pod", "data", "model"))
    ref_tree = _trees("olmo-1b")[0]
    rcfg = ref_get_config("olmo-1b")
    batch = ref_specs.train_batch_specs(rcfg, REF_SHAPES["train_4k"])
    want = (3 * _local_bytes(ref_tree, ref_rules.param_specs(
        rcfg, ref_tree, rmesh), sizes) + 4
        + _local_bytes(batch, ref_rules.batch_specs(batch, rmesh), sizes))
    assert result["memory"]["argument_bytes"] == want
    assert result["memory"]["peak_per_device"] >= want


def test_dryrun_list_matches_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                          "--list"], env=env, capture_output=True, text=True,
                         timeout=300)
    port = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--list"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert ref.returncode == port.returncode == 0, port.stderr[-2000:]
    assert port.stdout == ref.stdout
    assert port.stdout.count(" run") == 66


# -- configs/paper_gemm ---------------------------------------------------------

def test_paper_gemm_matches_the_reference():
    for name in ("SMALL_SIZES", "MEDIUM_SIZES", "LARGE_SIZES",
                 "PAPER_TILE_GENERIC", "PAPER_TILE_MMA", "PAPER_CLAIMS"):
        assert getattr(paper_gemm, name) == getattr(ref_paper_gemm, name)
    for n in paper_gemm.SMALL_SIZES + paper_gemm.MEDIUM_SIZES \
            + paper_gemm.LARGE_SIZES:
        got, want = paper_gemm.square(n), ref_paper_gemm.square(n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.flops == want.flops == 2 * n ** 3
    p = paper_gemm.GemmProblem(m=3, n=5, k=7, dtype="bfloat16")
    assert p.flops == ref_paper_gemm.GemmProblem(m=3, n=5, k=7).flops
