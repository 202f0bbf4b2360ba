"""Logical-axis sharding rules over the (pod, data, model) production mesh,
the counterpart of ``repro/parallel/mesh.py``.

Models never name physical mesh axes: they annotate activations with
*logical* axes via :func:`shard`, and parameter trees get specs from
``repro_torch.parallel.sharding``. The rules map logical -> physical:

  batch   -> ("pod", "data")   batch is split across pods (DP) and FSDP group
  fsdp    -> "data"            parameter shard axis (ZeRO-3 style)
  model   -> "model"           tensor parallel (heads / d_ff / experts / vocab)
  kv_seq  -> "model"           sequence-parallel KV for decode (SP)
  seq     -> "model"           the residual stream between layers (Megatron-SP)

A spec is a tuple with one entry per tensor dim: ``None``, an axis name, or
a tuple of names (the reference's ``PartitionSpec`` as a tuple, so
``tuple(reference_spec) == port_spec``). A dim is sharded only when its
size divides the mapped axes' product; otherwise it is replicated.

The mesh is an :class:`AbstractMesh` (shape and names: enough to resolve
specs without a process group) or a ``torch.distributed`` ``DeviceMesh``
with ``mesh_dim_names``. Under a ``DeviceMesh`` a spec becomes DTensor
placements (:func:`spec_placements`): an entry ``("pod", "data")`` on dim d
is ``Shard(d)`` on both mesh dims, pod-major, as JAX lays it out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple

import torch

LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "batch_nopod": ("data",),
    "fsdp": ("data",),
    "model": ("model",),
    "kv_seq": ("model",),
    "seq": ("model",),
    "replicated": (),
}

_state = threading.local()


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names, with no devices behind it."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and names "
                             f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, abstract or ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to resolve specs")
    return tuple(names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def mesh_size(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


def is_device_mesh(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, AbstractMesh)


def single_pod_rules() -> dict:
    """Rules for meshes without a 'pod' axis."""
    rules = dict(LOGICAL_RULES)
    rules["batch"] = ("data",)
    return rules


def current_mesh():
    """The mesh :func:`use_mesh` activated on this thread, or None."""
    m = getattr(_state, "mesh", None)
    if m is not None and mesh_size(m) > 0:
        return m
    return None


def current_rules() -> dict:
    rules = getattr(_state, "rules", None)
    if rules is not None:
        return rules
    mesh = current_mesh()
    if mesh is not None and "pod" not in axis_names(mesh):
        return single_pod_rules()
    return dict(LOGICAL_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate a mesh + logical rules for shard() / spec resolution on
    this thread (``None`` deactivates)."""
    prev = (getattr(_state, "mesh", None), getattr(_state, "rules", None))
    _state.mesh = mesh
    _state.rules = rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def _axes_size(sizes: dict, axes: Tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def logical_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 mesh=None) -> tuple:
    """Resolve logical axis names to a spec tuple with divisibility checks."""
    mesh = mesh or current_mesh()
    rules = current_rules()
    names = axis_names(mesh) if mesh is not None else ()
    sizes = axis_sizes(mesh) if mesh is not None else {}
    parts = []
    used: set = set()
    for dim, name in zip(shape, axes):
        if name is None or mesh is None:
            parts.append(None)
            continue
        phys = tuple(a for a in rules.get(name, ()) if a in names
                     and a not in used)
        if not phys or dim % _axes_size(sizes, phys) != 0:
            parts.append(None)
            continue
        used.update(phys)
        parts.append(phys if len(phys) > 1 else phys[0])
    return tuple(parts)


def spec_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim i is
    ``Shard(d)`` where tensor dim d's entry names it, ``Replicate()``
    elsewhere. A dim split over several axes must name them in mesh order
    (pod-major), the one order DTensor lays out."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} on dim {d} is not in mesh "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: the ``DeviceMesh`` and the DTensor placements on
    it (the reference's ``NamedSharding``)."""
    mesh: object
    placements: tuple

    def check(self, shape: Sequence[int], name: str = "leaf") -> None:
        """Raise unless a tensor of ``shape`` takes these placements: one
        per mesh dim, each ``Shard`` on an existing dim that the mesh dims
        sharding it divide evenly."""
        sizes = tuple(self.mesh.shape)
        if len(self.placements) != len(sizes):
            raise ValueError(f"{name}: {len(self.placements)} placements on "
                             f"a {len(sizes)}-D mesh")
        split = {}
        for size, p in zip(sizes, self.placements):
            if p.is_shard():
                if p.dim >= len(shape):
                    raise ValueError(f"{name}: {p} on a tensor of shape "
                                     f"{tuple(shape)}")
                split[p.dim] = split.get(p.dim, 1) * size
        for d, n in split.items():
            if shape[d] % n:
                raise ValueError(f"{name}: dim {d} of {tuple(shape)} does not "
                                 f"split into {n} shards")


def replicated(mesh) -> NamedSharding:
    """Every mesh dim replicating (a scalar's, the optimizer step's)."""
    from torch.distributed.tensor import Replicate
    return NamedSharding(mesh, (Replicate(),) * len(tuple(mesh.shape)))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing it when nothing is)."""
    if not torch.is_tensor(x) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Annotate an activation with logical axes.

    A Python no-op without a mesh, under an :class:`AbstractMesh`, and for
    a plain tensor (it lives whole on each rank, outside any layout): a
    served or captured step runs the same ops as without the call. A
    DTensor under an active ``DeviceMesh`` is redistributed to the spec's
    placements, the counterpart of ``with_sharding_constraint``."""
    mesh = current_mesh()
    if not is_device_mesh(mesh) or not is_dtensor(x):
        return x
    if len(axes) < x.ndim:
        axes = tuple(axes) + (None,) * (x.ndim - len(axes))
    placements = spec_placements(logical_spec(x.shape, axes, mesh), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def settle(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a DTensor's pending partial sums (a contraction's, the
    loss's metrics) reduced now: each partial placement becomes
    ``Replicate()``. Plain tensors pass unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_partial() else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def local_rows(x, i: int, n: int):
    """Slice i of n of each rank's rows (dim 0) of the DTensor ``x``, as a
    DTensor of the same placements: every rank keeps its own rows."""
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    rows = local.shape[0]
    if rows % n:
        raise ValueError(f"{rows} local rows do not split into {n}")
    part = local[i * (rows // n):(i + 1) * (rows // n)]
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    return DTensor.from_local(part, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def gather_inner_dims(x, end: int):
    """The DTensor ``x`` with dims 1 .. end-1 replicated (all-gathered),
    dim 0 and the dims from ``end`` on kept as they are: as Megatron-SP
    gathers the sequence before a mixer's projection. Folding dims 0 ..
    end-1 into one then keeps a plain shard of it; a dim sharded inside
    another sharded dim would fold into a strided shard, which DTensor
    plans over with a search that takes minutes on a 3-D mesh."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = [Replicate() if p.is_shard() and 0 < p.dim < end else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def sharded_attention(attend, q, k, v, **kw):
    """``attend(q, k, v, **kw)`` (an attention over [B, S, H, D] operands,
    independent across batch rows and heads) on each rank's local rows and
    heads of DTensor operands, as ``shard_map`` would run it: q keeps its
    batch (dim 0) and head (dim 2) shards and replicates the rest, k and v
    take the same layout (a mesh dim that cannot split the KV heads
    replicates q's heads too), and the [B, S] position / validity operands
    keep their batch shard. The result is q's layout; nothing is
    all-gathered along the sequence. (DTensor's own decomposition of the
    attention einsums folds the sharded batch and head dims together, a
    strided shard: see :func:`gather_inner_dims`.)"""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    mesh = q.device_mesh
    sizes = tuple(mesh.shape)
    hkv = k.shape[2]
    qp = []
    for i, p in enumerate(q.placements):
        keep = p.is_shard(0) or (p.is_shard(2) and hkv % sizes[i] == 0)
        qp.append(p if keep else Replicate())
    rows = [p if p.is_shard(0) else Replicate() for p in qp]

    def local(x, placements):
        if x is None:
            return None
        if not is_dtensor(x):
            x = distribute_tensor(x, mesh, [Replicate()] * len(sizes),
                                  src_data_rank=None)
        return x.redistribute(mesh, placements).to_local()

    out = attend(local(q, qp), local(k, qp), local(v, qp),
                 **{name: (local(val, rows) if torch.is_tensor(val)
                           and val.ndim == 2 else val)
                    for name, val in kw.items()})
    return DTensor.from_local(contiguous_grad(out), mesh, qp,
                              run_check=False, shape=q.shape,
                              stride=q.stride())


def contiguous_grad(x):
    """``x``, whose gradient arrives contiguous: a DTensor's gradient may
    hold a local tensor in other strides than the DTensor's global ones
    claim (a transposed product's), and the backward of the view that
    made ``x`` then fails to view it."""
    return _ContiguousGrad.apply(x)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the incoming gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # A DTensor's own strides may claim it contiguous while its local
        # tensor is not, and then ``contiguous()`` copies nothing.
        return grad.clone(memory_format=torch.contiguous_format)


def vocab_parallel_gold(logits, labels):
    """``logits[..., labels]`` (the gold logit of each position) for
    DTensor ``logits`` [B, S, V] with the vocab sharded, as Megatron's
    vocab-parallel cross entropy takes it: each rank picks its own vocab
    slice's entries by a local one-hot and the partial sums reduce over
    the vocab's mesh dims. (DTensor's own gather takes the same forward,
    but its backward materialises the whole [B, S, V] gradient on every
    rank.) ``labels`` [B, S] is laid out to the logits' batch shards."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = logits.device_mesh
    last = logits.ndim - 1
    logits = gather_inner_dims(logits, last)
    placements = list(logits.placements)
    rows = [p if p.is_shard(0) else Replicate() for p in placements]
    if not is_dtensor(labels):
        labels = distribute_tensor(labels, mesh,
                                   [Replicate()] * len(placements),
                                   src_data_rank=None)
    lab = labels.redistribute(mesh, rows).to_local().long()
    shape, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, placements)
    vocab = torch.arange(shape[-1], device=lab.device) + offset[-1]
    hot = (lab[..., None] == vocab).to(logits.dtype)
    hot = DTensor.from_local(hot, mesh, placements, run_check=False,
                             shape=logits.shape, stride=logits.stride())
    return settle((logits * hot).sum(-1))


def split_ready(x, parts: int, dim: int = -1):
    """The DTensor ``x`` ready to have dim ``dim`` split into ``parts``
    outer pieces (heads, token groups): mesh dims sharding that dim whose
    product does not divide ``parts`` replicate it (DTensor cannot
    unflatten an uneven shard; GSPMD reshards the same way). Plain tensors
    pass unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim = dim % x.ndim
    sizes = tuple(x.device_mesh.shape)
    want, n = list(x.placements), 1
    for i, p in enumerate(want):
        if p.is_shard(dim):
            if parts % (n * sizes[i]):
                want[i] = Replicate()
            else:
                n *= sizes[i]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def grad_split_ready(x, parts: int, dim: int = -1):
    """``x``, whose gradient is made :func:`split_ready` on its way back:
    the backward of the reshape that merged ``parts`` pieces into dim
    ``dim`` splits the gradient again. Plain tensors pass unchanged."""
    if not is_dtensor(x):
        return x
    return _SplitReadyGrad.apply(x, parts, dim)


class _SplitReadyGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, parts, dim):
        ctx.parts, ctx.dim = parts, dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return split_ready(grad, ctx.parts, ctx.dim), None, None


def keep_shards(x, dims):
    """The DTensor ``x`` with every shard on a dim outside ``dims``
    replicated; plain tensors pass unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    keep = {d % x.ndim for d in dims}
    want = [Replicate() if p.is_shard() and p.dim not in keep else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)
