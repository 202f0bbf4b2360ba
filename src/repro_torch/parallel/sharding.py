"""Parameter / batch / cache sharding rules for the (pod, data, model) mesh,
the counterpart of ``repro/parallel/sharding.py``.

Policy (the reference's):
  * FSDP: every weight's d_model-like dim shards over "data" (ZeRO-3 style;
    optimizer state inherits the same spec).
  * TP:   heads / FFN inner / expert dims shard over "model"; attention TP is
    disabled per-arch when head counts don't divide the axis
    (cfg.shard_attention).
  * EP:   MoE expert dim shards over "model" when divisible (llama4 16e),
    otherwise TP shards the expert FFN inner dim (mixtral 8e).
  * "pod" never shards parameters — pure DP across pods.

Divisibility fallbacks are automatic (``logical_spec`` replicates any dim
the mesh can't divide), so one rule set serves every architecture.

The port's parameter tree keeps layers as a list of per-layer dicts where
the reference stacks them ``[L, ...]`` (``interop.params_from_numpy``), and
its caches are a list of per-layer dicts likewise. So each port leaf's
spec is the reference's stacked spec without its leading ``None``: the
stacked dim is never sharded, and dropping it changes no divisibility.
Trees are dicts and lists of tensors (real, meta or fake: only shapes are
read); a spec tree has the same structure with a spec tuple a leaf.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.mesh import (NamedSharding, axis_names, axis_sizes,
                                       is_dtensor, logical_spec,
                                       spec_placements, use_mesh)


def map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists; a path holds the
    dict keys and list indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def map_tree(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of congruent trees of dicts and lists."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [map_tree(fn, *(t[i] for t in trees))
                for i in range(len(first))]
    return fn(*trees)


def _names(path) -> list:
    return [p for p in path if isinstance(p, str)]


def logical_axes_for(cfg: ModelConfig, path, ndim: int) -> tuple:
    """Logical axis names for one parameter leaf, by tree path (a layer's
    leaf has no stacked dim: see the module docstring)."""
    names = _names(path)
    leaf = names[-1]
    attn_tp = "model" if cfg.shard_attention else None

    if leaf == "table":            # embed / lm head [V, d]
        return ("model", "fsdp")
    if "attn" in names or "xattn" in names:
        if leaf in ("wq", "wk", "wv"):
            return ("fsdp", attn_tp)
        if leaf == "wo":
            return (attn_tp, "fsdp")
        return (None,) * ndim
    if "moe" in names:
        if leaf == "router":
            return ("fsdp", None)
        if leaf in ("wi", "wg", "wu"):   # [E, d, f]
            return ("model", "fsdp", None)   # EP layout (default)
        if leaf == "wo":                 # [E, f, d]
            return ("model", None, "fsdp")
    if "mlp" in names:
        if leaf in ("wi", "wg", "wu"):
            return ("fsdp", "model")
        if leaf == "wo":
            return ("model", "fsdp")
        return (None,) * ndim
    if "ssm" in names:
        if leaf == "in_proj":
            return ("fsdp", None)
        if leaf == "out_proj":
            return ("model", "fsdp")
        return (None,) * ndim
    # norms, biases, scalars: replicated
    return (None,) * ndim


def _ep_effective(cfg: ModelConfig, mesh) -> bool:
    if cfg.num_experts <= 0 or "model" not in axis_names(mesh):
        return False
    return cfg.num_experts % axis_sizes(mesh)["model"] == 0


def param_specs(cfg: ModelConfig, params_tree: Any, mesh):
    """Spec tree matching ``params_tree`` (tensors of any kind)."""
    ep = _ep_effective(cfg, mesh)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        axes = logical_axes_for(cfg, path, len(shape))
        if not ep:
            # fall back from EP to TP rules for the MoE weights
            names = _names(path)
            if "moe" in names and names[-1] in ("wi", "wg", "wu"):
                axes = (None, "fsdp", "model")
            if "moe" in names and names[-1] == "wo":
                axes = (None, "model", "fsdp")
        return logical_spec(shape, axes, mesh)

    with use_mesh(mesh):
        return map_with_path(spec_for, params_tree)


def named_shardings(cfg: ModelConfig, params_tree: Any, mesh):
    """A :class:`~repro_torch.parallel.mesh.NamedSharding` (the mesh and
    the DTensor placements) a leaf."""
    return map_tree(lambda s: NamedSharding(mesh, spec_placements(s, mesh)),
                    param_specs(cfg, params_tree, mesh))


def batch_specs(batch_tree: Any, mesh):
    """Shard every batch leaf's leading (batch) dim over (pod, data)."""
    def spec_for(_path, leaf):
        axes = ("batch",) + (None,) * (len(leaf.shape) - 1)
        return logical_spec(tuple(leaf.shape), axes, mesh)

    with use_mesh(mesh):
        return map_with_path(spec_for, batch_tree)


def cache_specs(cfg: ModelConfig, cache_tree: Any, mesh):
    """KV/SSM cache sharding: batch over (pod,data); KV seq over model (SP);
    falls back automatically when dims don't divide."""
    def spec_for(path, leaf):
        names = _names(path)
        shape = tuple(leaf.shape)
        if names[-1] in ("k", "v", "cross_k", "cross_v"):
            axes = (None, "batch", "kv_seq", None, None)[:len(shape)]
            if len(shape) == 4:  # unstacked [B,S,H,D]
                axes = ("batch", "kv_seq", None, None)
        elif names[-1] == "state":   # [L,B,H,P,N] or [B,H,P,N]
            lead = len(shape) - 4
            axes = (None,) * lead + ("batch", None, None, None)
        elif names[-1] == "conv":
            lead = len(shape) - 3
            axes = (None,) * lead + ("batch", None, None)
        else:
            axes = (None,) * len(shape)
        return logical_spec(shape, axes, mesh)

    with use_mesh(mesh):
        return map_with_path(spec_for, cache_tree)


def place(tree: Any, specs: Any, mesh) -> Any:
    """Distribute every tensor leaf of ``tree`` over the ``DeviceMesh`` by
    its spec: each rank keeps its shard of the leaf it holds (every rank
    holds the same full values, as the launcher's seeded init makes them),
    so no data moves."""
    from torch.distributed.tensor import distribute_tensor

    def one(leaf, spec):
        return distribute_tensor(leaf, mesh, spec_placements(spec, mesh),
                                 src_data_rank=None)
    return map_tree(one, tree, specs)


def local_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of ``tree`` laid out by ``specs`` (shapes
    only; every sharded dim divides its axes, so each shard is equal)."""
    sizes = axis_sizes(mesh)
    total = 0

    def one(leaf, spec):
        nonlocal total
        n = leaf.numel()
        for entry in spec:
            if entry is None:
                continue
            for a in ((entry,) if isinstance(entry, str) else entry):
                n //= sizes[a]
        total += n * leaf.element_size()
    map_tree(one, tree, specs)
    return total


def gather(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` as the full plain tensor, others as
    they are."""
    return map_tree(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


__all__ = ["batch_specs", "cache_specs", "gather", "local_bytes",
           "logical_axes_for", "map_tree", "map_with_path", "named_shardings",
           "param_specs", "place"]
