"""Parameters from the reference package's layout, through numpy.

:func:`params_from_numpy` takes the reference ``init_params`` tree with every
leaf already a numpy array (the caller converts, e.g. with
``jax.tree.map(np.asarray, params)``) and returns the port's parameters:
tensors on ``device``, with the stacked ``[L, ...]`` layer leaves split
into a list of per-layer dicts (an encoder's layers too) — the
scan-stacked MoE leaves as well: the router ``[L, d, E]`` becomes
``[d, E]`` and the expert stacks
``wg``/``wu``/``wo`` ``[L, E, K, N]`` become ``[E, K, N]`` in each layer's
``"moe"`` dict.

Packed leaves cross too, byte for byte: a tree the reference's
``pack_model_params`` packed (float, or int8 / int4 tiles with their scale
grids) carries its ``PackedWeight`` / ``GroupedPackedWeight`` leaves with
numpy buffers; each becomes the port's packed weight of the same plan, its
tiles and scales split per layer like any stacked leaf. The port then
serves the reference's quantized bytes exactly (its own planner tiles
differently, so packing the raw weights again would quantize them
otherwise). This module imports nothing of JAX.

:func:`params_to_numpy` is the inverse for raw trees: the port's params (or
an AdamW state, ``{"mu", "nu", "step"}``) back to the reference's layout,
each per-layer list of dicts stacked into ``[L, ...]`` numpy leaves (an
encoder's layers too), as the checkpoint files hold them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layered import GroupedPackedWeight, PackedWeight
from repro_torch.core.planner import GemmPlan


def _tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":   # ml_dtypes bf16 crosses as raw bits
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _is_packed(x) -> bool:
    """A packed leaf of the reference (duck-typed: tiles, scales, plan)."""
    return all(hasattr(x, a) for a in ("packed", "scales", "plan", "k", "n"))


def _plan(ref_plan) -> GemmPlan:
    """The port's plan of the same tiles, layouts, types and scale."""
    return GemmPlan(bm=ref_plan.bm, bk=ref_plan.bk, bn=ref_plan.bn,
                    dtype=ref_plan.dtype, acc_dtype=ref_plan.acc_dtype,
                    layout_a=ref_plan.layout_a, layout_b=ref_plan.layout_b,
                    b_dtype=ref_plan.b_dtype, b_scale=ref_plan.b_scale)


def _leaf(x, device, layer=None):
    """A reference leaf (layer ``layer`` of a stacked one) -> the port's."""
    def part(a):
        a = np.asarray(a)
        return _tensor(a if layer is None else a[layer], device)
    if not _is_packed(x):
        return part(x)
    scales = None if x.scales is None else part(x.scales)
    if hasattr(x, "e"):
        return GroupedPackedWeight(packed=part(x.packed), e=x.e, k=x.k,
                                   n=x.n, plan=_plan(x.plan), scales=scales)
    return PackedWeight(packed=part(x.packed), k=x.k, n=x.n,
                        plan=_plan(x.plan), scales=scales)


def _layers(stacked: dict, n: int, device) -> list:
    return [_map(stacked, lambda x, i=i: _leaf(x, device, i))
            for i in range(n)]


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """Reference params (numpy leaves, packed leaves with numpy buffers)
    -> port params on ``device``. An encoder-decoder's ``encoder`` subtree
    splits its ``layers`` by ``cfg.encoder_layers`` the same way."""
    out = {k: _map(v, lambda x: _leaf(x, device))
           for k, v in tree.items() if k not in ("layers", "encoder")}
    out["layers"] = _layers(tree["layers"], cfg.num_layers, device)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {k: _map(v, lambda x: _leaf(x, device))
                          for k, v in enc.items() if k != "layers"}
        out["encoder"]["layers"] = _layers(enc["layers"], cfg.encoder_layers,
                                           device)
    return out


def _numpy(x) -> np.ndarray:
    if not torch.is_tensor(x):
        raise TypeError(f"params_to_numpy takes raw tensor leaves; got "
                        f"{type(x).__name__}")
    return x.detach().cpu().numpy()


def _stack(items: list):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


def params_to_numpy(tree):
    """Port tree (tensor leaves; per-layer lists of dicts) -> the
    reference's layout with numpy leaves: each list stacked into
    ``[L, ...]`` leaves, dicts kept, everything else converted as it is."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _stack([params_to_numpy(v) for v in tree])
    return _numpy(tree)
