"""Parameters from the reference package's layout, through numpy.

:func:`params_from_numpy` takes the reference ``init_params`` tree with every
leaf already a numpy array (the caller converts, e.g. with
``jax.tree.map(np.asarray, params)``) and returns the port's parameters:
tensors on ``device``, with the stacked ``[L, ...]`` layer leaves split
into a list of per-layer dicts — the scan-stacked MoE leaves too: the
router ``[L, d, E]`` becomes ``[d, E]`` and the expert stacks
``wg``/``wu``/``wo`` ``[L, E, K, N]`` become ``[E, K, N]`` in each layer's
``"moe"`` dict. Raw weights only: the port packs them with its own packer
(``ServeConfig(pack_weights=True)``). This module imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


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


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """Reference params (numpy leaves) -> port params on ``device``."""
    out = {k: _map(v, lambda x: _tensor(x, device))
           for k, v in tree.items() if k != "layers"}
    stacked = _map(tree["layers"], lambda x: np.asarray(x))
    out["layers"] = [_map(stacked, lambda x, i=i: _tensor(x[i], device))
                     for i in range(cfg.num_layers)]
    return out
