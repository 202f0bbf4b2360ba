"""Stand-ins for every (arch x input-shape) cell, the counterpart of
``repro/launch/specs.py``: tensors under a ``FakeTensorMode`` with the
reference's shapes and dtypes at published widths, and no storage (olmo-1b's
f32 params alone are about 4.7 GB). Modality frontends are stubs, as in the
reference: whisper gets precomputed frame embeddings, paligemma precomputed
patch embeddings.

Each function makes its tensors under ``mode`` (a ``FakeTensorMode``; a new
one when None): the dry run passes the one it runs the cell under.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import Model


def _mode(mode: Optional[FakeTensorMode]):
    """Enter ``mode`` (a new FakeTensorMode when None), unless it is the
    mode already active."""
    mode = mode or FakeTensorMode()
    active = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    return contextlib.nullcontext() if active is mode else mode


def sds(shape, dtype, mode: Optional[FakeTensorMode] = None) -> torch.Tensor:
    """A storage-free tensor of ``shape`` and ``dtype``."""
    with _mode(mode):
        return torch.empty(tuple(shape), dtype=dtype)


def train_batch_specs(cfg: ModelConfig, shape: InputShape,
                      mode: Optional[FakeTensorMode] = None
                      ) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, s), torch.int32, mode),
             "labels": sds((b, s), torch.int32, mode)}
    if cfg.family == "vlm":
        batch["patches"] = sds((b, cfg.num_patches, cfg.d_model),
                               torch.float32, mode)
    if cfg.family == "audio":
        batch["frames"] = sds((b, cfg.encoder_seq, cfg.d_model),
                              torch.float32, mode)
    return batch


def params_specs(model: Model, mode: Optional[FakeTensorMode] = None) -> Any:
    """The parameter tree of ``model.init``, storage-free."""
    with _mode(mode):
        return model.init(0)


def decode_state_specs(model: Model, cfg: ModelConfig, shape: InputShape,
                       cache_dtype=torch.bfloat16,
                       mode: Optional[FakeTensorMode] = None,
                       params: Any = None) -> Tuple[Any, Any, Any]:
    """(caches, token, pos) stand-ins for a decode cell: the port's
    per-layer caches (an encoder-decoder's cross K / V from its encoder
    run over stand-in frames, as the reference's ``init_decode_state``,
    with ``params``: stand-ins of the same fake mode, or made here)."""
    from repro_torch.models import encdec, transformer
    b, s = shape.global_batch, shape.seq_len
    if mode is None and params is not None:
        mode = getattr(params["embed"]["table"], "fake_mode", None)
    mode = mode or FakeTensorMode()
    with _mode(mode):
        if cfg.is_encoder_decoder:
            params = params if params is not None else model.init(0)
            frames = train_batch_specs(cfg, shape, mode)["frames"]
            caches = encdec.init_caches(cfg, params, frames, s, cache_dtype)
        else:
            caches = transformer.init_caches(cfg, b, s, cache_dtype)
        token = torch.empty((b, 1), dtype=torch.int32)
        pos = torch.empty((b,), dtype=torch.int32)
    return caches, token, pos
