"""Uniform model API over every config: ``build(cfg, device=None)`` returns a
:class:`Model`.

  init(seed) -> params           (random f32 weights, made on the device)
  forward(params, batch, remat=True) -> (logits [B, S, V] f32, moe_aux)
  prefill(params, batch, max_len, cache_dtype, caches=None)
      -> (last logits, caches)   (``caches`` given: written in place)
  decode(params, caches, token, pos) -> (logits, caches)

Batches hold ``"tokens"`` [B, S] ints; a VLM's also ``"patches"`` [B, P, d]
(the image frontend's embeddings, a stub: precomputed) and an
encoder-decoder's ``"frames"`` [B, Se, d] (the audio frontend's, likewise);
a train batch also ``"labels"`` [B, S]. A VLM's train logits are sliced to
the text positions.
The device defaults to ``"cuda"``; without a card :func:`build` raises
rather than running on the CPU — pass ``device="cpu"`` to ask for it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; the default is the card, and asking
    for the card where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def cli_device(name: str, prog: str) -> torch.device:
    """:func:`resolve_device` for a command line: where ``name`` asks for
    the card and there is none, exit at once, naming the device, instead of
    running anything on the CPU in its place."""
    try:
        return resolve_device(name)
    except RuntimeError:
        raise SystemExit(f"{prog}: --device {name} needs a CUDA device and "
                         f"torch.cuda.is_available() is false; pass --device "
                         f"cpu to run on the CPU") from None


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    forward: Callable
    prefill: Callable
    decode: Callable


def build(cfg: ModelConfig, device=None) -> Model:
    dev = resolve_device(device)
    family = encdec if cfg.is_encoder_decoder else transformer

    def init(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return family.init_params(cfg, gen, dev)

    if cfg.is_encoder_decoder:
        def forward(params, batch, remat: bool = True):
            return encdec.forward(cfg, params, batch["frames"],
                                  batch["tokens"], remat=remat)

        def prefill(params, batch, max_len=None, cache_dtype=None,
                    caches=None):
            return encdec.prefill(cfg, params, batch["frames"],
                                  batch["tokens"], max_len=max_len,
                                  cache_dtype=cache_dtype, caches=caches)
    else:
        def forward(params, batch, remat: bool = True):
            prefix = batch.get("patches") if cfg.family == "vlm" else None
            logits, aux = transformer.forward(cfg, params, batch["tokens"],
                                              prefix_embeds=prefix,
                                              remat=remat)
            if prefix is not None:
                logits = logits[:, prefix.shape[1]:]  # text positions only
            return logits, aux

        def prefill(params, batch, max_len=None, cache_dtype=None,
                    caches=None):
            prefix = batch.get("patches") if cfg.family == "vlm" else None
            return transformer.prefill(cfg, params, batch["tokens"],
                                       prefix_embeds=prefix, max_len=max_len,
                                       cache_dtype=cache_dtype, caches=caches)

    return Model(
        cfg=cfg, device=dev, init=init, forward=forward, prefill=prefill,
        decode=lambda params, caches, token, pos: family.decode(
            cfg, params, caches, token, pos),
    )
