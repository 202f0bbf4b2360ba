"""Assigned input shapes and the (arch x shape) cell enumeration: the port's
own copy of the reference's shape table, field for field.

``train_*`` lowers a training step; ``prefill_*`` a prefill; ``decode_*`` /
``long_*`` one new token against a KV/state cache of ``seq_len``.
``long_500k`` only runs for sub-quadratic archs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicability(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """Return None if the cell runs, else a human-readable skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full quadratic attention at 524k context is not servable; "
                "skipped per assignment (sub-quadratic archs only)")
    return None


def iter_cells(configs) -> Iterator[Tuple[ModelConfig, InputShape, Optional[str]]]:
    """Yield every (arch, shape, skip_reason) cell in the assignment grid."""
    for cfg in configs:
        for shape in SHAPES.values():
            yield cfg, shape, shape_applicability(cfg, shape)
