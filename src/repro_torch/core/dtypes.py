"""Matrix-engine dtype table for Hopper (the paper's Table 1 on an H100).

Narrow inputs feed the tensor cores at a higher rate and accumulate into
wide (f32/i32) accumulators. The table drives the planner's alignment and
the accumulator choice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MatrixDtype:
    name: str
    itemsize: float         # bytes per element; int4 nibble-packs two a byte
    acc_dtype: str          # accumulator dtype


TABLE: Dict[str, MatrixDtype] = {
    "float32": MatrixDtype("float32", 4, "float32"),
    "bfloat16": MatrixDtype("bfloat16", 2, "float32"),
    "float16": MatrixDtype("float16", 2, "float32"),
    "int8": MatrixDtype("int8", 1, "int32"),
    "int4": MatrixDtype("int4", 0.5, "int32"),   # nibble-packed, widened to i8
}

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int8": torch.int8, "int32": torch.int32}


def dtype_name(dtype) -> str:
    """``torch.dtype | str`` -> its short name (``"bfloat16"``)."""
    if isinstance(dtype, str):
        return dtype
    return str(dtype).replace("torch.", "")


def torch_dtype(dtype) -> torch.dtype:
    """``str | torch.dtype`` -> ``torch.dtype`` (int4 is stored as int8)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH["int8" if dtype == "int4" else dtype]


def is_integer(dtype) -> bool:
    return dtype_name(dtype) in ("int8", "int4", "int32")


def info(dtype) -> MatrixDtype:
    name = dtype_name(dtype)
    if name not in TABLE:
        raise KeyError(f"dtype {name} not supported by the matrix engine table")
    return TABLE[name]


# Hopper feeding geometry: mma.sync / wgmma tiles are 16 rows (wgmma: 64 per
# warpgroup, four of 16) by a multiple of 8 columns, and one k-step is 32
# bytes deep (16 bf16, 32 int8). Tiles align rows and columns to 16 and the
# contraction to max(16, 32 bytes) of the element type.
ROW_ALIGN = 16


def alignment(dtype) -> Tuple[int, int]:
    """(row/col multiple, contraction multiple) for a tile of ``dtype``."""
    d = info(dtype)
    return ROW_ALIGN, max(16, int(32 // d.itemsize))
