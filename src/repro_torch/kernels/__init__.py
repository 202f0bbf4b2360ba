"""Hand-written CUDA kernels of the port and their plain torch versions.

Layout:
  ref.py             — plain-torch oracles (the correctness contract)
  pack.py            — K5, macro-level packing (paper §3.1)
  gemm_tiled.py      — K7, the "Tiling" strategy kernel (fused epilogue)
  gemm_packed.py     — K6 gemm_packed (both operands packed) and K1
                       gemm_packed_fused_a (B packed, A streamed pack-free)
  gemm_grouped.py    — K3 grouped GEMM over the packed expert stack (incl.
                       the silu-gate pair) and K2, its ragged variant
  gemm_vsx_like.py   — K8, the paper's generic vector-unit baseline
  flash_attention.py — K4, blocked online-softmax attention
  ops.py             — the public wrappers (the reference's kernel surface)
  build.py           — nvcc at first use, ctypes loading

``ops`` and ``ref`` are reachable as attributes of the package, as in the
reference. They resolve on first use: the core's format and epilogue modules
import ``kernels.common``, so importing the package must not import the
wrappers (which import the core) eagerly. Importing builds nothing: a kernel
is compiled the first time a wrapper launches it on a CUDA tensor.
"""
import importlib

__all__ = ["ops", "ref"]


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
