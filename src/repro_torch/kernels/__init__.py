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

Launch counts: each wrapper that launches a kernel counts its launches
(``.launches``) and its launches by body (``.variants``), adding one where
it launches and nowhere else. A wrapper gets both counters, and its place
in the one registry that reads them all (:func:`counted_wrappers`), from
:func:`counts_launches` in its own module.
"""
import importlib

__all__ = ["ops", "ref"]

# The modules whose wrappers launch kernels: importing them registers every
# counting wrapper.
_LAUNCHING_MODULES = ("gemm_packed", "gemm_grouped", "pack", "gemm_tiled",
                      "gemm_vsx_like", "flash_attention")
# Every counting wrapper by its qualified name (a re-import replaces it).
_COUNTED = {}


def counts_launches(fn, bodies):
    """Give the wrapper ``fn`` its launch counters, ``fn.launches = 0`` and
    ``fn.variants`` = 0 for each name in ``bodies``, and register it.
    Returns ``fn``."""
    fn.launches = 0
    fn.variants = dict.fromkeys(bodies, 0)
    _COUNTED[f"{fn.__module__}.{fn.__qualname__}"] = fn
    return fn


def counted_wrappers() -> tuple:
    """Every kernel wrapper that counts its launches (K1-K8), in the order
    registered."""
    for name in _LAUNCHING_MODULES:
        importlib.import_module(f"{__name__}.{name}")
    return tuple(_COUNTED.values())


def __getattr__(name):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
