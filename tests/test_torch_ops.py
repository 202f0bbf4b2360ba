"""Port vs reference: the kernels' public wrappers. Every wrapper of
``repro_torch.kernels.ops`` (plain torch versions of the kernels on CPU
tensors) against the reference's ``repro.kernels.ops`` counterpart (Pallas
in interpret mode) on the same numpy inputs. Tolerances: f32 rtol = atol =
1e-5 (the same f32 products summed in other orders), bf16 rtol = atol = 1e-2
(outputs rounded to bf16 after f32 sums in other orders), int8 -> int32
exact; the packers byte-identical. The silu-gate pair multiplies one
accumulator's f32 rounding (~1e-6 of terms of magnitude ~1) by the other
accumulator (up to ~30): atol 1e-4 there, as in test_torch_gemm_grouped."""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2),
       "int8": dict(rtol=0, atol=0)}
TOL_PAIR = dict(rtol=1e-5, atol=1e-4)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8,
       "int32": jnp.int32}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int8": torch.int8, "int32": torch.int32}
BLOCKS = dict(bm=32, bk=32, bn=32)   # small tiles: odd shapes span several
M, K, N = 33, 65, 48


def _arrays(seed, shapes, dtype):
    r = np.random.default_rng(seed)
    if dtype == "int8":
        return [r.integers(-100, 100, s).astype(np.int8) for s in shapes]
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def _j(x, dtype=None):
    return None if x is None else jnp.asarray(x, JDT[dtype] if dtype else None)


def _t(x, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(x)
    return t.to(TDT[dtype]) if dtype else t


def _np(x):
    return (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()


def _close(got, want, dtype, tol=None):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32)
                               if dtype == "bfloat16" else np.asarray(want),
                               **(tol or TOL[dtype]))


def _out(dtype):
    return "int32" if dtype == "int8" else None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tiled_matmul(dtype):
    a, b = _arrays(0, [(M, K), (K, N)], dtype)
    c = _arrays(1, [(M, N)], "float32")[0]
    c = c.astype(np.int32) * 10 if dtype == "int8" else c
    cdt = "int32" if dtype == "int8" else dtype
    want = jops.tiled_matmul(_j(a, dtype), _j(b, dtype), _j(c, cdt), alpha=1.5,
                             beta=0.5, **BLOCKS)
    got = ops.tiled_matmul(_t(a, dtype), _t(b, dtype), _t(c, cdt), alpha=1.5,
                           beta=0.5, bm=32)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout_a,layout_b", [("row", "row"), ("col", "col"),
                                               ("row", "col")])
def test_packed_matmul_alpha_beta_c(dtype, layout_a, layout_b):
    a, b = _arrays(2, [(M, K), (K, N)], dtype)
    c = _arrays(3, [(M, N)], "float32")[0]
    c = c.astype(np.int32) * 10 if dtype == "int8" else c
    cdt = "int32" if dtype == "int8" else dtype
    kw = dict(layout_a=layout_a, layout_b=layout_b, alpha=0.5, beta=2.0,
              **BLOCKS)
    want = jops.packed_matmul(_j(a, dtype), _j(b, dtype), _j(c, cdt),
                              out_dtype=JDT.get(_out(dtype)), **kw)
    got = ops.packed_matmul(_t(a, dtype), _t(b, dtype), _t(c, cdt),
                            out_dtype=TDT.get(_out(dtype)), **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype,epilogue", [("float32", "gelu"),
                                            ("float32", "relu"),
                                            ("bfloat16", "silu"),
                                            ("bfloat16", "tanh")])
@pytest.mark.parametrize("layout_b", ["row", "col"])
def test_packed_matmul_fused_bias_epilogue(dtype, epilogue, layout_b):
    a, b = _arrays(4, [(M, K), (K, N)], dtype)
    c, bias = _arrays(5, [(M, N), (N,)], "float32")
    kw = dict(layout_b=layout_b, alpha=1.5, beta=0.5, epilogue=epilogue,
              **BLOCKS)
    want = jops.packed_matmul_fused(_j(a, dtype), _j(b, dtype), _j(c, dtype),
                                    bias=_j(bias), **kw)
    got = ops.packed_matmul_fused(_t(a, dtype), _t(b, dtype), _t(c, dtype),
                                  bias=_t(bias), **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gate", [False, True])
def test_grouped_matmul_packed(dtype, gate):
    e = 3
    a, b, b2 = _arrays(6, [(e, M, K), (e, K, N), (e, K, N)], dtype)
    bias = _arrays(7, [(e, N)], "float32")[0]
    kw = dict(epilogue="silu_gate" if gate else "relu", **BLOCKS)
    want = jops.grouped_matmul_packed(
        _j(a, dtype), _j(b, dtype), b2=_j(b2, dtype) if gate else None,
        bias=_j(bias), **kw)
    got = ops.grouped_matmul_packed(
        _t(a, dtype), _t(b, dtype), b2=_t(b2, dtype) if gate else None,
        bias=_t(bias), **kw)
    _close(got, want, dtype, TOL_PAIR if gate and dtype == "float32" else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_vsx_matmul(dtype):
    a, b = _arrays(8, [(M, K), (K, N)], dtype)
    out = _out(dtype) or "float32"
    want = jops.vsx_matmul(_j(a, dtype), _j(b, dtype), out_dtype=JDT[out],
                           **BLOCKS)
    got = ops.vsx_matmul(_t(a, dtype), _t(b, dtype), out_dtype=TDT[out], bm=32)
    _close(got, want, "int8" if dtype == "int8" else "float32")


@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window", [
    (2, 40, 40, 4, 2, 16, True, None), (1, 1, 70, 4, 1, 16, True, 20),
    (1, 30, 20, 2, 2, 8, False, 6)])
def test_attention(b, sq, skv, h, hkv, d, causal, window):
    q, k, v = _arrays(9, [(b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d)],
                      "float32")
    want = jops.attention(_j(q), _j(k), _j(v), causal=causal, window=window,
                          scale=0.2, bq=16, bkv=16)
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                        scale=0.2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["row", "col"])
def test_packers_byte_identical(dtype, layout):
    a, b3 = _arrays(10, [(M, K), (3, K, N)], dtype)

    def same(got, want):
        want = np.asarray(want)
        got = got.view(torch.int16).numpy() if got.dtype == torch.bfloat16 \
            else got.numpy()
        want = want.view(np.int16) if dtype == "bfloat16" else want
        np.testing.assert_array_equal(got, want)

    same(ops.pack_a_op(_t(a, dtype), 16, 32, layout),
         jops.pack_a_op(_j(a, dtype), 16, 32, layout=layout))
    same(ops.pack_b_op(_t(b3[0], dtype), 32, 16, layout),
         jops.pack_b_op(_j(b3[0], dtype), 32, 16, layout=layout))
    same(ops.pack_b_grouped_op(_t(b3, dtype), 32, 16, layout),
         jops.pack_b_grouped_op(_j(b3, dtype), 32, 16, layout=layout))


def test_surface_matches_the_reference():
    assert ops.__all__ == jops.__all__
    assert all(callable(getattr(ops, name)) for name in ops.__all__)


def test_cpu_calls_launch_nothing():
    from repro_torch.kernels import (flash_attention, gemm_grouped,
                                     gemm_packed, gemm_tiled, gemm_vsx_like,
                                     pack)
    fns = [gemm_tiled.gemm_tiled, gemm_packed.gemm_packed,
           gemm_packed.gemm_packed_fused_a, gemm_grouped.gemm_grouped_packed,
           gemm_vsx_like.matmul_vsx_like, flash_attention.flash_attention,
           pack.pack_a, pack.pack_b, pack.pack_b_grouped]
    before = [f.launches for f in fns]
    a, b = _arrays(11, [(M, K), (K, N)], "float32")
    ops.tiled_matmul(_t(a), _t(b))
    ops.packed_matmul(_t(a), _t(b))
    ops.packed_matmul_fused(_t(a), _t(b))
    ops.vsx_matmul(_t(a), _t(b))
    ops.grouped_matmul_packed(_t(a)[None], _t(b)[None])
    assert [f.launches for f in fns] == before


def test_new_modules_import_no_jax_and_nothing_of_the_reference():
    code = ("import sys, repro_torch.kernels.ops, repro_torch.kernels.ref, "
            "repro_torch.kernels.flash_attention, repro_torch.core.syr2k, "
            "repro_torch.configs.shapes, repro_torch.kernels as k;"
            "k.ops.attention; k.ref.attention_ref;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')];"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": "src:.", "PATH": "/usr/bin:/bin"})
