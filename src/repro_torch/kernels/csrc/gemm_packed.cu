// gemm_packed — blocked GEMM with BOTH operands pre-packed tile-major, the
// alpha/beta, bias and activation epilogue fused into one store: the
// paper's "Tiling+Packing" strategy (pack_a + pack_b, then this kernel).
//
// Replaces the TPU Pallas kernel `gemm_packed` (`_packed_kernel`,
// src/repro/kernels/gemm_packed.py, with finalize_gemm from
// src/repro/kernels/common.py):
//
//   C[:M,:N] = act(alpha * unpack(A) @ unpack(B) + beta * Cin + bias)
//
// A is [Mb, Kb, bm, bk] ("row" tiles) or [Mb, Kb, bk, bm] ("col": each
// tile transposed, the paper's MMA-preferred A layout); B is [Nb, Kb, bk,
// bn] ("row") or [Nb, Kb, bn, bk] ("col"), zero-filled past K and N by the
// packer. The contraction runs over the whole padded depth Kb * bk, as the
// reference's does. Both operands have one element type: f32 and int8 (i32
// accumulators) on scalar FMAs, bf16 / f16 on the tensor cores. A "col"
// tile is transposed on its way into shared memory, so the tensor cores see
// the same [row][k] slices for both layouts (gemm_blocked.cuh).
//
// What bounds it on an H100: the same as gemm_tiled (bytes at small M,
// multiply-adds at large M); the packed streams make every tile one
// contiguous run of memory.
//
// Not yet: vectorized staging loads, TMA, wgmma.

#include "gemm_blocked.cuh"

namespace {

template <typename T>
PackedOperand<T> packed(const void* p, int tr, int tk, int kb, int k_major) {
  return PackedOperand<T>{static_cast<const T*>(p), tr, tk, kb, k_major, !k_major};
}

}  // namespace

// Plain C entry point (bound with ctypes). `a_col` / `b_col` are the tile
// layouts (1 for "col"); `dt` the element type of both; `variant` as in
// gemm_tiled (0 scalar FMA for f32 / int8, 1 mma decode, 2 mma prefill for
// bf16 / f16); BM / BN the FMA tile; `c` and `bias` f32; the output a
// contiguous [M, N] of `out_dt`. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int gemm_packed_launch(const void* a, int a_col, int bm, const void* b, int b_col,
                                  int bn, int Kb, int bk, int dt, int M, int N, const void* bias,
                                  const void* c, long long ldc, float alpha, float beta, void* out,
                                  int out_dt, int act, int variant, int BM, int BN, void* stream) {
  if (M <= 0 || N <= 0 || Kb <= 0 || bm <= 0 || bn <= 0 || bk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = Kb * bk;
  const Epilogue ep = make_epilogue(bias, c, ldc, alpha, beta, out, out_dt, act, M, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = (variant == V_MMA_DECODE || variant == V_MMA_PREFILL);
  const bool fma_ok = variant == V_FMA && valid_block(BM) && valid_block(BN);
  const int big = 0x7fffffff;
  // A rows are m ("col" tiles are k-major); B rows are n ("row" tiles are
  // k-major).
  switch (dt) {
    case DT_F32:
      if (!fma_ok) break;
      launch_fma<float>(packed<float>(a, bm, bk, Kb, a_col), packed<float>(b, bn, bk, Kb, !b_col),
                        M, N, K, ep, BM, BN, big, s);
      return static_cast<int>(cudaGetLastError());
    case DT_I8:
      if (!fma_ok) break;
      launch_fma<int>(packed<int8_t>(a, bm, bk, Kb, a_col), packed<int8_t>(b, bn, bk, Kb, !b_col),
                      M, N, K, ep, BM, BN, big, s);
      return static_cast<int>(cudaGetLastError());
    case DT_BF16:
      if (!mma) break;
      launch_mma<__nv_bfloat16>(variant, packed<__nv_bfloat16>(a, bm, bk, Kb, a_col),
                                packed<__nv_bfloat16>(b, bn, bk, Kb, !b_col), M, N, K, ep, big, s);
      return static_cast<int>(cudaGetLastError());
    case DT_F16:
      if (!mma) break;
      launch_mma<__half>(variant, packed<__half>(a, bm, bk, Kb, a_col),
                         packed<__half>(b, bn, bk, Kb, !b_col), M, N, K, ep, big, s);
      return static_cast<int>(cudaGetLastError());
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
