// gemm_tiled — blocked GEMM over strided, unpacked operands, with the
// alpha/beta, bias and activation epilogue fused into one store: the
// paper's "Tiling" strategy, and "Intrinsic" when launched as one block.
//
// Replaces the TPU Pallas kernel `gemm_tiled` (`_gemm_kernel`,
// src/repro/kernels/gemm_tiled.py, with finalize_gemm from
// src/repro/kernels/common.py):
//
//   C[:M,:N] = act(alpha * A @ B + beta * Cin + bias)
//
// A [M, K] and B [K, N] are read through their element strides, never
// copied: the raw LM head is B = table.t(), a transposed view of the
// [vocab, d_model] embedding, which the kernel streams k-contiguous
// (gemm_blocked.cuh picks the staging order from the strides). A and B have
// one element type: f32 and int8 (i32 accumulators) run gemm_blocked.cuh's
// CUDA-core bodies in full precision (no TF32, as the reference accumulates
// f32 GEMMs in f32): fma_tiled above 16 rows, fma_stream at decode, both
// with split-K; bf16 / f16 run on the tensor cores with f32 accumulators.
//
// What bounds it on an H100: at decode (M of a few rows) the weight stream,
// B's bytes over 3.35 TB/s; at large M the multiply-adds. The Pallas grid
// steps become output tiles that blocks take in turn; `max_blocks` = 1
// runs the whole problem in one block, which is the reference's one-step
// grid for "Intrinsic" (one TensorCore on a TPU v5e; here 1 of 132 SMs).
//
// Not yet for bf16 / f16: vectorized staging loads, TMA, wgmma, split-K.

#include "gemm_blocked.cuh"

// Plain C entry point (bound with ctypes). `dt` is A's and B's element type;
// `variant` 0 CUDA cores (f32, int8) with the FmaPlan (`fma_body`,
// `fma_tile`, `splits`, `kchunk`, workspace `ws`), 1 mma decode, 2 mma
// prefill (bf16, f16); `c` and `bias` are f32 (the wrapper converts
// them); the output is a contiguous [M, N] of `out_dt`. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// the kernel does not take.
extern "C" int gemm_tiled_launch(const void* a, long long sam, long long sak, const void* b,
                                 long long sbk, long long sbn, int dt, int M, int K, int N,
                                 const void* bias, const void* c, long long ldc, float alpha,
                                 float beta, void* out, int out_dt, int act, int variant,
                                 int fma_body, int fma_tile, int splits, int kchunk, void* ws,
                                 int max_blocks, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep = make_epilogue(bias, c, ldc, alpha, beta, out, out_dt, act, M, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = (variant == V_MMA_DECODE || variant == V_MMA_PREFILL);
  const bool fma_ok = variant == V_FMA;
  const FmaPlan plan{fma_body, fma_tile, splits, kchunk, ws};
  // B is seen by (n, k): its row stride is sbn.
  switch (dt) {
    case DT_F32:
      if (!fma_ok) break;
      return launch_fma<float>(strided<float>(a, sam, sak), strided<float>(b, sbn, sbk), M, N,
                               K, ep, plan, max_blocks, s);
    case DT_I8:
      if (!fma_ok) break;
      return launch_fma<int>(strided<int8_t>(a, sam, sak), strided<int8_t>(b, sbn, sbk), M, N,
                             K, ep, plan, max_blocks, s);
    case DT_BF16:
      if (!mma) break;
      launch_mma<__nv_bfloat16>(variant, strided<__nv_bfloat16>(a, sam, sak),
                                strided<__nv_bfloat16>(b, sbn, sbk), M, N, K, ep, max_blocks, s);
      return static_cast<int>(cudaGetLastError());
    case DT_F16:
      if (!mma) break;
      launch_mma<__half>(variant, strided<__half>(a, sam, sak), strided<__half>(b, sbn, sbk), M,
                         N, K, ep, max_blocks, s);
      return static_cast<int>(cudaGetLastError());
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
