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
// [vocab, d_model] embedding. A and B have one element type; the
// accumulator is f32 (i32 for int8) and the epilogue runs once, at the
// single store.
//
// What bounds it on an H100: at decode (M of a few rows, every raw-weight
// decode contraction of a served model) the weight stream, B's bytes over
// 3.35 TB/s; at large M the multiply-adds (989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s f32 on the CUDA cores).
//
// What the design does about it: the wrapper picks a body per call
// (gemm_tiled.py tiled_body) and counts its launches by name:
//  * tc_stream / wgmma (bf16 / f16 with 16-byte aligned bases, A
//    k-contiguous with a row stride a multiple of 16 bytes, B n- or
//    k-contiguous likewise): gemm_wgmma.cuh's TMA bodies, A and B each
//    read through a 2-D tensor map over the operand as it lies (NaturalA,
//    NaturalB): B row-major [K, N] is a map N wide with MN-major boxes,
//    table.t() a map over table [N, K], K wide, with K-major boxes; wgmma's
//    transpose bits take both, and no weight is packed or copied. Each map
//    is exactly as wide as its operand, so reads past M, N and K come back
//    as zeros, never a wider buffer's next columns. Decode (M <= 16):
//    mma_stream, each 64-column stripe of B streamed once through a TMA
//    ring, K cut into chunks of 64-deep boxes so that the card holds two
//    blocks an SM, the partials summed in split order before the one
//    epilogue. Above: wgmma_packed, 128 x 128 output tiles, a TMA ring fed
//    by one producer warp, two consumer warpgroups on wgmma.
//  * mma_general (bf16 / f16 operands TMA cannot read: an unaligned base,
//    a transposed A, a row stride off 16 bytes): gemm_blocked.cuh's
//    blocked_mma, mma.sync on staged tiles over any strides.
//  * fma_stream / fma_tiled (f32, and int8 with i32 accumulators):
//    gemm_blocked.cuh's CUDA-core bodies with split-K, in full precision
//    (no TF32: the reference accumulates f32 GEMMs in f32).
// `max_blocks` = 1 runs the whole problem in one block (1 of 132 SMs), the
// reference's one-step grid for "Intrinsic": the TMA bodies then walk
// every work item in that block.

#include "gemm_wgmma.cuh"

namespace {

// tc_stream (M <= 16) and wgmma over natural A and natural B; `sbn` == 1
// is a row-major B, else B is the transposed view of an [N, K] matrix
// (sbk == 1) whose rows are `sbn` apart. `splits` chunks of `kt_chunk`
// 64-deep k-boxes (tc_stream). cudaErrorInvalidValue for what they do not
// take.
template <typename T>
int launch_tma(int variant, const void* a, long long sam, long long sak, const void* b,
               long long sbk, long long sbn, int dt, int M, int K, int N, const Epilogue& ep,
               int splits, int kt_chunk, void* ws, int max_blocks, cudaStream_t s) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const int Kb = (K + BOX - 1) / BOX;  // the last box may be part padding
  const bool b_mn = sbn == 1;
  CUtensorMap ta, tb;
  // Each map exactly as wide as the operand (K for A and table.t(), N for
  // a row-major B), never its row stride: a strided view's columns past
  // the edge are not zeros, and a NaN there would meet the other operand's
  // zero padding (0 * NaN).
  const bool a_ok = aligned16(a) && sak == 1 && sam % 8 == 0 && sam >= K &&
                    make_tensor_map(&ta, a, dt, M, K, variant == V_WGMMA ? BOX : 16, sam);
  bool b_ok = aligned16(b);
  if (b_mn) {  // B [K, N] itself, N wide
    b_ok = b_ok && sbk % 8 == 0 && sbk >= N && make_tensor_map(&tb, b, dt, K, N, BOX, sbk);
  } else {     // table.t(): the map is over table [N, K], K wide
    b_ok = b_ok && sbk == 1 && sbn % 8 == 0 && sbn >= K &&
           make_tensor_map(&tb, b, dt, N, K, BOX, sbn);
  }
  if (!a_ok || !b_ok) return invalid;
  const int tiles_n = (N + BOX - 1) / BOX;
  if (variant == V_WGMMA) {
    const int tiles_m = ((M + BOX - 1) / BOX + 1) / 2, tiles_n2 = (tiles_n + 1) / 2;
    return b_mn ? launch_wgmma<T, NaturalA, NaturalB<true>>(ta, tb, Kb, BOX, tiles_m, tiles_n2,
                                                            ep, s, max_blocks)
                : launch_wgmma<T, NaturalA, NaturalB<false>>(ta, tb, Kb, BOX, tiles_m, tiles_n2,
                                                             ep, s, max_blocks);
  }
  if (M > 16 || !valid_tile_split(Kb, splits, kt_chunk, ws)) return invalid;
  float* wsf = static_cast<float*>(ws);
  const int err =
      b_mn ? launch_mma_stream<T, NaturalA, NaturalB<true>>(ta, tb, Kb, BOX, tiles_n, splits,
                                                            kt_chunk, wsf, ep, s, max_blocks)
           : launch_mma_stream<T, NaturalA, NaturalB<false>>(ta, tb, Kb, BOX, tiles_n, splits,
                                                             kt_chunk, wsf, ep, s, max_blocks);
  if (err != 0 || splits == 1) return err;
  return reduce_splits(wsf, splits, ep, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). `dt` is A's and B's element type;
// `variant` (enums Variant / TcVariant) 0 CUDA cores (f32, int8) with the
// FmaPlan (`fma_body`, `fma_tile`, `splits`, `kchunk` in elements of k,
// workspace `ws`), 1 / 2 mma_general (blocked_mma decode / prefill tiles),
// 3 wgmma, 4 tc_stream (`splits` chunks of `kchunk` 64-deep k-boxes,
// workspace `ws` of [splits, M, N] f32) for bf16 / f16; `c` and `bias` are
// f32 (the wrapper converts them); the output is a contiguous [M, N] of
// `out_dt`; `max_blocks` caps the grid (1: one block). Returns the CUDA
// error after the launches, or cudaErrorInvalidValue for what the body
// does not take.
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
  const bool tma = (variant == V_WGMMA || variant == V_TC_STREAM);
  const bool fma_ok = variant == V_FMA;
  const FmaPlan plan{fma_body, fma_tile, splits, kchunk, ws};
  // The CUDA-core and blocked_mma bodies see B by (n, k): its row stride is sbn.
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
      if (tma) {
        return launch_tma<__nv_bfloat16>(variant, a, sam, sak, b, sbk, sbn, dt, M, K, N, ep,
                                         splits, kchunk, ws, max_blocks, s);
      }
      if (!mma) break;
      launch_mma<__nv_bfloat16>(variant, strided<__nv_bfloat16>(a, sam, sak),
                                strided<__nv_bfloat16>(b, sbn, sbk), M, N, K, ep, max_blocks, s);
      return static_cast<int>(cudaGetLastError());
    case DT_F16:
      if (tma) {
        return launch_tma<__half>(variant, a, sam, sak, b, sbk, sbn, dt, M, K, N, ep, splits,
                                  kchunk, ws, max_blocks, s);
      }
      if (!mma) break;
      launch_mma<__half>(variant, strided<__half>(a, sam, sak), strided<__half>(b, sbn, sbk), M,
                         N, K, ep, max_blocks, s);
      return static_cast<int>(cudaGetLastError());
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
