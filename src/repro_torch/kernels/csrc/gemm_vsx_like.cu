// matmul_vsx_like / matmul_vsx_like_packed — A @ B as rank-1 broadcast-FMA
// updates on the CUDA cores, with no tensor-core instruction: the paper's
// generic vector-unit ("VSX") lowering, the baseline of its matrix-engine
// comparison (Fig. 10b).
//
// Replaces the TPU Pallas kernels `matmul_vsx_like` (`_vsx_kernel`) and
// `matmul_vsx_like_packed` (`_vsx_packed_kernel`),
// src/repro/kernels/gemm_vsx_like.py:
//
//   C[:M,:N] = A @ B, operands widened to the accumulator type first
//
// (f32 for float inputs, i32 for int8), stored as `out_dtype` with no other
// epilogue. A is [M, K] through its strides; B is [K, N] through its
// strides, or tile-major [Nb, Kb, bk, bn] ("row") / [Nb, Kb, bn, bk]
// ("col") for the packed variant. Both entry points run the same two bodies
// of gemm_blocked.cuh, whose every k is one rank-1 update (a splat of A's
// column times B's row) of a register tile: the splat+FMA emulation.
//
// What bounds it on an H100: above 16 rows the CUDA cores' multiply-adds
// (67 TFLOP/s of f32 FMA, against 989 TFLOP/s of bf16 on the tensor cores:
// at bf16 this kernel against gemm_tiled is the matrix-engine vs
// vector-unit comparison); at decode the bytes of B (a bf16 weight feeds 8
// flops at M = 4, a fifth of what the cores could do).
//
// What the design does about it: above 16 rows fma_tiled, a 128 x 128 (or
// 64 x 64) register-blocked outer product whose threads read 8 A and 8 B
// values a k with 128-bit shared-memory loads, double-buffered 8-deep
// slices and 16-byte global loads; at most 16 rows fma_stream, which reads
// every B element once, in 16-byte vectors along B's contiguous axis (n of
// a row-major B or of "row" tiles, k of table.t() or of "col" tiles: a
// packed tile is one contiguous run), against A's rows held in shared
// memory. Both split K (wrappers' fma_geometry) so that the card holds at
// least two blocks an SM, and reduce the partials in a fixed order.

#include "gemm_blocked.cuh"

namespace {

template <typename Acc, typename T>
int run_vsx(const void* a, long long sam, long long sak, int M, int K, const void* b,
            int b_packed, long long sbk, long long sbn, int b_col, int Kb, int bk, int bn, int N,
            const Epilogue& ep, const FmaPlan& plan, cudaStream_t s) {
  const int big = 0x7fffffff;
  const StridedOperand<T> A = strided<T>(a, sam, sak);
  if (b_packed) {
    if (Kb * bk < K) return static_cast<int>(cudaErrorInvalidValue);
    // B rows are n: "row" tiles [bk][bn] are k-major.
    return launch_fma<Acc>(A, packed<T>(b, bn, bk, Kb, !b_col), M, N, K, ep, plan, big, s);
  }
  return launch_fma<Acc>(A, strided<T>(b, sbn, sbk), M, N, K, ep, plan, big, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). `dt` is A's and B's element type
// (f32, bf16, f16, int8); `b_packed` selects the packed variant (then
// `b_col`, `Kb`, `bk`, `bn` describe B, else its strides `sbk`, `sbn`);
// `fma_body`, `fma_tile`, `splits`, `kchunk` and the workspace `ws` the
// FmaPlan of gemm_blocked.cuh; the output a contiguous [M, N] of `out_dt`.
// Returns the CUDA error after the launches, or cudaErrorInvalidValue for
// what the kernel does not take.
extern "C" int matmul_vsx_like_launch(const void* a, long long sam, long long sak, int dt, int M,
                                      int K, const void* b, int b_packed, long long sbk,
                                      long long sbn, int b_col, int Kb, int bk, int bn, int N,
                                      void* out, int out_dt, int fma_body, int fma_tile,
                                      int splits, int kchunk, void* ws, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep = make_epilogue(nullptr, nullptr, 0, 1.0f, 0.0f, out, out_dt, 0, M, N);
  const FmaPlan plan{fma_body, fma_tile, splits, kchunk, ws};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case DT_F32:
      return run_vsx<float, float>(a, sam, sak, M, K, b, b_packed, sbk, sbn, b_col, Kb, bk, bn, N,
                                   ep, plan, s);
    case DT_BF16:
      return run_vsx<float, __nv_bfloat16>(a, sam, sak, M, K, b, b_packed, sbk, sbn, b_col, Kb,
                                           bk, bn, N, ep, plan, s);
    case DT_F16:
      return run_vsx<float, __half>(a, sam, sak, M, K, b, b_packed, sbk, sbn, b_col, Kb, bk, bn,
                                    N, ep, plan, s);
    case DT_I8:
      return run_vsx<int, int8_t>(a, sam, sak, M, K, b, b_packed, sbk, sbn, b_col, Kb, bk, bn, N,
                                  ep, plan, s);
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
