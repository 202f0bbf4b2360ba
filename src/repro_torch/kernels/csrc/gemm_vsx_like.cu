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
// (f32 for float inputs, i32 for int8), stored as `out_dt` with no other
// epilogue. A is [M, K] through its strides; B is [K, N] through its
// strides, or tile-major [Nb, Kb, bk, bn] ("row") / [Nb, Kb, bn, bk]
// ("col") for the packed variant. The body is gemm_blocked.cuh's
// blocked_fma: every staged k is one rank-1 update (a splat of A's column
// times B's row) of the block's register tile.
//
// What bounds it on an H100: the CUDA cores' multiply-adds (67 TFLOP/s of
// f32 FMA, against 989 TFLOP/s of bf16 on the tensor cores): at bf16 this
// kernel against gemm_tiled is the matrix-engine vs vector-unit comparison.

#include "gemm_blocked.cuh"

namespace {

template <typename Acc, typename T>
int run_vsx(const void* a, long long sam, long long sak, int M, int K, const void* b,
            int b_packed, long long sbk, long long sbn, int b_col, int Kb, int bk, int bn, int N,
            const Epilogue& ep, int BM, int BN, cudaStream_t s) {
  const int big = 0x7fffffff;
  const StridedOperand<T> A{static_cast<const T*>(a), sam, sak, sak == 1};
  if (b_packed) {
    if (Kb * bk < K) return static_cast<int>(cudaErrorInvalidValue);
    // B rows are n: "row" tiles [bk][bn] are k-major.
    const PackedOperand<T> B{static_cast<const T*>(b), bn, bk, Kb, !b_col, b_col};
    launch_fma<Acc>(A, B, M, N, K, ep, BM, BN, big, s);
  } else {
    const StridedOperand<T> B{static_cast<const T*>(b), sbn, sbk, sbk == 1};
    launch_fma<Acc>(A, B, M, N, K, ep, BM, BN, big, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). `dt` is A's and B's element type
// (f32, bf16, f16, int8); `b_packed` selects the packed variant (then
// `b_col`, `Kb`, `bk`, `bn` describe B, else its strides `sbk`, `sbn`);
// BM / BN the block tile; the output a contiguous [M, N] of `out_dt`.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// what the kernel does not take.
extern "C" int matmul_vsx_like_launch(const void* a, long long sam, long long sak, int dt, int M,
                                      int K, const void* b, int b_packed, long long sbk,
                                      long long sbn, int b_col, int Kb, int bk, int bn, int N,
                                      void* out, int out_dt, int BM, int BN, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || !valid_block(BM) || !valid_block(BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Epilogue ep = make_epilogue(nullptr, nullptr, 0, 1.0f, 0.0f, out, out_dt, 0, M, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case DT_F32:
      return run_vsx<float, float>(a, sam, sak, M, K, b, b_packed, sbk, sbn, b_col, Kb, bk, bn, N,
                                   ep, BM, BN, s);
    case DT_BF16:
      return run_vsx<float, __nv_bfloat16>(a, sam, sak, M, K, b, b_packed, sbk, sbn, b_col, Kb,
                                           bk, bn, N, ep, BM, BN, s);
    case DT_F16:
      return run_vsx<float, __half>(a, sam, sak, M, K, b, b_packed, sbk, sbn, b_col, Kb, bk, bn,
                                    N, ep, BM, BN, s);
    case DT_I8:
      return run_vsx<int, int8_t>(a, sam, sak, M, K, b, b_packed, sbk, sbn, b_col, Kb, bk, bn, N,
                                  ep, BM, BN, s);
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
