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
// reference's does. Both operands have one element type.
//
// What bounds it on an H100: at decode (M of a few rows) the bytes of B
// over 3.35 TB/s; above that the tensor cores (989 TFLOP/s bf16) for bf16 /
// f16, the CUDA cores for f32 and int8.
//
// What the design does about it: every packed tile is one contiguous run
// of memory, so the bf16 / f16 bodies (gemm_wgmma.cuh, shared with K1,
// whose A boxes come from natural A instead) move whole tiles with TMA and
// never compute an element's address:
//  * V_WGMMA (bm = bn = 64, bk a multiple of 64): 128 x 128 output tiles,
//    a 4-stage TMA ring fed by one producer warp, two consumer warpgroups
//    on wgmma (the transpose bits take "col" A and "row" B as they lie);
//  * V_TC_STREAM (decode: bm = 16 "row" A, bn = 64, bk a multiple of 64):
//    B streamed once through a TMA ring, mma.sync on 16-row A boxes, Kb
//    split so that at least two blocks run on each SM;
//  * any other geometry the packer emits (bm 16 / 32 / 48, bn 16 / 32 / 48,
//    bk 16 / 32, "col" A at decode, unaligned buffers) takes
//    gemm_blocked.cuh's blocked_mma (variants 1 / 2).
// f32 and int8 (i32 accumulators) take the CUDA-core bodies fma_tiled /
// fma_stream of gemm_blocked.cuh, shared with K7 and K8.

#include "gemm_wgmma.cuh"

namespace {

// The TMA bodies for bf16 / f16; cudaErrorInvalidValue for a geometry they
// do not take. `kt_chunk` is the split's packed k-tiles (V_TC_STREAM).
template <typename T>
int launch_tc(int variant, const void* a, int a_col, int bm, const void* b, int b_col, int bn,
              int Kb, int bk, int dt, int M, int N, const Epilogue& ep, int splits, int kt_chunk,
              void* ws, cudaStream_t s) {
  const int Mb = (M + bm - 1) / bm, Nb = (N + bn - 1) / bn;
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0 && bk % BOX == 0 && bn == BOX;
  CUtensorMap ta, tb;
  const bool tb_ok = aligned && make_packed_b_map(&tb, b, dt, b_col, Nb, Kb, bk, bn);
  if (variant == V_WGMMA) {
    if (!tb_ok || bm != BOX) return static_cast<int>(cudaErrorInvalidValue);
    const bool ta_ok = a_col ? make_tensor_map(&ta, a, dt, 1LL * Mb * Kb * bk, bm, BOX)
                             : make_tensor_map(&ta, a, dt, 1LL * Mb * Kb * bm, bk, BOX);
    if (!ta_ok) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles_m = (Mb + 1) / 2, tiles_n = (Nb + 1) / 2;
    if (a_col && !b_col) {
      return launch_wgmma<T, PackedA<true>, PackedB<true>>(ta, tb, Kb, bk, tiles_m, tiles_n, ep,
                                                           s);
    }
    if (a_col) {
      return launch_wgmma<T, PackedA<true>, PackedB<false>>(ta, tb, Kb, bk, tiles_m, tiles_n, ep,
                                                            s);
    }
    if (!b_col) {
      return launch_wgmma<T, PackedA<false>, PackedB<true>>(ta, tb, Kb, bk, tiles_m, tiles_n, ep,
                                                            s);
    }
    return launch_wgmma<T, PackedA<false>, PackedB<false>>(ta, tb, Kb, bk, tiles_m, tiles_n, ep,
                                                           s);
  }
  // V_TC_STREAM
  if (!tb_ok || bm != 16 || a_col || M > 16 || !valid_tile_split(Kb, splits, kt_chunk, ws) ||
      !make_tensor_map(&ta, a, dt, 1LL * Kb * bm, bk, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* wsf = static_cast<float*>(ws);
  const int err =
      b_col ? launch_mma_stream<T, PackedA<false>, PackedB<false>>(ta, tb, Kb, bk, Nb, splits,
                                                                   kt_chunk, wsf, ep, s)
            : launch_mma_stream<T, PackedA<false>, PackedB<true>>(ta, tb, Kb, bk, Nb, splits,
                                                                  kt_chunk, wsf, ep, s);
  if (err != 0 || splits == 1) return err;
  return reduce_splits(wsf, splits, ep, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). `a_col` / `b_col` are the tile
// layouts (1 for "col"); `dt` the element type of both; `variant` 0 CUDA
// cores (f32 / int8, with the FmaPlan `fma_body`, `fma_tile`, `splits`,
// `kchunk` in elements of k), 1 / 2 blocked_mma decode / prefill, 3
// V_WGMMA, 4 V_TC_STREAM (`splits` chunks of `kchunk` packed k-tiles) for
// bf16 / f16; `ws` the split-K workspace ([splits, M, N] of the
// accumulator type); `c` and `bias` f32; the output a contiguous [M, N] of
// `out_dt`. Returns the CUDA error after the launches, or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int gemm_packed_launch(const void* a, int a_col, int bm, const void* b, int b_col,
                                  int bn, int Kb, int bk, int dt, int M, int N, const void* bias,
                                  const void* c, long long ldc, float alpha, float beta, void* out,
                                  int out_dt, int act, int variant, int fma_body, int fma_tile,
                                  int splits, int kchunk, void* ws, void* stream) {
  if (M <= 0 || N <= 0 || Kb <= 0 || bm <= 0 || bn <= 0 || bk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = Kb * bk;
  const Epilogue ep = make_epilogue(bias, c, ldc, alpha, beta, out, out_dt, act, M, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = (variant == V_MMA_DECODE || variant == V_MMA_PREFILL);
  const bool tc = (variant == V_WGMMA || variant == V_TC_STREAM);
  const FmaPlan plan{fma_body, fma_tile, splits, kchunk, ws};
  const int big = 0x7fffffff;
  // A rows are m ("col" tiles are k-major); B rows are n ("row" tiles are
  // k-major).
  switch (dt) {
    case DT_F32:
      if (variant != V_FMA) break;
      return launch_fma<float>(packed<float>(a, bm, bk, Kb, a_col),
                               packed<float>(b, bn, bk, Kb, !b_col), M, N, K, ep, plan, big, s);
    case DT_I8:
      if (variant != V_FMA) break;
      return launch_fma<int>(packed<int8_t>(a, bm, bk, Kb, a_col),
                             packed<int8_t>(b, bn, bk, Kb, !b_col), M, N, K, ep, plan, big, s);
    case DT_BF16:
      if (tc) {
        return launch_tc<__nv_bfloat16>(variant, a, a_col, bm, b, b_col, bn, Kb, bk, dt, M, N, ep,
                                        splits, kchunk, ws, s);
      }
      if (!mma) break;
      launch_mma<__nv_bfloat16>(variant, packed<__nv_bfloat16>(a, bm, bk, Kb, a_col),
                                packed<__nv_bfloat16>(b, bn, bk, Kb, !b_col), M, N, K, ep, big, s);
      return static_cast<int>(cudaGetLastError());
    case DT_F16:
      if (tc) {
        return launch_tc<__half>(variant, a, a_col, bm, b, b_col, bn, Kb, bk, dt, M, N, ep, splits,
                                 kchunk, ws, s);
      }
      if (!mma) break;
      launch_mma<__half>(variant, packed<__half>(a, bm, bk, Kb, a_col),
                         packed<__half>(b, bn, bk, Kb, !b_col), M, N, K, ep, big, s);
      return static_cast<int>(cudaGetLastError());
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
