// gemm_packed_fused_a — pack-free-A GEMM against a load-time-packed B, with
// the dequant / alpha-beta / bias / activation epilogue fused into one store.
//
// Replaces the TPU Pallas kernel `gemm_packed_fused_a` (`_fused_a_kernel`,
// src/repro/kernels/gemm_packed.py, with contract_tile / finalize_gemm from
// src/repro/kernels/common.py). It computes the same function, not the same
// blocks:
//
//   C[:M,:N] = act(colscale * alpha * sum_k A[:, kblk] @ deq(B[j, k])
//                  + beta * Cin + bias)
//
// A is natural [M, K] (row stride lda, unit column stride), read directly
// with the ragged M/K edges masked here. B is tile-major [Nb, Kb, t0, t1]:
// [bk, bn] tiles ("row") or [bn, bk] ("col"), zero-filled past K/N, as
// float32 / bfloat16 / float16 / int8, or int4 nibble-packed two a byte
// (element 2i in the low nibble). Quantized tiles carry f32 scales: [Nb, Kb]
// per tile, multiplied into each K-step's partial sum, or [Nb] per column,
// multiplied once at store ahead of alpha/beta, bias and activation.
//
// What bounds it on an H100: at decode (M of a few rows) the weight stream,
// B's bytes over 3.35 TB/s; at prefill (M in the hundreds) the tensor-core
// multiply-adds. Two kernels share the epilogue:
//
//  * fused_a_mma (bf16 / f16 activations, B of the same type or int8/int4):
//    tensor cores through mma.sync m16n8k16 with f32 accumulators. Each
//    block stages a KS-deep slice of A and of its B column chunk in shared
//    memory (int tiles widened exactly to the activation type on the way,
//    as contract_tile casts them), B stored k-contiguous per column so that
//    ldmatrix feeds mma's "col" operand. Prefill blocks are 64 x 64 with
//    four warps of 32 x 32. Decode blocks are 16 rows by 16 columns, so an
//    N = 2048 projection still spreads over 128 blocks, and their four warps
//    split the slice's k-steps between them (the partial sums meet in
//    shared memory in a fixed order): more weight bytes in flight per SM
//    against the weight-stream bound.
//  * fused_a_fma (every other combination: f32 A in full f32 without TF32,
//    int8 A with i32 accumulators): shared-memory tiles and scalar FMAs.
//
// Not yet: TMA, wgmma, warp specialisation, a deeper copy pipeline.

#include "gemm_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// fused_a_fma: scalar FMAs on shared-memory tiles (f32 and int8 activations)
// ---------------------------------------------------------------------------

template <typename Acc>
__global__ void __launch_bounds__(FMA_THREADS)
fused_a_fma(const void* __restrict__ A, int a_dt, long long lda, int K,
            const char* __restrict__ B, int b_dt, int col_layout, int Kb,
            int bk, int bn, long long tile_bytes, Epilogue ep, int BM, int BN, int KC) {
  __shared__ Acc As[MAX_KC][MAX_BM + 1];  // A slice, transposed: [k][row]
  __shared__ Acc Bs[MAX_KC][MAX_BN + 1];  // B slice: [k][col]

  const int chunks = bn / BN;
  const int j = blockIdx.x / chunks;           // B tile column
  const int c0 = (blockIdx.x % chunks) * BN;   // first column inside the tile
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int tm = BM / 16, tn = BN / 16;

  Acc total[MAX_T][MAX_T];
#pragma unroll
  for (int i = 0; i < MAX_T; ++i)
#pragma unroll
    for (int jn = 0; jn < MAX_T; ++jn) total[i][jn] = static_cast<Acc>(0);

  for (int kk = 0; kk < Kb; ++kk) {
    const char* tile = B + (static_cast<long long>(j) * Kb + kk) * tile_bytes;
    Acc part[MAX_T][MAX_T];
#pragma unroll
    for (int i = 0; i < MAX_T; ++i)
#pragma unroll
      for (int jn = 0; jn < MAX_T; ++jn) part[i][jn] = static_cast<Acc>(0);

    for (int kc = 0; kc < bk; kc += KC) {
      const int kbase = kk * bk + kc;
      for (int idx = tid; idx < BM * KC; idx += FMA_THREADS) {
        const int r = idx / KC, q = idx % KC;  // consecutive threads: consecutive k
        const int gm = m0 + r, gk = kbase + q;
        Acc v = static_cast<Acc>(0);
        if (gm < ep.M && gk < K) v = load_elem<Acc>(A, static_cast<long long>(gm) * lda + gk, a_dt);
        As[q][r] = v;
      }
      for (int idx = tid; idx < BN * KC; idx += FMA_THREADS) {
        int q, c;
        long long li;
        if (col_layout) {  // [bn, bk] tile: k is contiguous
          c = idx / KC;
          q = idx % KC;
          li = static_cast<long long>(c0 + c) * bk + kc + q;
        } else {           // [bk, bn] tile: n is contiguous
          q = idx / BN;
          c = idx % BN;
          li = static_cast<long long>(kc + q) * bn + c0 + c;
        }
        Bs[q][c] = load_b<Acc>(tile, li, b_dt);
      }
      __syncthreads();
      for (int q = 0; q < KC; ++q) {
        Acc av[MAX_T], bv[MAX_T];
#pragma unroll
        for (int i = 0; i < MAX_T; ++i) av[i] = (i < tm) ? As[q][ty + 16 * i] : static_cast<Acc>(0);
#pragma unroll
        for (int jn = 0; jn < MAX_T; ++jn) bv[jn] = (jn < tn) ? Bs[q][tx + 16 * jn] : static_cast<Acc>(0);
#pragma unroll
        for (int i = 0; i < MAX_T; ++i)
#pragma unroll
          for (int jn = 0; jn < MAX_T; ++jn) part[i][jn] += av[i] * bv[jn];
      }
      __syncthreads();
    }
    // Per-tile dequant of this K-step's partial product (contract_tile).
    const Acc s = (ep.scale_mode == 1)
                      ? static_cast<Acc>(ep.scales[static_cast<long long>(j) * Kb + kk])
                      : static_cast<Acc>(1);
#pragma unroll
    for (int i = 0; i < MAX_T; ++i)
#pragma unroll
      for (int jn = 0; jn < MAX_T; ++jn)
        total[i][jn] += (ep.scale_mode == 1) ? part[i][jn] * s : part[i][jn];
  }

#pragma unroll
  for (int i = 0; i < MAX_T; ++i)
#pragma unroll
    for (int jn = 0; jn < MAX_T; ++jn)
      if (i < tm && jn < tn)
        ep.store(static_cast<float>(total[i][jn]), m0 + ty + 16 * i,
                 j * bn + c0 + tx + 16 * jn, j);
}

// ---------------------------------------------------------------------------
// fused_a_mma: tensor cores (mma.sync m16n8k16, f32 accumulators)
// ---------------------------------------------------------------------------

// Warps: WM x WN over the block's rows and columns, WK splitting each slice's
// k-steps; a warp owns MT m16 tiles by NT n8 tiles. KS is the staged depth.
// The K loop runs over slices (bk / KS of them per B tile): slice s+1 is
// loaded from global memory into registers while the tensor cores work on
// slice s in shared memory, so each round's load latency overlaps compute.
template <typename T, int WM, int WN, int WK, int MT, int NT, int KS>
__global__ void __launch_bounds__(MMA_THREADS)
fused_a_mma(const T* __restrict__ A, long long lda, int K,
            const char* __restrict__ B, int b_dt, int col_layout, int Kb,
            int bk, int bn, long long tile_bytes, Epilogue ep) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8, KSTEPS = KS / 16, KPAD = KS + 8;
  constexpr int A_PER_T = BM * KS / MMA_THREADS;      // A elements a thread stages
  constexpr int W_PER_T = BN * KS / 2 / MMA_THREADS;  // B words, at most (16-bit B)
  static_assert(WM * WN * WK * 32 == MMA_THREADS, "four warps");
  static_assert(KSTEPS % WK == 0 && NT % 2 == 0, "warp split");
  static_assert(BM * KS % MMA_THREADS == 0 && BN * KS / 8 % MMA_THREADS == 0, "staging");
  __shared__ __align__(16) T As[BM][KPAD];  // [row][k]
  __shared__ __align__(16) T Bs[BN][KPAD];  // [col][k]: mma's "col" B operand
  __shared__ float Cs[WK][BM][BN + 4];

  const int chunks = bn / BN;
  const int j = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp % WK, wn = (warp / WK) % WN, wm = warp / (WK * WN);
  const int epw = (b_dt == DT_I4) ? 8 : (b_dt == DT_I8 ? 4 : 2);  // elements a word
  const int bits = (b_dt == DT_I4) ? 4 : (b_dt == DT_I8 ? 8 : 16);
  const int w_per_t = BN * KS / epw / MMA_THREADS;
  const int slices_per_tile = bk / KS, slices = Kb * slices_per_tile;
  const T zero = Half16<T>::from_float(0.0f);

  // Where thread-word w of a slice sits in the tile and in Bs.
  auto b_coords = [&](int w, int& c, int& q) {
    if (col_layout) {  // [bn, bk] tile: a word holds epw k-neighbours
      const int per_col = KS / epw;
      c = w / per_col;
      q = (w % per_col) * epw;
    } else {           // [bk, bn] tile: a word holds epw n-neighbours
      const int per_row = BN / epw;
      q = w / per_row;
      c = (w % per_row) * epw;
    }
  };

  T a_reg[A_PER_T];
  uint32_t b_reg[W_PER_T];
  auto load_slice = [&](int sl) {
    const int kk = sl / slices_per_tile, kc = (sl % slices_per_tile) * KS;
    const int kbase = kk * bk + kc;
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) {
      const int idx = tid + i * MMA_THREADS;
      const int gm = m0 + idx / KS, gk = kbase + idx % KS;
      a_reg[i] = (gm < ep.M && gk < K) ? A[static_cast<long long>(gm) * lda + gk] : zero;
    }
    const char* tile = B + (static_cast<long long>(j) * Kb + kk) * tile_bytes;
#pragma unroll
    for (int i = 0; i < W_PER_T; ++i) {
      if (i < w_per_t) {
        int c, q;
        b_coords(tid + i * MMA_THREADS, c, q);
        const long long li = col_layout ? static_cast<long long>(c0 + c) * bk + kc + q
                                        : static_cast<long long>(kc + q) * bn + c0 + c;
        b_reg[i] = *reinterpret_cast<const uint32_t*>(tile + li * bits / 8);
      }
    }
  };
  auto store_slice = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) {
      const int idx = tid + i * MMA_THREADS;
      As[idx / KS][idx % KS] = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < W_PER_T; ++i) {
      if (i < w_per_t) {
        int c, q;
        b_coords(tid + i * MMA_THREADS, c, q);
        T v[8];
        const int n = widen_word<T>(b_reg[i], b_dt, v);
        for (int e = 0; e < n; ++e) {
          if (col_layout) Bs[c][q + e] = v[e];
          else Bs[c + e][q] = v[e];
        }
      }
    }
  };

  float total[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[mt][nt][e] = part[mt][nt][e] = 0.0f;

  load_slice(0);
  for (int sl = 0; sl < slices; ++sl) {
    store_slice();
    __syncthreads();
    if (sl + 1 < slices) load_slice(sl + 1);  // in flight during the mma below
#pragma unroll
    for (int s = wk; s < KSTEPS; s += WK) {
      const int k0 = s * 16;
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], &As[wm * MT * 16 + mt * 16 + (lane % 16)][k0 + (lane / 16) * 8]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bf[4];  // b0/b1 of n8 tile 2np, then of 2np+1
        ldmatrix_x4(bf, &Bs[wn * NT * 8 + np * 16 + (lane % 8) + (lane / 16) * 8]
                           [k0 + ((lane / 8) % 2) * 8]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          Half16<T>::mma(part[mt][2 * np], af[mt], bf[0], bf[1]);
          Half16<T>::mma(part[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
    if ((sl + 1) % slices_per_tile == 0) {
      // Per-tile dequant of this K-step's partial product (contract_tile).
      const int kk = sl / slices_per_tile;
      const float sc = (ep.scale_mode == 1) ? ep.scales[static_cast<long long>(j) * Kb + kk] : 1.0f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[mt][nt][e] += (ep.scale_mode == 1) ? part[mt][nt][e] * sc : part[mt][nt][e];
            part[mt][nt][e] = 0.0f;
          }
    }
  }

  // Accumulator fragments -> shared memory (c0,c1: row g, cols 2t, 2t+1;
  // c2,c3: row g + 8), then the k-split warps' sums in a fixed order.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wm * MT * 16 + mt * 16 + lane / 4;
      const int c = wn * NT * 8 + nt * 8 + (lane % 4) * 2;
      Cs[wk][r][c] = total[mt][nt][0];
      Cs[wk][r][c + 1] = total[mt][nt][1];
      Cs[wk][r + 8][c] = total[mt][nt][2];
      Cs[wk][r + 8][c + 1] = total[mt][nt][3];
    }
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += MMA_THREADS) {
    const int r = idx / BN, c = idx % BN;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < WK; ++w) v += Cs[w][r][c];
    ep.store(v, m0 + r, j * bn + c0 + c, j);
  }
}

template <typename T>
void launch_mma(int variant, const void* a, long long lda, int M, int K, const char* b, int b_dt,
                int col_layout, int Nb, int Kb, int bk, int bn, long long tile_bytes,
                const Epilogue& ep, cudaStream_t s) {
  const T* at = static_cast<const T*>(a);
  if (variant == V_MMA_DECODE) {  // 16 x 16 blocks, four warps split k
    const dim3 grid(static_cast<unsigned>(Nb * (bn / 16)), static_cast<unsigned>((M + 15) / 16));
    if (bk % 128 == 0)
      fused_a_mma<T, 1, 1, 4, 1, 2, 128><<<grid, MMA_THREADS, 0, s>>>(
          at, lda, K, b, b_dt, col_layout, Kb, bk, bn, tile_bytes, ep);
    else
      fused_a_mma<T, 1, 1, 4, 1, 2, 64><<<grid, MMA_THREADS, 0, s>>>(
          at, lda, K, b, b_dt, col_layout, Kb, bk, bn, tile_bytes, ep);
  } else {                        // 64 x 64 blocks, 2 x 2 warps of 32 x 32
    const dim3 grid(static_cast<unsigned>(Nb * (bn / 64)), static_cast<unsigned>((M + 63) / 64));
    if (bk % 64 == 0)
      fused_a_mma<T, 2, 2, 1, 2, 4, 64><<<grid, MMA_THREADS, 0, s>>>(
          at, lda, K, b, b_dt, col_layout, Kb, bk, bn, tile_bytes, ep);
    else
      fused_a_mma<T, 2, 2, 1, 2, 4, 32><<<grid, MMA_THREADS, 0, s>>>(
          at, lda, K, b, b_dt, col_layout, Kb, bk, bn, tile_bytes, ep);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `variant` picks the kernel
// (0 fma, 1 mma decode, 2 mma prefill; the caller checks eligibility, see
// gemm_packed.py); BM / BN / KC are the fma kernel's block shape. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// geometry the kernel does not take. `stream` is the caller's cudaStream_t.
extern "C" int gemm_packed_fused_a_launch(
    const void* a, int a_dt, long long lda, int M, int K,
    const void* b, int b_dt, int col_layout, int Nb, int Kb, int bk, int bn,
    const void* scales, int scale_mode, const void* bias, const void* c,
    long long ldc, float alpha, float beta, void* out, int out_dt, int N,
    int act, int BM, int BN, int KC, int int_acc, int variant, void* stream) {
  if (M <= 0 || N <= 0 || Nb <= 0 || Kb <= 0 || bk % 16 || bn % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tile_bytes = (b_dt == DT_I4)
      ? static_cast<long long>(bk) * bn / 2
      : static_cast<long long>(bk) * bn * elem_bytes(b_dt);
  const Epilogue ep{static_cast<const float*>(scales), scale_mode, alpha, beta,
                    static_cast<const float*>(c), ldc, static_cast<const float*>(bias),
                    act, out, out_dt, M, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const char* bp = static_cast<const char*>(b);
  if (variant == V_MMA_DECODE || variant == V_MMA_PREFILL) {
    const bool half_a = (a_dt == DT_BF16 || a_dt == DT_F16);
    const bool b_ok = (b_dt == a_dt || b_dt == DT_I8 || b_dt == DT_I4);
    const bool shape_ok = (variant == V_MMA_DECODE) ? (bk % 64 == 0)
                                                    : (bk % 32 == 0 && bn % 64 == 0);
    if (!half_a || !b_ok || !shape_ok || int_acc) return static_cast<int>(cudaErrorInvalidValue);
    if (a_dt == DT_BF16)
      launch_mma<__nv_bfloat16>(variant, a, lda, M, K, bp, b_dt, col_layout, Nb, Kb, bk, bn,
                                tile_bytes, ep, s);
    else
      launch_mma<__half>(variant, a, lda, M, K, bp, b_dt, col_layout, Nb, Kb, bk, bn,
                         tile_bytes, ep, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != V_FMA || BM < 16 || BM > MAX_BM || BM % 16 ||
      !valid_chunk(BN, bn, MAX_BN) || !valid_chunk(KC, bk, MAX_KC)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(Nb * (bn / BN)), static_cast<unsigned>((M + BM - 1) / BM));
  if (int_acc)
    fused_a_fma<int><<<grid, FMA_THREADS, 0, s>>>(a, a_dt, lda, K, bp, b_dt, col_layout, Kb, bk,
                                                  bn, tile_bytes, ep, BM, BN, KC);
  else
    fused_a_fma<float><<<grid, FMA_THREADS, 0, s>>>(a, a_dt, lda, K, bp, b_dt, col_layout, Kb,
                                                    bk, bn, tile_bytes, ep, BM, BN, KC);
  return static_cast<int>(cudaGetLastError());
}
