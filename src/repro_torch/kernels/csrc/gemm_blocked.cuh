// Blocked GEMM bodies over operands read through an address map — shared by
// gemm_tiled.cu (K7: strided, unpacked A and B), gemm_packed.cu (K6: both
// operands tile-major packed) and gemm_vsx_like.cu (K8: CUDA-core rank-1
// updates over strided or packed B).
//
// An operand is seen as (row, k) -> element: A by (m, k), B by (n, k). Each
// kernel stages k-slices of both operands in shared memory and reads them
// back by row, so a block never needs the operands to be contiguous: the
// address map (StridedOperand or PackedOperand) is the only thing that
// knows the layout. `kfast` says whether neighbouring k are neighbours in
// memory; the staging loops then walk k fastest (else the row index), so
// that neighbouring threads load neighbouring addresses either way. Rows
// past M / N and k past K read as 0: ragged edges are masked here, with no
// padding copies.
//
// Two bodies, each a loop over its output tiles (tile = blockIdx.x, then
// += gridDim.x), so that a grid of one block runs the whole problem:
//  * blocked_fma: 16 x 16 threads, scalar multiply-adds on the accumulator
//    type (f32 for float inputs, i32 for int8), each k of a staged slice a
//    rank-1 update of the block's BM x BN tile. No tensor-core instruction.
//  * blocked_mma: bf16 / f16 on the tensor cores (mma.sync m16n8k16 through
//    ldmatrix, f32 accumulators), with the next slice loaded into registers
//    while the current one is multiplied. Decode-shaped calls (M <= 16) take
//    16 x 16 tiles whose four warps split each 128-deep slice; the others
//    64 x 64 tiles of four 32 x 32 warps over 32-deep slices.

#pragma once

#include "gemm_common.cuh"

namespace {

// A[r, k] at p[r * s_row + k * s_k] (element strides, any sign-free layout:
// a transposed view is s_row = 1, s_k = its leading dimension).
template <typename T>
struct StridedOperand {
  const T* p;
  long long s_row, s_k;
  int kfast;
  __device__ __forceinline__ T at(int r, int k) const {
    return p[static_cast<long long>(r) * s_row + static_cast<long long>(k) * s_k];
  }
};

// A tile-major stack [row tiles, kb, ...]: tiles of tr rows by tk k, stored
// [tk][tr] (k_major) or [tr][tk]. Packed A "row" is [bm][bk] tiles, "col"
// [bk][bm]; packed B "row" is [bk][bn] (k_major, rows are n), "col" [bn][bk].
template <typename T>
struct PackedOperand {
  const T* p;
  int tr, tk, kb, k_major, kfast;
  __device__ __forceinline__ T at(int r, int k) const {
    const int i = r / tr, rr = r - i * tr, kk = k / tk, kq = k - kk * tk;
    const long long base = (static_cast<long long>(i) * kb + kk) * tr * tk;
    return p[base + (k_major ? static_cast<long long>(kq) * tr + rr
                             : static_cast<long long>(rr) * tk + kq)];
  }
};

// Widening of an element to the accumulator type (reference: operands cast
// to acc_dtype_for before the rank-1 updates / the f32 contraction).
template <typename Acc>
struct Widen {
  static __device__ __forceinline__ Acc of(float x) { return static_cast<Acc>(x); }
  static __device__ __forceinline__ Acc of(__nv_bfloat16 x) { return static_cast<Acc>(__bfloat162float(x)); }
  static __device__ __forceinline__ Acc of(__half x) { return static_cast<Acc>(__half2float(x)); }
  static __device__ __forceinline__ Acc of(int8_t x) { return static_cast<Acc>(x); }
};

// Staging coordinates of element `idx` of a rows x depth slice.
__device__ __forceinline__ void slice_coords(int kfast, int rows, int depth, int idx, int& r,
                                             int& q) {
  if (kfast) {
    r = idx / depth;
    q = idx % depth;
  } else {
    q = idx / rows;
    r = idx % rows;
  }
}

constexpr int KC_FMA = 32;  // staged k-slice of the scalar kernel

template <typename Acc, class OpA, class OpB>
__global__ void __launch_bounds__(FMA_THREADS)
blocked_fma(OpA A, OpB B, int K, Epilogue ep, int BM, int BN, int tiles_n, int tiles) {
  __shared__ Acc As[KC_FMA][MAX_BM + 1];  // [k][row]
  __shared__ Acc Bs[KC_FMA][MAX_BN + 1];  // [k][col]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tm = BM / 16, tn = BN / 16;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    Acc acc[MAX_T][MAX_T];
#pragma unroll
    for (int i = 0; i < MAX_T; ++i)
#pragma unroll
      for (int j = 0; j < MAX_T; ++j) acc[i][j] = static_cast<Acc>(0);

    for (int k0 = 0; k0 < K; k0 += KC_FMA) {
      for (int idx = tid; idx < BM * KC_FMA; idx += FMA_THREADS) {
        int r, q;
        slice_coords(A.kfast, BM, KC_FMA, idx, r, q);
        const int gm = m0 + r, gk = k0 + q;
        As[q][r] = (gm < ep.M && gk < K) ? Widen<Acc>::of(A.at(gm, gk)) : static_cast<Acc>(0);
      }
      for (int idx = tid; idx < BN * KC_FMA; idx += FMA_THREADS) {
        int c, q;
        slice_coords(B.kfast, BN, KC_FMA, idx, c, q);
        const int gn = n0 + c, gk = k0 + q;
        Bs[q][c] = (gn < ep.N && gk < K) ? Widen<Acc>::of(B.at(gn, gk)) : static_cast<Acc>(0);
      }
      __syncthreads();
      for (int q = 0; q < KC_FMA; ++q) {  // one rank-1 update per k
        Acc av[MAX_T], bv[MAX_T];
#pragma unroll
        for (int i = 0; i < MAX_T; ++i) av[i] = (i < tm) ? As[q][ty + 16 * i] : static_cast<Acc>(0);
#pragma unroll
        for (int j = 0; j < MAX_T; ++j) bv[j] = (j < tn) ? Bs[q][tx + 16 * j] : static_cast<Acc>(0);
#pragma unroll
        for (int i = 0; i < MAX_T; ++i)
#pragma unroll
          for (int j = 0; j < MAX_T; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < MAX_T; ++i)
#pragma unroll
      for (int j = 0; j < MAX_T; ++j)
        if (i < tm && j < tn)
          ep.store(static_cast<float>(acc[i][j]), m0 + ty + 16 * i, n0 + tx + 16 * j, 0);
  }
}

// Warps: WM x WN over the tile's rows and columns, WK splitting each slice's
// k-steps; a warp owns MT m16 tiles by NT n8 tiles; KS is the staged depth.
template <typename T, class OpA, class OpB, int WM, int WN, int WK, int MT, int NT, int KS>
__global__ void __launch_bounds__(MMA_THREADS)
blocked_mma(OpA A, OpB B, int K, Epilogue ep, int tiles_n, int tiles) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8, KSTEPS = KS / 16, KPAD = KS + 8;
  constexpr int A_PER_T = BM * KS / MMA_THREADS, B_PER_T = BN * KS / MMA_THREADS;
  static_assert(WM * WN * WK * 32 == MMA_THREADS, "four warps");
  static_assert(KSTEPS % WK == 0 && NT % 2 == 0, "warp split");
  static_assert(BM * KS % MMA_THREADS == 0 && BN * KS % MMA_THREADS == 0, "staging");
  __shared__ __align__(16) T As[BM][KPAD];  // [row][k]
  __shared__ __align__(16) T Bs[BN][KPAD];  // [col][k]: mma's "col" B operand
  __shared__ float Cs[WK][BM][BN + 4];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp % WK, wn = (warp / WK) % WN, wm = warp / (WK * WN);
  const int slices = (K + KS - 1) / KS;
  const T zero = Half16<T>::from_float(0.0f);
  T a_reg[A_PER_T], b_reg[B_PER_T];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    auto load_slice = [&](int sl) {
      const int k0 = sl * KS;
#pragma unroll
      for (int i = 0; i < A_PER_T; ++i) {
        int r, q;
        slice_coords(A.kfast, BM, KS, tid + i * MMA_THREADS, r, q);
        const int gm = m0 + r, gk = k0 + q;
        a_reg[i] = (gm < ep.M && gk < K) ? A.at(gm, gk) : zero;
      }
#pragma unroll
      for (int i = 0; i < B_PER_T; ++i) {
        int c, q;
        slice_coords(B.kfast, BN, KS, tid + i * MMA_THREADS, c, q);
        const int gn = n0 + c, gk = k0 + q;
        b_reg[i] = (gn < ep.N && gk < K) ? B.at(gn, gk) : zero;
      }
    };
    auto store_slice = [&]() {
#pragma unroll
      for (int i = 0; i < A_PER_T; ++i) {
        int r, q;
        slice_coords(A.kfast, BM, KS, tid + i * MMA_THREADS, r, q);
        As[r][q] = a_reg[i];
      }
#pragma unroll
      for (int i = 0; i < B_PER_T; ++i) {
        int c, q;
        slice_coords(B.kfast, BN, KS, tid + i * MMA_THREADS, c, q);
        Bs[c][q] = b_reg[i];
      }
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

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
            Half16<T>::mma(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            Half16<T>::mma(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
      __syncthreads();
    }

    // Accumulator fragments -> shared memory (c0,c1: row g, cols 2t, 2t+1;
    // c2,c3: row g + 8), then the k-split warps' sums in a fixed order.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = wm * MT * 16 + mt * 16 + lane / 4;
        const int c = wn * NT * 8 + nt * 8 + (lane % 4) * 2;
        Cs[wk][r][c] = acc[mt][nt][0];
        Cs[wk][r][c + 1] = acc[mt][nt][1];
        Cs[wk][r + 8][c] = acc[mt][nt][2];
        Cs[wk][r + 8][c + 1] = acc[mt][nt][3];
      }
    __syncthreads();
    for (int idx = tid; idx < BM * BN; idx += MMA_THREADS) {
      const int r = idx / BN, c = idx % BN;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < WK; ++w) v += Cs[w][r][c];
      ep.store(v, m0 + r, n0 + c, 0);
    }
    __syncthreads();  // Cs and the staged slices are reused by the next tile
  }
}

inline int grid_for(long long tiles, int max_blocks) {
  const long long g = tiles < max_blocks ? tiles : max_blocks;
  return static_cast<int>(g < 1 ? 1 : g);
}

// Variant codes (the wrappers' pick_variant): 0 scalar FMA, 1 mma decode
// (16 x 16 tiles, M <= 16), 2 mma prefill (64 x 64 tiles).
template <typename T, class OpA, class OpB>
void launch_mma(int variant, OpA a, OpB b, int M, int N, int K, const Epilogue& ep,
                int max_blocks, cudaStream_t s) {
  if (variant == V_MMA_DECODE) {
    const int tiles_n = (N + 15) / 16;
    const long long tiles = static_cast<long long>(tiles_n) * ((M + 15) / 16);
    blocked_mma<T, OpA, OpB, 1, 1, 4, 1, 2, 128><<<grid_for(tiles, max_blocks), MMA_THREADS, 0, s>>>(
        a, b, K, ep, tiles_n, static_cast<int>(tiles));
  } else {
    const int tiles_n = (N + 63) / 64;
    const long long tiles = static_cast<long long>(tiles_n) * ((M + 63) / 64);
    blocked_mma<T, OpA, OpB, 2, 2, 1, 2, 4, 32><<<grid_for(tiles, max_blocks), MMA_THREADS, 0, s>>>(
        a, b, K, ep, tiles_n, static_cast<int>(tiles));
  }
}

template <typename Acc, class OpA, class OpB>
void launch_fma(OpA a, OpB b, int M, int N, int K, const Epilogue& ep, int BM, int BN,
                int max_blocks, cudaStream_t s) {
  const int tiles_n = (N + BN - 1) / BN;
  const long long tiles = static_cast<long long>(tiles_n) * ((M + BM - 1) / BM);
  blocked_fma<Acc, OpA, OpB><<<grid_for(tiles, max_blocks), FMA_THREADS, 0, s>>>(
      a, b, K, ep, BM, BN, tiles_n, static_cast<int>(tiles));
}

bool valid_block(int v) { return v >= 16 && v <= MAX_BM && v % 16 == 0; }

Epilogue make_epilogue(const void* bias, const void* c, long long ldc, float alpha, float beta,
                       void* out, int out_dt, int act, int M, int N) {
  return Epilogue{nullptr, 0, alpha, beta, static_cast<const float*>(c), ldc,
                  static_cast<const float*>(bias), act, out, out_dt, M, N};
}

}  // namespace
