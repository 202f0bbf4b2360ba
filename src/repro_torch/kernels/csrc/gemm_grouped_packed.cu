// gemm_grouped_packed — the grouped (batched-expert) GEMM of the MoE layer
// against load-time-packed expert stacks, ragged over per-segment counts,
// with the dequant / bias / activation or silu-gate epilogue fused into
// one store.
//
// Replaces two TPU Pallas kernels of src/repro/kernels/gemm_grouped.py:
//  * gemm_grouped_packed_ragged (_ragged_kernel) — K2, with a counts
//    pointer;
//  * gemm_grouped_packed (_grouped_kernel) — K3, the same function with a
//    null counts pointer (every row live).
// It computes their function, not their blocks. For each segment
// g = (e, s) of A [E, S, C, K] (natural layout, unit column stride) and
// count = clamp(counts[g], 0, C):
//
//   out[e, s, r, :] = r < count ? epi(sum_k A[e, s, r, kblk] @ deq(B[e, j, k]))
//                               : 0
//   epi(x)          = act(colscale * x + bias[e])                 or, with B2,
//                     silu(colscale * x + bias[e]) * (colscale2 * x2)
//
// where x2 is the same contraction against the silu-gate partner stack B2
// (the MoE gate/up pair: two accumulators over ONE read of A). B / B2 are
// tile-major [E, Nb, Kb, t0, t1] as gemm_packed_fused_a.cu takes them
// (float, int8, or int4 nibble-packed, "row" or "col" tiles); tile scales
// [E, Nb, Kb] multiply each K step's partial sum, col scales [E, Nb] once
// at store.
//
// One block per (m-block, column chunk, segment), with the K loop inside
// the block. The block reads its segment's count from device memory first:
// a block whose rows all lie at or past the count stores zeros and loads no
// A, B or scale tile — dead capacity costs a store, not a weight stream.
// m-blocks are the fastest grid axis, so the m-blocks of one column chunk
// run together and re-read its B tiles from L2, not from device memory.
//
// What bounds it on an H100: at decode (a few live rows per expert) the
// live experts' weight stream over 3.35 TB/s; at prefill (C in the
// hundreds) the tensor-core multiply-adds. Two kernels share the epilogue:
//  * grouped_mma (bf16 / f16 activations, B of the same type or int8/int4):
//    mma.sync m16n8k16 with f32 accumulators, B slices staged k-contiguous
//    per column for ldmatrix, int tiles widened exactly on the way, and the
//    next slice prefetched into registers while the tensor cores work, as
//    in gemm_packed_fused_a.cu. Decode blocks (C <= 16) are 16 x 16 with
//    four warps splitting each slice's k-steps; prefill blocks 32 x 64 with
//    four warps of 16 x 32 (32 rows keep the pair's two accumulators and
//    prefetch registers clear of spills).
//  * grouped_fma (f32 A in full f32 without TF32; int8 A with i32
//    accumulators): shared-memory tiles and scalar FMAs.
// The TPU kernel's sublane rule (decode-shaped segments to a masked
// fallback) does not apply: every segment runs here.
//
// Not yet: TMA, wgmma, split-K for the deep-K decode shapes.

#include "gemm_common.cuh"

namespace {

// One launch: A [E, S, C, K] against B[e] for every segment g = e * S + s.
struct Grouped {
  const void* A;
  long long sa_e, sa_s, lda;  // A strides in elements (expert, segment, row)
  int S, C, K;
  const int* counts;          // [E * S] valid leading rows, or null: all C
  const char* B;              // [E, Nb, Kb, t0, t1]
  const char* B2;             // the silu-gate partner stack, or null
  int b_dt, col_layout, Nb, Kb, bk, bn;
  long long tile_bytes;
  const float* scales;        // [E, Nb, Kb] (mode 1) or [E, Nb] (mode 2)
  const float* scales2;       // the partner's grid
  int scale_mode;             // 0 none, 1 per tile, 2 per column
  const float* bias;          // [E, N] or null
  int act;
  void* out;                  // [E, S, C, N], contiguous
  int out_dt, N;

  __device__ __forceinline__ int live_rows(int g) const {
    return counts == nullptr ? C : min(max(counts[g], 0), C);
  }
  __device__ __forceinline__ const char* b_stream(int which, int e) const {
    return (which ? B2 : B) + static_cast<long long>(e) * Nb * Kb * tile_bytes;
  }
  __device__ __forceinline__ float tile_scale(int which, int e, int j, int kk) const {
    return (which ? scales2 : scales)[(static_cast<long long>(e) * Nb + j) * Kb + kk];
  }

  // An all-padding block: zeros over its rows < C and columns < N.
  __device__ void store_zeros(int g, int m0, int n0, int BM, int BN, int nthreads) const {
    const long long base = static_cast<long long>(g) * C * N;
    for (int idx = threadIdx.x; idx < BM * BN; idx += nthreads) {
      const int r = m0 + idx / BN, gn = n0 + idx % BN;
      if (r < C && gn < N) store_out(out, base + static_cast<long long>(r) * N + gn, 0.0f, out_dt);
    }
  }

  // The store epilogue of one element: col scale, bias, then the activation
  // or silu(gate) * up; rows at or past the count are stored as 0.
  __device__ __forceinline__ void store(int g, int e, int count, int r, int gn, int j,
                                        float v, float up) const {
    if (r >= C || gn >= N) return;
    float o = 0.0f;
    if (r < count) {
      if (scale_mode == 2) v *= scales[static_cast<long long>(e) * Nb + j];
      if (bias != nullptr) v += bias[static_cast<long long>(e) * N + gn];
      if (B2 != nullptr) {
        if (scale_mode == 2) up *= scales2[static_cast<long long>(e) * Nb + j];
        o = activate(v, 3) * up;
      } else {
        o = activate(v, act);
      }
    }
    store_out(out, (static_cast<long long>(g) * C + r) * N + gn, o, out_dt);
  }
};

// ---------------------------------------------------------------------------
// grouped_fma: scalar FMAs on shared-memory tiles (f32 and int8 activations)
// ---------------------------------------------------------------------------

template <typename Acc, int NB>
__global__ void __launch_bounds__(FMA_THREADS)
grouped_fma(Grouped p, int a_dt, int BM, int BN, int KC) {
  __shared__ Acc As[MAX_KC][MAX_BM + 1];      // A slice, transposed: [k][row]
  __shared__ Acc Bs[NB][MAX_KC][MAX_BN + 1];  // B slices: [k][col]

  const int m0 = blockIdx.x * BM;
  const int chunks = p.bn / BN;
  const int j = blockIdx.y / chunks, c0 = (blockIdx.y % chunks) * BN;
  const int g = blockIdx.z, e = g / p.S;
  const int count = p.live_rows(g);
  if (count <= m0) {
    p.store_zeros(g, m0, j * p.bn + c0, BM, BN, FMA_THREADS);
    return;
  }
  const char* A = static_cast<const char*>(p.A);
  const long long a_off = static_cast<long long>(e) * p.sa_e + static_cast<long long>(g % p.S) * p.sa_s;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int tm = BM / 16, tn = BN / 16;

  Acc total[NB][MAX_T][MAX_T];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < MAX_T; ++i)
#pragma unroll
      for (int jn = 0; jn < MAX_T; ++jn) total[b][i][jn] = static_cast<Acc>(0);

  for (int kk = 0; kk < p.Kb; ++kk) {
    Acc part[NB][MAX_T][MAX_T];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < MAX_T; ++i)
#pragma unroll
        for (int jn = 0; jn < MAX_T; ++jn) part[b][i][jn] = static_cast<Acc>(0);

    for (int kc = 0; kc < p.bk; kc += KC) {
      const int kbase = kk * p.bk + kc;
      for (int idx = tid; idx < BM * KC; idx += FMA_THREADS) {
        const int r = idx / KC, q = idx % KC;
        const int gm = m0 + r, gk = kbase + q;
        Acc v = static_cast<Acc>(0);
        if (gm < count && gk < p.K)
          v = load_elem<Acc>(A, a_off + static_cast<long long>(gm) * p.lda + gk, a_dt);
        As[q][r] = v;
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const char* tile = p.b_stream(b, e) + (static_cast<long long>(j) * p.Kb + kk) * p.tile_bytes;
        for (int idx = tid; idx < BN * KC; idx += FMA_THREADS) {
          int q, c;
          long long li;
          if (p.col_layout) {  // [bn, bk] tile: k is contiguous
            c = idx / KC;
            q = idx % KC;
            li = static_cast<long long>(c0 + c) * p.bk + kc + q;
          } else {             // [bk, bn] tile: n is contiguous
            q = idx / BN;
            c = idx % BN;
            li = static_cast<long long>(kc + q) * p.bn + c0 + c;
          }
          Bs[b][q][c] = load_b<Acc>(tile, li, p.b_dt);
        }
      }
      __syncthreads();
      for (int q = 0; q < KC; ++q) {
        Acc av[MAX_T];
#pragma unroll
        for (int i = 0; i < MAX_T; ++i) av[i] = (i < tm) ? As[q][ty + 16 * i] : static_cast<Acc>(0);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          Acc bv[MAX_T];
#pragma unroll
          for (int jn = 0; jn < MAX_T; ++jn)
            bv[jn] = (jn < tn) ? Bs[b][q][tx + 16 * jn] : static_cast<Acc>(0);
#pragma unroll
          for (int i = 0; i < MAX_T; ++i)
#pragma unroll
            for (int jn = 0; jn < MAX_T; ++jn) part[b][i][jn] += av[i] * bv[jn];
        }
      }
      __syncthreads();
    }
    // Per-tile dequant of this K step's partial products (contract_tile).
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const Acc s = (p.scale_mode == 1) ? static_cast<Acc>(p.tile_scale(b, e, j, kk))
                                        : static_cast<Acc>(1);
#pragma unroll
      for (int i = 0; i < MAX_T; ++i)
#pragma unroll
        for (int jn = 0; jn < MAX_T; ++jn)
          total[b][i][jn] += (p.scale_mode == 1) ? part[b][i][jn] * s : part[b][i][jn];
    }
  }

#pragma unroll
  for (int i = 0; i < MAX_T; ++i)
#pragma unroll
    for (int jn = 0; jn < MAX_T; ++jn)
      if (i < tm && jn < tn)
        p.store(g, e, count, m0 + ty + 16 * i, j * p.bn + c0 + tx + 16 * jn, j,
                static_cast<float>(total[0][i][jn]),
                static_cast<float>(total[NB - 1][i][jn]));
}

// ---------------------------------------------------------------------------
// grouped_mma: tensor cores (mma.sync m16n8k16, f32 accumulators)
// ---------------------------------------------------------------------------

// Warps: WM x WN over the block's rows and columns, WK splitting each
// slice's k-steps; a warp owns MT m16 tiles by NT n8 tiles. KS is the
// staged depth; NB the number of B streams (2 for the silu-gate pair, both
// multiplied against the same A fragments).
template <typename T, int WM, int WN, int WK, int MT, int NT, int KS, int NB>
__global__ void __launch_bounds__(MMA_THREADS)
grouped_mma(Grouped p) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8, KSTEPS = KS / 16, KPAD = KS + 8;
  constexpr int A_PER_T = BM * KS / MMA_THREADS;      // A elements a thread stages
  constexpr int W_PER_T = BN * KS / 2 / MMA_THREADS;  // B words a stream, at most
  static_assert(WM * WN * WK * 32 == MMA_THREADS, "four warps");
  static_assert(KSTEPS % WK == 0 && NT % 2 == 0, "warp split");
  static_assert(BM * KS % MMA_THREADS == 0 && BN * KS / 8 % MMA_THREADS == 0, "staging");
  __shared__ __align__(16) T As[BM][KPAD];      // [row][k]
  __shared__ __align__(16) T Bs[NB][BN][KPAD];  // [col][k]: mma's "col" B operand
  __shared__ float Cs[NB][WK][BM][BN + 4];

  const int m0 = blockIdx.x * BM;
  const int chunks = p.bn / BN;
  const int j = blockIdx.y / chunks, c0 = (blockIdx.y % chunks) * BN;
  const int g = blockIdx.z, e = g / p.S;
  const int count = p.live_rows(g);
  if (count <= m0) {
    p.store_zeros(g, m0, j * p.bn + c0, BM, BN, MMA_THREADS);
    return;
  }
  const T* A = static_cast<const T*>(p.A) + static_cast<long long>(e) * p.sa_e +
               static_cast<long long>(g % p.S) * p.sa_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp % WK, wn = (warp / WK) % WN, wm = warp / (WK * WN);
  const int b_dt = p.b_dt, bk = p.bk, bn = p.bn, col_layout = p.col_layout;
  const int epw = (b_dt == DT_I4) ? 8 : (b_dt == DT_I8 ? 4 : 2);  // elements a word
  const int bits = (b_dt == DT_I4) ? 4 : (b_dt == DT_I8 ? 8 : 16);
  const int w_per_t = BN * KS / epw / MMA_THREADS;
  const int slices_per_tile = bk / KS, slices = p.Kb * slices_per_tile;
  const T zero = Half16<T>::from_float(0.0f);
  const char* b_base[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) b_base[b] = p.b_stream(b, e);

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
  uint32_t b_reg[NB][W_PER_T];
  auto load_slice = [&](int sl) {
    const int kk = sl / slices_per_tile, kc = (sl % slices_per_tile) * KS;
    const int kbase = kk * bk + kc;
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) {
      const int idx = tid + i * MMA_THREADS;
      const int gm = m0 + idx / KS, gk = kbase + idx % KS;
      a_reg[i] = (gm < count && gk < p.K) ? A[static_cast<long long>(gm) * p.lda + gk] : zero;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const char* tile = b_base[b] + (static_cast<long long>(j) * p.Kb + kk) * p.tile_bytes;
#pragma unroll
      for (int i = 0; i < W_PER_T; ++i) {
        if (i < w_per_t) {
          int c, q;
          b_coords(tid + i * MMA_THREADS, c, q);
          const long long li = col_layout ? static_cast<long long>(c0 + c) * bk + kc + q
                                          : static_cast<long long>(kc + q) * bn + c0 + c;
          b_reg[b][i] = *reinterpret_cast<const uint32_t*>(tile + li * bits / 8);
        }
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
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int i = 0; i < W_PER_T; ++i) {
        if (i < w_per_t) {
          int c, q;
          b_coords(tid + i * MMA_THREADS, c, q);
          T v[8];
          const int n = widen_word<T>(b_reg[b][i], b_dt, v);
          for (int x = 0; x < n; ++x) {
            if (col_layout) Bs[b][c][q + x] = v[x];
            else Bs[b][c + x][q] = v[x];
          }
        }
      }
    }
  };

  float total[NB][MT][NT][4], part[NB][MT][NT][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) total[b][mt][nt][x] = part[b][mt][nt][x] = 0.0f;

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
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bf[4];  // b0/b1 of n8 tile 2np, then of 2np+1
          ldmatrix_x4(bf, &Bs[b][wn * NT * 8 + np * 16 + (lane % 8) + (lane / 16) * 8]
                             [k0 + ((lane / 8) % 2) * 8]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            Half16<T>::mma(part[b][mt][2 * np], af[mt], bf[0], bf[1]);
            Half16<T>::mma(part[b][mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();
    if ((sl + 1) % slices_per_tile == 0) {
      // Per-tile dequant of this K step's partial products (contract_tile).
      const int kk = sl / slices_per_tile;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float sc = (p.scale_mode == 1) ? p.tile_scale(b, e, j, kk) : 1.0f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              total[b][mt][nt][x] += (p.scale_mode == 1) ? part[b][mt][nt][x] * sc
                                                         : part[b][mt][nt][x];
              part[b][mt][nt][x] = 0.0f;
            }
      }
    }
  }

  // Accumulator fragments -> shared memory (c0,c1: row g, cols 2t, 2t+1;
  // c2,c3: row g + 8), then the k-split warps' sums in a fixed order.
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = wm * MT * 16 + mt * 16 + lane / 4;
        const int c = wn * NT * 8 + nt * 8 + (lane % 4) * 2;
        Cs[b][wk][r][c] = total[b][mt][nt][0];
        Cs[b][wk][r][c + 1] = total[b][mt][nt][1];
        Cs[b][wk][r + 8][c] = total[b][mt][nt][2];
        Cs[b][wk][r + 8][c + 1] = total[b][mt][nt][3];
      }
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += MMA_THREADS) {
    const int r = idx / BN, c = idx % BN;
    float v[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      v[b] = 0.0f;
#pragma unroll
      for (int w = 0; w < WK; ++w) v[b] += Cs[b][w][r][c];
    }
    p.store(g, e, count, m0 + r, j * bn + c0 + c, j, v[0], v[NB - 1]);
  }
}

template <typename T, int NB>
void launch_mma(int variant, const Grouped& p, int E, cudaStream_t s) {
  const unsigned segs = static_cast<unsigned>(E * p.S);
  if (variant == V_MMA_DECODE) {  // 16 x 16 blocks, four warps split k
    const dim3 grid(static_cast<unsigned>((p.C + 15) / 16),
                    static_cast<unsigned>(p.Nb * (p.bn / 16)), segs);
    if (p.bk % 128 == 0)
      grouped_mma<T, 1, 1, 4, 1, 2, 128, NB><<<grid, MMA_THREADS, 0, s>>>(p);
    else
      grouped_mma<T, 1, 1, 4, 1, 2, 64, NB><<<grid, MMA_THREADS, 0, s>>>(p);
  } else {                        // 32 x 64 blocks, 2 x 2 warps of 16 x 32
    const dim3 grid(static_cast<unsigned>((p.C + 31) / 32),
                    static_cast<unsigned>(p.Nb * (p.bn / 64)), segs);
    if (p.bk % 64 == 0)
      grouped_mma<T, 2, 2, 1, 1, 4, 64, NB><<<grid, MMA_THREADS, 0, s>>>(p);
    else
      grouped_mma<T, 2, 2, 1, 1, 4, 32, NB><<<grid, MMA_THREADS, 0, s>>>(p);
  }
}

template <int NB>
int launch(const Grouped& p, int E, int a_dt, int BM, int BN, int KC, int int_acc,
           int variant, cudaStream_t s) {
  if (variant == V_MMA_DECODE || variant == V_MMA_PREFILL) {
    const bool half_a = (a_dt == DT_BF16 || a_dt == DT_F16);
    const bool b_ok = (p.b_dt == a_dt || p.b_dt == DT_I8 || p.b_dt == DT_I4);
    const bool shape_ok = (variant == V_MMA_DECODE) ? (p.bk % 64 == 0)
                                                    : (p.bk % 32 == 0 && p.bn % 64 == 0);
    if (!half_a || !b_ok || !shape_ok || int_acc) return static_cast<int>(cudaErrorInvalidValue);
    if (a_dt == DT_BF16) launch_mma<__nv_bfloat16, NB>(variant, p, E, s);
    else launch_mma<__half, NB>(variant, p, E, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != V_FMA || BM < 16 || BM > MAX_BM || BM % 16 ||
      !valid_chunk(BN, p.bn, MAX_BN) || !valid_chunk(KC, p.bk, MAX_KC)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((p.C + BM - 1) / BM),
                  static_cast<unsigned>(p.Nb * (p.bn / BN)), static_cast<unsigned>(E * p.S));
  if (int_acc)
    grouped_fma<int, NB><<<grid, FMA_THREADS, 0, s>>>(p, a_dt, BM, BN, KC);
  else
    grouped_fma<float, NB><<<grid, FMA_THREADS, 0, s>>>(p, a_dt, BM, BN, KC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). A is [E, S, C, K] with element
// strides sa_e, sa_s, lda and unit column stride; counts is [E * S] int32
// or null (K3: every row live); b2 / scales2 the silu-gate partner (or
// null). `variant` picks the kernel (0 fma, 1 mma decode, 2 mma prefill;
// the caller checks eligibility, see gemm_grouped.py); BM / BN / KC are the
// fma kernel's block shape. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a geometry the kernel does not take. `stream`
// is the caller's cudaStream_t.
extern "C" int gemm_grouped_packed_launch(
    const void* a, int a_dt, long long sa_e, long long sa_s, long long lda,
    int E, int S, int C, int K, const void* counts,
    const void* b, const void* b2, int b_dt, int col_layout, int Nb, int Kb, int bk, int bn,
    const void* scales, const void* scales2, int scale_mode, const void* bias,
    void* out, int out_dt, int N, int act, int BM, int BN, int KC, int int_acc,
    int variant, void* stream) {
  if (E <= 0 || S <= 0 || C <= 0 || N <= 0 || Nb <= 0 || Kb <= 0 || bk % 16 || bn % 16 ||
      static_cast<long long>(E) * S > 65535 ||
      (scale_mode != 0 && (scales == nullptr || (b2 != nullptr && scales2 == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tile_bytes = (b_dt == DT_I4)
      ? static_cast<long long>(bk) * bn / 2
      : static_cast<long long>(bk) * bn * elem_bytes(b_dt);
  const Grouped p{a, sa_e, sa_s, lda, S, C, K, static_cast<const int*>(counts),
                  static_cast<const char*>(b), static_cast<const char*>(b2), b_dt, col_layout,
                  Nb, Kb, bk, bn, tile_bytes, static_cast<const float*>(scales),
                  static_cast<const float*>(scales2), scale_mode,
                  static_cast<const float*>(bias), act, out, out_dt, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (b2 != nullptr) ? launch<2>(p, E, a_dt, BM, BN, KC, int_acc, variant, s)
                         : launch<1>(p, E, a_dt, BM, BN, KC, int_acc, variant, s);
}
