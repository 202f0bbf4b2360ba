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
// What bounds it on an H100: at decode (a few live rows per expert) the
// live experts' weight stream over 3.35 TB/s; at prefill (C in the
// hundreds) the tensor-core multiply-adds. Every body reads its segment's
// count from device memory at block (or tile) start, so the host never
// waits for the counts: work whose rows all lie at or past the count loads
// nothing and stores zeros. The wrapper picks a body per call
// (gemm_grouped.py grouped_body) and counts its launches by name:
//  * tc_stream / wgmma (bf16 / f16 A against unscaled tiles of its type,
//    bn 64, bk a multiple of 64, A, B and B2 TMA-aligned): gemm_wgmma.cuh's
//    ring, boxes and wgmma wrappers, with A's boxes from a 4-D tensor map
//    over A [E, S, C, K] (its own strides; rows past C and columns past K
//    read as zeros, never the next segment's) and B's (and B2's) from the
//    2-D view of the stack, tile (e, j, kk) = view tile (e*Nb + j)*Kb + kk.
//    Decode (C <= 16): grouped_stream, one block per (segment, split,
//    64-column stripe), B's boxes (the pair: a B and a B2 box a stage
//    against one A box) streamed once through a ring of GS_STAGES, Kb split
//    on whole packed tiles when E*S*Nb stripes leave SMs idle, the partials
//    reduced in split order by grouped_reduce before the one epilogue.
//    Above: grouped_wgmma, persistent blocks over (segment, 128-row m-tile,
//    column tile) with one producer warp and two consumer warpgroups on
//    m64n64k16 wgmma; the pair keeps two accumulator sets (B and B2 of
//    one 64-column tile) over one A box; a consumer warpgroup whose 64
//    rows all lie at or past the count loads and multiplies nothing.
//  * tc_stream_q / wgmma_q (bf16 / f16 A against int8 / int4 tiles with
//    tile, col or no scales, bn 64, bk a multiple of 64, TMA-aligned
//    operands): gemm_quant.cuh's bodies over the same A map and segment
//    walk. Decode: grouped_quant_stream, grouped_stream's ring and split
//    with the weight boxes widened in registers, each k-tile's partial
//    times its stream's tile scale. Above: grouped_quant_wgmma, the
//    widened weights as wgmma's register operand against 64 rows of a
//    segment; a tile with no live row loads nothing.
//  * mma_sync (grouped_mma, PR 12's tensor-core body: bf16 / f16 A against
//    float tiles of other geometries or alignments, or against int8 / int4
//    tiles the quantized TMA bodies do not take): mma.sync m16n8k16 with
//    f32 accumulators, B slices staged
//    k-contiguous per column for ldmatrix, int tiles widened exactly on the
//    way. Decode blocks (C <= 16) are 16 x 16 with four warps splitting
//    each slice's k-steps; prefill blocks 32 x 64.
//  * fma (grouped_fma: f32 A in full f32 without TF32; int8 A with i32
//    accumulators; mixed float types): shared-memory tiles and scalar FMAs.
// The TPU kernel's sublane rule (decode-shaped segments to a masked
// fallback) does not apply: every segment runs here.

#include "gemm_quant.cuh"

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
void launch_grouped_mma(int variant, const Grouped& p, int E, cudaStream_t s) {
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

// mma_sync and fma (variants 0 / 1 / 2).
template <int NB>
int launch_blocks(const Grouped& p, int E, int a_dt, int BM, int BN, int KC, int int_acc,
                  int variant, cudaStream_t s) {
  if (variant == V_MMA_DECODE || variant == V_MMA_PREFILL) {
    const bool half_a = (a_dt == DT_BF16 || a_dt == DT_F16);
    const bool b_ok = (p.b_dt == a_dt || p.b_dt == DT_I8 || p.b_dt == DT_I4);
    const bool shape_ok = (variant == V_MMA_DECODE) ? (p.bk % 64 == 0)
                                                    : (p.bk % 32 == 0 && p.bn % 64 == 0);
    if (!half_a || !b_ok || !shape_ok || int_acc) return static_cast<int>(cudaErrorInvalidValue);
    if (a_dt == DT_BF16) launch_grouped_mma<__nv_bfloat16, NB>(variant, p, E, s);
    else launch_grouped_mma<__half, NB>(variant, p, E, s);
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

// ---------------------------------------------------------------------------
// tc_stream and wgmma: TMA rings over A's 4-D map and B's 2-D view
// ---------------------------------------------------------------------------

enum GroupedBody { G_WGMMA = 3, G_TC_STREAM = 4 };
constexpr int GS_STAGES = 4;

// Where A's dims sit in its tensor map: dim 0 is k, dims 1-3 are C, S and
// E in increasing order of stride (a permuted A keeps its own strides).
struct AMap {
  int pos_c, pos_s, pos_e;
};

// A [E, S, C, K] of 16-bit elements with element strides (sa_e, sa_s, lda)
// as a 4-D map, K wide: columns past K and rows past C read as zeros, so a
// box never reaches into the next segment. Boxes are 64 k by `box_rows`
// rows of one segment.
bool make_grouped_a_map(CUtensorMap* map, AMap* am, const void* a, int dt, int E, int S, int C,
                        int K, long long sa_e, long long sa_s, long long lda, int box_rows) {
  EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const long long stride[3] = {lda, sa_s, sa_e};
  const int extent[3] = {C, S, E}, box[3] = {box_rows, 1, 1};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i) {
    for (int j = i; j > 0 && stride[order[j - 1]] > stride[order[j]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(K), 0, 0, 0}, strides[3];
  cuuint32_t boxes[4] = {BOX, 0, 0, 0};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  int pos[3];
  for (int q = 0; q < 3; ++q) {
    dims[q + 1] = static_cast<cuuint64_t>(extent[order[q]]);
    strides[q] = static_cast<cuuint64_t>(stride[order[q]] * 2);
    boxes[q + 1] = static_cast<cuuint32_t>(box[order[q]]);
    pos[order[q]] = q + 1;
  }
  *am = AMap{pos[0], pos[1], pos[2]};
  return enc(map, dt == DT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
             4, const_cast<void*>(a), dims, strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The A box of rows [r, r + box_rows) and k [k, k + 64) of segment (e, s).
__device__ __forceinline__ void tma_load_a(void* dst, const CUtensorMap* map, uint64_t* bar,
                                           const AMap& am, int k, int r, int s, int e) {
  auto at = [&](int d) { return am.pos_c == d ? r : (am.pos_s == d ? s : e); };
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(at(1)), "r"(at(2)),
      "r"(at(3))
      : "memory");
}

// Stream 0's boxes come from B's map, stream 1's (the pair's up
// projection) from B2's.
__device__ __forceinline__ const CUtensorMap* stream_map(const CUtensorMap& tb,
                                                         const CUtensorMap& tb2, int stream) {
  return stream ? &tb2 : &tb;
}

// grouped_stream's ring: an A box and NB B boxes a stage.
template <int NB>
struct StreamRing {
  static constexpr int STAGE = TS_A_BYTES + NB * TS_B_BYTES;
  static constexpr int SMEM = GS_STAGES * STAGE + 1024;
};

// Decode (C <= 16): block = (segment g, split sp, 64-column stripe j); the
// split covers packed k-tiles [sp*kt_chunk, min(Kb, (sp+1)*kt_chunk)). Its
// four warps take the four k16 steps of each 64-deep box (mma.sync
// m16n8k16), summed in warp order at the end. With one split the block
// stores through the epilogue; with more it writes its partial sums of
// rows < count to ws [splits, NB, E*S*C, N] for grouped_reduce.
template <typename T, bool B_MN, int NB>
__global__ void __launch_bounds__(TS_THREADS)
grouped_stream(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tb2, Grouped p, AMap am, int splits,
               int kt_chunk, float* ws, long long total) {
  constexpr int STAGE = StreamRing<NB>::STAGE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[GS_STAGES];
  __shared__ float red[4][16][BOX + 4];
  const int j = blockIdx.x % p.Nb, sp = (blockIdx.x / p.Nb) % splits;
  const int g = blockIdx.x / p.Nb / splits, e = g / p.S;
  const int count = p.live_rows(g);
  if (count == 0) {  // a dead segment loads nothing; its zeros are stored once
    if (splits == 1) p.store_zeros(g, 0, j * BOX, 16, BOX, TS_THREADS);
    return;
  }
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nbox = p.bk / BOX;
  if (tid == 0) {
    for (int s = 0; s < GS_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int kt0 = sp * kt_chunk, kt1 = min(p.Kb, kt0 + kt_chunk);
  const int steps = ring_steps(kt1 - kt0, p.bk);
  auto issue = [&](int st) {  // one thread: k-box st into its slot
    const int slot = st % GS_STAGES, kk = kt0 + st / nbox, kbox = st % nbox;
    uint8_t* base = smem + slot * STAGE;
    mbar_expect_tx(&full[slot], STAGE);
    tma_load_a(base, &ta, &full[slot], am, kk * p.bk + kbox * BOX, 0, g % p.S, e);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      int c0, c1;
      box_of(B_MN, (e * p.Nb + j) * p.Kb + kk, kbox, BOX, p.bk, c0, c1);
      tma_load(base + TS_A_BYTES + b * TS_B_BYTES, stream_map(tb, tb2, b), &full[slot], c0, c1);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < steps && st < GS_STAGES; ++st) issue(st);
  }
  float acc[NB][8][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[b][t][x] = 0.0f;
  for (int st = 0; st < steps; ++st) {
    const int slot = st % GS_STAGES;
    mbar_wait(&full[slot], (st / GS_STAGES) & 1);
    const uint8_t* a_box = smem + slot * STAGE;
    unsigned af[4];
    ldmatrix_x4(af, sw128(a_box, lane % 16, warp * 2 + lane / 16));  // k16 step `warp`
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint8_t* b_box = a_box + TS_A_BYTES + b * TS_B_BYTES;
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // n8 tiles 2q, 2q + 1
        unsigned bf[4];
        const int mat = lane / 8;
        if (B_MN) {
          ldmatrix_x4_trans(bf, sw128(b_box, warp * 16 + (mat % 2) * 8 + lane % 8, 2 * q + mat / 2));
        } else {
          ldmatrix_x4(bf, sw128(b_box, q * 16 + (mat / 2) * 8 + lane % 8, warp * 2 + mat % 2));
        }
        Half16<T>::mma(acc[b][2 * q], af, bf[0], bf[1]);
        Half16<T>::mma(acc[b][2 * q + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && st + GS_STAGES < steps) issue(st + GS_STAGES);
  }
  // The four warps' k-steps summed in order, one stream at a time.
  constexpr int PER_T = 16 * BOX / TS_THREADS;
  float v[NB][PER_T];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int r = lane / 4, c = t * 8 + (lane % 4) * 2;
      red[warp][r][c] = acc[b][t][0];
      red[warp][r][c + 1] = acc[b][t][1];
      red[warp][r + 8][c] = acc[b][t][2];
      red[warp][r + 8][c + 1] = acc[b][t][3];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER_T; ++i) {
      const int r = (tid + i * TS_THREADS) / BOX, c = (tid + i * TS_THREADS) % BOX;
      v[b][i] = red[0][r][c] + red[1][r][c] + red[2][r][c] + red[3][r][c];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PER_T; ++i) {
    const int r = (tid + i * TS_THREADS) / BOX, gn = j * BOX + (tid + i * TS_THREADS) % BOX;
    if (splits == 1) {
      p.store(g, e, count, r, gn, j, v[0][i], v[NB - 1][i]);
    } else if (r < count && gn < p.N) {
      const long long at = (static_cast<long long>(g) * p.C + r) * p.N + gn;
#pragma unroll
      for (int b = 0; b < NB; ++b) ws[(static_cast<long long>(sp) * NB + b) * total + at] = v[b][i];
    }
  }
}

// The split partials of grouped_stream added in split order, then the
// epilogue; rows at or past the count are stored as 0 without reading the
// workspace (their blocks never wrote it).
template <int NB>
__global__ void grouped_reduce(const float* ws, int splits, long long total, Grouped p) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / p.N;
    const int gn = static_cast<int>(i % p.N), g = static_cast<int>(row / p.C);
    const int r = static_cast<int>(row % p.C), count = p.live_rows(g);
    float v[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) v[b] = 0.0f;
    if (r < count) {
      for (int sp = 0; sp < splits; ++sp)
#pragma unroll
        for (int b = 0; b < NB; ++b) v[b] += ws[(static_cast<long long>(sp) * NB + b) * total + i];
    }
    p.store(g, g / p.S, count, r, gn, gn / p.bn, v[0], v[NB - 1]);
  }
}

// C > 16: persistent blocks over tiles (segment g, column tile tn, m-tile
// tm), m-tiles fastest so that the m-tiles of one column tile run together
// on B's boxes in L2. A tile is GW_BOXES A boxes of 64 rows (256 rows:
// mixtral's 160-row prefill segments take one tile, so each B box is read
// once a segment) by two B boxes: B tiles 2tn and 2tn + 1 (128 columns),
// or for the pair B and B2 tile tn (64 columns, two accumulator sets).
// Consumer warpgroup wg multiplies A boxes 2wg and 2wg + 1. A box whose 64
// rows all lie at or past the count is neither loaded nor multiplied; a
// warpgroup with no live box only keeps the ring in step, and a tile with
// no live row loads nothing.
constexpr int GW_BOXES = 4;
constexpr int GW_STAGE_BYTES = (GW_BOXES + 2) * WG_BOX_BYTES;
constexpr int GW_SMEM = WG_STAGES * GW_STAGE_BYTES + 1024;

// One 64-deep stage of a consumer warpgroup: its NA A boxes (from `a`,
// 64 rows each) against the two B boxes (from `b`), m64n64k16 wgmma.
template <typename T, bool B_MN, int NA>
__device__ __forceinline__ void wgmma_boxes(float (&acc)[2][2][32], const uint8_t* a,
                                            const uint8_t* b) {
#pragma unroll
  for (int ks = 0; ks < BOX / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const uint64_t da = sw128_desc(a + i * WG_BOX_BYTES + kstep_bytes(false, ks));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t db = sw128_desc(b + h * WG_BOX_BYTES + kstep_bytes(B_MN, ks));
        wgmma_m64n64k16<T, 0, B_MN ? 1 : 0>(acc[i][h], da, db);
      }
    }
  }
}

template <typename T, bool B_MN, int NB>
__global__ void __launch_bounds__(WG_THREADS)
grouped_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tb2, Grouped p, AMap am, int tiles_m,
              int tiles_n, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = ring_steps(p.Kb, p.bk), nbox = p.bk / BOX;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Tile -> (g, tm, tn); returns the live A boxes of the tile (0-4).
  auto live_boxes = [&](int tile, int& g, int& tm, int& tn) {
    tm = tile % tiles_m;
    tn = (tile / tiles_m) % tiles_n;
    g = tile / tiles_m / tiles_n;
    const int rest = p.live_rows(g) - tm * GW_BOXES * BOX;
    return rest <= 0 ? 0 : min(GW_BOXES, (rest + BOX - 1) / BOX);
  };

  if (warp == 8) {  // producer
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int g, tm, tn;
        const int live = live_boxes(tile, g, tm, tn);
        const int e = g / p.S, s = g % p.S;
        for (int st = 0; st < (live ? steps : 0); ++st) {
          const int kk = st / nbox, kbox = st - kk * nbox;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], (live + 2) * WG_BOX_BYTES);
          uint8_t* base = smem + stage * GW_STAGE_BYTES;
          for (int i = 0; i < live; ++i) {
            tma_load_a(base + i * WG_BOX_BYTES, &ta, &full[stage], am, kk * p.bk + kbox * BOX,
                       (tm * GW_BOXES + i) * BOX, s, e);
          }
          for (int h = 0; h < 2; ++h) {
            int c0, c1;
            const int jt = NB == 2 ? tn : 2 * tn + h;
            box_of(B_MN, (e * p.Nb + jt) * p.Kb + kk, kbox, BOX, p.bk, c0, c1);
            tma_load(base + (GW_BOXES + h) * WG_BOX_BYTES, stream_map(tb, tb2, NB == 2 ? h : 0),
                     &full[stage], c0, c1);
          }
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: A boxes 2wg, 2wg + 1 against both B boxes
    const int wg = warp / 4, wl = warp % 4;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int g, tm, tn;
      const int live = live_boxes(tile, g, tm, tn);
      const int mine = max(0, min(2, live - 2 * wg));  // live boxes of this warpgroup
      float acc[2][2][32];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < 32; ++x) acc[i][h][x] = 0.0f;
      // One wgmma group stays in flight: a stage is released once the
      // group after it has been issued and its own group has completed. A
      // warpgroup with no live box releases each stage as it arrives.
      int held = -1;
      for (int st = 0; st < (live ? steps : 0); ++st) {
        mbar_wait(&full[stage], phase);
        if (mine > 0) {
          const uint8_t* base = smem + stage * GW_STAGE_BYTES;
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          wgmma_fence();
          if (mine == 2) {
            wgmma_boxes<T, B_MN, 2>(acc, base + 2 * wg * WG_BOX_BYTES,
                                    base + GW_BOXES * WG_BOX_BYTES);
          } else {
            wgmma_boxes<T, B_MN, 1>(acc, base + 2 * wg * WG_BOX_BYTES,
                                    base + GW_BOXES * WG_BOX_BYTES);
          }
          wgmma_commit();
          wgmma_wait1();
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          if (held >= 0 && tid % 128 == 0) mbar_arrive(&empty[held]);
          held = stage;
        } else if (tid % 128 == 0) {
          mbar_arrive(&empty[stage]);
        }
        if (++stage == WG_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (mine > 0) {
        wgmma_wait0();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (held >= 0 && tid % 128 == 0) mbar_arrive(&empty[held]);
      }
      // Accumulator fragments: n8 block x / 4, rows wl*16 + lane/4 (+8 for
      // the odd pair), columns 2*(lane%4) (+1). Rows at or past the count
      // store 0 (a dead box's zero accumulators included).
      const int e = g / p.S, count = p.live_rows(g);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r0 = (tm * GW_BOXES + 2 * wg + i) * BOX + wl * 16 + lane / 4;
#pragma unroll
        for (int h = 0; h < 3 - NB; ++h)
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int r = r0 + ((x % 4) / 2) * 8, c = (x / 4) * 8 + (lane % 4) * 2 + (x % 2);
            if (NB == 2) {
              p.store(g, e, count, r, tn * BOX + c, tn, acc[i][0][x], acc[i][1][x]);
            } else {
              p.store(g, e, count, r, (2 * tn + h) * BOX + c, 2 * tn + h, acc[i][h][x], 0.0f);
            }
          }
      }
    }
  }
}

template <typename T, bool B_MN, int NB>
int launch_grouped_tma(int body, const CUtensorMap& ta, const CUtensorMap& tb,
                       const CUtensorMap& tb2, const Grouped& p, const AMap& am, int G,
                       int splits, int kt_chunk, float* ws, cudaStream_t s) {
  if (body == G_WGMMA) {
    static bool raised = false;
    if (!raised) {
      cudaFuncSetAttribute(grouped_wgmma<T, B_MN, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           GW_SMEM);
      raised = true;
    }
    const int cols = NB == 2 ? BOX : 2 * BOX;  // output columns a tile
    const int tiles_m = (p.C + GW_BOXES * BOX - 1) / (GW_BOXES * BOX);
    const int tiles_n = (p.N + cols - 1) / cols;
    const long long tiles = static_cast<long long>(G) * tiles_m * tiles_n;
    if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    grouped_wgmma<T, B_MN, NB><<<grid_for(tiles, sm_count()), WG_THREADS, GW_SMEM, s>>>(
        ta, tb, tb2, p, am, tiles_m, tiles_n, static_cast<int>(tiles));
    return static_cast<int>(cudaGetLastError());
  }
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(grouped_stream<T, B_MN, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         StreamRing<NB>::SMEM);
    raised = true;
  }
  const long long blocks = static_cast<long long>(G) * splits * p.Nb;
  const long long total = static_cast<long long>(G) * p.C * p.N;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  grouped_stream<T, B_MN, NB><<<static_cast<int>(blocks), TS_THREADS, StreamRing<NB>::SMEM,
                                s>>>(ta, tb, tb2, p, am, splits, kt_chunk, ws, total);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  const long long rblocks = (total + 255) / 256;
  grouped_reduce<NB><<<static_cast<int>(rblocks < 4096 ? rblocks : 4096), 256, 0, s>>>(
      ws, splits, total, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tma_typed(int body, int b_col, int nb_streams, const CUtensorMap& ta,
                     const CUtensorMap& tb, const CUtensorMap& tb2, const Grouped& p,
                     const AMap& am, int G, int splits, int kt_chunk, float* ws, cudaStream_t s) {
  // "row" tiles [bk][bn] are MN-major, "col" tiles [bn][bk] K-major.
  if (b_col) {
    return nb_streams == 2
        ? launch_grouped_tma<T, false, 2>(body, ta, tb, tb2, p, am, G, splits, kt_chunk, ws, s)
        : launch_grouped_tma<T, false, 1>(body, ta, tb, tb2, p, am, G, splits, kt_chunk, ws, s);
  }
  return nb_streams == 2
      ? launch_grouped_tma<T, true, 2>(body, ta, tb, tb2, p, am, G, splits, kt_chunk, ws, s)
      : launch_grouped_tma<T, true, 1>(body, ta, tb, tb2, p, am, G, splits, kt_chunk, ws, s);
}

// tc_stream (C <= 16) and wgmma: cudaErrorInvalidValue for what they do
// not take (the wrapper's grouped_body routes everything else elsewhere).
int launch_tma(int body, const Grouped& p, int E, int a_dt, int int_acc, int splits,
               int kt_chunk, void* ws, cudaStream_t s) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const bool float_pair = p.scale_mode == 0 && !int_acc && p.b_dt == a_dt &&
                          (a_dt == DT_BF16 || a_dt == DT_F16);
  if (!float_pair || p.bn != BOX || p.bk % BOX != 0 || !aligned16(p.A) || !aligned16(p.B) ||
      (p.B2 != nullptr && !aligned16(p.B2)) || p.lda % 8 != 0 || p.sa_s % 8 != 0 ||
      p.sa_e % 8 != 0 || p.lda < p.K || p.sa_s <= 0 || p.sa_e <= 0 ||
      (body == G_TC_STREAM && (p.C > 16 || !valid_tile_split(p.Kb, splits, kt_chunk, ws)))) {
    return invalid;
  }
  CUtensorMap ta, tb, tb2;
  AMap am;
  const int G = E * p.S;
  if (!make_grouped_a_map(&ta, &am, p.A, a_dt, E, p.S, p.C, p.K, p.sa_e, p.sa_s, p.lda,
                          body == G_WGMMA ? BOX : 16) ||
      !make_packed_b_map(&tb, p.B, a_dt, p.col_layout, E * p.Nb, p.Kb, p.bk, p.bn) ||
      !make_packed_b_map(&tb2, p.B2 != nullptr ? p.B2 : p.B, a_dt, p.col_layout, E * p.Nb, p.Kb,
                         p.bk, p.bn)) {
    return invalid;
  }
  float* wsf = static_cast<float*>(ws);
  const int nb_streams = p.B2 != nullptr ? 2 : 1;
  return a_dt == DT_BF16
      ? launch_tma_typed<__nv_bfloat16>(body, p.col_layout, nb_streams, ta, tb, tb2, p, am, G,
                                        splits, kt_chunk, wsf, s)
      : launch_tma_typed<__half>(body, p.col_layout, nb_streams, ta, tb, tb2, p, am, G, splits,
                                 kt_chunk, wsf, s);
}

// ---------------------------------------------------------------------------
// tc_stream_q and wgmma_q: gemm_quant.cuh's quantized bodies over segments
// ---------------------------------------------------------------------------

enum GroupedQuantBody { G_TC_STREAM_Q = 5, G_WGMMA_Q = 6 };

// Decode (C <= 16): grouped_stream with int8 / int4 weight boxes widened in
// registers (quant_box_mma: warp w multiplies its 16 columns of each of
// the NB streams' boxes). Each k-tile's partial joins the sum times its
// stream's tile scale (scale_mode 1) or as it is; one split stores
// through the epilogue, more write their partials of rows < count to ws
// [splits, NB, E*S*C, N] for grouped_reduce, which applies the col scales.
template <typename T, bool I4, bool COL, int NB>
__global__ void __launch_bounds__(TS_THREADS)
grouped_quant_stream(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tb2, Grouped p, AMap am, int splits,
                     int kt_chunk, float* ws, long long total) {
  constexpr int STAGE = TS_A_BYTES + NB * QBox<I4>::BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[QS_STAGES];
  const int j = blockIdx.x % p.Nb, sp = (blockIdx.x / p.Nb) % splits;
  const int g = blockIdx.x / p.Nb / splits, e = g / p.S;
  const int count = p.live_rows(g);
  if (count == 0) {  // a dead segment loads nothing; its zeros are stored once
    if (splits == 1) p.store_zeros(g, 0, BOX * j, 16, BOX, TS_THREADS);
    return;
  }
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nbox = p.bk / BOX;
  if (tid == 0) {
    for (int s = 0; s < QS_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int kt0 = sp * kt_chunk, kt1 = min(p.Kb, kt0 + kt_chunk);
  const int steps = ring_steps(kt1 - kt0, p.bk);
  auto issue = [&](int st) {  // one thread: k-box st into its slot
    const int slot = st % QS_STAGES, kk = kt0 + st / nbox, kbox = st % nbox;
    uint8_t* base = smem + slot * STAGE;
    mbar_expect_tx(&full[slot], STAGE);
    tma_load_a(base, &ta, &full[slot], am, kk * p.bk + kbox * BOX, 0, g % p.S, e);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      int c0, c1;
      quant_box<I4, COL>((e * p.Nb + j) * p.Kb + kk, kbox, p.bk, c0, c1);
      tma_load(base + TS_A_BYTES + b * QBox<I4>::BYTES, stream_map(tb, tb2, b), &full[slot], c0,
               c1);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < steps && st < QS_STAGES; ++st) issue(st);
  }
  float sum[NB][2][4], part[NB][2][4];
  zero_acc<NB>(sum);
  zero_acc<NB>(part);
  for (int st = 0; st < steps; ++st) {
    const int slot = st % QS_STAGES;
    mbar_wait(&full[slot], (st / QS_STAGES) & 1);
    const uint8_t* base = smem + slot * STAGE;
    quant_box_mma<T, I4, COL, NB>(base, base + TS_A_BYTES, warp, lane, part);
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && st + QS_STAGES < steps) issue(st + QS_STAGES);
    if ((st + 1) % nbox == 0) {  // k-tile kk done: its scaled partials join the sums
      const int kk = kt0 + st / nbox;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float s = p.scale_mode == 1 ? p.tile_scale(b, e, j, kk) : 1.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            sum[b][h][x] += part[b][h][x] * s;
            part[b][h][x] = 0.0f;
          }
      }
    }
  }
  // c0, c1: row lane / 4, positions 2t, 2t + 1 of n8 tile h; c2, c3: row + 8.
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = lane / 4 + (x / 2) * 8;
      const int gn = j * BOX + 16 * warp + qcol<COL>(8 * h + 2 * (lane % 4) + x % 2);
      if (splits == 1) {
        p.store(g, e, count, r, gn, j, sum[0][h][x], sum[NB - 1][h][x]);
      } else if (r < count && gn < p.N) {
        const long long at = (static_cast<long long>(g) * p.C + r) * p.N + gn;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          ws[(static_cast<long long>(sp) * NB + b) * total + at] = sum[b][h][x];
        }
      }
    }
}

// C > 16: persistent blocks over tiles (segment g, 64-row m-tile tm,
// column tile tn), m-tiles fastest. Producer warp 8 loads the m-tile's
// 64-row A box (nothing for a tile with no live row) and two weight boxes a
// stage: stripes 2tn and 2tn + 1 of B, or for the pair stripe tn of B and
// of B2. Consumer warpgroup wg widens weight box wg and multiplies it by
// the 64 rows (quant_wgmma_tile, wgmma with the weights in registers),
// each k-tile's partial times its stream's tile scale. The pair's up
// stream (warpgroup 1) hands its sums to warpgroup 0 through shared memory
// for the silu-gate store; rows at or past the count are stored as 0.
template <typename T, bool I4, bool COL, int NB>
__global__ void __launch_bounds__(QW_THREADS, 1)
grouped_quant_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap tb2, Grouped p, AMap am, int tiles_m,
                    int tiles_n, int tiles) {
  constexpr int STAGE = QwRing<I4>::STAGE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[QW_STAGES], empty[QW_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* xch = reinterpret_cast<float*>(smem + QW_STAGES * STAGE);  // [32][128], the pair only
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = ring_steps(p.Kb, p.bk), nbox = p.bk / BOX;
  if (tid == 0) {
    for (int s = 0; s < QW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Tile -> (g, tm, tn); whether the m-tile holds a live row.
  auto live_tile = [&](int tile, int& g, int& tm, int& tn) {
    tm = tile % tiles_m;
    tn = (tile / tiles_m) % tiles_n;
    g = tile / tiles_m / tiles_n;
    return p.live_rows(g) > tm * BOX;
  };
  // Weight box h of column tile tn: its stripe.
  auto stripe = [&](int tn, int h) { return NB == 2 ? tn : 2 * tn + h; };

  if (warp == 8) {  // producer
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int g, tm, tn;
        const bool live = live_tile(tile, g, tm, tn);
        const int e = g / p.S, s = g % p.S;
        for (int st = 0; st < (live ? steps : 0); ++st) {
          const int kk = st / nbox, kbox = st - kk * nbox;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE);
          uint8_t* base = smem + stage * STAGE;
          tma_load_a(base, &ta, &full[stage], am, kk * p.bk + kbox * BOX, tm * BOX, s, e);
          for (int h = 0; h < 2; ++h) {
            int c0, c1;
            quant_box<I4, COL>((e * p.Nb + min(stripe(tn, h), p.Nb)) * p.Kb + kk, kbox, p.bk, c0,
                               c1);
            tma_load(base + QW_A_BYTES + h * QBox<I4>::BYTES, stream_map(tb, tb2, NB == 2 ? h : 0),
                     &full[stage], c0, c1);
          }
          if (++stage == QW_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: weight box wg
    const int wg = warp / 4, wl = warp % 4;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int g, tm, tn;
      const bool live = live_tile(tile, g, tm, tn);
      const int e = g / p.S, j = stripe(tn, wg), which = NB == 2 ? wg : 0;
      float total[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) total[x] = 0.0f;
      if (live) {
        quant_wgmma_tile<T, I4, COL>(smem, full, empty, stage, phase, steps, nbox, wg, lane,
                                     total, [&](int kk) {
                                       return p.scale_mode != 1 ? 1.0f
                                              : j < p.Nb ? p.tile_scale(which, e, j, kk)
                                                         : 0.0f;
                                     });
      }
      const int count = p.live_rows(g);
      if (NB == 2) {  // the up stream's sums to warpgroup 0, then the pair's store
        if (wg == 1) {
#pragma unroll
          for (int x = 0; x < 32; ++x) xch[x * 128 + tid % 128] = total[x];
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (wg == 0) {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int gn = j * BOX + 16 * wl + qcol<COL>(qw_pos(x, lane));
            p.store(g, e, count, tm * BOX + qw_row(x, lane), gn, j, total[x],
                    xch[x * 128 + tid]);
          }
        }
        asm volatile("bar.sync 2, 256;\n" ::: "memory");
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int gn = j * BOX + 16 * wl + qcol<COL>(qw_pos(x, lane));
          p.store(g, e, count, tm * BOX + qw_row(x, lane), gn, j, total[x], 0.0f);
        }
      }
    }
  }
}

// grouped_quant_wgmma over G segments x tiles_m x tiles_n tiles (one block
// an SM at most), or grouped_quant_stream over G x splits x Nb blocks with
// grouped_reduce after it when it splits. Returns the CUDA error of the
// launches.
template <typename T, bool I4, bool COL, int NB>
int launch_grouped_quant(int body, const CUtensorMap& ta, const CUtensorMap& tb,
                         const CUtensorMap& tb2, const Grouped& p, const AMap& am, int G,
                         int splits, int kt_chunk, float* ws, cudaStream_t s) {
  if (body == G_WGMMA_Q) {
    constexpr int SMEM = QwRing<I4>::SMEM + (NB == 2 ? 32 * 128 * 4 : 0);
    static bool raised = false;
    if (!raised) {
      cudaFuncSetAttribute(grouped_quant_wgmma<T, I4, COL, NB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
      raised = true;
    }
    const int tiles_m = (p.C + BOX - 1) / BOX, tiles_n = NB == 2 ? p.Nb : (p.Nb + 1) / 2;
    const long long tiles = static_cast<long long>(G) * tiles_m * tiles_n;
    if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    grouped_quant_wgmma<T, I4, COL, NB><<<grid_for(tiles, sm_count()), QW_THREADS, SMEM, s>>>(
        ta, tb, tb2, p, am, tiles_m, tiles_n, static_cast<int>(tiles));
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int SMEM = QS_STAGES * (TS_A_BYTES + NB * QBox<I4>::BYTES) + 1024;
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(grouped_quant_stream<T, I4, COL, NB>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    raised = true;
  }
  const long long blocks = static_cast<long long>(G) * splits * p.Nb;
  const long long total = static_cast<long long>(G) * p.C * p.N;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  grouped_quant_stream<T, I4, COL, NB><<<static_cast<int>(blocks), TS_THREADS, SMEM, s>>>(
      ta, tb, tb2, p, am, splits, kt_chunk, ws, total);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  const long long rblocks = (total + 255) / 256;
  grouped_reduce<NB><<<static_cast<int>(rblocks < 4096 ? rblocks : 4096), 256, 0, s>>>(
      ws, splits, total, p);
  return static_cast<int>(cudaGetLastError());
}

// tc_stream_q (C <= 16) and wgmma_q: bf16 / f16 A against int8 / int4
// tiles (tile, col or no scales); cudaErrorInvalidValue for what they do
// not take.
int launch_quant(int body, const Grouped& p, int E, int a_dt, int int_acc, int splits,
                 int kt_chunk, void* ws, cudaStream_t s) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const bool quant_pair = (a_dt == DT_BF16 || a_dt == DT_F16) && !int_acc &&
                          (p.b_dt == DT_I8 || p.b_dt == DT_I4);
  if (!quant_pair || p.bn != BOX || p.bk % BOX != 0 || !aligned16(p.A) || !aligned16(p.B) ||
      (p.B2 != nullptr && !aligned16(p.B2)) || p.lda % 8 != 0 || p.sa_s % 8 != 0 ||
      p.sa_e % 8 != 0 || p.lda < p.K || p.sa_s <= 0 || p.sa_e <= 0 ||
      (body == G_TC_STREAM_Q && (p.C > 16 || !valid_tile_split(p.Kb, splits, kt_chunk, ws)))) {
    return invalid;
  }
  CUtensorMap ta, tb, tb2;
  AMap am;
  const int G = E * p.S;
  const long long tiles = 1LL * E * p.Nb * p.Kb;
  if (!make_grouped_a_map(&ta, &am, p.A, a_dt, E, p.S, p.C, p.K, p.sa_e, p.sa_s, p.lda,
                          body == G_WGMMA_Q ? BOX : 16) ||
      !make_quant_b_map(&tb, p.B, p.b_dt, p.col_layout, tiles, p.bk, p.bn) ||
      !make_quant_b_map(&tb2, p.B2 != nullptr ? p.B2 : p.B, p.b_dt, p.col_layout, tiles, p.bk,
                        p.bn)) {
    return invalid;
  }
  float* wsf = static_cast<float*>(ws);
  return quant_dispatch(p.b_dt, p.col_layout, [&](auto i4, auto col) {
    constexpr bool I4 = decltype(i4)::value, COL = decltype(col)::value;
    if (a_dt == DT_BF16) {
      return p.B2 != nullptr
          ? launch_grouped_quant<__nv_bfloat16, I4, COL, 2>(body, ta, tb, tb2, p, am, G, splits,
                                                            kt_chunk, wsf, s)
          : launch_grouped_quant<__nv_bfloat16, I4, COL, 1>(body, ta, tb, tb2, p, am, G, splits,
                                                            kt_chunk, wsf, s);
    }
    return p.B2 != nullptr
        ? launch_grouped_quant<__half, I4, COL, 2>(body, ta, tb, tb2, p, am, G, splits, kt_chunk,
                                                   wsf, s)
        : launch_grouped_quant<__half, I4, COL, 1>(body, ta, tb, tb2, p, am, G, splits, kt_chunk,
                                                   wsf, s);
  });
}

}  // namespace

// Plain C entry point (bound with ctypes). A is [E, S, C, K] with element
// strides sa_e, sa_s, lda and unit column stride; counts is [E * S] int32
// or null (K3: every row live); b2 / scales2 the silu-gate partner (or
// null). `variant` picks the body (0 fma, 1 / 2 mma_sync decode / prefill,
// 3 wgmma, 4 tc_stream, 5 tc_stream_q, 6 wgmma_q; the caller checks
// eligibility, see gemm_grouped.py grouped_body); BM / BN / KC are the fma
// body's block shape; tc_stream and tc_stream_q cut Kb into `splits`
// chunks of `kchunk` packed k-tiles, their partials in `ws` (f32 [splits,
// streams, E*S*C, N]) when splits > 1. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for what
// the body does not take. `stream` is the caller's cudaStream_t.
extern "C" int gemm_grouped_packed_launch(
    const void* a, int a_dt, long long sa_e, long long sa_s, long long lda,
    int E, int S, int C, int K, const void* counts,
    const void* b, const void* b2, int b_dt, int col_layout, int Nb, int Kb, int bk, int bn,
    const void* scales, const void* scales2, int scale_mode, const void* bias,
    void* out, int out_dt, int N, int act, int BM, int BN, int KC, int int_acc,
    int variant, int splits, int kchunk, void* ws, void* stream) {
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
  if (variant == G_WGMMA || variant == G_TC_STREAM) {
    return launch_tma(variant, p, E, a_dt, int_acc, splits, kchunk, ws, s);
  }
  if (variant == G_TC_STREAM_Q || variant == G_WGMMA_Q) {
    return launch_quant(variant, p, E, a_dt, int_acc, splits, kchunk, ws, s);
  }
  return (b2 != nullptr) ? launch_blocks<2>(p, E, a_dt, BM, BN, KC, int_acc, variant, s)
                         : launch_blocks<1>(p, E, a_dt, BM, BN, KC, int_acc, variant, s);
}
