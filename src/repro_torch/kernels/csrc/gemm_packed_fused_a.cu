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
// A is natural [M, K] (row stride lda, unit column stride), never copied.
// B is tile-major [Nb, Kb, t0, t1]: [bk, bn] tiles ("row") or [bn, bk]
// ("col"), zero-filled past K/N, as float32 / bfloat16 / float16 / int8, or
// int4 nibble-packed two a byte (element 2i in the low nibble). Quantized
// tiles carry f32 scales: [Nb, Kb] per tile, multiplied into each K-step's
// partial sum, or [Nb] per column, multiplied once at store ahead of
// alpha/beta, bias and activation.
//
// What bounds it on an H100: at decode (M of a few rows) the weight stream,
// B's bytes over 3.35 TB/s; at prefill (M in the hundreds) the tensor-core
// multiply-adds (989 TFLOP/s bf16), the CUDA cores for f32 / int8.
//
// What the design does about it: the wrapper picks a body per call
// (gemm_packed.py fused_a_body) and counts its launches by name:
//  * tc_stream / wgmma (bf16 / f16 A against B tiles of the same type, bn
//    64, bk a multiple of 64, A's base 16-byte aligned and lda a multiple
//    of 8): K6's TMA bodies of gemm_wgmma.cuh with A's boxes from a 2-D
//    tensor map over natural A (NaturalA), K wide, so that rows past M and
//    columns past K read as zeros. Decode (M <= 16): mma_stream, B's
//    64-column stripes streamed once through a TMA ring, Kb split on whole
//    packed tiles, the partials reduced in split order before the one
//    epilogue. Above: wgmma_packed, 128 x 128 output tiles, a TMA ring fed
//    by one producer warp, two consumer warpgroups on wgmma.
//  * mma_general (bf16 / f16 float tiles of any other geometry or
//    alignment): gemm_blocked.cuh's blocked_mma over a StridedOperand A and
//    a PackedOperand B.
//  * fma_stream / fma_tiled (f32 A with f32 tiles, int8 A with unscaled
//    int8 tiles and i32 accumulators): gemm_blocked.cuh's CUDA-core bodies
//    with split-K, as K8's packed variant runs them; no tensor-core
//    instruction for f32, which the reference accumulates in full f32.
//  * tc_stream_q / wgmma_q (bf16 / f16 A against int8 / int4 tiles, with
//    tile, col or no scales, bn 64, bk a multiple of 64, A TMA-aligned):
//    gemm_quant.cuh's bodies. The narrow tiles come through TMA as stored
//    and each warp widens what it multiplies in registers. Decode (M <= 16):
//    quant_stream, mma.sync on a ring of (A box, weight box) stages, Kb
//    split on whole k-tiles as tc_stream splits it, each k-tile's partial
//    times its tile scale, the splits reduced in order with the col scale
//    in the reduction's epilogue. Above: quant_wgmma, the widened weights as
//    wgmma's register operand against 64 activation rows from shared
//    memory, 64 x 128 output tiles.
//  * mma_quant / fma_quant (every other pair: int8 / int4 tiles under f32
//    A, int4 under int8 A, mixed float types, other geometries or a
//    misaligned A): the quantized bodies below, fused_a_mma (mma.sync
//    m16n8k16, int tiles widened exactly to the activation type in shared
//    memory) and fused_a_fma (scalar FMAs on shared-memory tiles).

#include "gemm_quant.cuh"

namespace {

// ---------------------------------------------------------------------------
// fma_quant (fused_a_fma): scalar FMAs on shared-memory tiles
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
// mma_quant (fused_a_mma): mma.sync m16n8k16, f32 accumulators
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
void launch_quant_mma(int variant, const void* a, long long lda, int M, int K, const char* b,
                      int b_dt,
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

// The bodies of the `body` argument (the wrapper's _BODY_CODE).
enum FusedBody {
  F_FMA_QUANT = 0,
  F_MMA_QUANT_DECODE = 1,
  F_MMA_QUANT_PREFILL = 2,
  F_WGMMA = 3,
  F_TC_STREAM = 4,
  F_MMA_GENERAL = 5,
  F_FMA = 6,
  F_TC_STREAM_Q = 7,
  F_WGMMA_Q = 8
};

// tc_stream (M <= 16) and wgmma: natural A and the packed B stack through
// 2-D tensor maps; cudaErrorInvalidValue for what they do not take.
template <typename T>
int launch_tma(int body, const void* a, long long lda, int M, int K, const void* b, int b_col,
               int Nb, int Kb, int bk, int bn, int dt, int N, const Epilogue& ep, int splits,
               int kt_chunk, void* ws, cudaStream_t s) {
  CUtensorMap ta, tb;
  const int box_rows = body == F_WGMMA ? BOX : 16;
  // A's map is K wide, not lda: the columns of a strided view past K are
  // not zeros, and a NaN there would meet B's zero padding (0 * NaN).
  if (bn != BOX || bk % BOX != 0 || !aligned16(a) || !aligned16(b) || lda % 8 != 0 || lda < K ||
      !make_packed_b_map(&tb, b, dt, b_col, Nb, Kb, bk, bn) ||
      !make_tensor_map(&ta, a, dt, M, K, box_rows, lda)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_n = (N + BOX - 1) / BOX;
  if (body == F_WGMMA) {
    const int tiles_m = ((M + BOX - 1) / BOX + 1) / 2, tiles_n2 = (tiles_n + 1) / 2;
    return b_col ? launch_wgmma<T, NaturalA, PackedB<false>>(ta, tb, Kb, bk, tiles_m, tiles_n2,
                                                             ep, s)
                 : launch_wgmma<T, NaturalA, PackedB<true>>(ta, tb, Kb, bk, tiles_m, tiles_n2,
                                                            ep, s);
  }
  if (M > 16 || !valid_tile_split(Kb, splits, kt_chunk, ws)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* wsf = static_cast<float*>(ws);
  const int err =
      b_col ? launch_mma_stream<T, NaturalA, PackedB<false>>(ta, tb, Kb, bk, tiles_n, splits,
                                                             kt_chunk, wsf, ep, s)
            : launch_mma_stream<T, NaturalA, PackedB<true>>(ta, tb, Kb, bk, tiles_n, splits,
                                                            kt_chunk, wsf, ep, s);
  if (err != 0 || splits == 1) return err;
  return reduce_splits(wsf, splits, ep, s);
}

// tc_stream_q (M <= 16) and wgmma_q: natural A through a 2-D tensor map,
// the int8 / int4 stack through its byte view; cudaErrorInvalidValue for
// what they do not take.
template <typename T>
int launch_quant(int body, const void* a, int a_dt, long long lda, int M, int K, const void* b,
                 int b_dt, int b_col, int Nb, int Kb, int bk, int bn, const Epilogue& ep,
                 int splits, int kt_chunk, void* ws, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (bn != BOX || bk % BOX != 0 || !aligned16(a) || !aligned16(b) || lda % 8 != 0 || lda < K ||
      !make_quant_b_map(&tb, b, b_dt, b_col, 1LL * Nb * Kb, bk, bn) ||
      !make_tensor_map(&ta, a, a_dt, M, K, body == F_WGMMA_Q ? BOX : 16, lda)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (body == F_WGMMA_Q) {
    const int tiles_m = (M + BOX - 1) / BOX, tiles_n = (Nb + 1) / 2;
    return quant_dispatch(b_dt, b_col, [&](auto i4, auto col) {
      return launch_quant_wgmma<T, decltype(i4)::value, decltype(col)::value>(
          ta, tb, Kb, bk, Nb, tiles_m, tiles_n, ep, s);
    });
  }
  if (M > 16 || !valid_tile_split(Kb, splits, kt_chunk, ws)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* wsf = static_cast<float*>(ws);
  const int err = quant_dispatch(b_dt, b_col, [&](auto i4, auto col) {
    return launch_quant_stream<T, decltype(i4)::value, decltype(col)::value>(
        ta, tb, Kb, bk, Nb, splits, kt_chunk, wsf, ep, s);
  });
  if (err != 0 || splits == 1) return err;
  return reduce_splits(wsf, splits, ep, s, BOX);
}

// mma_general: blocked_mma over natural A and any float tile geometry.
template <typename T>
int launch_general(const void* a, long long lda, int M, int K, const void* b, int b_col, int Kb,
                   int bk, int bn, int N, const Epilogue& ep, cudaStream_t s) {
  // B rows are n: "row" tiles [bk][bn] are k-major.
  launch_mma<T>(M <= 16 ? V_MMA_DECODE : V_MMA_PREFILL, strided<T>(a, lda, 1),
                packed<T>(b, bn, bk, Kb, !b_col), M, N, K, ep, 0x7fffffff, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). `body` picks the body (enum
// FusedBody; the caller checks eligibility, see gemm_packed.py): 0 / 1 / 2
// the quantized bodies fma_quant and mma_quant decode / prefill (BM / BN /
// KC the fma body's block shape), 3 wgmma, 4 tc_stream (`splits` chunks of
// `kchunk` packed k-tiles), 5 mma_general, 6 fma_tiled / fma_stream (the
// FmaPlan `fma_body`, `fma_tile`, `splits`, `kchunk` in elements of k),
// 7 tc_stream_q (split as tc_stream), 8 wgmma_q; `ws` the split-K
// workspace ([splits, M, N] of the accumulator type).
// Returns the CUDA error after the launches, or cudaErrorInvalidValue for
// what the body does not take. `stream` is the caller's cudaStream_t.
extern "C" int gemm_packed_fused_a_launch(
    const void* a, int a_dt, long long lda, int M, int K,
    const void* b, int b_dt, int col_layout, int Nb, int Kb, int bk, int bn,
    const void* scales, int scale_mode, const void* bias, const void* c,
    long long ldc, float alpha, float beta, void* out, int out_dt, int N,
    int act, int body, int BM, int BN, int KC, int int_acc,
    int fma_body, int fma_tile, int splits, int kchunk, void* ws, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Nb <= 0 || Kb <= 0 || bk % 16 || bn % 16 ||
      static_cast<long long>(Nb) * bn < N || static_cast<long long>(Kb) * bk < K) {
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
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const bool float_pair = scale_mode == 0 && !int_acc && b_dt == a_dt;
  switch (body) {
    case F_WGMMA:
    case F_TC_STREAM:
      if (!float_pair) return invalid;
      if (a_dt == DT_BF16) {
        return launch_tma<__nv_bfloat16>(body, a, lda, M, K, b, col_layout, Nb, Kb, bk, bn, a_dt,
                                         N, ep, splits, kchunk, ws, s);
      }
      if (a_dt == DT_F16) {
        return launch_tma<__half>(body, a, lda, M, K, b, col_layout, Nb, Kb, bk, bn, a_dt, N, ep,
                                  splits, kchunk, ws, s);
      }
      return invalid;
    case F_TC_STREAM_Q:
    case F_WGMMA_Q: {
      const bool quant_pair = (b_dt == DT_I8 || b_dt == DT_I4) && !int_acc &&
                              (scale_mode == 0 || scales != nullptr);
      if (!quant_pair) return invalid;
      if (a_dt == DT_BF16) {
        return launch_quant<__nv_bfloat16>(body, a, a_dt, lda, M, K, b, b_dt, col_layout, Nb, Kb,
                                           bk, bn, ep, splits, kchunk, ws, s);
      }
      if (a_dt == DT_F16) {
        return launch_quant<__half>(body, a, a_dt, lda, M, K, b, b_dt, col_layout, Nb, Kb, bk, bn,
                                    ep, splits, kchunk, ws, s);
      }
      return invalid;
    }
    case F_MMA_GENERAL:
      if (!float_pair) return invalid;
      if (a_dt == DT_BF16) {
        return launch_general<__nv_bfloat16>(a, lda, M, K, b, col_layout, Kb, bk, bn, N, ep, s);
      }
      if (a_dt == DT_F16) {
        return launch_general<__half>(a, lda, M, K, b, col_layout, Kb, bk, bn, N, ep, s);
      }
      return invalid;
    case F_FMA: {
      const FmaPlan plan{fma_body, fma_tile, splits, kchunk, ws};
      const int big = 0x7fffffff;
      if (scale_mode != 0 || b_dt != a_dt) return invalid;
      if (a_dt == DT_F32 && !int_acc) {
        return launch_fma<float>(strided<float>(a, lda, 1),
                                 packed<float>(b, bn, bk, Kb, !col_layout), M, N, K, ep, plan,
                                 big, s);
      }
      if (a_dt == DT_I8 && int_acc) {
        return launch_fma<int>(strided<int8_t>(a, lda, 1),
                               packed<int8_t>(b, bn, bk, Kb, !col_layout), M, N, K, ep, plan, big,
                               s);
      }
      return invalid;
    }
    case F_MMA_QUANT_DECODE:
    case F_MMA_QUANT_PREFILL: {
      const bool half_a = (a_dt == DT_BF16 || a_dt == DT_F16);
      const bool b_ok = (b_dt == DT_I8 || b_dt == DT_I4);  // float tiles: 3 / 4 / 5
      const bool shape_ok = (body == F_MMA_QUANT_DECODE) ? (bk % 64 == 0)
                                                         : (bk % 32 == 0 && bn % 64 == 0);
      if (!half_a || !b_ok || !shape_ok || int_acc) return invalid;
      if (a_dt == DT_BF16) {
        launch_quant_mma<__nv_bfloat16>(body, a, lda, M, K, bp, b_dt, col_layout, Nb, Kb, bk, bn,
                                        tile_bytes, ep, s);
      } else {
        launch_quant_mma<__half>(body, a, lda, M, K, bp, b_dt, col_layout, Nb, Kb, bk, bn,
                                 tile_bytes, ep, s);
      }
      return static_cast<int>(cudaGetLastError());
    }
    case F_FMA_QUANT:
      if (b_dt == a_dt && scale_mode == 0) return invalid;  // bodies 3 / 4 / 5 / 6
      break;
    default:
      return invalid;
  }
  if (BM < 16 || BM > MAX_BM || BM % 16 || !valid_chunk(BN, bn, MAX_BN) ||
      !valid_chunk(KC, bk, MAX_KC)) {
    return invalid;
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
