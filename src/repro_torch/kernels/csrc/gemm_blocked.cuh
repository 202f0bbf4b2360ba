// Blocked GEMM bodies over operands read through an address map — shared by
// gemm_tiled.cu (K7: strided, unpacked A and B), gemm_packed.cu (K6: both
// operands tile-major packed) and gemm_vsx_like.cu (K8: CUDA-core rank-1
// updates over strided or packed B).
//
// An operand is seen as (row, k) -> element: A by (m, k), B by (n, k). The
// address map (StridedOperand or PackedOperand) is the only thing that knows
// the layout. `kfast` says whether neighbouring k are neighbours in memory
// (else neighbouring rows are); `vec` (checked on the host) says whether a
// vector of vec_elems<T>() elements along that fast axis, starting on a
// multiple of its length, is one aligned load of at most 16 bytes. Rows past
// M / N and k past K read as 0: ragged edges are masked here, with no
// padding copies.
//
// Bodies, each a loop over its work items (tile = blockIdx.x, then +=
// gridDim.x), so that a grid of one block runs the whole problem:
//  * fma_tiled and fma_stream: the CUDA-core bodies, multiply-adds on the
//    accumulator type (f32 for float inputs, i32 for int8), each k a rank-1
//    update of a register tile. No tensor-core instruction.
//    - fma_tiled (more than 16 rows): 256 threads own 8 x 8 (128 x 128
//      block tile) or 4 x 4 (64 x 64) outputs, each split into 4-wide halves
//      64 rows / columns apart; 8-deep k-slices staged k-major in shared
//      memory, double-buffered, the next slice's global loads (vectors along
//      the operand's contiguous axis) in flight during the current one's
//      multiply-adds; a thread reads its A and B fragments with 128-bit
//      loads: 4 loads for 64 multiply-adds.
//    - fma_stream (at most 16 rows, decode): B streamed once at memory
//      speed in vectors along its contiguous axis (n for a row-major [K, N],
//      k for the LM head's table.t() or "col" tiles), A's rows of a
//      k-chunk held in shared memory, every B element multiplied by all MR
//      rows; the k lanes of a column reduced by shuffles (and, along n, in
//      shared memory) in a fixed order.
//    Both split K when the output alone gives the card too few blocks: split
//    s writes its partial sums to a workspace [splits, M, N] of the
//    accumulator type, and splitk_reduce adds them in split order (no
//    atomics) and runs the store epilogue.
//  * blocked_mma: bf16 / f16 on the tensor cores (mma.sync m16n8k16 through
//    ldmatrix, f32 accumulators), with the next slice loaded into registers
//    while the current one is multiplied. Decode-shaped calls (M <= 16) take
//    16 x 16 tiles whose four warps split each 128-deep slice; the others
//    64 x 64 tiles of four 32 x 32 warps over 32-deep slices.

#pragma once

#include "gemm_common.cuh"

namespace {

// Elements of one staging vector: 16 bytes, at most 8 elements (8 bytes of
// int8), so that a thread's register tile stays small.
template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T)) < 8 ? 16 / static_cast<int>(sizeof(T)) : 8;
}

// A[r, k] at p[r * s_row + k * s_k] (element strides, any sign-free layout:
// a transposed view is s_row = 1, s_k = its leading dimension).
template <typename T>
struct StridedOperand {
  using Elem = T;
  const T* p;
  long long s_row, s_k;
  int kfast, vec;
  __device__ __forceinline__ const T* ptr(int r, int k) const {
    return p + static_cast<long long>(r) * s_row + static_cast<long long>(k) * s_k;
  }
  __device__ __forceinline__ T at(int r, int k) const { return *ptr(r, k); }
};

// A tile-major stack [row tiles, kb, ...]: tiles of tr rows by tk k, stored
// [tk][tr] (k_major) or [tr][tk]. Packed A "row" is [bm][bk] tiles, "col"
// [bk][bm]; packed B "row" is [bk][bn] (k_major, rows are n), "col" [bn][bk].
template <typename T>
struct PackedOperand {
  using Elem = T;
  const T* p;
  int tr, tk, kb, k_major, kfast, vec;
  __device__ __forceinline__ const T* ptr(int r, int k) const {
    const int i = r / tr, rr = r - i * tr, kk = k / tk, kq = k - kk * tk;
    const long long base = (static_cast<long long>(i) * kb + kk) * tr * tk;
    return p + base + (k_major ? static_cast<long long>(kq) * tr + rr
                               : static_cast<long long>(rr) * tk + kq);
  }
  __device__ __forceinline__ T at(int r, int k) const { return *ptr(r, k); }
};

// Host checks of the `vec` flag: the vector's bytes divide the base address
// and every step between vectors.
template <typename T>
int strided_vec(const void* p, long long s_row, long long s_k) {
  const long long vb = vec_elems<T>() * static_cast<long long>(sizeof(T));
  const long long other = (s_k == 1 ? s_row : s_k) * static_cast<long long>(sizeof(T));
  const bool unit = s_k == 1 || s_row == 1;
  return unit && reinterpret_cast<uintptr_t>(p) % vb == 0 && other % vb == 0;
}

template <typename T>
int packed_vec(const void* p, int tr, int tk, int k_major) {
  const int v = vec_elems<T>();
  const long long vb = v * static_cast<long long>(sizeof(T));
  return reinterpret_cast<uintptr_t>(p) % vb == 0 && (k_major ? tr : tk) % v == 0;
}

template <typename T>
StridedOperand<T> strided(const void* p, long long s_row, long long s_k) {
  return StridedOperand<T>{static_cast<const T*>(p), s_row, s_k, s_k == 1,
                           strided_vec<T>(p, s_row, s_k)};
}

template <typename T>
PackedOperand<T> packed(const void* p, int tr, int tk, int kb, int k_major) {
  return PackedOperand<T>{static_cast<const T*>(p), tr, tk, kb, k_major, !k_major,
                          packed_vec<T>(p, tr, tk, k_major)};
}

// Widening of an element to the accumulator type (reference: operands cast
// to acc_dtype_for before the rank-1 updates / the f32 contraction).
template <typename Acc>
struct Widen {
  static __device__ __forceinline__ Acc of(float x) { return static_cast<Acc>(x); }
  static __device__ __forceinline__ Acc of(__nv_bfloat16 x) { return static_cast<Acc>(__bfloat162float(x)); }
  static __device__ __forceinline__ Acc of(__half x) { return static_cast<Acc>(__half2float(x)); }
  static __device__ __forceinline__ Acc of(int8_t x) { return static_cast<Acc>(x); }
};

template <typename T> struct Zero { static __device__ __forceinline__ T get() { return static_cast<T>(0); } };
template <> struct Zero<__nv_bfloat16> { static __device__ __forceinline__ __nv_bfloat16 get() { return __float2bfloat16(0.0f); } };
template <> struct Zero<__half> { static __device__ __forceinline__ __half get() { return __float2half(0.0f); } };

template <int BYTES> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };

// Four accumulators read from shared memory with one 128-bit load.
template <typename Acc> struct Quad;
template <> struct Quad<float> { using type = float4; };
template <> struct Quad<int> { using type = int4; };

template <typename Acc>
__device__ __forceinline__ void read_quad(const Acc* p, Acc* out) {
  const typename Quad<Acc>::type q = *reinterpret_cast<const typename Quad<Acc>::type*>(p);
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
}

template <typename T, int V>
struct Elems {
  T e[V];
};

// The element-by-element path of fetch (unaligned operands and ragged
// edges), kept out of line: the bodies inline only the vector path.
template <int V, class Op>
__device__ __noinline__ Elems<typename Op::Elem, V> fetch_masked(const Op op, int r, int k,
                                                                 int rows, int kend) {
  Elems<typename Op::Elem, V> out;
  for (int i = 0; i < V; ++i) {
    const int rr = op.kfast ? r : r + i, kk = op.kfast ? k + i : k;
    out.e[i] = (rr < rows && kk < kend) ? op.at(rr, kk) : Zero<typename Op::Elem>::get();
  }
  return out;
}

// A staged vector widened and written along a shared-memory row with
// 128-bit stores (neighbouring lanes' vectors are neighbours there).
template <typename Acc, typename T, int V>
__device__ __forceinline__ void write_quads(Acc* dst, const T (&v)[V]) {
  static_assert(V % 4 == 0, "whole quads");
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    typename Quad<Acc>::type q;
    q.x = Widen<Acc>::of(v[e]);
    q.y = Widen<Acc>::of(v[e + 1]);
    q.z = Widen<Acc>::of(v[e + 2]);
    q.w = Widen<Acc>::of(v[e + 3]);
    *reinterpret_cast<typename Quad<Acc>::type*>(dst + e) = q;
  }
}

// V elements of `op` from (r, k) along its fast axis (k when kfast, else
// the rows); elements at rows >= rows or k >= kend read 0. One aligned
// vector load when op.vec holds and the vector lies whole inside the bounds.
template <int V, class Op>
__device__ __forceinline__ void fetch(const Op& op, int r, int k, int rows, int kend,
                                      typename Op::Elem (&v)[V]) {
  using T = typename Op::Elem;
  const bool whole = op.kfast ? (r < rows && k + V <= kend) : (r + V <= rows && k < kend);
  if (op.vec && whole) {
    using R = typename RawVec<V * sizeof(T)>::type;
    const R raw = *reinterpret_cast<const R*>(op.ptr(r, k));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = e[i];
    return;
  }
  const Elems<T, V> slow = fetch_masked<V>(op, r, k, rows, kend);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = slow.e[i];
}

// The result of output (r, n): the store epilogue, or split s's partial sum
// into the workspace.
template <typename Acc>
__device__ __forceinline__ void put(const Epilogue& ep, Acc* ws, int splits, int s, int r, int n,
                                    Acc v) {
  if (r >= ep.M || n >= ep.N) return;
  if (splits == 1) {
    ep.store(static_cast<float>(v), r, n, 0);
  } else {
    ws[(static_cast<long long>(s) * ep.M + r) * ep.N + n] = v;
  }
}

constexpr int FMA_KS = 8;  // k-slice of fma_tiled

// HM x HN halves of 64 rows / columns: a 64*HM x 64*HN block tile, each of
// the 16 x 16 threads owning 4*HM x 4*HN outputs.
template <typename Acc, class OpA, class OpB, int HM, int HN>
__global__ void __launch_bounds__(FMA_THREADS)
fma_tiled(OpA A, OpB B, int K, Epilogue ep, int tiles_m, int tiles_n, int splits, int kchunk,
          Acc* ws) {
  using TA = typename OpA::Elem;
  using TB = typename OpB::Elem;
  constexpr int BM = 64 * HM, BN = 64 * HN, KS = FMA_KS;
  constexpr int VA = vec_elems<TA>(), VB = vec_elems<TB>();
  constexpr int NVA = BM * KS / VA, NVB = BN * KS / VB;
  constexpr int RA = (NVA + FMA_THREADS - 1) / FMA_THREADS;
  constexpr int RB = (NVB + FMA_THREADS - 1) / FMA_THREADS;
  __shared__ __align__(16) Acc As[2][KS][BM];  // [k][row]
  __shared__ __align__(16) Acc Bs[2][KS][BN];  // [k][col]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int per_split = tiles_m * tiles_n, tiles = per_split * splits;
  TA ar[RA][VA];
  TB br[RB][VB];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int sp = tile / per_split, rest = tile - sp * per_split;
    const int m0 = (rest / tiles_n) * BM, n0 = (rest % tiles_n) * BN;
    const int kb = sp * kchunk, ke = min(K, kb + kchunk);
    const int slices = (ke - kb + KS - 1) / KS;

    // Vector i of a slice: KS / V vectors a row when k is fast, else BM / V
    // vectors a k.
    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int v = tid + i * FMA_THREADS;
        if (NVA % FMA_THREADS == 0 || v < NVA) {
          const int r = A.kfast ? v / (KS / VA) : (v % (BM / VA)) * VA;
          const int q = A.kfast ? (v % (KS / VA)) * VA : v / (BM / VA);
          fetch<VA>(A, m0 + r, k0 + q, ep.M, ke, ar[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int v = tid + i * FMA_THREADS;
        if (NVB % FMA_THREADS == 0 || v < NVB) {
          const int c = B.kfast ? v / (KS / VB) : (v % (BN / VB)) * VB;
          const int q = B.kfast ? (v % (KS / VB)) * VB : v / (BN / VB);
          fetch<VB>(B, n0 + c, k0 + q, ep.N, ke, br[i]);
        }
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int v = tid + i * FMA_THREADS;
        if (NVA % FMA_THREADS == 0 || v < NVA) {
          const int r = A.kfast ? v / (KS / VA) : (v % (BM / VA)) * VA;
          const int q = A.kfast ? (v % (KS / VA)) * VA : v / (BM / VA);
          if (A.kfast) {
#pragma unroll
            for (int e = 0; e < VA; ++e) As[buf][q + e][r] = Widen<Acc>::of(ar[i][e]);
          } else {
            write_quads(&As[buf][q][r], ar[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int v = tid + i * FMA_THREADS;
        if (NVB % FMA_THREADS == 0 || v < NVB) {
          const int c = B.kfast ? v / (KS / VB) : (v % (BN / VB)) * VB;
          const int q = B.kfast ? (v % (KS / VB)) * VB : v / (BN / VB);
          if (B.kfast) {
#pragma unroll
            for (int e = 0; e < VB; ++e) Bs[buf][q + e][c] = Widen<Acc>::of(br[i][e]);
          } else {
            write_quads(&Bs[buf][q][c], br[i]);
          }
        }
      }
    };

    Acc acc[4 * HM][4 * HN];
#pragma unroll
    for (int i = 0; i < 4 * HM; ++i)
#pragma unroll
      for (int j = 0; j < 4 * HN; ++j) acc[i][j] = static_cast<Acc>(0);

    load(kb);
    store(0);
    __syncthreads();
    for (int s = 0; s < slices; ++s) {
      const int buf = s & 1;
      if (s + 1 < slices) load(kb + (s + 1) * KS);  // in flight during the FMAs
#pragma unroll
      for (int q = 0; q < KS; ++q) {  // one rank-1 update per k
        Acc a[4 * HM], b[4 * HN];
#pragma unroll
        for (int h = 0; h < HM; ++h) read_quad(&As[buf][q][h * 64 + ty * 4], &a[4 * h]);
#pragma unroll
        for (int h = 0; h < HN; ++h) read_quad(&Bs[buf][q][h * 64 + tx * 4], &b[4 * h]);
#pragma unroll
        for (int i = 0; i < 4 * HM; ++i)
#pragma unroll
          for (int j = 0; j < 4 * HN; ++j) acc[i][j] += a[i] * b[j];
      }
      if (s + 1 < slices) store(buf ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4 * HM; ++i)
#pragma unroll
      for (int j = 0; j < 4 * HN; ++j)
        put(ep, ws, splits, sp, m0 + (i / 4) * 64 + ty * 4 + i % 4,
            n0 + (j / 4) * 64 + tx * 4 + j % 4, acc[i][j]);
  }
}

constexpr int STREAM_A = 4096;  // accumulators of A staged at once: MR rows x KSUB k
constexpr int STREAM_U = 4;     // B vectors a thread has in flight

// Columns of one fma_stream work item (mirrored by the wrappers' geometry).
template <typename T>
__host__ __device__ constexpr int stream_bn(bool b_kfast) {
  return b_kfast ? 32 : 8 * vec_elems<T>();
}

// At most MR rows of A against B streamed once. BKFAST (B's k contiguous):
// 8 k lanes x 32 columns, each thread a vector of k of one column, A staged
// [MR][KSUB]; else 8 column lanes (a vector of n each) x 32 k lanes, A
// staged [KSUB][MR] so that a thread reads four rows with one 128-bit load.
template <typename Acc, class OpA, class OpB, int MR, bool BKFAST>
__global__ void __launch_bounds__(FMA_THREADS)
fma_stream(OpA A, OpB B, int K, Epilogue ep, int tiles_n, int splits, int kchunk, Acc* ws) {
  using TB = typename OpB::Elem;
  constexpr int VB = vec_elems<TB>(), KSUB = STREAM_A / MR, U = STREAM_U;
  constexpr int BN = stream_bn<TB>(BKFAST);
  static_assert(MR % 4 == 0 && KSUB % (8 * VB) == 0, "stream geometry");
  __shared__ __align__(16) Acc As[STREAM_A];
  __shared__ __align__(16) Acc red[BKFAST ? 4 : 8 * 4 * BN];  // [warp][row][col]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles = tiles_n * splits;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int sp = tile / tiles_n, n0 = (tile % tiles_n) * BN;
    const int kb = sp * kchunk, ke = min(K, kb + kchunk);
    Acc acc[MR][BKFAST ? 1 : VB];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int e = 0; e < (BKFAST ? 1 : VB); ++e) acc[m][e] = static_cast<Acc>(0);

    // A thread's column (BKFAST: one column, vectors of k; else a vector
    // of VB columns, one k a vector) and its first k; QS is the k between
    // its vectors. Two groups of U vectors are in flight: the next group's
    // loads are issued before the current one's multiply-adds, the first
    // one's before A is staged.
    const int n = BKFAST ? n0 + tid / 8 : n0 + (tid % 8) * VB;
    const int q_first = BKFAST ? (tid % 8) * VB : tid / 8;
    constexpr int QS = BKFAST ? 8 * VB : 32;
    TB bv[U][VB], nx[U][VB];
    for (int kc = kb; kc < ke; kc += KSUB) {
      const int len = min(KSUB, ke - kc);
      auto load = [&](TB (&dst)[U][VB], int q0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = q0 + u * QS;
          if (q < len) fetch<VB>(B, n, kc + q, ep.N, kc + len, dst[u]);
        }
      };
      __syncthreads();  // the previous chunk's readers are done
      load(bv, q_first);
      for (int idx = tid; idx < MR * KSUB; idx += FMA_THREADS) {
        const int m = idx / KSUB, q = idx - m * KSUB;  // k fastest: coalesced in A
        const Acc v = (m < ep.M && q < len) ? Widen<Acc>::of(A.at(m, kc + q))
                                            : static_cast<Acc>(0);
        As[BKFAST ? idx : q * MR + m] = v;
      }
      __syncthreads();
      for (int q0 = q_first; q0 < len; q0 += QS * U) {
        if (q0 + QS * U < len) load(nx, q0 + QS * U);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = q0 + u * QS;
          if (q >= len) continue;
          if constexpr (BKFAST) {
#pragma unroll
            for (int m = 0; m < MR; ++m) {
              Acc a[VB];
#pragma unroll
              for (int e = 0; e < VB; e += 4) read_quad(&As[m * KSUB + q + e], &a[e]);
#pragma unroll
              for (int e = 0; e < VB; ++e) acc[m][0] += a[e] * Widen<Acc>::of(bv[u][e]);
            }
          } else {
            Acc a[MR];
#pragma unroll
            for (int m = 0; m < MR; m += 4) read_quad(&As[q * MR + m], &a[m]);
#pragma unroll
            for (int m = 0; m < MR; ++m)
#pragma unroll
              for (int e = 0; e < VB; ++e) acc[m][e] += a[m] * Widen<Acc>::of(bv[u][e]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int e = 0; e < VB; ++e) bv[u][e] = nx[u][e];
      }
    }

    if (BKFAST) {  // the 8 k lanes of a column are neighbours in the warp
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int off = 1; off < 8; off *= 2) acc[m][0] += __shfl_xor_sync(0xffffffffu, acc[m][0], off);
      if (tid % 8 == 0) {
#pragma unroll
        for (int m = 0; m < MR; ++m) put(ep, ws, splits, sp, m, n0 + tid / 8, acc[m][0]);
      }
    } else {  // 4 k lanes a warp by shuffles, then the 8 warps in order
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int e = 0; e < VB; ++e) {
          acc[m][e] += __shfl_xor_sync(0xffffffffu, acc[m][e], 8);
          acc[m][e] += __shfl_xor_sync(0xffffffffu, acc[m][e], 16);
        }
#pragma unroll
      for (int p = 0; p < MR / 4; ++p) {
        __syncthreads();
        if (lane < 8) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < VB; ++e) red[(warp * 4 + i) * BN + lane * VB + e] = acc[p * 4 + i][e];
        }
        __syncthreads();
        for (int idx = tid; idx < 4 * BN; idx += FMA_THREADS) {
          const int i = idx / BN, c = idx - i * BN;
          Acc v = static_cast<Acc>(0);
#pragma unroll
          for (int w = 0; w < FMA_THREADS / 32; ++w) v += red[(w * 4 + i) * BN + c];
          put(ep, ws, splits, sp, p * 4 + i, n0 + c, v);
        }
      }
    }
  }
}

// The split-K partial sums added in split order, then the store epilogue
// (output column n's col scale is that of tile column n / col_bn).
template <typename Acc>
__global__ void splitk_reduce(const Acc* ws, int splits, Epilogue ep, int col_bn) {
  const long long total = static_cast<long long>(ep.M) * ep.N;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    Acc v = static_cast<Acc>(0);
    for (int s = 0; s < splits; ++s) v += ws[s * total + i];
    const int n = static_cast<int>(i % ep.N);
    ep.store(static_cast<float>(v), static_cast<int>(i / ep.N), n, n / col_bn);
  }
}

// Launches splitk_reduce over the [splits, M, N] workspace; returns the
// CUDA error of the launch. `col_bn`: the width of a col scale's tile
// column (the default: no col scale).
template <typename Acc>
int reduce_splits(const Acc* ws, int splits, const Epilogue& ep, cudaStream_t s,
                  int col_bn = 0x7fffffff) {
  const long long total = static_cast<long long>(ep.M) * ep.N;
  const long long blocks = (total + 255) / 256;
  splitk_reduce<Acc><<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(ws, splits,
                                                                                     ep, col_bn);
  return static_cast<int>(cudaGetLastError());
}

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

// Variant codes (the wrappers' pick_variant): 0 the CUDA-core bodies (the
// plan below picks which), 1 mma decode (16 x 16 tiles, M <= 16), 2 mma
// prefill (64 x 64 tiles).
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

// The CUDA-core plan, from the wrappers' fma_geometry: `body` 0 fma_tiled
// (`tile` 1: 64 x 64, 2: 128 x 128) or 1 fma_stream (`tile` = MR, 4 or
// 16, at least M); K cut into `splits` chunks of `kchunk` (a multiple of
// 16), each chunk non-empty; `ws` the [splits, M, N] accumulator workspace
// when splits > 1.
struct FmaPlan {
  int body, tile, splits, kchunk;
  void* ws;
};

template <typename Acc, class OpA, class OpB, int MR>
void launch_stream(OpA a, OpB b, int N, int K, const Epilogue& ep, const FmaPlan& p,
                   int max_blocks, cudaStream_t s) {
  using T = typename OpB::Elem;
  Acc* ws = static_cast<Acc*>(p.ws);
  if (b.kfast) {
    const int tiles_n = (N + stream_bn<T>(true) - 1) / stream_bn<T>(true);
    fma_stream<Acc, OpA, OpB, MR, true>
        <<<grid_for(static_cast<long long>(tiles_n) * p.splits, max_blocks), FMA_THREADS, 0, s>>>(
            a, b, K, ep, tiles_n, p.splits, p.kchunk, ws);
  } else {
    const int tiles_n = (N + stream_bn<T>(false) - 1) / stream_bn<T>(false);
    fma_stream<Acc, OpA, OpB, MR, false>
        <<<grid_for(static_cast<long long>(tiles_n) * p.splits, max_blocks), FMA_THREADS, 0, s>>>(
            a, b, K, ep, tiles_n, p.splits, p.kchunk, ws);
  }
}

// Launches the CUDA-core plan (and the split-K reduction); returns a CUDA
// error code, cudaErrorInvalidValue for a plan the bodies do not take.
template <typename Acc, class OpA, class OpB>
int launch_fma(OpA a, OpB b, int M, int N, int K, const Epilogue& ep, const FmaPlan& p,
               int max_blocks, cudaStream_t s) {
  const bool split_ok = p.splits >= 1 && p.kchunk > 0 && p.kchunk % 16 == 0 &&
                        static_cast<long long>(p.splits) * p.kchunk >= K &&
                        static_cast<long long>(p.splits - 1) * p.kchunk < K &&
                        (p.splits == 1 || p.ws != nullptr);
  if (!split_ok) return static_cast<int>(cudaErrorInvalidValue);
  Acc* ws = static_cast<Acc*>(p.ws);
  if (p.body == 0 && (p.tile == 1 || p.tile == 2)) {
    const int edge = 64 * p.tile, tiles_m = (M + edge - 1) / edge, tiles_n = (N + edge - 1) / edge;
    const int grid = grid_for(static_cast<long long>(tiles_m) * tiles_n * p.splits, max_blocks);
    if (p.tile == 2) {
      fma_tiled<Acc, OpA, OpB, 2, 2><<<grid, FMA_THREADS, 0, s>>>(a, b, K, ep, tiles_m, tiles_n,
                                                                   p.splits, p.kchunk, ws);
    } else {
      fma_tiled<Acc, OpA, OpB, 1, 1><<<grid, FMA_THREADS, 0, s>>>(a, b, K, ep, tiles_m, tiles_n,
                                                                   p.splits, p.kchunk, ws);
    }
  } else if (p.body == 1 && M <= p.tile && p.tile == 4) {
    launch_stream<Acc, OpA, OpB, 4>(a, b, N, K, ep, p, max_blocks, s);
  } else if (p.body == 1 && M <= p.tile && p.tile == 16) {
    launch_stream<Acc, OpA, OpB, 16>(a, b, N, K, ep, p, max_blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  return reduce_splits(ws, p.splits, ep, s);
}

Epilogue make_epilogue(const void* bias, const void* c, long long ldc, float alpha, float beta,
                       void* out, int out_dt, int act, int M, int N) {
  return Epilogue{nullptr, 0, alpha, beta, static_cast<const float*>(c), ldc,
                  static_cast<const float*>(bias), act, out, out_dt, M, N};
}

}  // namespace
