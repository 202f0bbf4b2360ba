// flash_attention — blocked online-softmax attention over q [B, Sq, H, D] and
// k / v [B, Skv, Hkv, D], output [B, Sq, H, D] in q's type.
//
// Replaces the TPU Pallas kernel `flash_attention` (`_flash_kernel`,
// src/repro/kernels/flash_attention.py):
//
//   s   = (q . k) * scale                      in f32
//   keep  k_pos < Skv, causal q_pos >= k_pos, window q_pos - k_pos < window
//         (q_pos = i + Skv - Sq: queries are right-aligned with the keys)
//   out = sum_k softmax(s)_k v_k, and 0 for a row that sees no key
//
// with the online softmax of the reference: a running max (finite sentinel
// -1e30), a running denominator and an f32 accumulator, masked weights
// exactly 0, `acc / l` at the end. Scores are scaled by scale * log2(e) so
// that the weights are exp2f(s - m). In the 16-bit bodies P is rounded to
// the input type for the PV product (2^-9 relative a weight), as
// flash-attention kernels do; the denominator sums the unrounded weights.
//
// Four bodies; the wrapper picks one a call (`attention_body` in
// kernels/flash_attention.py) and passes its code:
//   - wgmma (bf16 / f16, q / k / v readable by TMA, D 64 or 128, more than
//     16 rows per (batch, KV head)): prefill. A block owns 128 queries of
//     ONE query head (a TMA box of consecutive positions; mixtral's group
//     of 6 divides no row tile), the longest row tiles first. One producer
//     warp brings Q once and K / V tiles of 128 keys through a ring of 4
//     (D 64) or 3 (D 128) stages, by TMA over 4-D maps of q / k / v as they
//     lie (rows past Sq and keys past Skv read as zeros); two consumer
//     warpgroups of 64 rows each run S = Q K^T as SS wgmma m64n128k16 (both
//     K-major), the online softmax on the accumulators, then O += P V as RS
//     wgmma m64n64k16: P stays in registers, since the S accumulator of
//     each n8 pair is exactly the A fragment of a k16 step (see the P
//     packing below), and V is read MN-major (transpose bit). The query
//     heads of a group re-read their K / V tiles from L2: the body is bound
//     by the tensor cores, not by HBM.
//   - stream (same operands, at most 16 rows per (batch, KV head)): decode.
//     A block owns the (query, head) rows of one (batch, KV head), group
//     innermost. One producer warp streams K / V tiles of 64 keys through a
//     ring of 4 stages; tile n goes to consumer warp n % 4, so every warp
//     works, each with its own m, l and O on mma.sync m16n8k16 (Q held as
//     A fragments in registers). The four partials are combined in shared
//     memory once, in warp order. Bound by HBM: 4 x 32 KB in flight a block
//     at D 128.
//   - mma_general (any other bf16 / f16: D not 64 / 128, a base or stride
//     off 16 bytes): 128 threads, 64 (query, head) rows x 64 keys (32 at
//     D > 128) a tile, mma.sync through ldmatrix from padded shared rows,
//     cp.async double buffering (element by element where D, a pointer or
//     a stride is off 16 bytes), head dims zero-padded to 16 ... 256.
//   - f32: 32 rows x 32 keys on the CUDA cores in full f32 (no TF32: the
//     reference accumulates f32 in f32), four threads a row.
// Every body walks only the KV tiles its rows can see (`visible_tiles`).
// The TMA bodies take a tile that every row sees whole (`interior_tile`)
// with no mask at all; the others (the diagonal, the window's lower edge,
// the Skv tail) are masked element by element by `sees`. Those two
// functions define the ranges for every body.
//
// What bounds it on an H100: prefill the tensor-core multiply-adds, 4 * B *
// H * D per visible (query, key) pair over 989 TFLOP/s; decode the bytes of
// the visible K / V rows over 3.35 TB/s. Per body: wgmma the tensor cores,
// with the softmax of a warpgroup serialised between its two products (the
// other warpgroup's products fill that gap) and 64 KB of K / V a 128-key
// tile read from L2 by every block; ptxas caps it at 168 registers a
// thread (nine warps share four register files). stream HBM, with four
// tiles (128 KB at D 128) in flight a block. mma_general and f32 keep the
// first port's tiles: 64 x 64 on mma.sync, and the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"

namespace {

constexpr int FA_THREADS = 128;
constexpr float FA_NEG = -1e30f;            // the reference's finite sentinel
constexpr float FA_LOG2E = 1.4426950408889634f;

// Body codes of the C entry point (kernels/flash_attention.py BODY).
enum FlashBody { FB_F32 = 0, FB_MMA_GENERAL = 1, FB_STREAM = 2, FB_WGMMA = 3 };

// Where the heads, sequence and batch dims of q, k or v sit in its 4-D
// tensor map (1-3, dim 0 being D): the map orders them by stride.
struct QkvMap { int pos_h, pos_s, pos_b; };

struct FlashParams {
  const void* q; long long q_sb, q_ss, q_sh;
  const void* k; long long k_sb, k_ss, k_sh;
  const void* v; long long v_sb, v_ss, v_sh;
  void* o;  // contiguous [B, Sq, H, D]
  int B, Sq, Skv, H, Hkv, D, group;
  long long rows;  // Sq * group rows per (batch, KV head)
  int causal, has_window;
  long long window;
  float scale_log2;  // scale * log2(e)
  int vec;           // mma_general: 16-byte loads (D, strides and pointers aligned)
  QkvMap qm, km, vm;  // the TMA bodies' maps
};

// The query positions [*qp_lo, *qp_hi] of the live rows among [t0, t0 + n)
// (row t is query t / group).
__device__ __forceinline__ void row_positions(const FlashParams& p, long long t0, int n,
                                              long long* qp_lo, long long* qp_hi) {
  const long long last = (t0 + n < p.rows ? t0 + n : p.rows) - 1;
  const long long shift = static_cast<long long>(p.Skv) - p.Sq;
  *qp_lo = t0 / p.group + shift;
  *qp_hi = last / p.group + shift;
}

// Rows at query positions [qp_lo, qp_hi] see the KV tiles [*j0, *j1) of
// width bkv (at most: the edge tiles are masked).
__device__ __forceinline__ void visible_tiles(const FlashParams& p, long long qp_lo,
                                              long long qp_hi, int bkv, int* j0, int* j1) {
  long long k_lo = 0, k_hi = static_cast<long long>(p.Skv) - 1;
  if (p.causal && qp_hi < k_hi) k_hi = qp_hi;
  if (p.has_window && qp_lo - p.window + 1 > k_lo) k_lo = qp_lo - p.window + 1;
  if (k_hi < k_lo) {
    *j0 = *j1 = 0;
  } else {
    *j0 = static_cast<int>(k_lo / bkv);
    *j1 = static_cast<int>(k_hi / bkv) + 1;
  }
}

// The position of row t's query (a row is a (query, head) pair).
__device__ __forceinline__ long long query_pos(const FlashParams& p, long long t) {
  return t / p.group + (static_cast<long long>(p.Skv) - p.Sq);
}

// Whether a row at q_pos (live: t < rows) sees key k_pos.
__device__ __forceinline__ bool sees(const FlashParams& p, bool live, long long q_pos,
                                     long long k_pos) {
  return live && k_pos < p.Skv && (!p.causal || q_pos >= k_pos) &&
         (!p.has_window || q_pos - k_pos < p.window);
}

// Whether every row at query positions [qp_lo, qp_hi] sees every key of
// [k0, k0 + n): the keys a row sees form a band (k < Skv, k <= q under
// causal, q - k < window), so its two far corners decide. Such an
// interior tile takes no mask; any other visible tile is an edge tile.
__device__ __forceinline__ bool interior_tile(const FlashParams& p, long long qp_lo,
                                              long long qp_hi, long long k0, int n) {
  return sees(p, true, qp_lo, k0 + n - 1) && sees(p, true, qp_hi, k0);
}

// Element offset of row t's query (or output) head in q's layout.
__device__ __forceinline__ long long q_offset(const FlashParams& p, int b, int hk, long long t,
                                              long long sb, long long ss, long long sh) {
  const long long i = t / p.group;
  const long long h = static_cast<long long>(hk) * p.group + t % p.group;
  return b * sb + i * ss + h * sh;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy `nrows` rows of `dp` elements into shared rows of `ld` elements,
// zero-filling columns >= D and rows for which src_row() returns nullptr.
// Vector path: 16-byte cp.async; else element by element.
template <typename T, typename RowFn>
__device__ __forceinline__ void load_rows(T* dst, int nrows, int dp, int ld, const FlashParams& p,
                                          RowFn src_row) {
  constexpr int VEC = 16 / sizeof(T);
  if (p.vec) {
    const int chunks = dp / VEC;
    for (int c = threadIdx.x; c < nrows * chunks; c += FA_THREADS) {
      const int r = c / chunks, col = (c % chunks) * VEC;
      const T* src = src_row(r);
      const bool ok = src != nullptr && col < p.D;
      cp_async16(dst + r * ld + col, ok ? src + col : static_cast<const T*>(p.q), ok);
    }
  } else {
    for (int c = threadIdx.x; c < nrows * dp; c += FA_THREADS) {
      const int r = c / dp, col = c % dp;
      const T* src = src_row(r);
      dst[r * ld + col] = (src != nullptr && col < p.D) ? src[col] : T(0.0f);
    }
  }
}

template <typename T> __device__ __forceinline__ unsigned pack2(float lo, float hi);
template <> __device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
template <> __device__ __forceinline__ unsigned pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One mma.sync m16n8k16 onto four accumulators of a flat array.
template <typename T>
__device__ __forceinline__ void mma_n8(float& d0, float& d1, float& d2, float& d3,
                                       const unsigned (&a)[4], unsigned b0, unsigned b1) {
  float d[4] = {d0, d1, d2, d3};
  Half16<T>::mma(d, a, b0, b1);
  d0 = d[0];
  d1 = d[1];
  d2 = d[2];
  d3 = d[3];
}

// ---------------------------------------------------------------------------
// bf16 / f16, any operands: mma.sync ("mma_general")
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;  // 4 warps x 16 rows

template <int DP> struct MmaTile { static constexpr int BKV = DP > 128 ? 32 : 64; };

template <int DP>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(MMA_BQ + 4 * MmaTile<DP>::BKV) * (DP + 8) * 2;
}

template <typename T, int DP>
__global__ void __launch_bounds__(FA_THREADS) flash_mma_kernel(FlashParams p) {
  constexpr int BKV = MmaTile<DP>::BKV;
  constexpr int LD = DP + 8;  // padded rows: ldmatrix without bank conflicts
  constexpr int NT = BKV / 8, DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + MMA_BQ * LD;      // [2][BKV][LD]
  T* vs = ks + 2 * BKV * LD;     // [2][BKV][LD]

  const int tiles = static_cast<int>((p.rows + MMA_BQ - 1) / MMA_BQ);
  const long long t0 = static_cast<long long>(tiles - 1 - blockIdx.x) * MMA_BQ;  // long first
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  int j0, j1;
  long long qp_lo, qp_hi;
  row_positions(p, t0, MMA_BQ, &qp_lo, &qp_hi);
  visible_tiles(p, qp_lo, qp_hi, BKV, &j0, &j1);

  load_rows<T>(qs, MMA_BQ, DP, LD, p, [&](int r) -> const T* {
    const long long t = t0 + r;
    return t < p.rows ? qg + q_offset(p, b, hk, t, p.q_sb, p.q_ss, p.q_sh) : nullptr;
  });
  auto load_kv = [&](int j, int buf) {
    const long long base = static_cast<long long>(j) * BKV;
    load_rows<T>(ks + buf * BKV * LD, BKV, DP, LD, p, [&](int r) -> const T* {
      const long long kp = base + r;
      return kp < p.Skv ? kg + b * p.k_sb + kp * p.k_ss + hk * p.k_sh : nullptr;
    });
    load_rows<T>(vs + buf * BKV * LD, BKV, DP, LD, p, [&](int r) -> const T* {
      const long long kp = base + r;
      return kp < p.Skv ? vg + b * p.v_sb + kp * p.v_ss + hk * p.v_sh : nullptr;
    });
  };
  if (j0 < j1) load_kv(j0, 0);
  cp_async_commit();

  const long long wrow = t0 + warp * 16;   // this warp's first row
  const bool live = wrow < p.rows;
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.0f, 0.0f};
  // This thread's two rows: lane/4 and lane/4 + 8 of the warp's 16.
  long long row_t[2], row_q[2];
  bool row_live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_t[h] = wrow + lane / 4 + 8 * h;
    row_live[h] = row_t[h] < p.rows;
    row_q[h] = query_pos(p, row_t[h]);
  }

  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < j1) {
      load_kv(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const T* kt = ks + buf * BKV * LD;
      const T* vt = vs + buf * BKV * LD;
      // S = Q K^T for this warp's 16 rows and the tile's BKV keys.
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, qs + (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + kk * 16 +
                           8 * (lane / 16));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bb[4];
          ldmatrix_x4(bb, kt + (np * 16 + (lane % 8) + 8 * (lane / 16)) * LD + kk * 16 +
                              8 * ((lane / 8) % 2));
          Half16<T>::mma(s[2 * np], a, bb[0], bb[1]);
          Half16<T>::mma(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      // Mask, online softmax. Element e of n-tile n: row lane/4 + 8*(e/2),
      // key j*BKV + n*8 + (lane%4)*2 + e%2.
      unsigned keep = 0;
      float mx[2] = {FA_NEG, FA_NEG};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long kp = static_cast<long long>(j) * BKV + n * 8 + (lane % 4) * 2 + e % 2;
          if (sees(p, row_live[e / 2], row_q[e / 2], kp)) {
            keep |= 1u << (n * 4 + e);
            s[n][e] *= p.scale_log2;
          } else {
            s[n][e] = FA_NEG;
          }
          mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = (keep >> (n * 4 + e)) & 1u ? exp2f(s[n][e] - m[e / 2]) : 0.0f;
          s[n][e] = pe;
          l[e / 2] += pe;
        }
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][0] *= alpha[0]; acc[d][1] *= alpha[0];
        acc[d][2] *= alpha[1]; acc[d][3] *= alpha[1];
      }
      // acc += P V: P's accumulator fragments are the A fragments of the
      // second product; V^T's fragments come from ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        unsigned a[4];
        a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          unsigned bb[4];
          ldmatrix_x4_trans(bb, vt + (kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD +
                                    dp * 16 + 8 * (lane / 16));
          Half16<T>::mma(acc[2 * dp], a, bb[0], bb[1]);
          Half16<T>::mma(acc[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // the next iteration refills the buffer just read
  }
  cp_async_wait<0>();  // a block that sees no key still issued Q's copies

  if (!live) return;
  T* og = static_cast<T*>(p.o);
  const long long o_ss = static_cast<long long>(p.H) * p.D;
  const long long o_sb = static_cast<long long>(p.Sq) * o_ss;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = quad_sum(l[h]);  // every lane shuffles, live row or not
    if (!row_live[h]) continue;
    const float inv = lsum == 0.0f ? 0.0f : 1.0f / lsum;  // no key seen -> 0
    T* orow = og + q_offset(p, b, hk, row_t[h], o_sb, o_ss, p.D);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = d * 8 + (lane % 4) * 2 + e;
        if (col < p.D) orow[col] = Half16<T>::from_float(acc[d][2 * h + e] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The TMA bodies' shared pieces
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// The box at head h, position s, batch b and head-dim columns [d0, d0 + 64)
// of a q / k / v map.
__device__ __forceinline__ void tma_load_qkv(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             const QkvMap& qm, int d0, int h, int s, int b) {
  auto at = [&](int dim) { return qm.pos_h == dim ? h : (qm.pos_s == dim ? s : b); };
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0), "r"(at(1)), "r"(at(2)),
      "r"(at(3))
      : "memory");
}

// Scales a tile's scores by scale * log2(e); an edge tile (not `interior`)
// also sets the scores its rows do not see to -inf, so that their weights
// come out exactly 0. Element e of n8 block nb: row `hrow` = (e % 4) / 2
// of the thread's two, key k0 + 8 * nb + 2 * (lane % 4) + e % 2. Returns
// the thread's max of each row.
template <int N>
__device__ __forceinline__ void scale_mask(const FlashParams& p, float (&s)[N], bool interior,
                                           long long k0, const bool (&live)[2],
                                           const long long (&qpos)[2], float (&mx)[2]) {
  const int lane = threadIdx.x % 32;
  mx[0] = mx[1] = FA_NEG;
  if (interior) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      s[e] *= p.scale_log2;
      mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], s[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int hrow = (e % 4) / 2;
      const long long kp = k0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
      s[e] = sees(p, live[hrow], qpos[hrow], kp) ? s[e] * p.scale_log2
                                                 : __int_as_float(0xff800000);  // -inf
      mx[hrow] = fmaxf(mx[hrow], s[e]);
    }
  }
}

// The online-softmax step on a tile's scaled scores: the running max m and
// denominator l of the thread's two rows move on, s becomes the weights
// exp2f(s - m) (0 where s is -inf), and the factor by which the rows'
// accumulators must shrink is returned in alpha.
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N], const float (&mx)[2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    s[e] = exp2f(s[e] - m[(e % 4) / 2]);
    l[(e % 4) / 2] += s[e];
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16 prefill: TMA + wgmma ("wgmma")
// ---------------------------------------------------------------------------

constexpr int WQ_ROWS = 128;     // queries a block: two consumer warpgroups of 64
constexpr int WQ_THREADS = 288;  // two consumer warpgroups, then one producer warp
constexpr int WQ_BKV = 128;      // keys a tile

template <int D> struct WqTile {
  static constexpr int BOXES = D / 64;                   // 64-column boxes of the head dim
  static constexpr int Q_BYTES = BOXES * WQ_ROWS * 128;
  static constexpr int KV_BYTES = BOXES * WQ_BKV * 128;  // K or V of one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int STAGES = D == 64 ? 4 : 3;         // as many as shared memory holds
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(WQ_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, FlashParams p) {
  using Tile = WqTile<D>;
  constexpr int BOXES = Tile::BOXES, STAGES = Tile::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qbar;
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;                    // [BOXES][WQ_ROWS rows][128 B]
  uint8_t* ring = smem + Tile::Q_BYTES;  // [STAGES][K boxes][V boxes], WQ_BKV rows each

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long heads = static_cast<long long>(p.B) * p.H;
  const int row_tiles = (p.Sq + WQ_ROWS - 1) / WQ_ROWS;
  const int bh = static_cast<int>(blockIdx.x % heads);
  const int i0 = (row_tiles - 1 - static_cast<int>(blockIdx.x / heads)) * WQ_ROWS;  // long first
  const int b = bh / p.H, h = bh % p.H, hk = h / p.group;
  const long long shift = static_cast<long long>(p.Skv) - p.Sq;
  int j0, j1;
  visible_tiles(p, i0 + shift, min(p.Sq, i0 + WQ_ROWS) - 1 + shift, WQ_BKV, &j0, &j1);
  const int steps = j1 - j0;  // KV tiles the block walks
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0 && steps > 0) {
      mbar_expect_tx(&qbar, Tile::Q_BYTES);
      for (int bx = 0; bx < BOXES; ++bx)
        tma_load_qkv(qs + bx * WQ_ROWS * 128, &tq, &qbar, p.qm, bx * 64, h, i0, b);
      for (int n = 0; n < steps; ++n) {
        const int stage = n % STAGES, key0 = (j0 + n) * WQ_BKV;
        mbar_wait(&empty[stage], ((n / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[stage], Tile::STAGE_BYTES);
        uint8_t* kv = ring + stage * Tile::STAGE_BYTES;
        for (int bx = 0; bx < BOXES; ++bx) {
          tma_load_qkv(kv + bx * WQ_BKV * 128, &tk, &full[stage], p.km, bx * 64, hk, key0, b);
          tma_load_qkv(kv + Tile::KV_BYTES + bx * WQ_BKV * 128, &tv, &full[stage], p.vm, bx * 64,
                       hk, key0, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: queries i0 + 64 wg + [0, 64); this thread's rows
  // wl*16 + lane/4 and + 8 of them.
  const int wg = warp / 4, wl = warp % 4;
  const int w_i0 = i0 + 64 * wg, w_end = min(p.Sq, w_i0 + 64);
  const long long w_lo = w_i0 + shift, w_hi = w_end - 1 + shift;
  int wj0 = 0, wj1 = 0;  // the tiles this warpgroup's rows see
  if (w_i0 < p.Sq) visible_tiles(p, w_lo, w_hi, WQ_BKV, &wj0, &wj1);
  const int r0 = w_i0 + wl * 16 + lane / 4;
  const bool live[2] = {r0 < p.Sq, r0 + 8 < p.Sq};
  const long long qpos[2] = {r0 + shift, r0 + 8 + shift};
  float o[BOXES][32];
#pragma unroll
  for (int bx = 0; bx < BOXES; ++bx)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[bx][e] = 0.0f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.0f, 0.0f};
  const uint8_t* qa = qs + wg * 64 * 128;  // this warpgroup's 64 rows of each Q box
  if (steps > 0) mbar_wait(&qbar, 0);

  for (int n = 0; n < steps; ++n) {
    const int stage = n % STAGES, j = j0 + n;
    mbar_wait(&full[stage], (n / STAGES) & 1);
    if (j >= wj0 && j < wj1) {
      const uint8_t* kb = ring + stage * Tile::STAGE_BYTES;
      const uint8_t* vb = kb + Tile::KV_BYTES;
      // S = Q K^T: 64 rows x 128 keys, k16 steps along the head dim (32
      // bytes along a K-major row of a 64-column box).
      float s[64];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint64_t da = sw128_desc(qa + (ks / 4) * WQ_ROWS * 128 + (ks % 4) * 32);
        const uint64_t db = sw128_desc(kb + (ks / 4) * WQ_BKV * 128 + (ks % 4) * 32);
        wgmma_m64n128k16<T, 0, 0>(s, da, db, ks > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      const long long k0 = static_cast<long long>(j) * WQ_BKV;
      float mx[2], alpha[2];
      scale_mask(p, s, interior_tile(p, w_lo, w_hi, k0, WQ_BKV), k0, live, qpos, mx);
      softmax_step(s, mx, m, l, alpha);
      // P as RS wgmma's A: the S accumulators of n8 blocks 2kk and 2kk + 1
      // (keys 16kk + 2*(lane%4) (+1) and + 8, rows lane/4 and + 8) are the
      // four registers of k16 step kk, rounded to the input type.
      unsigned pa[WQ_BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < WQ_BKV / 16; ++kk) {
        pa[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int bx = 0; bx < BOXES; ++bx)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[bx][e] *= alpha[(e % 4) / 2];
      // O += P V: V's box bx is MN-major (the head dim contiguous); k16
      // step kk is its rows 16kk onward.
#pragma unroll
      for (int bx = 0; bx < BOXES; ++bx) fence_regs(o[bx]);
#pragma unroll
      for (int kk = 0; kk < WQ_BKV / 16; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WQ_BKV / 16; ++kk)
#pragma unroll
        for (int bx = 0; bx < BOXES; ++bx)
          wgmma_m64n64k16_rs<T, 1>(o[bx], pa[kk],
                                   sw128_desc(vb + bx * WQ_BKV * 128 + kk * 16 * 128));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int bx = 0; bx < BOXES; ++bx) fence_regs(o[bx]);
#pragma unroll
      for (int kk = 0; kk < WQ_BKV / 16; ++kk) fence_regs(pa[kk]);
    }
    if (tid % 128 == 0) mbar_arrive(&empty[stage]);  // this warpgroup is done with the stage
  }

  if (w_i0 >= p.Sq) return;
  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float lsum = quad_sum(l[hr]);  // every lane shuffles, live row or not
    if (!live[hr]) continue;
    const float inv = lsum == 0.0f ? 0.0f : 1.0f / lsum;  // no key seen -> 0
    T* orow = og + ((static_cast<long long>(b) * p.Sq + r0 + 8 * hr) * p.H + h) * D;
#pragma unroll
    for (int bx = 0; bx < BOXES; ++bx)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int col = bx * 64 + nb * 8 + 2 * (lane % 4);
        *reinterpret_cast<unsigned*>(orow + col) =
            pack2<T>(o[bx][4 * nb + 2 * hr] * inv, o[bx][4 * nb + 2 * hr + 1] * inv);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16 decode: TMA ring + mma.sync ("stream")
// ---------------------------------------------------------------------------

constexpr int ST_ROWS = 16;                      // (query, head) rows: one m16 tile
constexpr int ST_WARPS = 4;                      // consumer warps
constexpr int ST_THREADS = 32 * (ST_WARPS + 1);  // then one producer warp
constexpr int ST_BKV = 64;                       // keys a tile
constexpr int ST_STAGES = 4;                     // tile n: slot n % 4, consumer warp n % 4

template <int D> struct StTile {
  static constexpr int BOXES = D / 64;
  static constexpr int Q_BYTES = BOXES * ST_ROWS * 128;
  static constexpr int KV_BYTES = BOXES * ST_BKV * 128;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int RED_LD = D + 4;  // floats a row of a warp's partial O
  static constexpr int SMEM = Q_BYTES + ST_STAGES * STAGE_BYTES + 1024;
  // The partials (O, m, l of each warp) reuse the ring once it is drained.
  static_assert(ST_WARPS * ST_ROWS * (RED_LD + 2) * 4 <= ST_STAGES * STAGE_BYTES, "combine");
};

template <typename T, int D>
__global__ void __launch_bounds__(ST_THREADS)
flash_stream_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, FlashParams p) {
  using Tile = StTile<D>;
  constexpr int BOXES = Tile::BOXES, LD = Tile::RED_LD;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[ST_STAGES], empty[ST_STAGES], qbar;
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;                    // [BOXES][16 rows][128 B]
  uint8_t* ring = smem + Tile::Q_BYTES;  // [ST_STAGES][K boxes][V boxes], ST_BKV rows each

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int rows = static_cast<int>(p.rows);
  long long qp_lo, qp_hi;
  row_positions(p, 0, ST_ROWS, &qp_lo, &qp_hi);
  int j0, j1;
  visible_tiles(p, qp_lo, qp_hi, ST_BKV, &j0, &j1);
  const int ntiles = j1 - j0;
  if (tid == 0) {
    for (int s = 0; s < ST_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);  // the slot's one consumer warp
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // TMA writes Q's rows [0, rows); the rows past them read as zeros.
  for (int i = tid; i < BOXES * (ST_ROWS - rows) * 32; i += ST_THREADS) {
    const int bx = i / ((ST_ROWS - rows) * 32), w = i % ((ST_ROWS - rows) * 32);
    reinterpret_cast<uint32_t*>(qs + bx * ST_ROWS * 128 + rows * 128)[w] = 0u;
  }
  __syncthreads();

  if (warp == ST_WARPS) {  // producer
    if (lane == 0 && ntiles > 0) {
      mbar_expect_tx(&qbar, BOXES * rows * 128);
      for (int bx = 0; bx < BOXES; ++bx)
        tma_load_qkv(qs + bx * ST_ROWS * 128, &tq, &qbar, p.qm, bx * 64, hk * p.group, 0, b);
      for (int n = 0; n < ntiles; ++n) {
        const int slot = n % ST_STAGES, key0 = (j0 + n) * ST_BKV;
        mbar_wait(&empty[slot], ((n / ST_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[slot], Tile::STAGE_BYTES);
        uint8_t* kv = ring + slot * Tile::STAGE_BYTES;
        for (int bx = 0; bx < BOXES; ++bx) {
          tma_load_qkv(kv + bx * ST_BKV * 128, &tk, &full[slot], p.km, bx * 64, hk, key0, b);
          tma_load_qkv(kv + Tile::KV_BYTES + bx * ST_BKV * 128, &tv, &full[slot], p.vm, bx * 64,
                       hk, key0, b);
        }
      }
    }
    return;
  }

  // Consumer warp: rows lane/4 and + 8 of the 16.
  bool live[2];
  long long qpos[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    live[hr] = lane / 4 + 8 * hr < rows;
    qpos[hr] = query_pos(p, lane / 4 + 8 * hr);
  }
  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.0f, 0.0f};
  unsigned qf[D / 16][4];  // Q as A fragments, once
  if (ntiles > 0) {
    mbar_wait(&qbar, 0);
    // Row t = i * group + hh of the box, or hh * Sq + i where the map
    // orders the sequence dim inside the heads (rows past `rows` are zero).
    const int t = lane % 16;
    const int srow =
        (t >= rows || p.qm.pos_h < p.qm.pos_s) ? t : (t % p.group) * p.Sq + t / p.group;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      ldmatrix_x4(qf[ks], sw128(qs + (ks / 4) * ST_ROWS * 128, srow, (ks % 4) * 2 + lane / 16));
  }

  for (int n = warp; n < ntiles; n += ST_WARPS) {
    const int slot = n % ST_STAGES;
    mbar_wait(&full[slot], (n / ST_STAGES) & 1);
    const uint8_t* kb = ring + slot * Tile::STAGE_BYTES;
    const uint8_t* vb = kb + Tile::KV_BYTES;
    const int mat = lane / 8;
    // S = Q K^T, K's boxes K-major (keys are rows).
    float s[ST_BKV / 2];  // element e: n8 block e / 4, as the wgmma accumulators
#pragma unroll
    for (int e = 0; e < ST_BKV / 2; ++e) s[e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int pp = 0; pp < ST_BKV / 16; ++pp) {
        unsigned bf[4];
        ldmatrix_x4(bf, sw128(kb + (ks / 4) * ST_BKV * 128, pp * 16 + (mat / 2) * 8 + lane % 8,
                              (ks % 4) * 2 + mat % 2));
        mma_n8<T>(s[8 * pp], s[8 * pp + 1], s[8 * pp + 2], s[8 * pp + 3], qf[ks], bf[0], bf[1]);
        mma_n8<T>(s[8 * pp + 4], s[8 * pp + 5], s[8 * pp + 6], s[8 * pp + 7], qf[ks], bf[2],
                  bf[3]);
      }
    const long long k0 = static_cast<long long>(j0 + n) * ST_BKV;
    float mx[2], alpha[2];
    scale_mask(p, s, interior_tile(p, qp_lo, qp_hi, k0, ST_BKV), k0, live, qpos, mx);
    softmax_step(s, mx, m, l, alpha);
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      o[d][0] *= alpha[0]; o[d][1] *= alpha[0];
      o[d][2] *= alpha[1]; o[d][3] *= alpha[1];
    }
    // O += P V: V's boxes MN-major, through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < ST_BKV / 16; ++kk) {
      unsigned a[4];
      a[0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
      a[1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
      a[2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
      a[3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned bf[4];
        ldmatrix_x4_trans(bf, sw128(vb + (dp / 4) * ST_BKV * 128,
                                    kk * 16 + (mat % 2) * 8 + lane % 8, (dp % 4) * 2 + mat / 2));
        Half16<T>::mma(o[2 * dp], a, bf[0], bf[1]);
        Half16<T>::mma(o[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // Combine the warps' partials in warp order: shared memory past Q (the
  // ring, drained once every consumer warp is here) holds each warp's O, m
  // and l.
  const float lq[2] = {quad_sum(l[0]), quad_sum(l[1])};
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * ST_WARPS) : "memory");
  float* red_o = reinterpret_cast<float*>(ring);      // [ST_WARPS][16][LD]
  float* red_m = red_o + ST_WARPS * ST_ROWS * LD;     // [ST_WARPS][16]
  float* red_l = red_m + ST_WARPS * ST_ROWS;          // [ST_WARPS][16]
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red_o[(warp * ST_ROWS + lane / 4 + 8 * (e / 2)) * LD + 8 * d + 2 * (lane % 4) + e % 2] =
          o[d][e];
  if (lane % 4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      red_m[warp * ST_ROWS + lane / 4 + 8 * hr] = m[hr];
      red_l[warp * ST_ROWS + lane / 4 + 8 * hr] = lq[hr];
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * ST_WARPS) : "memory");
  T* og = static_cast<T*>(p.o);
  const long long o_ss = static_cast<long long>(p.H) * D;
  const long long o_sb = static_cast<long long>(p.Sq) * o_ss;
  for (int idx = tid; idx < rows * D; idx += 32 * ST_WARPS) {
    const int r = idx / D, c = idx % D;
    float mm = FA_NEG, ll = 0.0f, oo = 0.0f;
    for (int w = 0; w < ST_WARPS; ++w) {
      const float mw = red_m[w * ST_ROWS + r], mn = fmaxf(mm, mw);
      const float a = exp2f(mm - mn), bw = exp2f(mw - mn);
      ll = ll * a + red_l[w * ST_ROWS + r] * bw;
      oo = oo * a + red_o[(w * ST_ROWS + r) * LD + c] * bw;
      mm = mn;
    }
    const float inv = ll == 0.0f ? 0.0f : 1.0f / ll;  // no key seen -> 0
    og[q_offset(p, b, hk, r, o_sb, o_ss, D) + c] = Half16<T>::from_float(oo * inv);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full f32
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 32, F32_BKV = 32;  // 4 threads a row

template <int DP>
constexpr size_t f32_smem_bytes() {
  return (static_cast<size_t>(F32_BQ + 2 * F32_BKV) * (DP + 1) + F32_BQ * (F32_BKV + 1)) * 4;
}

template <int DP>
__global__ void __launch_bounds__(FA_THREADS) flash_f32_kernel(FlashParams p) {
  constexpr int LD = DP + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + F32_BQ * LD;
  float* vs = ks + F32_BKV * LD;
  float* ps = vs + F32_BKV * LD;  // [F32_BQ][F32_BKV + 1]

  const int tiles = static_cast<int>((p.rows + F32_BQ - 1) / F32_BQ);
  const long long t0 = static_cast<long long>(tiles - 1 - blockIdx.x) * F32_BQ;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4;
  const long long t = t0 + r;
  const bool live = t < p.rows;
  const long long q_pos = query_pos(p, t);
  const float* qg = static_cast<const float*>(p.q);
  const float* kg = static_cast<const float*>(p.k);
  const float* vg = static_cast<const float*>(p.v);
  int j0, j1;
  long long qp_lo, qp_hi;
  row_positions(p, t0, F32_BQ, &qp_lo, &qp_hi);
  visible_tiles(p, qp_lo, qp_hi, F32_BKV, &j0, &j1);
  load_rows<float>(qs, F32_BQ, DP, LD, p, [&](int rr) -> const float* {
    const long long tt = t0 + rr;
    return tt < p.rows ? qg + q_offset(p, b, hk, tt, p.q_sb, p.q_ss, p.q_sh) : nullptr;
  });

  float acc[DP / 4];
#pragma unroll
  for (int d = 0; d < DP / 4; ++d) acc[d] = 0.0f;
  float m = FA_NEG, l = 0.0f;

  for (int j = j0; j < j1; ++j) {
    const long long base = static_cast<long long>(j) * F32_BKV;
    __syncthreads();
    load_rows<float>(ks, F32_BKV, DP, LD, p, [&](int rr) -> const float* {
      const long long kp = base + rr;
      return kp < p.Skv ? kg + b * p.k_sb + kp * p.k_ss + hk * p.k_sh : nullptr;
    });
    load_rows<float>(vs, F32_BKV, DP, LD, p, [&](int rr) -> const float* {
      const long long kp = base + rr;
      return kp < p.Skv ? vg + b * p.v_sb + kp * p.v_ss + hk * p.v_sh : nullptr;
    });
    __syncthreads();
    float s[F32_BKV / 4];
    float mx = FA_NEG;
#pragma unroll
    for (int i = 0; i < F32_BKV / 4; ++i) {
      const int kk = c + 4 * i;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) dot = fmaf(qs[r * LD + d], ks[kk * LD + d], dot);
      s[i] = sees(p, live, q_pos, base + kk) ? dot * p.scale_log2 : FA_NEG;
      mx = fmaxf(mx, s[i]);
    }
    const float m_new = fmaxf(m, quad_max(mx));
    const float alpha = exp2f(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < F32_BKV / 4; ++i) {
      const int kk = c + 4 * i;
      const float pe = sees(p, live, q_pos, base + kk) ? exp2f(s[i] - m) : 0.0f;
      l += pe;
      ps[r * (F32_BKV + 1) + kk] = pe;
    }
    __syncwarp();  // the row's four threads are one quad of one warp
#pragma unroll
    for (int d = 0; d < DP / 4; ++d) acc[d] *= alpha;
    for (int kk = 0; kk < F32_BKV; ++kk) {
      const float pe = ps[r * (F32_BKV + 1) + kk];
#pragma unroll
      for (int d = 0; d < DP / 4; ++d) acc[d] = fmaf(pe, vs[kk * LD + c + 4 * d], acc[d]);
    }
  }

  const float lsum = quad_sum(l);
  if (!live) return;
  const float inv = lsum == 0.0f ? 0.0f : 1.0f / lsum;  // no key seen -> 0
  const long long o_ss = static_cast<long long>(p.H) * p.D;
  float* orow = static_cast<float*>(p.o) +
                q_offset(p, b, hk, t, static_cast<long long>(p.Sq) * o_ss, o_ss, p.D);
#pragma unroll
  for (int d = 0; d < DP / 4; ++d) {
    const int col = c + 4 * d;
    if (col < p.D) orow[col] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int rows_per_tile, const FlashParams& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (p.rows + rows_per_tile - 1) / rows_per_tile;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // B * Hkv on grid y: the wrapper keeps it within 65535.
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(p.B * p.Hkv)), FA_THREADS,
           smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mma_general(int dp, const FlashParams& p, cudaStream_t s) {
  switch (dp) {
    case 16: return launch(flash_mma_kernel<T, 16>, mma_smem_bytes<16>(), MMA_BQ, p, s);
    case 32: return launch(flash_mma_kernel<T, 32>, mma_smem_bytes<32>(), MMA_BQ, p, s);
    case 64: return launch(flash_mma_kernel<T, 64>, mma_smem_bytes<64>(), MMA_BQ, p, s);
    case 128: return launch(flash_mma_kernel<T, 128>, mma_smem_bytes<128>(), MMA_BQ, p, s);
    case 256: return launch(flash_mma_kernel<T, 256>, mma_smem_bytes<256>(), MMA_BQ, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_f32(int dp, const FlashParams& p, cudaStream_t s) {
  switch (dp) {
    case 16: return launch(flash_f32_kernel<16>, f32_smem_bytes<16>(), F32_BQ, p, s);
    case 32: return launch(flash_f32_kernel<32>, f32_smem_bytes<32>(), F32_BQ, p, s);
    case 64: return launch(flash_f32_kernel<64>, f32_smem_bytes<64>(), F32_BQ, p, s);
    case 128: return launch(flash_f32_kernel<128>, f32_smem_bytes<128>(), F32_BQ, p, s);
    case 256: return launch(flash_f32_kernel<256>, f32_smem_bytes<256>(), F32_BQ, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k or v [batch, seq, heads, D] of 16-bit elements as a 4-D map: D (64
// a box, 128-byte swizzle) first, then the other three dims ordered by
// element stride (a stable sort), so that a transposed view is read as it
// lies. Boxes are box_h heads by box_s positions of one batch entry; rows
// and keys past the extents read as zeros. `qm` says where each dim went.
bool make_qkv_map(CUtensorMap* map, QkvMap* qm, const void* ptr, int dt, int D, int heads,
                  int seq, int batch, long long sh, long long ss, long long sb, int box_h,
                  int box_s) {
  EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const long long stride[3] = {sh, ss, sb};
  const int extent[3] = {heads, seq, batch}, box[3] = {box_h, box_s, 1};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i) {
    for (int j = i; j > 0 && stride[order[j - 1]] > stride[order[j]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0}, strides[3];
  cuuint32_t boxes[4] = {BOX, 0, 0, 0};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  int pos[3];
  for (int q = 0; q < 3; ++q) {
    dims[q + 1] = static_cast<cuuint64_t>(extent[order[q]]);
    strides[q] = static_cast<cuuint64_t>(stride[order[q]] * 2);
    boxes[q + 1] = static_cast<cuuint32_t>(box[order[q]]);
    pos[order[q]] = q + 1;
  }
  *qm = QkvMap{pos[0], pos[1], pos[2]};
  return enc(map, dt == DT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
             4, const_cast<void*>(ptr), dims, strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
int launch_tma(Kernel kernel, int smem, long long blocks, int threads, const CUtensorMap& tq,
               const CUtensorMap& tk, const CUtensorMap& tv, const FlashParams& p,
               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma (prefill) or stream (decode) body: maps over q / k / v as they
// lie, Q boxes of 128 positions of one head (wgmma) or of the group's
// heads at every position (stream, at most 16 rows).
template <typename T>
int launch_tma_body(int body, FlashParams& p, int dt, cudaStream_t s) {
  const bool stream = body == FB_STREAM;
  CUtensorMap tq, tk, tv;
  const int qbox_h = stream ? p.group : 1, qbox_s = stream ? p.Sq : WQ_ROWS;
  const int kv_rows = stream ? ST_BKV : WQ_BKV;
  if (!make_qkv_map(&tq, &p.qm, p.q, dt, p.D, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, qbox_h,
                    qbox_s) ||
      !make_qkv_map(&tk, &p.km, p.k, dt, p.D, p.Hkv, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb, 1,
                    kv_rows) ||
      !make_qkv_map(&tv, &p.vm, p.v, dt, p.D, p.Hkv, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb, 1,
                    kv_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (stream) {
    const long long blocks = static_cast<long long>(p.B) * p.Hkv;
    return p.D == 64
               ? launch_tma(flash_stream_kernel<T, 64>, StTile<64>::SMEM, blocks, ST_THREADS, tq,
                            tk, tv, p, s)
               : launch_tma(flash_stream_kernel<T, 128>, StTile<128>::SMEM, blocks, ST_THREADS,
                            tq, tk, tv, p, s);
  }
  const long long blocks =
      static_cast<long long>((p.Sq + WQ_ROWS - 1) / WQ_ROWS) * p.B * p.H;
  return p.D == 64 ? launch_tma(flash_wgmma_kernel<T, 64>, WqTile<64>::SMEM, blocks, WQ_THREADS,
                                tq, tk, tv, p, s)
                   : launch_tma(flash_wgmma_kernel<T, 128>, WqTile<128>::SMEM, blocks,
                                WQ_THREADS, tq, tk, tv, p, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v are read through their
// batch / sequence / head element strides (the head dim is contiguous); the
// output is a contiguous [B, Sq, H, D] of `dt` (0 f32, 1 bf16, 2 f16, the
// inputs' type); `window` applies where `has_window` is set. `body` is the
// body to run (enum FlashBody), as the wrapper's route picked it; one that
// does not take these operands is refused. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int flash_attention_launch(const void* q, long long q_sb, long long q_ss,
                                      long long q_sh, const void* k, long long k_sb,
                                      long long k_ss, long long k_sh, const void* v,
                                      long long v_sb, long long v_ss, long long v_sh, void* o,
                                      int dt, int B, int Sq, int Skv, int H, int Hkv, int D,
                                      int causal, int has_window, long long window, float scale,
                                      int body, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p{q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh, o,
                B, Sq, Skv, H, Hkv, D, H / Hkv, 0, causal != 0, has_window != 0,
                window, scale * FA_LOG2E, 0, QkvMap{}, QkvMap{}, QkvMap{}};
  p.rows = static_cast<long long>(Sq) * p.group;
  // The padded head dim; none above 256 (the switches' default refuses it).
  const int dp = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 0;
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  bool aligned = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (long long st : strides) aligned = aligned && st % 8 == 0;
  const bool half = dt == DT_BF16 || dt == DT_F16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case FB_F32:
      if (dt != DT_F32) break;
      return launch_f32(dp, p, s);
    case FB_MMA_GENERAL:
      if (!half) break;
      p.vec = aligned;  // 16-byte cp.async where D, every stride and pointer allow it
      return dt == DT_BF16 ? launch_mma_general<__nv_bfloat16>(dp, p, s)
                           : launch_mma_general<__half>(dp, p, s);
    case FB_STREAM:
    case FB_WGMMA: {
      bool positive = true;
      for (long long st : strides) positive = positive && st > 0;
      if (!half || !aligned || !positive || (D != 64 && D != 128) || Skv == 0) break;
      if ((body == FB_STREAM) != (p.rows <= ST_ROWS)) break;
      return dt == DT_BF16 ? launch_tma_body<__nv_bfloat16>(body, p, dt, s)
                           : launch_tma_body<__half>(body, p, dt, s);
    }
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
