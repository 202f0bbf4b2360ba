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
// zeroed explicitly, `acc / l` at the end.
//
// Design. One block of 128 threads per (query-row tile, batch x KV head).
// The rows of a tile are (query, head) pairs with the `group` = H / Hkv
// query heads that share a KV head innermost, so every K / V tile a block
// loads serves the whole group: GQA reads K and V once per KV head, with no
// repeat in memory. The block walks only the KV tiles that the causal and
// window ranges of its rows can see (the reference walks every tile and
// masks); the tail past Skv is masked in the kernel and zero-filled in
// shared memory, nothing is padded in device memory. Head dims up to 256
// are zero-padded in shared memory to 16, 32, 64, 128 or 256.
//   - bf16 / f16: 64 rows a tile (16 per warp), 64 keys (32 at D > 128);
//     QK^T and PV on the tensor cores (mma.sync m16n8k16, f32 accumulate),
//     Q / K / V through ldmatrix from padded shared rows, K / V tiles double
//     buffered with cp.async. P is rounded to the input type for the PV
//     product (2^-9 relative a weight), as flash-attention kernels do.
//   - f32: 32 rows x 32 keys on the CUDA cores in full f32 (no TF32: the
//     reference accumulates f32 in f32), four threads a row.
// Scores are scaled by scale * log2(e) so that the weights are exp2f(s - m).
//
// What bounds it on an H100: prefill (Sq = Skv) the tensor-core multiply-
// adds, 4 * B * H * D per visible (query, key) pair over 989 TFLOP/s;
// decode (Sq = 1) the bytes of the visible K / V rows over 3.35 TB/s.
//
// Not yet: wgmma / TMA, split-KV for decode batches that fill few SMs,
// unmasked fast path for the tiles below the diagonal.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_common.cuh"

namespace {

constexpr int FA_THREADS = 128;
constexpr float FA_NEG = -1e30f;            // the reference's finite sentinel
constexpr float FA_LOG2E = 1.4426950408889634f;

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
  int vec;           // 16-byte loads: D, strides and pointers aligned
};

// The rows [t0, t0 + n) of a tile see the KV tiles [*j0, *j1) of width bkv.
__device__ __forceinline__ void visible_tiles(const FlashParams& p, long long t0, int n,
                                              int bkv, int* j0, int* j1) {
  const long long last = (t0 + n < p.rows ? t0 + n : p.rows) - 1;
  const long long shift = static_cast<long long>(p.Skv) - p.Sq;
  const long long qp_lo = t0 / p.group + shift, qp_hi = last / p.group + shift;
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

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores
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
  visible_tiles(p, t0, MMA_BQ, BKV, &j0, &j1);

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
  visible_tiles(p, t0, F32_BQ, F32_BKV, &j0, &j1);
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
int launch_mma(int dp, const FlashParams& p, cudaStream_t s) {
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

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v are read through their
// batch / sequence / head element strides (the head dim is contiguous); the
// output is a contiguous [B, Sq, H, D] of `dt` (0 f32, 1 bf16, 2 f16, the
// inputs' type); `window` applies where `has_window` is set. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int flash_attention_launch(const void* q, long long q_sb, long long q_ss,
                                      long long q_sh, const void* k, long long k_sb,
                                      long long k_ss, long long k_sh, const void* v,
                                      long long v_sb, long long v_ss, long long v_sh, void* o,
                                      int dt, int B, int Sq, int Skv, int H, int Hkv, int D,
                                      int causal, int has_window, long long window, float scale,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Skv < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p{q, q_sb, q_ss, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh, o,
                B, Sq, Skv, H, Hkv, D, H / Hkv, 0, causal != 0, has_window != 0,
                window, scale * FA_LOG2E, 0};
  p.rows = static_cast<long long>(Sq) * p.group;
  // The padded head dim; none above 256 (the switches' default refuses it).
  const int dp = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 0;
  // 16-byte cp.async for the 16-bit types where D, every stride and every
  // pointer allow it (the f32 kernel loads element by element).
  const long long strides[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  bool vec = dt != DT_F32 && D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (long long st : strides) vec = vec && st % 8 == 0;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case DT_F32: return launch_f32(dp, p, s);
    case DT_BF16: return launch_mma<__nv_bfloat16>(dp, p, s);
    case DT_F16: return launch_mma<__half>(dp, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
