// Device code shared by the port's GEMM kernels (gemm_packed_fused_a.cu,
// gemm_grouped_packed.cu and, through gemm_blocked.cuh, gemm_tiled.cu,
// gemm_packed.cu and gemm_vsx_like.cu): dtype codes, the activation table,
// the output store and the fused store epilogue, scalar element loads (int4 nibbles
// sign-extended, so -8 reads back), the mma.sync m16n8k16 / ldmatrix
// wrappers for bf16 and f16, and the widening of a 32-bit B word into
// 16-bit values for the tensor cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2, DT_I8 = 3, DT_I4 = 4, DT_I32 = 5 };
enum Variant { V_FMA = 0, V_MMA_DECODE = 1, V_MMA_PREFILL = 2 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.0f);
    case 2: {  // gelu, tanh approximation (jax.nn.gelu(approximate=True))
      const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
    }
    case 3: return x * (1.0f / (1.0f + expf(-x)));  // silu
    case 4: return tanhf(x);
    default: return x;
  }
}

__device__ __forceinline__ void store_out(void* out, long long i, float v, int dt) {
  switch (dt) {
    case DT_F32: static_cast<float*>(out)[i] = v; break;
    case DT_BF16: static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v); break;
    case DT_F16: static_cast<__half*>(out)[i] = __float2half(v); break;
    case DT_I32: static_cast<int*>(out)[i] = static_cast<int>(v); break;
    default: break;
  }
}

// The fused store epilogue of every GEMM kernel (finalize_gemm): col scale,
// alpha / beta * C, bias, activation, one store of the [M, N] output.
struct Epilogue {
  const float* scales;
  int scale_mode;  // 0 none, 1 per (Nb, Kb) tile, 2 per Nb column
  float alpha, beta;
  const float* C;
  long long ldc;
  const float* bias;
  int act;
  void* out;
  int out_dt;
  int M, N;

  // finalize_gemm: col scale, alpha/beta, bias, activation, one store.
  __device__ __forceinline__ void store(float v, int r, int gn, int j) const {
    if (r >= M || gn >= N) return;
    if (scale_mode == 2) v *= scales[j];
    v = alpha * v;
    if (C != nullptr && beta != 0.0f) v += beta * C[static_cast<long long>(r) * ldc + gn];
    if (bias != nullptr) v += bias[gn];
    store_out(out, static_cast<long long>(r) * N + gn, activate(v, act), out_dt);
  }
};

constexpr int FMA_THREADS = 256;  // a 16 x 16 grid of threads
constexpr int MAX_BM = 64;
constexpr int MAX_BN = 64;
constexpr int MAX_KC = 32;
constexpr int MAX_T = MAX_BM / 16;  // register tile edge (rows and columns)

template <typename Acc>
__device__ __forceinline__ Acc load_elem(const void* p, long long i, int dt) {
  switch (dt) {
    case DT_F32: return static_cast<Acc>(static_cast<const float*>(p)[i]);
    case DT_BF16:
      return static_cast<Acc>(__bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]));
    case DT_F16: return static_cast<Acc>(__half2float(static_cast<const __half*>(p)[i]));
    case DT_I8: return static_cast<Acc>(static_cast<const int8_t*>(p)[i]);
    default: return static_cast<Acc>(0);
  }
}

// One element of a B tile by its logical index inside the tile. For int4 the
// byte holds logical elements 2i (low nibble) and 2i+1 (high nibble); both
// are sign-extended, so -8 reads back.
template <typename Acc>
__device__ __forceinline__ Acc load_b(const char* tile, long long li, int dt) {
  if (dt == DT_I4) {
    const int8_t byte = reinterpret_cast<const int8_t*>(tile)[li >> 1];
    const int v = (li & 1) ? (static_cast<int>(byte) >> 4)
                           : (static_cast<int>(static_cast<int8_t>(byte << 4)) >> 4);
    return static_cast<Acc>(v);
  }
  return load_elem<Acc>(tile, li, dt);
}

constexpr int MMA_THREADS = 128;  // four warps

template <typename T> struct Half16;
template <> struct Half16<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) { return __float2bfloat16(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_bits(unsigned short b) { return __ushort_as_bfloat16(b); }
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Half16<__half> {
  static __device__ __forceinline__ __half from_float(float x) { return __float2half(x); }
  static __device__ __forceinline__ __half from_bits(unsigned short b) { return __ushort_as_half(b); }
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Four 8x8 b16 matrices from shared memory; lane l gives the row address of
// matrix l / 8, row l % 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// One 32-bit word of a B tile as n16 values of the activation type: two
// 16-bit values of that type, four int8, or eight int4 nibbles (element 2i
// low, 2i+1 high; sign-extended, so -8 reads back). Returns the count.
template <typename T>
__device__ __forceinline__ int widen_word(uint32_t w, int b_dt, T (&v)[8]) {
  if (b_dt == DT_I8) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = Half16<T>::from_float(static_cast<float>(static_cast<int8_t>(w >> (8 * i))));
    return 4;
  }
  if (b_dt == DT_I4) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int nib = static_cast<int>((w >> (4 * i)) & 0xFu);
      v[i] = Half16<T>::from_float(static_cast<float>((nib ^ 8) - 8));
    }
    return 8;
  }
  v[0] = Half16<T>::from_bits(static_cast<unsigned short>(w & 0xFFFFu));
  v[1] = Half16<T>::from_bits(static_cast<unsigned short>(w >> 16));
  return 2;
}

int elem_bytes(int dt) {
  switch (dt) {
    case DT_F32: case DT_I32: return 4;
    case DT_BF16: case DT_F16: return 2;
    default: return 1;
  }
}

bool valid_chunk(int v, int multiple_of, int most) {
  return v >= 16 && v <= most && v % 16 == 0 && multiple_of % v == 0;
}

}  // namespace
