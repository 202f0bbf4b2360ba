// Tensor-core bodies for bf16 / f16 on Hopper, shared by gemm_packed.cu
// (K6: A and B packed), gemm_packed_fused_a.cu (K1: natural A, packed B)
// and gemm_tiled.cu (K7: natural A and natural B): boxes brought to shared
// memory by TMA, read by wgmma (more than 16 rows) or by ldmatrix +
// mma.sync (decode).
// gemm_grouped_packed.cu (K2 / K3) builds its grouped bodies from the same
// tensor maps, ring primitives and wgmma wrappers.
//
// A packed stack is one 2-D row-major tensor: "row" A [Mb*Kb*bm, bk] (tile
// (i, kk) is rows (i*Kb + kk)*bm onward), "col" A [Mb*Kb*bk, bm], "row" B
// [Nb*Kb*bk, bn], "col" B [Nb*Kb*bn, bk]. Natural A is the 2-D tensor
// [M, K] with its own row stride (lda): its boxes are K-major, and rows
// past M and columns past K read as zeros, so ragged edges need no mask. A
// TMA box is 64 elements (128 bytes) of the contiguous axis by up to 64
// rows, stored with the 128-byte swizzle; boxes past the tensor read as
// zeros. A tile whose contiguous axis is k is "K-major" for wgmma, the
// other "MN-major": wgmma's transpose bits take both, so no tile is
// transposed in software. Where A's and B's boxes come from are the
// bodies' `ASrc` and `BSrc` template parameters: PackedA / PackedB for K6,
// NaturalA / PackedB for K1, NaturalA / NaturalB for K7. Natural B is a
// 2-D map over the raw [K, N] weight (N wide, MN-major boxes) or, for a
// transposed view such as the LM head's table.t(), over the [N, K] matrix
// it views (K wide, K-major boxes); its "bk" is one 64-deep box.
//
//  * wgmma_packed: a 128 x 128 output tile (2 x 2 packed 64 x 64 tiles) a
//    block, a ring of WG_STAGES stages of one 64-deep k-box each (two A and
//    two B boxes, 32 KB), one producer warp issuing TMA and two consumer
//    warpgroups each running m64n64k16 wgmma on its A tile against both B
//    tiles, one wgmma group in flight; full / empty mbarriers between them. Blocks walk the output tiles
//    (tile += gridDim.x), so the next tile's loads overlap this one's
//    stores; a grid of one block walks them all.
//  * mma_stream: decode (bm = 16). A block streams the B tiles of one
//    64-column stripe over a chunk of Kb (split-K, partials reduced by
//    splitk_reduce in a fixed order) through a ring of TS_STAGES boxes; its
//    four warps take the four k16 steps of a box with mma.sync m16n8k16.
//    Blocks walk the (split, stripe) items, the ring's positions carried
//    from one item to the next.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include <type_traits>

#include "gemm_blocked.cuh"

namespace {

enum TcVariant { V_WGMMA = 3, V_TC_STREAM = 4 };
constexpr int WG_STAGES = 4, TS_STAGES = 4;
constexpr int BOX = 64;  // elements of a box's contiguous axis (128 bytes)

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The 2-D row-major view [rows, cols] of 16-bit elements, `row_elems`
// elements from one row to the next (0: cols), boxes of `box_rows` x 64.
bool make_tensor_map(CUtensorMap* map, const void* p, int dt, long long rows, long long cols,
                     int box_rows, long long row_elems = 0) {
  EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>((row_elems ? row_elems : cols) * 2)};
  const cuuint32_t box[2] = {BOX, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, dt == DT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
             2, const_cast<void*>(p), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA takes 16-byte aligned global addresses.
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
// A wait of more than about ten seconds traps: a broken ring faults the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Box (c0, c1) = (column, row) of k-box `kbox` of tile `t` (= i*Kb + kk) in
// a stack whose tiles are `t_mn` x bk: K-major tiles are [t_mn][bk] rows of
// the view, MN-major ones [bk][t_mn] (t_mn = 64, one box wide).
__device__ __forceinline__ void box_of(bool mn_major, int t, int kbox, int t_mn, int bk, int& c0,
                                       int& c1) {
  if (mn_major) {
    c0 = 0;
    c1 = t * bk + kbox * BOX;
  } else {
    c0 = kbox * BOX;
    c1 = t * t_mn;
  }
}

// Where the A boxes of a work item come from: box (c0, c1) of k-box `kbox`
// of packed k-tile `kk` of A's m-tile `i` (`t_mn` rows).
template <bool MN>
struct PackedA {  // a packed stack: tile (i, kk) is tile i*Kb + kk of the view
  static constexpr bool mn_major = MN;
  static __device__ __forceinline__ void box(int i, int kk, int kbox, int Kb, int t_mn, int bk,
                                             int& c0, int& c1) {
    box_of(MN, i * Kb + kk, kbox, t_mn, bk, c0, c1);
  }
};

struct NaturalA {  // row-major [M, K]: a box is t_mn rows by 64 k
  static constexpr bool mn_major = false;
  static __device__ __forceinline__ void box(int i, int kk, int kbox, int Kb, int t_mn, int bk,
                                             int& c0, int& c1) {
    c0 = kk * bk + kbox * BOX;
    c1 = i * t_mn;
  }
};

// Where the B boxes of a work item come from: box (c0, c1) of k-box `kbox`
// of k-tile `kk` (bk deep) of B's 64-column stripe `j`.
template <bool MN>
struct PackedB {  // a packed stack: tile (j, kk) is tile j*Kb + kk of the view
  static constexpr bool mn_major = MN;
  static __device__ __forceinline__ void box(int j, int kk, int kbox, int Kb, int bk, int& c0,
                                             int& c1) {
    box_of(MN, j * Kb + kk, kbox, BOX, bk, c0, c1);
  }
};

template <bool MN>
struct NaturalB {  // MN: the map is B [K, N] itself; else the [N, K] matrix B views
  static constexpr bool mn_major = MN;
  static __device__ __forceinline__ void box(int j, int kk, int kbox, int Kb, int bk, int& c0,
                                             int& c1) {
    const int k0 = kk * bk + kbox * BOX, n0 = j * BOX;
    c0 = MN ? n0 : k0;
    c1 = MN ? k0 : n0;
  }
};

// The 2-D view of a packed B stack of Nb x Kb tiles: "row" tiles are
// [bk][bn] (MN-major), "col" [bn][bk] (K-major).
bool make_packed_b_map(CUtensorMap* map, const void* b, int dt, int b_col, int Nb, int Kb, int bk,
                       int bn) {
  return b_col ? make_tensor_map(map, b, dt, 1LL * Nb * Kb * bn, bk, BOX)
               : make_tensor_map(map, b, dt, 1LL * Nb * Kb * bk, bn, BOX);
}

// k-boxes a work item walks: `ktiles` packed tiles of bk.
__device__ __forceinline__ int ring_steps(int ktiles, int bk) { return ktiles * (bk / BOX); }

// wgmma shared-memory descriptor of a 128-byte-swizzled box (1024-byte
// aligned): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  uint64_t d = static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(64) << 16;  // leading byte offset (1024 B)
  d |= static_cast<uint64_t>(64) << 32;  // stride byte offset (1024 B)
  d |= static_cast<uint64_t>(1) << 62;   // 128-byte swizzle
  return d;
}

// Byte offset of k16 step `ks` inside a box: 32 bytes along a K-major row,
// 16 rows of 128 bytes in an MN-major box.
__device__ __forceinline__ int kstep_bytes(bool mn_major, int ks) {
  return mn_major ? ks * 16 * 128 : ks * 32;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// wgmma writes the accumulators asynchronously: this keeps the compiler
// from moving any read or write of them across the point it marks.
__device__ __forceinline__ void fence_acc(float (&d)[2][32]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(d[h][e])::"memory");
}

#define WG_ACC32(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define WG_MMA_ASM(TYPE)                                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "        \
  "%32, %33, p, 1, 1, %35, %36;\n}\n"

// D[64 x 64] += A[64 x 16] B[16 x 64], both from shared memory.
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(WG_MMA_ASM("bf16") : WG_ACC32(d) : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else {
    asm volatile(WG_MMA_ASM("f16") : WG_ACC32(d) : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
}

#define WG_ACC8(d, o)                                                                          \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]),   \
      "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_ACC64(d)                                                                            \
  WG_ACC32(d), WG_ACC8(d, 32), WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)

#define WG_MMA128_ASM(TYPE)                                                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                               \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "        \
  "%64, %65, p, 1, 1, %67, %68;\n}\n"

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory; D is
// overwritten where scale_d is 0. Accumulator element e: n8 block e / 4,
// row lane/4 (+8 for e % 4 >= 2) of the warp's 16, column 2*(lane%4) + e%2.
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(WG_MMA128_ASM("bf16")
                 : WG_ACC64(d) : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(WG_MMA128_ASM("f16")
                 : WG_ACC64(d) : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

#define WG_MMA_RS_ASM(TYPE)                                                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " "                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "        \
  "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"

// D[64 x 64] += A[64 x 16] B[16 x 64] with A from registers (RS): each
// warp of the warpgroup holds its 16 rows as mma.sync m16n8k16's A
// fragment (a[0] row lane/4, columns 2*(lane%4) and +1; a[1] the row + 8;
// a[2] / a[3] the same 8 columns on), B from shared memory.
template <typename T, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const unsigned (&a)[4],
                                                   uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(WG_MMA_RS_ASM("bf16")
                 : WG_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  } else {
    asm volatile(WG_MMA_RS_ASM("f16")
                 : WG_ACC32(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
}

// fence_acc for any register array the asynchronous wgmma reads or writes.
template <typename R, int N>
__device__ __forceinline__ void fence_regs(R (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if constexpr (std::is_same<R, float>::value) {
      asm volatile("" : "+f"(d[e])::"memory");
    } else {
      asm volatile("" : "+r"(d[e])::"memory");
    }
  }
}

constexpr int WG_THREADS = 288;  // two consumer warpgroups, then one producer warp
constexpr int WG_BOX_BYTES = BOX * BOX * 2;
constexpr int WG_STAGE_BYTES = 4 * WG_BOX_BYTES;  // A tiles 2i, 2i+1; B tiles 2j, 2j+1
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024;

template <typename T, class ASrc, class BSrc>
__global__ void __launch_bounds__(WG_THREADS)
wgmma_packed(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
             int Kb, int bk, int tiles_m, int tiles_n, Epilogue ep) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles = tiles_m * tiles_n, steps = ring_steps(Kb, bk), nbox = bk / BOX;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int i0 = 2 * (tile / tiles_n), j0 = 2 * (tile % tiles_n);
        for (int st = 0; st < steps; ++st) {
          const int kk = st / nbox, kbox = st - kk * nbox;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], WG_STAGE_BYTES);
          uint8_t* base = smem + stage * WG_STAGE_BYTES;
          for (int h = 0; h < 2; ++h) {
            int c0, c1;
            ASrc::box(i0 + h, kk, kbox, Kb, BOX, bk, c0, c1);
            tma_load(base + h * WG_BOX_BYTES, &ta, &full[stage], c0, c1);
            BSrc::box(j0 + h, kk, kbox, Kb, bk, c0, c1);
            tma_load(base + (2 + h) * WG_BOX_BYTES, &tb, &full[stage], c0, c1);
          }
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: A tile 2i + wg against B tiles 2j, 2j + 1
    const int wg = warp / 4, wl = warp % 4;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tm = tile / tiles_n, tn = tile % tiles_n;
      float acc[2][32];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[h][e] = 0.0f;
      // One wgmma group stays in flight: a stage is released once the
      // group after it has been issued and its own group has completed.
      int held = -1;
      for (int st = 0; st < steps; ++st) {
        mbar_wait(&full[stage], phase);
        const uint8_t* base = smem + stage * WG_STAGE_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BOX / 16; ++ks) {
          const uint64_t da =
              sw128_desc(base + wg * WG_BOX_BYTES + kstep_bytes(ASrc::mn_major, ks));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint64_t db =
                sw128_desc(base + (2 + h) * WG_BOX_BYTES + kstep_bytes(BSrc::mn_major, ks));
            wgmma_m64n64k16<T, ASrc::mn_major ? 1 : 0, BSrc::mn_major ? 1 : 0>(acc[h], da, db);
          }
        }
        wgmma_commit();
        wgmma_wait1();
        fence_acc(acc);
        if (held >= 0 && tid % 128 == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == WG_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait0();
      fence_acc(acc);
      if (held >= 0 && tid % 128 == 0) mbar_arrive(&empty[held]);
      // Accumulator fragments: n8 block e / 4, rows wl*16 + lane/4 (+8 for
      // the odd pair), columns 2*(lane%4) (+1).
      const int r0 = tm * 128 + wg * 64 + wl * 16 + lane / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int r = r0 + ((e % 4) / 2) * 8;
          const int c = tn * 128 + h * 64 + (e / 4) * 8 + (lane % 4) * 2 + (e % 2);
          ep.store(acc[h][e], r, c, 0);
        }
    }
  }
}

// Four 8x8 b16 matrices, transposed on the way (ldmatrix .trans).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Address of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled box.
__device__ __forceinline__ const uint8_t* sw128(const uint8_t* box, int row, int chunk) {
  return box + row * 128 + ((chunk ^ (row % 8)) * 16);
}

constexpr int TS_THREADS = 128;
constexpr int TS_A_BYTES = 16 * BOX * 2, TS_B_BYTES = BOX * BOX * 2;
constexpr int TS_STAGE_BYTES = TS_A_BYTES + TS_B_BYTES;
constexpr int TS_SMEM = TS_STAGES * TS_STAGE_BYTES + 1024;

// Decode: A boxes of 16 rows (K-major: packed "row" tiles or natural A);
// B boxes MN-major or K-major. Work item = (split, 64-column stripe j); the
// split covers k-tiles [sp*kt_chunk, min(Kb, (sp+1)*kt_chunk)).
template <typename T, class ASrc, class BSrc>
__global__ void __launch_bounds__(TS_THREADS)
mma_stream(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, int Kb,
           int bk, int tiles_n, int splits, int kt_chunk, float* ws, Epilogue ep) {
  static_assert(!ASrc::mn_major, "decode A boxes are K-major");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[TS_STAGES];
  __shared__ float red[4][16][BOX + 4];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nbox = bk / BOX;
  if (tid == 0) {
    for (int s = 0; s < TS_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int issued = 0, consumed = 0;  // ring positions (issued: thread 0's), across work items
  for (int tile = blockIdx.x; tile < tiles_n * splits; tile += gridDim.x) {
    const int sp = tile / tiles_n, j = tile % tiles_n;
    const int kt0 = sp * kt_chunk, kt1 = min(Kb, kt0 + kt_chunk);
    const int steps = ring_steps(kt1 - kt0, bk);
    auto issue = [&](int st) {  // one thread: k-box st of this item into the next slot
      const int slot = issued % TS_STAGES, kk = kt0 + st / nbox, kbox = st % nbox;
      uint8_t* base = smem + slot * TS_STAGE_BYTES;
      int c0, c1;
      mbar_expect_tx(&full[slot], TS_STAGE_BYTES);
      ASrc::box(0, kk, kbox, Kb, 16, bk, c0, c1);
      tma_load(base, &ta, &full[slot], c0, c1);
      BSrc::box(j, kk, kbox, Kb, bk, c0, c1);
      tma_load(base + TS_A_BYTES, &tb, &full[slot], c0, c1);
      ++issued;
    };
    if (tid == 0) {
      for (int st = 0; st < steps && st < TS_STAGES; ++st) issue(st);
    }
    float acc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
    for (int st = 0; st < steps; ++st) {
      const int slot = consumed % TS_STAGES;
      mbar_wait(&full[slot], (consumed / TS_STAGES) & 1);
      const uint8_t* a_box = smem + slot * TS_STAGE_BYTES;
      const uint8_t* b_box = a_box + TS_A_BYTES;
      const int ks = warp;  // this warp's k16 step of the box
      unsigned af[4];
      ldmatrix_x4(af, sw128(a_box, lane % 16, ks * 2 + lane / 16));
#pragma unroll
      for (int p = 0; p < 4; ++p) {  // n8 tiles 2p, 2p + 1
        unsigned bf[4];
        const int mat = lane / 8;
        if (BSrc::mn_major) {
          const int row = ks * 16 + (mat % 2) * 8 + lane % 8;
          ldmatrix_x4_trans(bf, sw128(b_box, row, 2 * p + mat / 2));
        } else {
          const int row = p * 16 + (mat / 2) * 8 + lane % 8;
          ldmatrix_x4(bf, sw128(b_box, row, ks * 2 + mat % 2));
        }
        Half16<T>::mma(acc[2 * p], af, bf[0], bf[1]);
        Half16<T>::mma(acc[2 * p + 1], af, bf[2], bf[3]);
      }
      ++consumed;
      __syncthreads();  // every warp is done with the slot
      if (tid == 0 && st + TS_STAGES < steps) issue(st + TS_STAGES);
    }
    // The four warps' k-steps summed in order, then stored or kept as split
    // sp's partial.
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int r = lane / 4, c = t * 8 + (lane % 4) * 2;
      red[warp][r][c] = acc[t][0];
      red[warp][r][c + 1] = acc[t][1];
      red[warp][r + 8][c] = acc[t][2];
      red[warp][r + 8][c + 1] = acc[t][3];
    }
    __syncthreads();
    for (int idx = tid; idx < 16 * BOX; idx += TS_THREADS) {
      const int r = idx / BOX, c = idx % BOX;
      const float v = red[0][r][c] + red[1][r][c] + red[2][r][c] + red[3][r][c];
      put(ep, ws, splits, sp, r, j * BOX + c, v);
    }
    __syncthreads();
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// wgmma_packed over tiles_m x tiles_n output tiles of 128 x 128, one block
// an SM at most, and at most `max_blocks` (1: one block walks every tile).
// Each instantiation raises its shared-memory limit on its first launch.
// Returns the CUDA error of the launch.
template <typename T, class ASrc, class BSrc>
int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb, int Kb, int bk, int tiles_m,
                 int tiles_n, const Epilogue& ep, cudaStream_t s, int max_blocks = 0x7fffffff) {
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(wgmma_packed<T, ASrc, BSrc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         WG_SMEM);
    raised = true;
  }
  const int grid = grid_for(static_cast<long long>(tiles_m) * tiles_n,
                            max_blocks < sm_count() ? max_blocks : sm_count());
  wgmma_packed<T, ASrc, BSrc><<<grid, WG_THREADS, WG_SMEM, s>>>(ta, tb, Kb, bk, tiles_m, tiles_n,
                                                                ep);
  return static_cast<int>(cudaGetLastError());
}

// mma_stream over tiles_n 64-column stripes x `splits` chunks of
// `kt_chunk` k-tiles (partials to `ws` when splits > 1; the caller reduces
// them), one block an item, at most `max_blocks` (1: one block walks every
// item). Returns the CUDA error of the launch.
template <typename T, class ASrc, class BSrc>
int launch_mma_stream(const CUtensorMap& ta, const CUtensorMap& tb, int Kb, int bk, int tiles_n,
                      int splits, int kt_chunk, float* ws, const Epilogue& ep, cudaStream_t s,
                      int max_blocks = 0x7fffffff) {
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(mma_stream<T, ASrc, BSrc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         TS_SMEM);
    raised = true;
  }
  const int grid = grid_for(static_cast<long long>(tiles_n) * splits, max_blocks);
  mma_stream<T, ASrc, BSrc><<<grid, TS_THREADS, TS_SMEM, s>>>(ta, tb, Kb, bk, tiles_n, splits,
                                                              kt_chunk, ws, ep);
  return static_cast<int>(cudaGetLastError());
}

// Whether (splits, kt_chunk) cut Kb k-tiles into non-empty chunks
// that cover it once, with a workspace when there is more than one.
bool valid_tile_split(int Kb, int splits, int kt_chunk, const void* ws) {
  return splits >= 1 && kt_chunk >= 1 && static_cast<long long>(splits) * kt_chunk >= Kb &&
         static_cast<long long>(splits - 1) * kt_chunk < Kb && (splits == 1 || ws != nullptr);
}

}  // namespace
