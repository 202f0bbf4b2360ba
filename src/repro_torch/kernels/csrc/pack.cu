// pack — tile-major copies of a matrix (or a stack of them): the paper's
// macro-level data reorganization, done per call by the "Tiling+Packing"
// strategies and once at load for packed weights.
//
// Replaces the TPU Pallas kernels `_pack` (`_pack_kernel`; serves pack_a
// and pack_b) and `pack_b_grouped` (`_pack_kernel_grouped`),
// src/repro/kernels/pack.py. For each of E matrices X [R, C], read through
// its element strides (a transposed view needs no copy first):
//
//   out[e, g0, g1] = the [b0, b1] tile of X at (g0, g1)   (row order: pack_a)
//   out[e, g1, g0] = the same tile                       (col order: pack_b)
//
// each tile transposed to [b1, b0] for a "col" layout, elements past R or C
// zero-filled. With `nibble` (int4 formats; X already quantized to int8
// values in [-7, 7]) each output byte holds two neighbours along the tile's
// trailing axis, element 2i in the low nibble and 2i+1 in the high one: the
// reference's pack_nibbles, folded into the store. Elements are copied as
// raw bits, so every dtype packs alike.
//
// What bounds it on an H100: bytes, one read of X and one write of the
// packed buffer over 3.35 TB/s. Three bodies, one a call, picked in Python
// (kernels/pack.py `pack_body`, checked here by `tma_plan`):
//
//  * tma_copy: the stored tile is X's box as it lies (the row layout of a
//    row-major X; the col layout of a transposed view). A 3-D tensor map
//    over X (its unit-stride axis u, the other matrix axis v, E), exactly
//    as wide as X, so TMA's zero fill pads the ragged edge; one box a
//    chunk (a slab of whole rows of the stored tile, the whole tile unless
//    it overfills a 16 KB stage), stored by one bulk copy. One thread a
//    block issues everything; blocks walk the chunks in output order
//    (c = blockIdx.x; c += gridDim.x) through a ring of COPY_STAGES stages,
//    two blocks an SM. No thread touches an element: bound by HBM and by
//    how many chunks are in flight.
//  * tma_stage: the same map and walk where the stored tile is not the box
//    as it lies (a transpose: the col layout of a row-major X, the row
//    layout of table.t(); or an int4 nibble packing; or both). Each stage
//    has a second buffer: the block's threads transform the landed box
//    into it (transposes move 4 x 4 bytes, 2 x 2 16-bit elements or single
//    32-bit ones through 32-bit lanes, along diagonals, so that neither the
//    reads nor the writes of a warp meet in a bank), then one thread
//    bulk-stores it while TMA fills the next stages. Bound by HBM, with
//    two shared-memory passes a byte beside the copies.
//  * general: one thread an output element (or byte), any strides and
//    8-byte elements — what TMA cannot read (a base off 16 bytes, no unit
//    stride, a stride off 16 bytes, a tile over 256 or one that cannot be
//    cut into 16-byte slabs). Bound by its 64-bit index arithmetic and
//    2- to 8-byte accesses, 4-5x the byte bound at large shapes.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_wgmma.cuh"  // tensor_map_encoder, smem_u32, the mbarrier ring, aligned16

namespace {

enum Body { GENERAL = 0, TMA_COPY = 1, TMA_STAGE = 2 };
constexpr int TMA_BOX_MAX = 256;    // elements of one box dimension
constexpr int CHUNK_BYTES = 16384;  // one stage buffer (a 128 x 64 bf16 tile)
constexpr int COPY_STAGES = 6, COPY_THREADS = 32;     // 96 KB a block, two blocks an SM
constexpr int STAGE_STAGES = 6, STAGE_THREADS = 256;  // 192 KB a block, one block an SM

// ---------------------------------------------------------------------------
// general: one thread an output element
// ---------------------------------------------------------------------------

struct Geometry {
  long long se, sr, sc;   // element strides of X
  int R, C, b0, b1;       // matrix and tile shape
  int t0, t1;             // stored tile: (b0, b1), or (b1, b0) transposed
  int t1s;                // stored trailing dim: t1, or t1 / 2 with nibble
  int n_outer, n_inner;   // tile grid in output order
  int col_order, transpose;
  long long total;        // output units (elements, or bytes with nibble)
};

// Element at stored-tile position (p0, p1) of tile (e, g0, g1), or 0 past
// the matrix's edge.
template <typename E>
__device__ __forceinline__ E element(const E* __restrict__ src, const Geometry& g, long long e,
                                     int g0, int g1, int p0, int p1) {
  const int lr = g.transpose ? p1 : p0, lc = g.transpose ? p0 : p1;
  const int r = g0 * g.b0 + lr, c = g1 * g.b1 + lc;
  if (r >= g.R || c >= g.C) return E(0);
  return src[e * g.se + static_cast<long long>(r) * g.sr + static_cast<long long>(c) * g.sc];
}

template <typename E>
__global__ void k5_general(const E* __restrict__ src, E* __restrict__ out, Geometry g, int nibble) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < g.total; idx += stride) {
    long long rest = idx;
    const int j1 = static_cast<int>(rest % g.t1s);
    rest /= g.t1s;
    const int j0 = static_cast<int>(rest % g.t0);
    rest /= g.t0;
    const int gi = static_cast<int>(rest % g.n_inner);
    rest /= g.n_inner;
    const int go = static_cast<int>(rest % g.n_outer);
    const long long e = rest / g.n_outer;
    const int g0 = g.col_order ? gi : go, g1 = g.col_order ? go : gi;
    if (nibble) {
      const int lo = static_cast<int>(element(src, g, e, g0, g1, j0, 2 * j1));
      const int hi = static_cast<int>(element(src, g, e, g0, g1, j0, 2 * j1 + 1));
      out[idx] = static_cast<E>((lo & 0xF) | ((hi & 0xF) << 4));
    } else {
      out[idx] = element(src, g, e, g0, g1, j0, j1);
    }
  }
}

// ---------------------------------------------------------------------------
// The TMA bodies
// ---------------------------------------------------------------------------

// How the TMA bodies walk a call (mirrors kernels/pack.py `pack_plan`).
struct TmaPlan {
  int u_c;               // X's unit-stride axis u is C (else R); v is the other
  int tpass;             // the stored tile's trailing axis is v: the pass transposes
  int bu, bv;            // tile extents along u and v
  int h, q;              // stored rows a chunk; chunks a tile
  int box_u, box_v;      // a chunk's box
  int chunk_bytes;       // bytes a chunk stores
  int n_outer, n_inner;  // tile grid in output order
  int col_order;
  int e_first;           // the map's dims 1 and 2 are (E, v): E's stride is below v's
  long long chunks;      // chunks in all, in output order
};

// Chunks block `blockIdx.x` walks: c = blockIdx.x, + gridDim.x, ... below p.chunks.
__device__ __forceinline__ int my_chunks(const TmaPlan& p) {
  return static_cast<int>((p.chunks - blockIdx.x + gridDim.x - 1) / gridDim.x);
}

__device__ __forceinline__ long long chunk_of(int i) {
  return blockIdx.x + static_cast<long long>(i) * gridDim.x;
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from shared to global memory, in the thread's
// current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Returns once at most N of the thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Returns once every bulk group of the thread has landed in global memory.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory accesses before the
// async proxy's (the bulk store) that a barrier then lets run.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// Issues the TMA load of chunk `c` (tile c / q, slab c % q) into `dst`.
__device__ __forceinline__ void load_chunk(const CUtensorMap* map, const TmaPlan& p, long long c,
                                           uint8_t* dst, uint64_t* bar, uint32_t box_bytes) {
  const long long t = c / p.q, rest = t / p.n_inner;
  const int sub = static_cast<int>(c - t * p.q);
  const int gi = static_cast<int>(t - rest * p.n_inner);
  const int go = static_cast<int>(rest % p.n_outer);
  const int e = static_cast<int>(rest / p.n_outer);
  const int g0 = p.col_order ? gi : go, g1 = p.col_order ? go : gi;  // tile row, tile column
  const int gu = p.u_c ? g1 : g0, gv = p.u_c ? g0 : g1;
  const int cu = gu * p.bu + (p.tpass ? sub * p.h : 0);
  const int cv = gv * p.bv + (p.tpass ? 0 : sub * p.h);
  mbar_expect_tx(bar, box_bytes);  // the whole box, zero fill included
  tma_load_3d(dst, map, bar, cu, p.e_first ? e : cv, p.e_first ? cv : e);
}

// tma_copy: one thread moves every chunk of the block, box by box.
__global__ void __launch_bounds__(COPY_THREADS, 2)
k5_tma_copy(const __grid_constant__ CUtensorMap map, uint8_t* __restrict__ out, const TmaPlan p,
            uint32_t box_bytes) {
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x != 0) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint8_t* ring = align1024(smem_raw + COPY_STAGES * sizeof(uint64_t));
  const int n = my_chunks(p);
  for (int s = 0; s < COPY_STAGES; ++s) mbar_init(&full[s], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int i = 0; i < n && i < COPY_STAGES; ++i)
    load_chunk(&map, p, chunk_of(i), ring + i * CHUNK_BYTES, &full[i], box_bytes);
  for (int i = 0; i < n; ++i) {
    const int s = i % COPY_STAGES;
    mbar_wait(&full[s], (i / COPY_STAGES) & 1);
    fence_proxy_async();  // the landed box, then the bulk store's read of it
    bulk_store(out + chunk_of(i) * p.chunk_bytes, ring + s * CHUNK_BYTES, p.chunk_bytes);
    bulk_commit();
    // Refill the stage of chunk i - 1 once its store has left shared memory
    // (at most this chunk's group still reads).
    const int next = i - 1 + COPY_STAGES;
    if (i > 0 && next < n) {
      const int ps = (i - 1) % COPY_STAGES;
      bulk_wait_read<1>();
      load_chunk(&map, p, chunk_of(next), ring + ps * CHUNK_BYTES, &full[ps], box_bytes);
    }
  }
  bulk_wait_all();
}

// Two int4 values a byte: bytes (v0, v1, v2, v3) of `w` -> the 16 bits
// (v0 & 0xF | v1 << 4, v2 & 0xF | v3 << 4).
__device__ __forceinline__ uint32_t nibbles(uint32_t w) {
  const uint32_t m = w & 0x0F0F0F0Fu;
  return __byte_perm(m | (m >> 4), 0, 0x4420);
}

// Words (P * jb + r) * ub + ib, r < P, of the landed box: block (jb, ib),
// P rows along v by one 32-bit lane (P elements) along u.
template <int P>
__device__ __forceinline__ void load_block(const uint32_t* src, int jb, int ib, int ub,
                                           uint32_t (&w)[P]) {
#pragma unroll
  for (int r = 0; r < P; ++r) w[r] = src[(P * jb + r) * ub + ib];
}

// Block (jb, ib) of the box, transposed, to block (ib, jb) of the stored
// slab (rows along u, vb lanes a row; with NIB, vb 16-bit halves a row).
template <int EB, bool NIB>
__device__ __forceinline__ void store_block(uint8_t* dst, int ib, int jb, int vb,
                                            const uint32_t (&w)[4 / EB]) {
  uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
  if constexpr (EB == 4) {
    d32[ib * vb + jb] = w[0];
  } else if constexpr (EB == 2) {
    d32[(2 * ib) * vb + jb] = __byte_perm(w[0], w[1], 0x5410);      // elements 0 of both rows
    d32[(2 * ib + 1) * vb + jb] = __byte_perm(w[0], w[1], 0x7632);  // elements 1
  } else {
    const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140), x1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140), y1 = __byte_perm(w[2], w[3], 0x7362);
    const uint32_t c[4] = {__byte_perm(x0, y0, 0x5410), __byte_perm(x0, y0, 0x7632),
                           __byte_perm(x1, y1, 0x5410), __byte_perm(x1, y1, 0x7632)};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (NIB) {
        reinterpret_cast<uint16_t*>(dst)[(4 * ib + r) * vb + jb] = static_cast<uint16_t>(nibbles(c[r]));
      } else {
        d32[(4 * ib + r) * vb + jb] = c[r];
      }
    }
  }
}

// The stage pass: the landed box `src` [box_v][box_u] (rows along v) into
// the stored slab `dst`, by every thread of the block.
template <int EB, bool TPASS, bool NIB>
__device__ __forceinline__ void stage_pass(const uint8_t* src, uint8_t* dst, const TmaPlan& p) {
  if constexpr (!TPASS) {
    // Nibble packing alone (u is the stored trailing axis): 16 landed bytes
    // to 8 stored, rows of a multiple of 16 bytes, so no vector straddles.
    const int n16 = p.box_v * p.box_u / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint2* d2 = reinterpret_cast<uint2*>(dst);
    for (int v = threadIdx.x; v < n16; v += STAGE_THREADS) {
      const uint4 w = s4[v];
      d2[v] = make_uint2(nibbles(w.x) | (nibbles(w.y) << 16), nibbles(w.z) | (nibbles(w.w) << 16));
    }
  } else {
    // The transpose, in P x P blocks (P elements a 32-bit lane) over a grid
    // of vb x ub blocks, cut into 32 x 32 squares. Pass k of a square moves
    // its k-th diagonal: lane l takes block row l and block column
    // (l + k) % 32, so a warp reads words (P * l + r) * ub + (l + k) and
    // writes (P * (l + k) + r) * vb + l: both land in 32 distinct banks
    // when ub and vb are even (P = 2, 4 always; P = 1 when the box's sides
    // are even, as every served shape's are). No padding: TMA fills the
    // box densely and the bulk store reads the slab densely.
    constexpr int P = 4 / EB;
    const int ub = p.box_u / P, vb = p.box_v / P;
    const int squares_u = (ub + 31) / 32, passes = squares_u * ((vb + 31) / 32) * 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
    for (int it = warp; it < passes; it += STAGE_THREADS / 32) {
      const int sq = it / 32, k = it % 32;
      const int jb = (sq / squares_u) * 32 + lane;
      const int ib = (sq % squares_u) * 32 + ((lane + k) & 31);
      if (jb < vb && ib < ub) {
        uint32_t w[P];
        load_block<P>(s32, jb, ib, ub, w);
        store_block<EB, NIB>(dst, ib, jb, vb, w);
      }
    }
  }
}

// tma_stage: the ring of tma_copy with a second buffer a stage and a pass
// of the whole block between the load and the store.
template <int EB, bool TPASS, bool NIB>
__global__ void __launch_bounds__(STAGE_THREADS, 1)
k5_tma_stage(const __grid_constant__ CUtensorMap map, uint8_t* __restrict__ out, const TmaPlan p,
             uint32_t box_bytes) {
  extern __shared__ uint8_t smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint8_t* ring = align1024(smem_raw + STAGE_STAGES * sizeof(uint64_t));  // stage s: in, then out
  const int n = my_chunks(p);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGE_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < n && i < STAGE_STAGES; ++i)
      load_chunk(&map, p, chunk_of(i), ring + 2 * i * CHUNK_BYTES, &full[i], box_bytes);
  }
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGE_STAGES;
    uint8_t* in = ring + 2 * s * CHUNK_BYTES;
    uint8_t* slab = in + CHUNK_BYTES;
    // The slab buffer is rewritten: the store of chunk i - STAGE_STAGES,
    // its last use, must have left shared memory.
    if (threadIdx.x == 0 && i >= STAGE_STAGES) bulk_wait_read<STAGE_STAGES - 1>();
    __syncthreads();
    mbar_wait(&full[s], (i / STAGE_STAGES) & 1);
    stage_pass<EB, TPASS, NIB>(in, slab, p);
    fence_proxy_async();  // the pass's writes, then the bulk store's read
    __syncthreads();      // ... and every thread is done with `in`
    if (threadIdx.x == 0) {
      bulk_store(out + chunk_of(i) * p.chunk_bytes, slab, p.chunk_bytes);
      bulk_commit();
      if (i + STAGE_STAGES < n)
        load_chunk(&map, p, chunk_of(i + STAGE_STAGES), in, &full[s], box_bytes);
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// The TMA bodies' plan (kernels/pack.py `pack_plan`, which the wrapper
// routes by): false where TMA cannot read the call as it lies.
bool tma_plan(TmaPlan* p, const void* src, int eb, int R, int C, long long se, long long sr,
              long long sc, int b0, int b1, int transpose, int nibble) {
  if ((eb != 1 && eb != 2 && eb != 4) || !aligned16(src) || b0 > TMA_BOX_MAX || b1 > TMA_BOX_MAX)
    return false;
  if ((sr == 1) == (sc == 1)) return false;
  p->u_c = sc == 1;
  p->bu = p->u_c ? b1 : b0;
  p->bv = p->u_c ? b0 : b1;
  const long long ext_u = p->u_c ? C : R, sv = p->u_c ? sr : sc;
  if (sv < ext_u || se <= 0 || (sv * eb) % 16 || (se * eb) % 16) return false;
  p->tpass = (p->u_c != 0) == (transpose != 0);
  const int t0 = p->tpass ? p->bu : p->bv, t1 = p->tpass ? p->bv : p->bu;
  const int row_bytes = (nibble ? t1 / 2 : t1) * eb;
  if (p->tpass && p->bv % (4 / eb)) return false;
  for (int q = 1; t0 % q == 0; q *= 2) {
    const int h = t0 / q;
    const int box_u = p->tpass ? h : p->bu, box_v = p->tpass ? p->bv : h;
    if ((box_u * eb) % 16 == 0 && (h * row_bytes) % 16 == 0 &&
        box_u * box_v * eb <= CHUNK_BYTES) {
      p->h = h;
      p->q = q;
      p->box_u = box_u;
      p->box_v = box_v;
      p->chunk_bytes = h * row_bytes;
      return true;
    }
  }
  return false;
}

// The 3-D map over X as it lies: u first, then v and E ordered by stride,
// elements as raw 1-, 2- or 4-byte integers, the box one chunk, no swizzle,
// zeros past the edges.
bool make_pack_map(CUtensorMap* map, TmaPlan* p, const void* src, int eb, int E, int R, int C,
                   long long se, long long sr, long long sc) {
  EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const long long ext_u = p->u_c ? C : R, ext_v = p->u_c ? R : C, sv = p->u_c ? sr : sc;
  // Exactly X's extent, never its row stride: past it TMA fills zeros
  // where the row's neighbour (or padding) would be read.
  const cuuint64_t width = static_cast<cuuint64_t>(ext_u);
  p->e_first = se < sv;
  const cuuint64_t dims[3] = {width, static_cast<cuuint64_t>(p->e_first ? E : ext_v),
                              static_cast<cuuint64_t>(p->e_first ? ext_v : E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>((p->e_first ? se : sv) * eb),
                                 static_cast<cuuint64_t>((p->e_first ? sv : se) * eb)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(p->box_u),
                             static_cast<cuuint32_t>(p->e_first ? 1 : p->box_v),
                             static_cast<cuuint32_t>(p->e_first ? p->box_v : 1)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType dt = eb == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                 : eb == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                           : CU_TENSOR_MAP_DATA_TYPE_UINT32;
  return enc(map, dt, 3, const_cast<void*>(src), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
int launch_ring(Kernel kernel, int threads, int stages, int buffers, int blocks_per_sm,
                const CUtensorMap& map, void* out, const TmaPlan& p, uint32_t box_bytes,
                cudaStream_t s) {
  const size_t smem = static_cast<size_t>(stages) * (buffers * CHUNK_BYTES + sizeof(uint64_t)) + 1024;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = static_cast<long long>(blocks_per_sm) * (sms > 0 ? sms : 132);
  const int grid = static_cast<int>(p.chunks < want ? p.chunks : want);
  kernel<<<grid, threads, smem, s>>>(map, static_cast<uint8_t*>(out), p, box_bytes);
  return static_cast<int>(cudaGetLastError());
}

int launch_tma(int body, const void* src, int eb, int E, int R, int C, long long se, long long sr,
               long long sc, int b0, int b1, int col_order, int transpose, int nibble, void* out,
               cudaStream_t s) {
  TmaPlan p;
  if (!tma_plan(&p, src, eb, R, C, se, sr, sc, b0, b1, transpose, nibble) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool copy = !p.tpass && !nibble;
  if ((body == TMA_COPY) != copy) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (!make_pack_map(&map, &p, src, eb, E, R, C, se, sr, sc))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gr = (R + b0 - 1) / b0, gc = (C + b1 - 1) / b1;
  p.col_order = col_order;
  p.n_outer = col_order ? gc : gr;
  p.n_inner = col_order ? gr : gc;
  p.chunks = static_cast<long long>(E) * gr * gc * p.q;
  const uint32_t box_bytes = static_cast<uint32_t>(p.box_u) * p.box_v * eb;
  if (copy) return launch_ring(k5_tma_copy, COPY_THREADS, COPY_STAGES, 1, 2, map, out, p, box_bytes, s);
  if (nibble && !p.tpass)
    return launch_ring(k5_tma_stage<1, false, true>, STAGE_THREADS, STAGE_STAGES, 2, 1, map, out, p,
                       box_bytes, s);
  switch (eb * 2 + nibble) {
    case 2: return launch_ring(k5_tma_stage<1, true, false>, STAGE_THREADS, STAGE_STAGES, 2, 1, map,
                               out, p, box_bytes, s);
    case 3: return launch_ring(k5_tma_stage<1, true, true>, STAGE_THREADS, STAGE_STAGES, 2, 1, map,
                               out, p, box_bytes, s);
    case 4: return launch_ring(k5_tma_stage<2, true, false>, STAGE_THREADS, STAGE_STAGES, 2, 1, map,
                               out, p, box_bytes, s);
    case 8: return launch_ring(k5_tma_stage<4, true, false>, STAGE_THREADS, STAGE_STAGES, 2, 1, map,
                               out, p, box_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). X is E matrices [R, C] of
// `elem_bytes`-byte elements at `src` with element strides (se, sr, sc) (the
// strides of extent-1 dims set as kernels/pack.py `pack_strides` sets them);
// `out` a contiguous [E, n_outer, n_inner, t0, t1s] buffer of the same
// element size: (Gr, Gc) tiles of (b0, b1) in row order, (Gc, Gr) in col
// order. `nibble` needs 1-byte (int8) elements and an even trailing tile
// dim. `body` names the body (enum Body); a body that cannot take the call
// is refused, never replaced. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for what the body does not take.
extern "C" int pack_tiles_launch(const void* src, int elem_bytes, int E, int R, int C,
                                 long long se, long long sr, long long sc, int b0, int b1,
                                 int col_order, int transpose, int nibble, int body, void* out,
                                 void* stream) {
  if (E <= 0 || R <= 0 || C <= 0 || b0 <= 0 || b1 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int t0 = transpose ? b1 : b0, t1 = transpose ? b0 : b1;
  if (nibble && (elem_bytes != 1 || t1 % 2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == TMA_COPY || body == TMA_STAGE)
    return launch_tma(body, src, elem_bytes, E, R, C, se, sr, sc, b0, b1, col_order, transpose,
                      nibble, out, s);
  if (body != GENERAL) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.se = se;
  g.sr = sr;
  g.sc = sc;
  g.R = R;
  g.C = C;
  g.b0 = b0;
  g.b1 = b1;
  g.t0 = t0;
  g.t1 = t1;
  g.t1s = nibble ? g.t1 / 2 : g.t1;
  const int gr = (R + b0 - 1) / b0, gc = (C + b1 - 1) / b1;
  g.n_outer = col_order ? gc : gr;
  g.n_inner = col_order ? gr : gc;
  g.col_order = col_order;
  g.transpose = transpose;
  g.total = static_cast<long long>(E) * gr * gc * g.t0 * g.t1s;
  const int threads = 256;
  const long long want = (g.total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  switch (elem_bytes) {
    case 1:
      k5_general<int8_t><<<blocks, threads, 0, s>>>(static_cast<const int8_t*>(src),
                                                     static_cast<int8_t*>(out), g, nibble);
      break;
    case 2:
      k5_general<uint16_t><<<blocks, threads, 0, s>>>(static_cast<const uint16_t*>(src),
                                                       static_cast<uint16_t*>(out), g, 0);
      break;
    case 4:
      k5_general<uint32_t><<<blocks, threads, 0, s>>>(static_cast<const uint32_t*>(src),
                                                       static_cast<uint32_t*>(out), g, 0);
      break;
    case 8:
      k5_general<uint64_t><<<blocks, threads, 0, s>>>(static_cast<const uint64_t*>(src),
                                                       static_cast<uint64_t*>(out), g, 0);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
