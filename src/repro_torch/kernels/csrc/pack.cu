// pack — tile-major copies of a matrix (or a stack of them): the paper's
// macro-level data reorganization, done per call by the "Tiling+Packing"
// strategies.
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
// raw bits of 1, 2, 4 or 8 bytes, so every dtype packs alike.
//
// What bounds it on an H100: bytes, one read of X and one write of the
// packed buffer over 3.35 TB/s. One thread writes one output element (or
// byte), so the stores are contiguous; the loads are contiguous along the
// tile's trailing axis for a "row" layout and strided for "col".
//
// Not yet: a shared-memory transpose for the "col" layout, 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__global__ void pack_tiles(const E* __restrict__ src, E* __restrict__ out, Geometry g, int nibble) {
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

}  // namespace

// Plain C entry point (bound with ctypes). X is E matrices [R, C] of
// `elem_bytes`-byte elements at `src` with element strides (se, sr, sc);
// `out` a contiguous [E, n_outer, n_inner, t0, t1s] buffer of the same
// element size: (Gr, Gc) tiles of (b0, b1) in row order, (Gc, Gr) in col
// order. `nibble` needs 1-byte (int8) elements and an even trailing tile
// dim. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int pack_tiles_launch(const void* src, int elem_bytes, int E, int R, int C,
                                 long long se, long long sr, long long sc, int b0, int b1,
                                 int col_order, int transpose, int nibble, void* out,
                                 void* stream) {
  if (E <= 0 || R <= 0 || C <= 0 || b0 <= 0 || b1 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.se = se;
  g.sr = sr;
  g.sc = sc;
  g.R = R;
  g.C = C;
  g.b0 = b0;
  g.b1 = b1;
  g.t0 = transpose ? b1 : b0;
  g.t1 = transpose ? b0 : b1;
  if (nibble && (elem_bytes != 1 || g.t1 % 2)) return static_cast<int>(cudaErrorInvalidValue);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      pack_tiles<int8_t><<<blocks, threads, 0, s>>>(static_cast<const int8_t*>(src),
                                                     static_cast<int8_t*>(out), g, nibble);
      break;
    case 2:
      pack_tiles<uint16_t><<<blocks, threads, 0, s>>>(static_cast<const uint16_t*>(src),
                                                       static_cast<uint16_t*>(out), g, 0);
      break;
    case 4:
      pack_tiles<uint32_t><<<blocks, threads, 0, s>>>(static_cast<const uint32_t*>(src),
                                                       static_cast<uint32_t*>(out), g, 0);
      break;
    case 8:
      pack_tiles<uint64_t><<<blocks, threads, 0, s>>>(static_cast<const uint64_t*>(src),
                                                       static_cast<uint64_t*>(out), g, 0);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
