// Quantized tensor-core bodies for Hopper, shared by gemm_packed_fused_a.cu
// (K1) and gemm_grouped_packed.cu (K2 / K3): bf16 / f16 activations against
// int8 or nibble-packed int4 weight tiles, widened exactly in registers.
//
// They replace the quantized paths of the TPU kernels `_fused_a_kernel`
// (src/repro/kernels/gemm_packed.py) and `_ragged_kernel` / `_grouped_kernel`
// (src/repro/kernels/gemm_grouped.py), whose contract_tile
// (src/repro/kernels/common.py) widens a tile to the activation type,
// contracts it in f32 and multiplies that tile's f32 partial by its scale;
// a col scale multiplies the finished sum once, in the store.
//
// What bounds them on an H100: at decode the narrow weight stream (a half
// or a quarter of bf16's bytes over 3.35 TB/s); at prefill the tensor-core
// rate, with the widening in the way. What the design does about it:
//  * TMA brings the narrow tiles as they are stored: a 64-deep box of a
//    tile is 64 rows of 64 bytes (int8) or 32 bytes (int4), with the 64- or
//    32-byte swizzle, so a warp's reads below spread over the banks.
//  * Each warp widens the weights it multiplies straight from the box into
//    mma fragments (quant_frags): a bf16 or f16 pair is built from two
//    stored values by masks and one packed subtraction (the magic-number
//    trick), exact for every int8 and int4 value, -8 and -128 included. No
//    widened copy goes through shared memory.
//  * The fragment a lane builds is both mma.sync m16n8k16's B operand (two
//    n8 tiles of a warp's 16 columns) and wgmma's register-sourced A
//    operand of the transposed product (16 weight columns of a warp's 64):
//    the decode body multiplies activations by weights on mma.sync, the
//    prefill body weights by activations on wgmma (RS), the activations'
//    box read from shared memory as wgmma's B operand.
//  * A row-layout tile stores a k row's columns side by side, so a lane's
//    pair of k values for one column comes from two rows; its two columns
//    are neighbours (2g, 2g + 1 of the warp's 16), where a col-layout lane
//    holds columns g and g + 8. The epilogues store by that map (qcol).
//  * Tile scales multiply each k-tile's f32 partial before it joins the
//    sum (a second accumulator set); a col scale multiplies the finished
//    sum once, in the store or in the split reduction.

#pragma once

#include "gemm_wgmma.cuh"

namespace {

constexpr int QS_STAGES = 8;   // the decode ring: small stages, many in flight
constexpr int QW_STAGES = 6;   // the prefill ring
constexpr int QW_A_BYTES = BOX * BOX * 2;  // 64 activation rows by 64 k
constexpr int NIB_LO = 0, NIB_HI = 4;      // the bit offsets of nibbles 2i, 2i + 1

// Bytes of one 64-element row of a box: 64 (int8) or 32 (int4 nibbles).
template <bool I4>
struct QBox {
  static constexpr int W = I4 ? 32 : 64;
  static constexpr int BYTES = BOX * W;
};

// The 2-D byte view of a packed int8 / int4 stack of `tiles` tiles: "row"
// tiles [bk][bn] are rows of bn values, "col" tiles [bn][bk] rows of bk;
// boxes of 64 rows by 64 values, swizzled at their own width.
bool make_quant_b_map(CUtensorMap* map, const void* b, int b_dt, int b_col, long long tiles,
                      int bk, int bn) {
  EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const int bits = b_dt == DT_I4 ? 4 : 8;
  const long long inner = static_cast<long long>(b_col ? bk : bn) * bits / 8;
  const long long rows = tiles * (b_col ? bn : bk);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BOX * bits / 8), BOX};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(b), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             bits == 8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Box (c0, c1) of k-box `kbox` of tile `t` of the byte view.
template <bool I4, bool COL>
__device__ __forceinline__ void quant_box(int t, int kbox, int bk, int& c0, int& c1) {
  if (COL) {
    c0 = kbox * QBox<I4>::W;
    c1 = t * BOX;
  } else {
    c0 = 0;
    c1 = t * bk + kbox * BOX;
  }
}

// Byte `b` of row `r` of a box stored with the W-byte swizzle (16-byte
// chunks XORed with address bits 7 and up).
template <int W>
__device__ __forceinline__ const uint8_t* qsw(const uint8_t* box, int r, int b) {
  return box + r * W + ((((b >> 4) ^ ((r * W) >> 7)) & (W / 16 - 1)) << 4) + (b & 15);
}

__device__ __forceinline__ uint32_t ld8(const uint8_t* p) { return *p; }
__device__ __forceinline__ uint32_t ld16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ uint32_t bsub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t hsub(uint32_t a, uint32_t b) {
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&a),
                            *reinterpret_cast<const __half2*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Two stored values -> one register of two 16-bit values, exactly: i8 takes
// int8 values in bytes 0 and 2, i4 nibbles in bits 0-3 and 16-19.
template <typename T>
struct QWiden;
template <>
struct QWiden<__nv_bfloat16> {
  // 128 + (v & 127), less 128 or, for a negative v, 256: the sign bit of
  // the byte is the exponent's low bit of 0x4300 (128) / 0x4380 (256).
  static __device__ __forceinline__ uint32_t i8(uint32_t x) {
    return bsub((x & 0x007F007Fu) | 0x43004300u, (x & 0x00800080u) | 0x43004300u);
  }
  // 128 + (v + 8) less 136.
  static __device__ __forceinline__ uint32_t i4(uint32_t y) {
    return bsub((y & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
  }
};
template <>
struct QWiden<__half> {
  // 1024 + (v + 128) less 1152.
  static __device__ __forceinline__ uint32_t i8(uint32_t x) {
    return hsub((x & 0x00FF00FFu) ^ 0x64806480u, 0x64806480u);
  }
  // 1024 + (v + 8) less 1032.
  static __device__ __forceinline__ uint32_t i4(uint32_t y) {
    return hsub((y & 0x000F000Fu) ^ 0x64086408u, 0x64086408u);
  }
};

// The fragments of one k16 step `ks` of a 64-deep box for the 16 columns
// [c, c + 16) of the box (c a multiple of 16), in the k order of the step:
// f[0] / f[1] k 2t, 2t + 1 / 2t + 8, 2t + 9 of the lane's first column,
// f[2] / f[3] of its second (g = lane / 4, t = lane % 4). As mma.sync's B
// operand they are b0 / b1 of n8 tiles 0 and 1; as wgmma's register A
// operand a0 = f[0], a1 = f[2], a2 = f[1], a3 = f[3]. Row tiles give the
// lane columns c + 2g and c + 2g + 1, col tiles c + g and c + g + 8 (qcol).
template <typename T, bool I4, bool COL>
__device__ __forceinline__ void quant_frags(const uint8_t* box, int c, int ks, int lane,
                                            uint32_t (&f)[4]) {
  constexpr int W = QBox<I4>::W;
  const int g = lane >> 2, k = ks * 16 + 2 * (lane & 3);
  if constexpr (!COL) {  // rows k, k + 1, k + 8, k + 9 of the box
    if constexpr (I4) {
      const int b = c / 2 + g;  // columns c + 2g (low nibble), c + 2g + 1 (high)
      const uint32_t y0 = ld8(qsw<W>(box, k, b)) | (ld8(qsw<W>(box, k + 1, b)) << 16);
      const uint32_t y8 = ld8(qsw<W>(box, k + 8, b)) | (ld8(qsw<W>(box, k + 9, b)) << 16);
      f[0] = QWiden<T>::i4(y0 >> NIB_LO);
      f[1] = QWiden<T>::i4(y8 >> NIB_LO);
      f[2] = QWiden<T>::i4(y0 >> NIB_HI);
      f[3] = QWiden<T>::i4(y8 >> NIB_HI);
    } else {
      const int b = c + 2 * g;  // columns c + 2g (byte 0), c + 2g + 1 (byte 1)
      const uint32_t x0 = ld16(qsw<W>(box, k, b)) | (ld16(qsw<W>(box, k + 1, b)) << 16);
      const uint32_t x8 = ld16(qsw<W>(box, k + 8, b)) | (ld16(qsw<W>(box, k + 9, b)) << 16);
      f[0] = QWiden<T>::i8(x0);
      f[1] = QWiden<T>::i8(x8);
      f[2] = QWiden<T>::i8(x0 >> 8);
      f[3] = QWiden<T>::i8(x8 >> 8);
    }
  } else {  // rows c + g and c + g + 8 of the box (one column each), k-contiguous
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = c + g + 8 * h;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if constexpr (I4) {  // one byte: k (low nibble), k + 1 (high)
          const uint32_t x = ld8(qsw<W>(box, n, (k + 8 * q) / 2));
          f[2 * h + q] = QWiden<T>::i4(((x >> NIB_LO) & 0xFu) | (((x >> NIB_HI) & 0xFu) << 16));
        } else {             // two bytes: k, k + 1
          const uint32_t x = ld16(qsw<W>(box, n, k + 8 * q));
          f[2 * h + q] = QWiden<T>::i8(x | (x << 8));
        }
      }
    }
  }
}

// The column, inside a warp's 16, of position q (0-15) of quant_frags'
// fragments: q = g + 8h is the lane's h-th column.
template <bool COL>
__device__ __forceinline__ int qcol(int q) {
  return COL ? q : 2 * (q % 8) + q / 8;
}

// K1's tile scale of k-tile kk of 64-column stripe j.
__device__ __forceinline__ float quant_tile_scale(const Epilogue& ep, int j, int Kb, int kk) {
  return ep.scales[static_cast<long long>(j) * Kb + kk];
}

// ---------------------------------------------------------------------------
// Decode (K1 tc_stream_q): M <= 16 activation rows, mma.sync
// ---------------------------------------------------------------------------

// One 64-deep box of a stage: warp w multiplies A's 16 rows by its 16
// columns [16w, 16w + 16) of each of the NB weight boxes, all four k16
// steps, into acc[b][n8 tile].
template <typename T, bool I4, bool COL, int NB>
__device__ __forceinline__ void quant_box_mma(const uint8_t* a_box, const uint8_t* b_box,
                                              int warp, int lane, float (&acc)[NB][2][4]) {
#pragma unroll
  for (int ks = 0; ks < BOX / 16; ++ks) {
    unsigned af[4];
    ldmatrix_x4(af, sw128(a_box, lane % 16, ks * 2 + lane / 16));
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      uint32_t f[4];
      quant_frags<T, I4, COL>(b_box + b * QBox<I4>::BYTES, 16 * warp, ks, lane, f);
      Half16<T>::mma(acc[b][0], af, f[0], f[1]);
      Half16<T>::mma(acc[b][1], af, f[2], f[3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][2][4]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][h][e] = 0.0f;
}

// Block = (split sp, 64-column stripe j), item = blockIdx.x (grid = items):
// the split covers k-tiles [sp*kt_chunk, min(Kb, (sp+1)*kt_chunk)). Thread 0
// keeps QS_STAGES stages of (A box, weight box) in flight; the four warps
// each multiply their 16 columns through every stage. Each k-tile's
// partial joins the sum times its tile scale (scale_mode 1) or as it is.
// One split stores through the epilogue (col scale included); more write
// partial sums to ws [splits, M, N] for the reduction, which applies the
// col scale once.
template <typename T, bool I4, bool COL>
__global__ void __launch_bounds__(TS_THREADS)
quant_stream(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, int Kb,
             int bk, int tiles_n, int splits, int kt_chunk, float* ws, Epilogue ep) {
  constexpr int STAGE = TS_A_BYTES + QBox<I4>::BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[QS_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, nbox = bk / BOX;
  const int sp = blockIdx.x / tiles_n, j = blockIdx.x % tiles_n;
  const int kt0 = sp * kt_chunk, kt1 = min(Kb, kt0 + kt_chunk);
  const int steps = ring_steps(kt1 - kt0, bk);
  if (tid == 0) {
    for (int s = 0; s < QS_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int st) {  // one thread: k-box st into its slot
    const int slot = st % QS_STAGES, kk = kt0 + st / nbox, kbox = st % nbox;
    uint8_t* base = smem + slot * STAGE;
    int c0, c1;
    mbar_expect_tx(&full[slot], STAGE);
    tma_load(base, &ta, &full[slot], kk * bk + kbox * BOX, 0);
    quant_box<I4, COL>(j * Kb + kk, kbox, bk, c0, c1);
    tma_load(base + TS_A_BYTES, &tb, &full[slot], c0, c1);
  };
  if (tid == 0) {
    for (int st = 0; st < steps && st < QS_STAGES; ++st) issue(st);
  }
  float total[1][2][4], part[1][2][4];
  zero_acc<1>(total);
  zero_acc<1>(part);
  for (int st = 0; st < steps; ++st) {
    const int slot = st % QS_STAGES;
    mbar_wait(&full[slot], (st / QS_STAGES) & 1);
    const uint8_t* base = smem + slot * STAGE;
    quant_box_mma<T, I4, COL, 1>(base, base + TS_A_BYTES, warp, lane, part);
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && st + QS_STAGES < steps) issue(st + QS_STAGES);
    if ((st + 1) % nbox == 0) {  // k-tile kk done: its scaled partial joins the sum
      const float s = ep.scale_mode == 1 ? quant_tile_scale(ep, j, Kb, kt0 + st / nbox) : 1.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          total[0][h][e] += part[0][h][e] * s;
          part[0][h][e] = 0.0f;
        }
    }
  }
  // c0, c1: row lane / 4, positions 2t, 2t + 1 of n8 tile h; c2, c3: row + 8.
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = lane / 4 + (e / 2) * 8;
      const int gn = j * BOX + 16 * warp + qcol<COL>(8 * h + 2 * (lane % 4) + e % 2);
      const float v = total[0][h][e];
      if (splits == 1) {
        ep.store(v, r, gn, j);
      } else if (r < ep.M && gn < ep.N) {
        ws[(static_cast<long long>(sp) * ep.M + r) * ep.N + gn] = v;
      }
    }
}

// ---------------------------------------------------------------------------
// Prefill (K1 wgmma_q): wgmma with the widened weights as the register A
// operand of the transposed product
// ---------------------------------------------------------------------------

constexpr int QW_THREADS = 288;  // two consumer warpgroups, then one producer warp

template <bool I4>
struct QwRing {
  static constexpr int STAGE = QW_A_BYTES + 2 * QBox<I4>::BYTES;
  static constexpr int SMEM = QW_STAGES * STAGE + 1024;
};

// One 64-deep stage of a consumer warpgroup: its 64 weight columns (the
// weight box `b_box`, warp wl widening columns [16wl, 16wl + 16)) times the
// 64 activation rows of `a_box`, four m64n64k16 wgmmas into d; fr holds the
// widened fragments until the group completes.
template <typename T, bool I4, bool COL>
__device__ __forceinline__ void quant_wgmma_stage(const uint8_t* a_box, const uint8_t* b_box,
                                                  int wl, int lane, uint32_t (&fr)[4][4],
                                                  float (&d)[32]) {
#pragma unroll
  for (int ks = 0; ks < BOX / 16; ++ks) {
    uint32_t f[4];
    quant_frags<T, I4, COL>(b_box, 16 * wl, ks, lane, f);
    fr[ks][0] = f[0];
    fr[ks][1] = f[2];
    fr[ks][2] = f[1];
    fr[ks][3] = f[3];
    fence_regs(fr[ks]);
  }
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BOX / 16; ++ks) {
    wgmma_m64n64k16_rs<T, 0>(d, fr[ks], sw128_desc(a_box + kstep_bytes(false, ks)));
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&fr)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(fr[i]);
}

// The k-loop of a consumer warpgroup over one output tile: `steps` stages
// of the ring (`stage` / `phase` carried across tiles), weight box `wg` of
// each against its 64 activation rows, into total. Each k-tile's groups
// accumulate in a second set, which joins total times scale(k-tile) (1
// without tile scales) once they complete; within a k-tile one group stays
// in flight, and a stage is released once the group after it is issued
// and its own has completed.
template <typename T, bool I4, bool COL, class Scale>
__device__ __forceinline__ void quant_wgmma_tile(const uint8_t* smem, uint64_t* full,
                                                 uint64_t* empty, int& stage, int& phase,
                                                 int steps, int nbox, int wg, int lane,
                                                 float (&total)[32], Scale scale) {
  constexpr int STAGE = QwRing<I4>::STAGE;
  const int wl = (threadIdx.x / 32) % 4, leader = threadIdx.x % 128 == 0;
  uint32_t fr0[4][4] = {}, fr1[4][4] = {};  // group st's fragments, by st's parity
  float part[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) part[e] = 0.0f;
  int held = -1;
  auto step = [&](int st, uint32_t (&fr)[4][4], uint32_t (&prev)[4][4]) {
    mbar_wait(&full[stage], phase);
    const uint8_t* base = smem + stage * STAGE;
    quant_wgmma_stage<T, I4, COL>(base, base + QW_A_BYTES + wg * QBox<I4>::BYTES, wl, lane,
                                  fr, part);
    const bool tile_end = (st + 1) % nbox == 0;
    if (tile_end) {
      wgmma_wait0();
      fence_frags(fr);
    } else {
      wgmma_wait1();
    }
    fence_frags(prev);  // the group before this one read them: complete now
    fence_regs(part);
    if (held >= 0 && leader) mbar_arrive(&empty[held]);
    held = stage;
    if (tile_end) {  // k-tile st / nbox complete: its scaled partial joins the sum
      if (leader) mbar_arrive(&empty[held]);
      held = -1;
      const float s = scale(st / nbox);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        total[e] += part[e] * s;
        part[e] = 0.0f;
      }
    }
    if (++stage == QW_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  for (int st = 0; st < steps; st += 2) {
    step(st, fr0, fr1);
    if (st + 1 < steps) step(st + 1, fr1, fr0);
  }
  if (held >= 0 && leader) mbar_arrive(&empty[held]);
}

// Accumulator element e of m64n64 D: weight position (row) wl*16 + lane/4
// (+8 for e % 4 >= 2), activation row (column) (e/4)*8 + 2*(lane%4) + e%2.
__device__ __forceinline__ int qw_pos(int e, int lane) { return lane / 4 + ((e % 4) / 2) * 8; }
__device__ __forceinline__ int qw_row(int e, int lane) {
  return (e / 4) * 8 + (lane % 4) * 2 + (e % 2);
}

// Persistent blocks over output tiles (64 activation rows tm, 128 weight
// columns tn), m-tiles fastest so the blocks at work share the weight
// stripes in L2. Producer warp 8 keeps QW_STAGES stages in flight: a
// 64-row activation box and the 64-deep boxes of weight stripes 2tn and
// 2tn + 1. Consumer warpgroup wg widens stripe 2tn + wg and multiplies it
// by the 64 rows (quant_wgmma_tile).
template <typename T, bool I4, bool COL>
__global__ void __launch_bounds__(QW_THREADS, 1)
quant_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            int Kb, int bk, int Nb, int tiles_m, int tiles_n, Epilogue ep) {
  constexpr int STAGE = QwRing<I4>::STAGE;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[QW_STAGES], empty[QW_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles = tiles_m * tiles_n, steps = ring_steps(Kb, bk), nbox = bk / BOX;
  if (tid == 0) {
    for (int s = 0; s < QW_STAGES; ++s) {
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
        const int tm = tile % tiles_m, tn = tile / tiles_m;
        for (int st = 0; st < steps; ++st) {
          const int kk = st / nbox, kbox = st - kk * nbox;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE);
          uint8_t* base = smem + stage * STAGE;
          tma_load(base, &ta, &full[stage], kk * bk + kbox * BOX, tm * BOX);
          for (int h = 0; h < 2; ++h) {
            int c0, c1;
            quant_box<I4, COL>(min(2 * tn + h, Nb) * Kb + kk, kbox, bk, c0, c1);
            tma_load(base + QW_A_BYTES + h * QBox<I4>::BYTES, &tb, &full[stage], c0, c1);
          }
          if (++stage == QW_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: weight stripe 2tn + wg
    const int wg = warp / 4, wl = warp % 4;
    const bool scaled = ep.scale_mode == 1;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tm = tile % tiles_m, tn = tile / tiles_m, j = 2 * tn + wg;
      float total[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) total[e] = 0.0f;
      quant_wgmma_tile<T, I4, COL>(smem, full, empty, stage, phase, steps, nbox, wg, lane, total,
                                   [&](int kk) {
                                     return !scaled ? 1.0f
                                            : j < Nb ? quant_tile_scale(ep, j, Kb, kk)
                                                     : 0.0f;
                                   });
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = j * BOX + 16 * wl + qcol<COL>(qw_pos(e, lane));
        ep.store(total[e], tm * BOX + qw_row(e, lane), c, j);
      }
    }
  }
}

// quant_stream over tiles_n stripes x `splits` chunks of `kt_chunk` k-tiles
// (partials to `ws` when splits > 1; the caller reduces them). Returns the
// CUDA error of the launch.
template <typename T, bool I4, bool COL>
int launch_quant_stream(const CUtensorMap& ta, const CUtensorMap& tb, int Kb, int bk,
                        int tiles_n, int splits, int kt_chunk, float* ws, const Epilogue& ep,
                        cudaStream_t s) {
  constexpr int SMEM = QS_STAGES * (TS_A_BYTES + QBox<I4>::BYTES) + 1024;
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(quant_stream<T, I4, COL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    raised = true;
  }
  const long long blocks = static_cast<long long>(tiles_n) * splits;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  quant_stream<T, I4, COL><<<static_cast<int>(blocks), TS_THREADS, SMEM, s>>>(
      ta, tb, Kb, bk, tiles_n, splits, kt_chunk, ws, ep);
  return static_cast<int>(cudaGetLastError());
}

// quant_wgmma over tiles_m x tiles_n output tiles of 64 x 128, one block an
// SM at most. Returns the CUDA error of the launch.
template <typename T, bool I4, bool COL>
int launch_quant_wgmma(const CUtensorMap& ta, const CUtensorMap& tb, int Kb, int bk, int Nb,
                       int tiles_m, int tiles_n, const Epilogue& ep, cudaStream_t s) {
  static bool raised = false;
  if (!raised) {
    cudaFuncSetAttribute(quant_wgmma<T, I4, COL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         QwRing<I4>::SMEM);
    raised = true;
  }
  const int grid = grid_for(static_cast<long long>(tiles_m) * tiles_n, sm_count());
  quant_wgmma<T, I4, COL><<<grid, QW_THREADS, QwRing<I4>::SMEM, s>>>(ta, tb, Kb, bk, Nb, tiles_m,
                                                                     tiles_n, ep);
  return static_cast<int>(cudaGetLastError());
}

// The four (int8 / int4) x (row / col) instantiations of a launcher `L`
// (a callable taking the compile-time <I4, COL> as std::integral_constant
// arguments).
template <class L>
int quant_dispatch(int b_dt, int b_col, L&& launch) {
  using F = std::false_type;
  using Tr = std::true_type;
  if (b_dt == DT_I4) return b_col ? launch(Tr{}, Tr{}) : launch(Tr{}, F{});
  return b_col ? launch(F{}, Tr{}) : launch(F{}, F{});
}

}  // namespace
