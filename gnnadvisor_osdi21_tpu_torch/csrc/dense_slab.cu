// Dense slab contractions of the measurement probes on a streamed slab
// ring: a slab A of K columns over R graph rows, stored [K, R] (graph rows
// contiguous), contracted over K with a 16-wide feature table on the
// tensor cores.
//
// Replaces the TPU kernels of the probe scripts:
//   _i8_t_kernel   (gnnadvisor_osdi21_tpu/bench/fixprobe.py:94, pallas_call
//                   at :105): out[16, R] = x_t[16, K] @ A, A int8 [K, R]
//                   cast to bf16, x_t bf16;
//   _dense_kernel  (gnnadvisor_osdi21_tpu/bench/stepprobe.py:69,
//                   pallas_call at :82): out[R, 16] = A^T @ x[K, 16] for
//                   (A, x) int8/bf16, bf16/bf16 and int8/f32;
//   _i8_kernel     (gnnadvisor_osdi21_tpu/bench/fmtprobe.py:118,
//                   pallas_call at :124): out[R, 16] = A @ x[K, 16], A int8
//                   [R, K] (row-major: slab columns contiguous) cast to
//                   bf16, x bf16 (i8_slab; its own ring, below).
// Any int8 value is taken, not only 0/1, as the TPU kernels cast any.
//
// What bounds it.  Bytes: the slab crosses device memory once (K bytes a
// graph row as int8, 2K as bf16) and the f32 output once (64 bytes a row);
// the features are at most a few hundred KB.  The tensor cores' 2·16·K
// flops a row (three times that for f32 features, below) stay far below
// the byte time, but the CUDA cores' share is not small: the int8 slab has
// to be widened to bf16 cell by cell, and I2F (a conversion at 16 results
// per clock and SM on compute capability 9.0) would take nearly the whole
// byte time at K = 4096.
//
// Design.
// - Persistent blocks (as many as the SMs hold at once, two per SM) of one
//   producer warp and four consumer warps walk tiles of 256 graph rows,
//   blockIdx.x, + gridDim.x, ...  The producer keeps a ring of stages full
//   (mbarriers; async.cuh): a stage is kKS slab columns of the tile (64
//   int8 or 32 bf16 columns) and the same columns of the features.  The
//   slab part comes as boxes of one 2-D tensor map (cp.async.bulk.tensor),
//   the slab viewed as [K/2, 2·R] column pairs, so that its row stride is a
//   multiple of 16 bytes for every R that is a multiple of 8: boxes of 128
//   bytes by kKS / 2 columns, the even columns' boxes and the odd ones'.
//   Stages run on across tiles, so the next tile streams in while the
//   consumers finish this one.  (On the H100 a bulk copy per slab column,
//   256 bytes, streamed well below the memory rate, held back by the copy
//   engine's rate per request, and unswizzled boxes 32 bytes wider than
//   the tile, for a conflict-free row pitch, streamed slower than these.)
// - The features are put into the MMA's A-fragment order once per call by
//   a small pass (frag_features_kernel) into a scratch buffer: for each
//   k16 step, 32 lanes x 16 bytes.  A stage's feature slice is then one
//   contiguous bulk copy, and each lane takes its fragments with one
//   16-byte shared load per k16 step.
// - Graph rows are the MMA's N dimension and the 16 features its M: a
//   consumer warp owns 64 rows of the tile, eight n8 tiles of
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate).  The lane with g = lane/4
//   owns rows 8g..8g+7 of the warp's 64 (tile j's column g is row 8g + j),
//   and the lane with t = lane % 4 slab columns 4t..4t+3 of each k16 step
//   (the MMA's k index 2t, 2t+1, 2t+8, 2t+9: the same sum in another
//   order).  So its B fragments come from four vector loads, 8 bytes each
//   for int8, 16 for bf16, and a byte or half-word permute pairs columns
//   4t and 4t+1 (4t+2 and 4t+3) of one graph row into a fragment register:
//   no 2-byte shared loads.  The boxes are 128-byte swizzled (chunk q of
//   box row p at q ^ (p % 8)); the four lanes of one g read box rows 2t
//   (+1) apart, so every load's lanes fall in distinct banks.
// - int8 -> bf16 without I2F, exact for every int8 value b = -128·s + l
//   (s the sign bit, l the low 7 bits): one permute builds the bf16
//   0x4300 | l = 128 + l, another 0xC300 | (s << 7) = -(128 + 128·s), and
//   one bf16x2 FMA (x·1 + y) adds the pair; the sum is b, exact in bf16.
//   About 2.25 instructions a cell, four cells a permute.
// - f32 features (int8/f32) go through the tensor cores too: the feature
//   pass splits each f32 x exactly into three bf16 terms hi + mid + lo
//   (each the top 8 significant bits of what is left; exact for ±0 and
//   every normal |x| >= 2^-103), and each k16 step runs three MMAs into
//   the same accumulators.  The slab's values are exact in bf16 and every
//   product is exact in f32, so only the order of the f32 sums differs
//   from the plain version.  No TF32 anywhere.
// - Epilogues in whole sectors.  Lane (g, t) holds features g and g + 8 of
//   rows 16t..16t+15 of the warp's 64: out[16, R] is written as four
//   float4 per feature; out[R, 16] goes through a per-warp staging area in
//   shared memory (rows offset by 8 words per 16 rows: conflict-free both
//   ways) and leaves as float4 rows, 512 contiguous bytes a store.
// - R a multiple of 8 and K of 16.  A box starts on a 16-byte boundary:
//   for an int8 slab with R = 8 (mod 16) the odd columns start 8 bytes off
//   one, so their boxes start 8 bytes early (one box more) and the lanes
//   read 8 bytes in.  Rows past R in the last tile compute on whatever the
//   boxes brought and are not stored (each graph row is its own MMA
//   column); columns past K arrive as zeros and are not read.
// - The row-major int8 slab (i8_slab) has a ring of its own
//   (rows_ring_kernel), which keeps B.12/B.13's consumer untouched.  A
//   stage is 128 slab columns of a 64-row tile: one box of a 2-D tensor
//   map over [R, K] (128 bytes of a graph row by 64 rows, 128-byte
//   swizzled) and the same columns' feature fragments.  (On the H100,
//   boxes of 64-byte rows streamed a third slower: each row's piece is a
//   separate 64-byte read.)  The n8 tile j of a warp's 16 rows holds rows
//   8j..8j+7 (column g is row 8j + g), so the lane (g, t) takes columns
//   4t..4t+3 of one graph row, the k16 step's B fragments b0 and b1, with
//   one 32-bit shared load and widens them as above; the eight lanes of
//   one t read rows 8j..8j+7, which the swizzle puts in distinct banks.
//   A last stage past K (K a multiple of 64) gets zeros in its box and
//   only K's fragments, and runs only K's k16 steps.  The [R, 16]
//   epilogue stages a warp's rows in pairs, row r at r·16 + 8·(r / 2)
//   floats, conflict-free for this fragment order both ways.  Any R (rows
//   past R arrive as zeros and are not stored).
// No atomics; every output element is written once by one thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async.cuh"

namespace gnna {
namespace dense {

constexpr int kFeat = 16;  // the probes' feature width: one m16 MMA tile
constexpr int kWR = 64;    // graph rows per consumer warp: eight n8 tiles
constexpr int kBarrierBytes = 128;
constexpr int kFragBytes = 32 * 16;  // one k16 step's A fragments, one term
// out[R, 16] staging per warp: row r at r·16 + (r / 16)·8 floats
constexpr int kEpiFloats = kWR * kFeat + (kWR / 16) * 8;

enum Src { kInt8 = 1, kBf16 = 2 };

// The ring of a slab of E-byte elements with NS feature terms.  A stage
// holds kKS slab columns of a tile: the even columns as kBoxes boxes of
// kKS / 2 rows of 128 bytes (a box row is 128 bytes of one slab column,
// swizzled: 16-byte chunk q of box row p lands at chunk q ^ (p % 8)), the
// odd columns as kOddBoxes more (one more for an int8 slab, whose odd
// columns may start 8 bytes off a 16-byte boundary), then the features.
// Four stages, three with the three-term features: two blocks of threads
// per SM either way.
template <int E, int NS>
struct Ring {
  static constexpr int kNC = 4;  // consumer warps per block
  static constexpr int kTR = kWR * kNC;  // graph rows per tile
  static constexpr int kThreads = 32 * (kNC + 1);  // + the producer warp
  static constexpr int kStages = NS == 1 ? 4 : 3;
  static constexpr int kKS = 64 / E;  // slab columns per stage
  static constexpr int kBoxBytes = kKS / 2 * 128;
  static constexpr int kBoxes = kTR * E / 128;
  static constexpr int kOddBoxes = kBoxes + (E == 1);
  static constexpr int kFeatBytes = (kKS / 16) * NS * kFragBytes;
  static constexpr int kStageBytes =
      (kBoxes + kOddBoxes) * kBoxBytes + kFeatBytes;
  static_assert(kBoxBytes % 1024 == 0 && kStageBytes % 1024 == 0,
                "swizzled boxes start on 1024-byte boundaries");
};

// c[0:4] += A (16 x 16, row-major fragment a) x B (16 x 8, column fragment
// b0, b1): bf16 operands, f32 accumulate (PTX ISA, mma.m16n8k16).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// x + y on a bf16 pair (x·1 + y, rounded to nearest: exact here).
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t x, uint32_t y) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(x), "r"(0x3F803F80u), "r"(y));
  return d;
}

// Four int8 bytes [b0, b1, b2, b3] -> the bf16 pairs (b0, b1) and (b2, b3)
// (the first in the low half), exactly: bf16(0x4300 | l) = 128 + l plus
// bf16(0xC300 | s << 7) = -(128 + 128·s).
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t p, uint32_t& lo_pair,
                                               uint32_t& hi_pair) {
  const uint32_t l = p & 0x7F7F7F7Fu, s = p & 0x80808080u;
  lo_pair = add_bf16x2(prmt(l, 0x43434343u, 0x4140u),
                       prmt(s, 0xC3C3C3C3u, 0x4140u));
  hi_pair = add_bf16x2(prmt(l, 0x43434343u, 0x4342u),
                       prmt(s, 0xC3C3C3C3u, 0x4342u));
}

// B fragments of the lane's eight n8 tiles for one k16 step: b[j][0] pairs
// slab columns 4t and 4t+1 of graph row 8g + j, b[j][1] columns 4t+2 and
// 4t+3.  ``r[c]`` is the lane's part of column 4t + c: 8 int8 bytes or 8
// bf16 (graph rows 8g..8g+7).
template <int SRC>
struct Frag;

template <>
struct Frag<kInt8> {
  using Row = uint2;
  __device__ __forceinline__ static void build(const Row* r,
                                               uint32_t (&b)[8][2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // columns (4t, 4t+1), (4t+2, 4t+3)
        const uint32_t u = h ? r[2 * c].y : r[2 * c].x;
        const uint32_t v = h ? r[2 * c + 1].y : r[2 * c + 1].x;
        // [u.b0, v.b0, u.b1, v.b1] and [u.b2, v.b2, u.b3, v.b3]
        i8x4_to_bf16x2(prmt(u, v, 0x5140u), b[4 * h][c], b[4 * h + 1][c]);
        i8x4_to_bf16x2(prmt(u, v, 0x7362u), b[4 * h + 2][c], b[4 * h + 3][c]);
      }
    }
  }
};

template <>
struct Frag<kBf16> {
  using Row = uint4;
  __device__ __forceinline__ static void build(const Row* r,
                                               uint32_t (&b)[8][2]) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t u[4] = {r[2 * c].x, r[2 * c].y, r[2 * c].z, r[2 * c].w};
      const uint32_t v[4] = {r[2 * c + 1].x, r[2 * c + 1].y, r[2 * c + 1].z,
                             r[2 * c + 1].w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        b[2 * w][c] = prmt(u[w], v[w], 0x5410u);
        b[2 * w + 1][c] = prmt(u[w], v[w], 0x7632u);
      }
    }
  }
};

// f32 v = hi + mid + lo, each term a bf16 (the top 16 bits of what is
// left): exact for ±0 and normal |v| >= 2^-103, where every term is a
// normal bf16 of at most 8 significant bits.
__device__ __forceinline__ void split3(float v, uint32_t* t) {
  const uint32_t hi = __float_as_uint(v) & 0xFFFF0000u;
  const float r1 = __fsub_rn(v, __uint_as_float(hi));
  const uint32_t mid = __float_as_uint(r1) & 0xFFFF0000u;
  const float r2 = __fsub_rn(r1, __uint_as_float(mid));
  t[0] = hi >> 16;
  t[1] = mid >> 16;
  t[2] = __float_as_uint(r2) >> 16;
}

// The features in A-fragment order: for k16 step s, term p and lane
// (g, t), the uint4 {a0, a1, a2, a3} of mma.m16n8k16 at frags[(s·NS + p)·32
// + lane]: a0 = (feature g; slab columns 4t, 4t+1), a1 = (g + 8; 4t, 4t+1),
// a2 = (g; 4t+2, 4t+3), a3 = (g + 8; 4t+2, 4t+3), columns counted from 16s.
// (The MMA's k index 2t, 2t+1, 2t+8, 2t+9 is slab column 4t..4t+3: the
// same sum in another order, and B fragments from four columns in a row.)
// X is bf16 (NS = 1) or f32 (NS = 3, split); TRANS: x is x_t [16, K], else
// [K, 16].
template <typename X, int NS, bool TRANS>
__global__ void frag_features_kernel(const X* __restrict__ x, int K,
                                     uint4* __restrict__ frags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (K / 16) * 32) return;
  const int s = i >> 5, lane = i & 31, g = lane >> 2, t = lane & 3;
  uint32_t a[NS][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int f = g + 8 * (q & 1), k = 16 * s + 4 * t + 2 * (q >> 1);
    const size_t at0 = TRANS ? static_cast<size_t>(f) * K + k
                             : static_cast<size_t>(k) * kFeat + f;
    const size_t at1 = TRANS ? at0 + 1 : at0 + kFeat;
    if constexpr (NS == 1) {
      const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
      a[0][q] = static_cast<uint32_t>(xb[at0]) |
                (static_cast<uint32_t>(xb[at1]) << 16);
    } else {
      const float* xf = reinterpret_cast<const float*>(x);
      uint32_t t0[3], t1[3];
      split3(xf[at0], t0);
      split3(xf[at1], t1);
#pragma unroll
      for (int p = 0; p < NS; ++p) a[p][q] = t0[p] | (t1[p] << 16);
    }
  }
#pragma unroll
  for (int p = 0; p < NS; ++p)
    frags[(static_cast<size_t>(s) * NS + p) * 32 + lane] =
        make_uint4(a[p][0], a[p][1], a[p][2], a[p][3]);
}

// The ring walk.  TRANS: out is [16, R] (i8_slab_t), else [R, 16].  ``map``
// views the slab as [K/2, 2·R·E/4] uint32 (column pairs), boxes of kKS / 2
// rows of 32 words, 128-byte swizzled.
template <int SRC, int NS, bool TRANS>
__global__ void __launch_bounds__(Ring<SRC == kBf16 ? 2 : 1, NS>::kThreads)
    dense_ring_kernel(const __grid_constant__ CUtensorMap map, int K, int R,
                      const unsigned char* __restrict__ frags,
                      float* __restrict__ out) {
  constexpr int E = SRC == kBf16 ? 2 : 1;
  using G = Ring<E, NS>;
  constexpr int kStages = G::kStages, kNC = G::kNC, kTR = G::kTR;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  // the ring from the first 1024-byte boundary past the barriers
  const uint32_t base = smem_addr(smem);
  unsigned char* ring = smem + (((base + kBarrierBytes + 1023) & ~1023u) - base);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (R + kTR - 1) / kTR;
  // a box starts on a 16-byte boundary: an int8 slab with R = 8 (mod 16)
  // has its odd columns' box start 8 bytes early, and read 8 bytes in
  const int shift = (R * E) & 15;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kNC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kNC) {  // producer: one lane issues every copy
    if (lane) return;
    int seq = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int x0 = tile * kTR * E / 4;  // the tile in words of a row
      for (int kc = 0; kc < K; kc += G::kKS, ++seq) {
        const int slot = seq % kStages;
        if (seq >= kStages) mbar_wait(&empty[slot], (seq / kStages - 1) & 1);
        const uint32_t feat = (min(G::kKS, K - kc) / 16) * NS * kFragBytes;
        unsigned char* stage = ring + slot * G::kStageBytes;
        const int odd = G::kBoxes + (shift ? 1 : 0);  // boxes of odd columns
        mbar_expect_tx(&full[slot], (G::kBoxes + odd) * G::kBoxBytes + feat);
        for (int b = 0; b < G::kBoxes; ++b)
          tensor_load_2d(stage + b * G::kBoxBytes, &map, x0 + 32 * b, kc / 2,
                         &full[slot]);
        unsigned char* odds = stage + G::kBoxes * G::kBoxBytes;
        const int xo = x0 + (R * E - shift) / 4;
        for (int b = 0; b < odd; ++b)
          tensor_load_2d(odds + b * G::kBoxBytes, &map, xo + 32 * b, kc / 2,
                         &full[slot]);
        bulk_load(stage + (G::kBoxes + G::kOddBoxes) * G::kBoxBytes,
                  frags + static_cast<size_t>(kc / 16) * NS * kFragBytes,
                  feat, &full[slot]);
      }
    }
    return;
  }

  // consumer: rows r0 + warp·64 + [0, 64)
  using F = Frag<SRC>;
  using Row = typename F::Row;
  const int g = lane >> 2, t = lane & 3;
  // where the lane's part of column 16s + 4t + c lies in a stage, less
  // s·1024: box row 8s + p of its parity's boxes, p = 2t + c / 2, bytes
  // from o = its graph rows' offset in the column (8 more for a shifted
  // odd column), chunks swizzled by p
  uint32_t at[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int p = 2 * t + (c >> 1);
    const int o = (warp * kWR + 8 * g) * E + ((c & 1) ? shift : 0);
    at[c] = ((c & 1) * G::kBoxes + (o >> 7)) * G::kBoxBytes + p * 128 +
            ((((o & 127) >> 4) ^ p) << 4) + (o & 15);
  }
  int seq = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

    for (int kc = 0; kc < K; kc += G::kKS, ++seq) {
      const int slot = seq % kStages;
      mbar_wait(&full[slot], (seq / kStages) & 1);
      const unsigned char* stage = ring + slot * G::kStageBytes;
      const uint4* fs = reinterpret_cast<const uint4*>(
                            stage + (G::kBoxes + G::kOddBoxes) * G::kBoxBytes) +
                        lane;
      const int nk16 = min(G::kKS, K - kc) / 16;
#pragma unroll
      for (int s = 0; s < G::kKS / 16; ++s) {
        if (s >= nk16) break;
        uint32_t a[NS][4];
#pragma unroll
        for (int p = 0; p < NS; ++p) {
          const uint4 q = fs[(s * NS + p) * 32];
          a[p][0] = q.x;
          a[p][1] = q.y;
          a[p][2] = q.z;
          a[p][3] = q.w;
        }
        Row r[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          r[c] = *reinterpret_cast<const Row*>(stage + at[c] + s * 1024);
        uint32_t b[8][2];
        F::build(r, b);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int p = 0; p < NS; ++p) mma_bf16(acc[j], a[p], b[j][0], b[j][1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }

    // acc[j]: features (g, g + 8) x rows (16t + j, 16t + 8 + j) of the
    // warp's 64
    const int rw = tile * kTR + warp * kWR;  // the warp's first row
    if (TRANS) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = rw + 16 * t + 4 * q;  // R is a multiple of 8
        if (r >= R) continue;
        const int j0 = 4 * (q & 1), e = q >> 1;
        *reinterpret_cast<float4*>(out + static_cast<size_t>(g) * R + r) =
            make_float4(acc[j0][e], acc[j0 + 1][e], acc[j0 + 2][e],
                        acc[j0 + 3][e]);
        *reinterpret_cast<float4*>(out + static_cast<size_t>(g + 8) * R + r) =
            make_float4(acc[j0][e + 2], acc[j0 + 1][e + 2], acc[j0 + 2][e + 2],
                        acc[j0 + 3][e + 2]);
      }
    } else {
      float* st = reinterpret_cast<float*>(ring + kStages * G::kStageBytes) +
                  warp * kEpiFloats;
      __syncwarp();  // the last tile's rows have left
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* a = st + (16 * t + j) * kFeat + 8 * t;
        a[g] = acc[j][0];
        a[g + 8] = acc[j][2];
        a[8 * kFeat + g] = acc[j][1];
        a[8 * kFeat + g + 8] = acc[j][3];
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kWR / 8; ++i) {
        const int rl = 8 * i + (lane >> 2), q = lane & 3;
        if (rw + rl < R)
          *reinterpret_cast<float4*>(out + static_cast<size_t>(rw + rl) *
                                               kFeat + 4 * q) =
              *reinterpret_cast<const float4*>(st + rl * kFeat +
                                               (rl >> 4) * 8 + 4 * q);
      }
    }
  }
}

// The row-major int8 slab's ring (i8_slab): one producer warp and four
// consumer warps of kWR graph rows each (two n8 tiles); a stage is kKS slab
// columns (a 128-byte box row) of a kTR-row tile, one box, and their
// feature fragments.
struct RowRing {
  static constexpr int kNC = 4;
  static constexpr int kWR = 16;
  static constexpr int kTR = kWR * kNC;
  static constexpr int kThreads = 32 * (kNC + 1);
  static constexpr int kStages = 4;
  static constexpr int kKS = 128;
  static constexpr int kBoxBytes = kKS * kTR;
  static constexpr int kFeatBytes = (kKS / 16) * kFragBytes;
  static constexpr int kStageBytes = kBoxBytes + kFeatBytes;
  // staging per warp: row r at r·16 + (r / 2)·8 floats
  static constexpr int kEpi = kWR * kFeat + (kWR / 2) * 8;
  static_assert(kStageBytes % 1024 == 0,
                "swizzled boxes start on 1024-byte boundaries");
};

// out[R, 16] = A @ x, A int8 [R, K] seen through ``map`` ([R, K] bytes,
// boxes of kKS columns by kTR rows), x's fragments in ``frags``.
__global__ void __launch_bounds__(RowRing::kThreads)
    rows_ring_kernel(const __grid_constant__ CUtensorMap map, int K, int R,
                     const unsigned char* __restrict__ frags,
                     float* __restrict__ out) {
  using G = RowRing;
  constexpr int kStages = G::kStages, kNC = G::kNC, kTR = G::kTR;
  constexpr int KS = G::kKS, WR = G::kWR;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  const uint32_t base = smem_addr(smem);
  unsigned char* ring = smem + (((base + kBarrierBytes + 1023) & ~1023u) - base);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (R + kTR - 1) / kTR;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kNC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kNC) {  // producer: one lane starts every copy
    if (lane) return;
    int seq = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int kc = 0; kc < K; kc += KS, ++seq) {
        const int slot = seq % kStages;
        if (seq >= kStages) mbar_wait(&empty[slot], (seq / kStages - 1) & 1);
        unsigned char* stage = ring + slot * G::kStageBytes;
        const uint32_t feat = (min(KS, K - kc) / 16) * kFragBytes;
        mbar_expect_tx(&full[slot], G::kBoxBytes + feat);
        tensor_load_2d(stage, &map, kc, tile * kTR, &full[slot]);
        bulk_load(stage + G::kBoxBytes,
                  frags + static_cast<size_t>(kc / 16) * kFragBytes, feat,
                  &full[slot]);
      }
    }
    return;
  }

  // consumer: rows tile·kTR + warp·WR + [0, WR); the lane reads rows
  // warp·WR + 8j + g, whose box rows swizzle the 16-byte chunks by g
  const int g = lane >> 2, t = lane & 3;
  const uint32_t row0 = (warp * WR + g) * KS + 4 * t;
  float* st = reinterpret_cast<float*>(ring + kStages * G::kStageBytes) +
              warp * G::kEpi;
  int seq = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[WR / 8][4];
#pragma unroll
    for (int j = 0; j < WR / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

    for (int kc = 0; kc < K; kc += KS, ++seq) {
      const int slot = seq % kStages;
      mbar_wait(&full[slot], (seq / kStages) & 1);
      const unsigned char* stage = ring + slot * G::kStageBytes;
      const uint4* fs =
          reinterpret_cast<const uint4*>(stage + G::kBoxBytes) + lane;
      const int nk16 = min(KS, K - kc) / 16;
#pragma unroll
      for (int s = 0; s < KS / 16; ++s) {
        if (s >= nk16) break;
        const uint4 q = fs[s * 32];
        const uint32_t a[4] = {q.x, q.y, q.z, q.w};
        const unsigned char* col = stage + row0 + ((s ^ g) << 4);
#pragma unroll
        for (int j = 0; j < WR / 8; ++j) {
          uint32_t b0, b1;
          i8x4_to_bf16x2(*reinterpret_cast<const uint32_t*>(col + j * 8 * KS),
                         b0, b1);
          mma_bf16(acc[j], a, b0, b1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }

    // acc[j]: features (g, g + 8) x rows (8j + 2t, 8j + 2t + 1) of the
    // warp's WR, staged with row r at r·16 + (r / 2)·8
    const int rw = tile * kTR + warp * WR;  // the warp's first row
    __syncwarp();  // the last tile's rows have left
#pragma unroll
    for (int j = 0; j < WR / 8; ++j) {
      float* a = st + (8 * j + 2 * t) * kFeat + (4 * j + t) * 8;
      a[g] = acc[j][0];
      a[g + 8] = acc[j][2];
      a[kFeat + g] = acc[j][1];
      a[kFeat + g + 8] = acc[j][3];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < WR / 8; ++i) {
      const int rl = 8 * i + (lane >> 2), q = lane & 3;
      if (rw + rl < R)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(rw + rl) *
                                             kFeat + 4 * q) =
            *reinterpret_cast<const float4*>(st + rl * kFeat +
                                             (rl >> 1) * 8 + 4 * q);
    }
  }
}

int launch_rows(const void* slab, int K, int R, const void* frags, void* out,
                cudaStream_t stream) {
  using G = RowRing;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(R)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {G::kKS, G::kTR};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(slab),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kBarrierBytes + 1024 + G::kStages * G::kStageBytes +
                      sizeof(float) * G::kNC * G::kEpi;
  auto kernel = rows_ring_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        G::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (R + G::kTR - 1) / G::kTR;
  kernel<<<min(tiles, max(1, sms * min(per_sm, 2))), G::kThreads, smem,
           stream>>>(map, K, R, static_cast<const unsigned char*>(frags),
                     static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename X, int NS, bool TRANS>
int prepare(const void* x, int K, void* frags, cudaStream_t stream) {
  const int n = (K / 16) * 32;
  frag_features_kernel<X, NS, TRANS><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const X*>(x), K, static_cast<uint4*>(frags));
  return static_cast<int>(cudaGetLastError());
}

template <int SRC, int NS, bool TRANS>
int launch_ring(const void* slab, int K, int R, const void* frags, void* out,
                cudaStream_t stream) {
  constexpr int E = SRC == kBf16 ? 2 : 1;
  using G = Ring<E, NS>;
  // the [K, R] slab as [K/2, 2·R·E/4] uint32: slab columns 2i and 2i + 1 in
  // row i, whose stride, 2·R·E bytes, is a multiple of 16 for R a multiple
  // of 8
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(R) * E / 2,
                              static_cast<cuuint64_t>(K / 2)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(R) * E * 2};
  const cuuint32_t box[2] = {32, G::kKS / 2};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(slab),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kBarrierBytes + 1024 + G::kStages * G::kStageBytes +
                      (TRANS ? 0 : sizeof(float) * G::kNC * kEpiFloats);
  auto kernel = dense_ring_kernel<SRC, NS, TRANS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  // persistent: as many blocks of threads as the SMs hold at once, two per
  // SM at most
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        G::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (R + G::kTR - 1) / G::kTR;
  kernel<<<min(tiles, max(1, sms * min(per_sm, 2))), G::kThreads, smem,
           stream>>>(map, K, R, static_cast<const unsigned char*>(frags),
                     static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

inline bool bad(const void* a, int K, int R, const void* x, const void* frags,
                const void* out) {
  const auto mis = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  return K <= 0 || K % 16 || R <= 0 || R % 8 || mis(a) || mis(x) ||
         mis(frags) || mis(out);
}

}  // namespace dense
}  // namespace gnna

extern "C" {

// a int8 [K, R], x_t bf16 [16, K] -> out f32 [16, R]; frags: scratch of
// K / 16 · 512 bytes for the features in fragment order.
int gnna_i8_slab_t(const void* a, int K, int R, const void* x_t, void* frags,
                   void* out, void* stream) {
  using namespace gnna::dense;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad(a, K, R, x_t, frags, out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = prepare<uint16_t, 1, true>(x_t, K, frags, s);
  return rc ? rc : launch_ring<kInt8, 1, true>(a, K, R, frags, out, s);
}

// a [K, R] (int8, or bf16 when a_bf16), x [K, 16] (bf16, or f32 when x_f32,
// which takes an int8 slab) -> out f32 [R, 16]; frags: scratch of K / 16 ·
// 512 bytes (three times that for f32 features).
int gnna_dense_slab(const void* a, int a_bf16, int K, int R, const void* x,
                    int x_f32, void* frags, void* out, void* stream) {
  using namespace gnna::dense;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad(a, K, R, x, frags, out) || (a_bf16 && x_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_f32) {
    const int rc = prepare<float, 3, false>(x, K, frags, s);
    return rc ? rc : launch_ring<kInt8, 3, false>(a, K, R, frags, out, s);
  }
  const int rc = prepare<uint16_t, 1, false>(x, K, frags, s);
  if (rc) return rc;
  return a_bf16 ? launch_ring<kBf16, 1, false>(a, K, R, frags, out, s)
                : launch_ring<kInt8, 1, false>(a, K, R, frags, out, s);
}

// a int8 [R, K] (K a multiple of 64), x bf16 [K, 16] -> out f32 [R, 16];
// frags: scratch of K / 16 · 512 bytes.  block_rows (a positive multiple
// of 256, the TPU grid step) is checked and does not change the launch.
int gnna_i8_slab(const void* a, int R, int K, const void* x, int block_rows,
                 void* frags, void* out, void* stream) {
  using namespace gnna::dense;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto mis = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (K <= 0 || K % 64 || R <= 0 || block_rows <= 0 || block_rows % 256 ||
      mis(a) || mis(x) || mis(frags) || mis(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = prepare<uint16_t, 1, false>(x, K, frags, s);
  return rc ? rc : launch_rows(a, K, R, frags, out, s);
}

}  // extern "C"
