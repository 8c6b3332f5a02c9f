// The measurement probes' legacy uint32 bit slabs, contracted with a 16-wide
// feature table by a streamed walk over the set bits.
//
// Replaces the TPU kernels of the probe scripts:
//   mk_slab.kern   (gnnadvisor_osdi21_tpu/bench/fmtprobe.py:216, pallas_call
//                   at :235): out[R, 16] = unpack(bits [R, K/32]) @ x, x bf16
//                   (base_bf16) or f32 (mul_f32dot), the row-major slab;
//   _bit_t_kernel  (gnnadvisor_osdi21_tpu/bench/fixprobe.py:63, pallas_call
//                   at :76): out[16, R] = x_t[16, K] @ unpack(bits [K/32, R]),
//                   x_t bf16, the word-major ("transposed") slab.
// In both, slab column j sits in word j % W32 at bit j // W32.
//
// What bounds it.  Bytes: the slab crosses device memory once (K/8 bytes a
// graph row) and the f32 output once (64 bytes a row); the table is at
// most 256 KB and stays in L2.  The probes' slabs are almost empty (6 and
// 8 set bits a row over K = 4096 and 2048), so the work is the set bits'
// table-row adds (16 f32 adds a bit), far below the byte time; the TPU
// kernels' dense 2·16·K flops a row are not needed.
//
// Design.  Tiles of 128 consecutive graph rows; persistent blocks of one
// producer warp and eight consumer warps of 16 rows walk tiles blockIdx.x,
// + gridDim.x, ...
// - The producer streams each tile's slab, kStageWords words of every row
//   a stage, through a ring of kStages shared-memory stages guarded by full
//   and empty mbarriers (async.cuh), running on into the next tile.  A
//   stage is one box of a 2-D tensor map over the slab (the tile's 128 rows
//   by the stage's words), one copy request from one lane, where a bulk
//   copy per word would leave the stream to the copy engine's rate per
//   request.
// - Row owners.  Lanes 2i and 2i + 1 of a consumer warp own graph row i of
//   the warp's 16, each half of the stage's words of that row.  A lane
//   copies its words into registers; a zero word costs its popcount.
// - The lane writes the columns of its set bits (bit·W32 + word, in a fixed
//   order: its words in order, bits from the lowest) into its row's list in
//   shared memory, after its partner's (one shuffle says where), and the
//   stage is released: a row's list outlives the stage, and the ring
//   refills while the warp adds.
// - When a row's list holds kAddAt columns, or would overflow, and at the
//   end of a tile, the warp adds the listed table rows: each lane of a row
//   takes every second column, loads whole table rows (32 or 64 bytes, as
//   16-byte loads, kUnroll rows in flight) and adds them in list order into
//   16 f32 registers.  The tile's output row is the two lanes' sums, each
//   lane writing half of it.
// Every product of a 0/1 entry with a feature is exact, so the result
// differs from the plain version by the order of the f32 sums only, and
// that order is fixed: no atomics, one writer per output element, the same
// result whatever the grid (the wrappers' block_rows does not change it).

#include <cuda_runtime.h>
#include <stdint.h>

#include "async.cuh"

namespace gnna {
namespace walk {

constexpr int kFeat = 16;       // the probes' feature width
constexpr int kTileRows = 128;  // graph rows per tile
constexpr int kWarpRows = 16;   // rows per consumer warp
constexpr int kConsumers = kTileRows / kWarpRows;
constexpr int kThreads = 32 * (kConsumers + 1);  // + the producer warp
constexpr int kStages = 4;
constexpr int kStageWords = 16;  // words of each row per stage
constexpr int kLaneWords = kStageWords / 2;  // a lane's words of a stage
constexpr int kCap = 32;    // a row's list
constexpr int kAddAt = 8;  // listed columns of a row that start the adds
constexpr int kBarrierBytes = 128;
constexpr int kAlign = 128;  // a tensor-map box lands 128-byte aligned
constexpr unsigned kAll = 0xFFFFFFFFu;

// --- Slab layouts -----------------------------------------------------------

// uint32 [W32, R], graph rows minor (fixprobe; out [16, R]).  A stage is a
// box of the tile's 128 rows by min(kStageWords, W32) words, word after word
// (512 bytes a word): lane (i, h) reads words 2j + h of row i.  (The two
// halves of the warp read the same banks: two-way conflicts on eight 4-byte
// reads a stage.)
struct W32 {
  static constexpr bool kTransposedOut = true;
  static constexpr int kWordStride = 4 * kTileRows;
  static constexpr int kStageBytes = kStageWords * kWordStride;
  // the box's coordinates (innermost first) for words w0.. of rows r0..
  __device__ __forceinline__ static int2 at(int w0, int r0) {
    return make_int2(r0, w0);
  }
  __device__ __forceinline__ static int word(int j, int h) { return 2 * j + h; }
  __device__ __forceinline__ static void read(const unsigned char* stage,
                                              int, int nw, int row, int h,
                                              int, uint32_t (&w)[kLaneWords]) {
#pragma unroll
    for (int j = 0; j < kLaneWords; ++j)
      w[j] = word(j, h) < nw ? *reinterpret_cast<const uint32_t*>(
                                   stage + word(j, h) * kWordStride + row * 4)
                             : 0u;
  }
};

// uint32 [R, W32], a row's words contiguous (fmtprobe; out [R, 16]).  A
// stage is one box
// of min(kStageWords, W32) words by 128 rows, row after row (``pitch``
// bytes a row): lane (i, h) reads words 8h..8h+7 of row i as two 16-byte
// pieces, odd quarter warps the second piece first, so a quarter warp's
// reads fall in eight distinct bank groups.
struct Row32 {
  static constexpr bool kTransposedOut = false;
  static constexpr int kStageBytes = kStageWords * 4 * kTileRows;
  __device__ __forceinline__ static int2 at(int w0, int r0) {
    return make_int2(w0, r0);
  }
  __device__ __forceinline__ static int word(int j, int h) {
    return kLaneWords * h + j;
  }
  __device__ __forceinline__ static void read(const unsigned char* stage,
                                              int pitch, int nw, int row,
                                              int h, int lane,
                                              uint32_t (&w)[kLaneWords]) {
    const int first = (lane >> 2) & 1;  // the piece read first
    uint4 q[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = p ^ first;
      q[p] = kLaneWords * h + 4 * c < nw
                 ? *reinterpret_cast<const uint4*>(stage + row * pitch +
                                                   32 * h + 16 * c)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    const uint4 lo = first ? q[1] : q[0], hi = first ? q[0] : q[1];
    w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
    w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
  }
};

// --- Table rows -------------------------------------------------------------

// One table row (16 features) as 16-byte pieces, widened and added to f32.
template <typename T>
struct TableRow;
template <>
struct TableRow<uint16_t> {  // bf16
  static constexpr int kPieces = 2;
  __device__ __forceinline__ static void add(const uint4 (&q)[kPieces],
                                             float (&acc)[kFeat]) {
    const uint32_t v[8] = {q[0].x, q[0].y, q[0].z, q[0].w,
                           q[1].x, q[1].y, q[1].z, q[1].w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc[2 * k] += __uint_as_float(v[k] << 16);
      acc[2 * k + 1] += __uint_as_float(v[k] & 0xFFFF0000u);
    }
  }
};
template <>
struct TableRow<float> {
  static constexpr int kPieces = 4;
  __device__ __forceinline__ static void add(const uint4 (&q)[kPieces],
                                             float (&acc)[kFeat]) {
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      acc[4 * p] += __uint_as_float(q[p].x);
      acc[4 * p + 1] += __uint_as_float(q[p].y);
      acc[4 * p + 2] += __uint_as_float(q[p].z);
      acc[4 * p + 3] += __uint_as_float(q[p].w);
    }
  }
};

// Table rows in flight per lane before any is added.  (Four or eight were
// slower on the H100: the registers they take spill at this kernel's
// bound of three blocks of threads per SM.)
constexpr int kUnroll = 2;

// Add the table rows of row list ``list`` [0, cnt) that are lane half h's
// (entries h, h + 2, ...), in list order.  Warp-wide: every lane calls it.
template <typename T>
__device__ __forceinline__ void add_rows(const uint32_t* list, int cnt, int h,
                                         const T* __restrict__ table,
                                         float (&acc)[kFeat]) {
  using R = TableRow<T>;
  __syncwarp();  // the partner's list entries are written
  for (int i0 = h; __any_sync(kAll, i0 < cnt); i0 += 2 * kUnroll) {
    uint4 q[kUnroll][R::kPieces];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + 2 * u;
      if (i < cnt) {
        const uint4* row = reinterpret_cast<const uint4*>(
            table + static_cast<size_t>(list[i]) * kFeat);
#pragma unroll
        for (int p = 0; p < R::kPieces; ++p) q[u][p] = __ldg(row + p);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + 2 * u < cnt) R::add(q[u], acc);
  }
  __syncwarp();  // the list is read before it is written again
}

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads, 3)
    walk_kernel(const __grid_constant__ CUtensorMap map, int words, int R,
                const T* __restrict__ table, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  const uint32_t base = smem_addr(smem);
  unsigned char* ring =
      smem + (((base + kBarrierBytes + kAlign - 1) & ~(kAlign - 1u)) - base);
  uint32_t* lists =
      reinterpret_cast<uint32_t*>(ring + kStages * L::kStageBytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stages = (words + kStageWords - 1) / kStageWords;
  const int tiles = (R + kTileRows - 1) / kTileRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // producer
    const uint32_t box_bytes = min(kStageWords, words) * 4 * kTileRows;
    int seq = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int r0 = tile * kTileRows;
      for (int st = 0; st < stages; ++st, ++seq) {
        const int slot = seq % kStages;
        if (seq >= kStages) mbar_wait(&empty[slot], (seq / kStages - 1) & 1);
        // the whole box's bytes arrive, zeros past the slab included
        if (lane == 0) {
          const int2 at = L::at(st * kStageWords, r0);
          mbar_expect_tx(&full[slot], box_bytes);
          tensor_load_2d(ring + slot * L::kStageBytes, &map, at.x, at.y,
                         &full[slot]);
        }
      }
    }
    return;
  }

  // consumer: lanes 2i, 2i + 1 own row r0 + warp·16 + i
  const int i = lane >> 1, h = lane & 1;
  const int row = warp * kWarpRows + i;  // in the tile
  uint32_t* list = lists + (warp * kWarpRows + i) * kCap;
  const int pitch = 4 * min(kStageWords, words);  // a staged row (Row32)
  int seq = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * kTileRows;
    float acc[kFeat];
#pragma unroll
    for (int f = 0; f < kFeat; ++f) acc[f] = 0.f;
    int cnt = 0;  // the row's listed columns (the same in both lanes)
    for (int st = 0; st < stages; ++st, ++seq) {
      const int slot = seq % kStages;
      const int w0 = st * kStageWords;
      const int nw = min(kStageWords, words - w0);
      mbar_wait(&full[slot], (seq / kStages) & 1);
      // a row past R reads no word (the last tile's stale stage bytes)
      uint32_t w[kLaneWords];
      L::read(ring + slot * L::kStageBytes, pitch, r0 + row < R ? nw : 0, row,
              h, lane, w);
      int c = 0;
#pragma unroll
      for (int j = 0; j < kLaneWords; ++j) c += __popc(w[j]);
      const int cp = __shfl_xor_sync(kAll, c, 1);
      const int tot = c + cp;  // the row's columns of this stage
      if (__any_sync(kAll, cnt + tot > kCap)) {
        add_rows<T>(list, cnt, h, table, acc);
        cnt = 0;
      }
      // in chunks of the list's size: one unless a row is dense
      const int chunks = __reduce_max_sync(kAll, (tot + kCap - 1) / kCap);
      for (int ch = 0; ch < chunks; ++ch) {
        const int lo = ch * kCap;
        if (ch) {
          add_rows<T>(list, cnt, h, table, acc);
          cnt = 0;
        }
        int idx = h ? cp : 0;  // the lane's columns follow its partner's
#pragma unroll
        for (int j = 0; j < kLaneWords; ++j) {
          uint32_t m = w[j];
          const int col0 = w0 + L::word(j, h);
          while (m) {
            const int bit = __ffs(m) - 1;
            m &= m - 1;
            if (idx >= lo && idx < lo + kCap)
              list[cnt + idx - lo] = static_cast<uint32_t>(bit * words + col0);
            ++idx;
          }
        }
        cnt += max(0, min(kCap, tot - lo));
      }
      // release the stage after the words' last use, not once they are
      // read: the compiler may read a word from the stage again rather
      // than keep it in a register (it cannot see the copies that refill
      // the stage).  Released right after the reads, some rows came out
      // with bits of the stage's next fill on the H100 under this kernel's
      // register bound.
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (__any_sync(kAll, cnt >= kAddAt)) {
        add_rows<T>(list, cnt, h, table, acc);
        cnt = 0;
      }
    }
    add_rows<T>(list, cnt, h, table, acc);

    // the row's sum: this lane's half of the features, its own part plus
    // its partner's (f32 addition commutes, so both lanes agree)
    float s[kFeat / 2];
#pragma unroll
    for (int f = 0; f < kFeat / 2; ++f) {
      const float mine = h ? acc[kFeat / 2 + f] : acc[f];
      const float other =
          __shfl_xor_sync(kAll, h ? acc[f] : acc[kFeat / 2 + f], 1);
      s[f] = mine + other;
    }
    const int r = r0 + row;
    if (r < R) {
      if (L::kTransposedOut) {
#pragma unroll
        for (int f = 0; f < kFeat / 2; ++f)
          out[static_cast<size_t>(kFeat / 2 * h + f) * R + r] = s[f];
      } else {
        float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(r) *
                                                        kFeat +
                                              kFeat / 2 * h);
        o[0] = make_float4(s[0], s[1], s[2], s[3]);
        o[1] = make_float4(s[4], s[5], s[6], s[7]);
      }
    }
  }
}

// x [K, 16] = x_t [16, K]ᵀ (bf16): the walk reads whole table rows.
__global__ void transpose_table_kernel(const uint16_t* __restrict__ x_t, int K,
                                       uint16_t* __restrict__ x) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // e = k·16 + f
  if (e < K * kFeat) x[e] = x_t[static_cast<size_t>(e % kFeat) * K + e / kFeat];
}

// A 2-D tensor map over a uint32 slab of ``inner`` by ``outer`` words
// (``inner`` contiguous; its stride a multiple of 16 bytes), boxes of
// ``box_inner`` by ``box_outer`` words, unswizzled; words past the slab
// arrive as zeros.
inline int encode_slab(const void* bits, int inner, int outer, int box_inner,
                       int box_outer, CUtensorMap* map) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(bits),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's shared memory and its resident blocks (as many as the SMs
// hold at once: the blocks are persistent), set up on the first launch, for
// the card current then, and kept: that host work leaves every later
// launch (the probes run on one card).
struct Setup {
  cudaError_t err;
  size_t smem;
  int blocks;
};

template <typename T, typename L>
Setup setup() {
  Setup s{cudaSuccess,
          kBarrierBytes + kAlign + kStages * L::kStageBytes +
              sizeof(uint32_t) * kTileRows * kCap,
          0};
  auto kernel = walk_kernel<T, L>;
  int device = 0, sms = 0, per_sm = 0;
  s.err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s.smem));
  if (s.err == cudaSuccess) s.err = cudaGetDevice(&device);
  if (s.err == cudaSuccess)
    s.err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (s.err == cudaSuccess)
    s.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, s.smem);
  s.blocks = max(1, sms * per_sm);
  return s;
}

template <typename T, typename L>
int launch(const CUtensorMap& map, int words, int R, const void* table,
           float* out, cudaStream_t stream) {
  static const Setup s = setup<T, L>();
  if (s.err != cudaSuccess) return static_cast<int>(s.err);
  const int tiles = (R + kTileRows - 1) / kTileRows;
  walk_kernel<T, L><<<min(tiles, s.blocks), kThreads, s.smem, stream>>>(
      map, words, R, static_cast<const T*>(table), out);
  return static_cast<int>(cudaGetLastError());
}

inline bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace walk
}  // namespace gnna

extern "C" {

// fmtprobe's bit slab: bits uint32 [R, W32] (W32 a multiple of 4), x [32·W32,
// 16] bf16 (or f32 when x_f32) -> out f32 [R, 16].  ``block_rows`` (a
// positive multiple of 256, the TPU grid step's rows) is checked and does
// not change the launch: the walk sizes its own tiles.
int gnna_bit_slab(const void* bits, int R, int W32, const void* x, int x_f32,
                  int block_rows, void* out, void* stream) {
  using namespace gnna::walk;
  if (R <= 0 || W32 <= 0 || W32 % 4 || block_rows <= 0 || block_rows % 256 ||
      misaligned(bits) || misaligned(x) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int rc =
      encode_slab(bits, W32, R, min(kStageWords, W32), kTileRows, &map);
  if (rc) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  return x_f32 ? launch<float, Row32>(map, W32, R, x, o, s)
               : launch<uint16_t, Row32>(map, W32, R, x, o, s);
}

// fixprobe's bit slab: bits uint32 [w32, R] (R a multiple of 8), x_t bf16
// [16, 32·w32] -> out f32 [16, R]; table: scratch of 32·w32 · 16 bf16, where
// x_t is first copied row-major.  ``block_rows`` (32 to 512, a multiple of
// 32) is checked and does not change the launch.
int gnna_bit_slab_t(const void* bits, int w32, int R, const void* x_t,
                    void* table, int block_rows, void* out, void* stream) {
  using namespace gnna::walk;
  if (w32 <= 0 || R <= 0 || R % 8 || block_rows < 32 || block_rows > 512 ||
      block_rows % 32 || misaligned(bits) || misaligned(table) ||
      misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int rc =
      encode_slab(bits, R, w32, kTileRows, min(kStageWords, w32), &map);
  if (rc) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = 32 * w32 * kFeat;
  transpose_table_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const uint16_t*>(x_t), 32 * w32,
      static_cast<uint16_t*>(table));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<uint16_t, W32>(map, w32, R, table, static_cast<float*>(out),
                               s);
}

}  // extern "C"
