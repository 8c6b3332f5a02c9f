// Two of the format probe's kernels (bench/fmtprobe.py): a streaming
// read-reduce and a one-hot segment reduce.  (Its dense int8 slab runs on
// the slab ring of dense_slab.cu, and its row-major bit slab is walked over
// its set bits in bit_walk.cu.)
//
// Replaces the TPU kernels of gnnadvisor_osdi21_tpu/bench/fmtprobe.py:
//   _sum_kernel   (:53, pallas_call at :63): each [block, K] row block of an
//                 int8, f32 or uint32 [R, K] array summed to one f32 (uint32
//                 words read as int32), plus s [8, 128] -> one [8, 128] tile
//                 per block;
//   _seg_kernel   (:287, pallas_call at :335): per tile of TILE slots,
//                 mask the [TILE, 128] values by a lane-group bit mask, fold
//                 the 128 lanes to 16, and reduce the slots into OB output
//                 rows by a one-hot product; the tile's part is written into
//                 (first tile) or added to its output block.
//
// What bounds them.  Bytes: each reads its big operand once (the [R, K]
// array or the [m, 128] values) and writes a small output; the bf16
// tensor cores' one-hot products (2·16 flops a slot and output row met)
// and the fold's few CUDA-core operations a value stay far below the byte
// time.
//
// Design.
// - stream_sum: one CTA per row block, 16-byte loads, four in flight per
//   thread.  Each thread sums exactly (int8 through dp4a into int64, int32
//   words into int64) or in f64 (f32 values), the CTA adds the threads'
//   sums in a fixed tree order, and the block total is rounded to f32 once.
//   So the result does not depend on the launch, and equals the plain
//   version (an f64 sum rounded once) for integer inputs.
// - seg_reduce: persistent CTAs (one per SM) walk the output blocks,
//   blockIdx.x, + gridDim.x, ...; each block's tiles are contiguous slots
//   (t2b is sorted) and are walked in order, so "set on the first tile,
//   then add" needs no atomics and each output element is written once.
//   A producer warp finds each block's tiles (a search of t2b by the
//   whole warp, 32 entries a probe, the first around where an even spread
//   puts them) and keeps a ring of stages full (mbarriers; async.cuh):
//   a stage is kSlots consecutive slots of one block, their values (32 KB,
//   one bulk copy), masks and segment ids, plus a word of what the stage
//   is.  Stages run on across tiles and blocks, so the next block streams
//   in while this one runs its products and its stores; a block without
//   tiles is a stage without slots, and the consumers write it as zeros.
//   Eight consumer warps take each stage in two steps:
//   * the fold: a thread owns one slot and four features.  It reads the
//     eight lane groups from the stage as 16-byte loads (odd slots take
//     each pair of groups in the other order, so the 8 lanes of a quarter
//     warp hit distinct banks; the pair sums are the same in either
//     order), rounds each value to bf16 (cvt.rn.bf16x2, two a
//     conversion), clears the groups whose mask bit is 0 with integer
//     ops (bf16(v)·0 = +0 = the cleared bf16 for finite v; no I2F), adds
//     the groups in f32 in the TPU kernel's pair-tree order and rounds the
//     four sums to bf16: both roundings of the TPU kernel.  The folded
//     values go to one of two buffers [16, kSlots] bf16 (feature-major),
//     and a named barrier of the consumer warps hands them on;
//   * the one-hot product: each warp owns MT m16 tiles of the block's
//     output rows and runs mma.m16n8k16 (bf16, f32 accumulate) over the
//     stage's k16 slot chunks whose segment ids meet its rows (one or two
//     m16 tiles when the ids are sorted within a tile; any order is
//     right).  The one-hot A fragments are built in registers from the
//     ids; the product goes into a part per tile, which is added to the
//     block's accumulators, with s[0] once per tile, where the tile ends
//     (written over them on a tile whose first flag is 1).
//   The two fold buffers take turns, so one barrier a stage keeps a fold
//   from overwriting values a slower warp still multiplies.  A stage is
//   released after its products, its ids' last use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async.cuh"

namespace gnna {
namespace fmt {

constexpr int kFeat = 16;      // the probes' feature width: one m16 tile
constexpr int kThreads = 256;  // threads per CTA of stream_sum
constexpr uint32_t kOne = 0x3F80u;  // 1.0 in bf16

// c[0:4] += A (16 x 16, row fragment a) x B (16 x 8, column fragment b0,
// b1): bf16 operands, f32 accumulate (PTX ISA, mma.m16n8k16).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to the nearest bf16 (a in the low half, b in the high).
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The low and the high bf16 of a pair, as f32.
__device__ __forceinline__ float lo_f32(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t p) {
  return __uint_as_float(p & 0xFFFF0000u);
}

// ---------------------------------------------------------------------------
// stream_sum
// ---------------------------------------------------------------------------

enum SumSrc { kI8 = 0, kF32 = 1, kI32 = 2 };

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* shared) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  T total = 0;
  for (int w = 0; w < kThreads / 32; ++w) total += shared[w];  // fixed order
  return total;
}

template <int SRC>
__device__ __forceinline__ void add_vec(const uint4& q, long long& i64,
                                        double& f64) {
  if (SRC == kI8) {
    const int ones = 0x01010101;
    int v = __dp4a(static_cast<int>(q.x), ones, 0);
    v = __dp4a(static_cast<int>(q.y), ones, v);
    v = __dp4a(static_cast<int>(q.z), ones, v);
    v = __dp4a(static_cast<int>(q.w), ones, v);
    i64 += v;
  } else if (SRC == kI32) {
    i64 += static_cast<long long>(static_cast<int>(q.x)) +
           static_cast<int>(q.y) + static_cast<int>(q.z) +
           static_cast<int>(q.w);
  } else {
    f64 += (static_cast<double>(__uint_as_float(q.x)) +
            static_cast<double>(__uint_as_float(q.y))) +
           (static_cast<double>(__uint_as_float(q.z)) +
            static_cast<double>(__uint_as_float(q.w)));
  }
}

// CTA i sums row block i (n_vec 16-byte pieces) into out[8i:8i+8, :] = sum
// + s.
template <int SRC>
__global__ void __launch_bounds__(kThreads)
    stream_sum_kernel(const uint4* __restrict__ a, long long n_vec,
                      const float* __restrict__ s, float* __restrict__ out) {
  __shared__ long long si[kThreads / 32];
  __shared__ double sf[kThreads / 32];
  const uint4* p = a + static_cast<long long>(blockIdx.x) * n_vec;
  long long i64 = 0;
  double f64 = 0.0;
  long long i = threadIdx.x;
  for (; i + 3 * kThreads < n_vec; i += 4 * kThreads) {
    const uint4 q0 = __ldg(p + i), q1 = __ldg(p + i + kThreads),
                q2 = __ldg(p + i + 2 * kThreads),
                q3 = __ldg(p + i + 3 * kThreads);
    add_vec<SRC>(q0, i64, f64);
    add_vec<SRC>(q1, i64, f64);
    add_vec<SRC>(q2, i64, f64);
    add_vec<SRC>(q3, i64, f64);
  }
  for (; i < n_vec; i += kThreads) add_vec<SRC>(__ldg(p + i), i64, f64);
  const float total =
      SRC == kF32 ? static_cast<float>(block_sum(f64, sf))
                  : static_cast<float>(static_cast<double>(block_sum(i64, si)));
  float* o = out + static_cast<size_t>(blockIdx.x) * 8 * 128;
  for (int j = threadIdx.x; j < 8 * 128; j += kThreads) o[j] = total + s[j];
}

// ---------------------------------------------------------------------------
// seg_reduce: a ring of slot stages
// ---------------------------------------------------------------------------

constexpr int kNC = 8;                    // consumer warps
constexpr int kSegThreads = 32 * (kNC + 1);  // + the producer warp
constexpr int kSlots = 64;                // slots a stage: 4 threads each
constexpr int kStages = 4;
constexpr int kLanes = 128;               // values a slot
// a stage: values [kSlots, 128] f32, masks and ids [kSlots], then what it
// is (int4: block, first slot, slots, 1 where the block ends; block -1
// ends the walk)
constexpr int kMaskOff = kSlots * kLanes * 4;
constexpr int kSegOff = kMaskOff + kSlots * 4;
constexpr int kMetaOff = kSegOff + kSlots * 4;
constexpr int kStageBytes = kMetaOff + 128;
constexpr int kFoldLd = kSlots + 8;  // bf16 a folded feature row: the
                                     // products' loads hit distinct banks
constexpr int kFoldElems = kFeat * kFoldLd;
constexpr int kBarrierBytes = 128;
constexpr size_t kSegSmem = kBarrierBytes +
                            static_cast<size_t>(kStages) * kStageBytes +
                            2 * kFoldElems * sizeof(uint16_t);

// The first index in [lo, hi) of the sorted t2b whose value is >= b (hi if
// none), found by the whole warp: a first probe of the 32 entries around
// ``hint``, then steps that each probe 32 evenly spaced entries and keep
// the piece where the values reach b.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ t2b,
                                                int lo, int hi, int b,
                                                int hint, int lane) {
  const int w0 = max(lo, min(hint - 16, hi - 32));
  const int nw = min(32, hi - w0);
  const int cw = __popc(__ballot_sync(
      0xffffffffu, lane < nw && __ldg(t2b + w0 + lane) < b));
  if (cw < nw) {
    if (cw > 0 || w0 == lo) return w0 + cw;
    hi = w0;  // t2b[w0] >= b
  } else {
    lo = w0 + nw;  // every probed entry < b
  }
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int pos = lo + lane * step;
    const int c = __popc(
        __ballot_sync(0xffffffffu, pos < hi && __ldg(t2b + pos) < b));
    if (c == 0) return lo;
    // t2b[lo + (c-1)·step] < b, and t2b[lo + c·step] >= b or past hi
    hi = min(hi, lo + c * step);
    lo += (c - 1) * step + 1;
  }
  return lo + __popc(__ballot_sync(
                  0xffffffffu, lo + lane < hi && __ldg(t2b + lo + lane) < b));
}

// The fold of slot j, features 4q..4q+3, into fb [16, kFoldLd] (column j).
__device__ __forceinline__ void fold_slot(const unsigned char* stage, int j,
                                          int q, uint16_t* fb) {
  const float4* row = reinterpret_cast<const float4*>(stage) + j * 32 + q;
  uint32_t m = reinterpret_cast<const uint32_t*>(stage + kMaskOff)[j];
  const int h = j & 1;  // odd slots take each pair's groups swapped
  if (h) m = ((m & 0x55u) << 1) | ((m >> 1) & 0x55u);
  float pair[4][4];
#pragma unroll
  for (int pr = 0; pr < 4; ++pr) {
    const float4 x = row[4 * (2 * pr + h)];      // group 2pr (+1 if odd)
    const float4 y = row[4 * (2 * pr + 1 - h)];  // the pair's other group
    const uint32_t kx = 0u - ((m >> (2 * pr)) & 1u);
    const uint32_t ky = 0u - ((m >> (2 * pr + 1)) & 1u);
    const uint32_t x01 = bf16x2(x.x, x.y) & kx, x23 = bf16x2(x.z, x.w) & kx;
    const uint32_t y01 = bf16x2(y.x, y.y) & ky, y23 = bf16x2(y.z, y.w) & ky;
    pair[pr][0] = lo_f32(x01) + lo_f32(y01);
    pair[pr][1] = hi_f32(x01) + hi_f32(y01);
    pair[pr][2] = lo_f32(x23) + lo_f32(y23);
    pair[pr][3] = hi_f32(x23) + hi_f32(y23);
  }
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = (pair[0][e] + pair[1][e]) + (pair[2][e] + pair[3][e]);
  const uint32_t f01 = bf16x2(v[0], v[1]), f23 = bf16x2(v[2], v[3]);
  uint16_t* col = fb + 4 * q * kFoldLd + j;
  col[0] = static_cast<uint16_t>(f01);
  col[kFoldLd] = static_cast<uint16_t>(f01 >> 16);
  col[2 * kFoldLd] = static_cast<uint16_t>(f23);
  col[3 * kFoldLd] = static_cast<uint16_t>(f23 >> 16);
}

// out[n_blocks·OB, 16]; OB = 128·MT (MT m16 tiles per consumer warp).
// vals f32 [T·tile, 128], masks uint32 [T·tile], segs int32 [T·tile]
// (sorted within each tile for speed; any order is correct), t2b int32 [T]
// sorted, first int32 [T], s f32 (s[0] is added to every tile's part).
template <int MT>
__global__ void __launch_bounds__(kSegThreads, 1)
    seg_reduce_kernel(const float* __restrict__ vals,
                      const uint32_t* __restrict__ masks,
                      const int* __restrict__ segs,
                      const int* __restrict__ t2b,
                      const int* __restrict__ first, int T, int tile,
                      int n_blocks, const float* __restrict__ s,
                      float* __restrict__ out) {
  constexpr int OB = 128 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarrierBytes;
  uint16_t* fold = reinterpret_cast<uint16_t*>(ring + kStages * kStageBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kNC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kNC) {  // producer: the warp searches, lane 0 copies
    int seq = 0, t_from = 0;
    const auto post = [&](int b, int p, int n, int last) {
      if (lane == 0) {
        const int slot = seq % kStages;
        if (seq >= kStages) mbar_wait(&empty[slot], (seq / kStages - 1) & 1);
        unsigned char* st = ring + slot * kStageBytes;
        *reinterpret_cast<int4*>(st + kMetaOff) = make_int4(b, p, n, last);
        mbar_expect_tx(&full[slot], n * (kLanes * 4 + 8));
        if (n) {
          bulk_load(st, vals + static_cast<size_t>(p) * kLanes,
                    n * kLanes * 4, &full[slot]);
          bulk_load(st + kMaskOff, masks + p, n * 4, &full[slot]);
          bulk_load(st + kSegOff, segs + p, n * 4, &full[slot]);
        }
      }
      ++seq;
    };
    for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
      // hints: the block's place in an even spread, then a few tiles on
      const int t_lo = warp_lower_bound(
          t2b, t_from, T, b,
          static_cast<int>(static_cast<long long>(b) * T / n_blocks), lane);
      const int t_hi = warp_lower_bound(t2b, t_lo, T, b + 1, t_lo + 16, lane);
      t_from = t_hi;
      const int end = t_hi * tile;
      int p = t_lo * tile;
      do {  // a block without tiles is one stage without slots
        const int n = min(kSlots, end - p);
        post(b, p, n, p + n >= end);
        p += n;
      } while (p < end);
    }
    post(-1, 0, 0, 1);
    return;
  }

  // consumers
  const int g = lane >> 2, t = lane & 3;
  const int j = threadIdx.x >> 2, q = threadIdx.x & 3;  // the fold's
  const float s00 = __ldg(s);
  float acc[MT][2][4], part[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = part[mt][n][e] = 0.f;
  int cur = -1, tile_end = 0;  // the tile being reduced, its end slot
  bool set = false;            // its first flag
  int buf = 0;
  for (int seq = 0;; ++seq) {
    const int slot = seq % kStages;
    mbar_wait(&full[slot], (seq / kStages) & 1);
    const unsigned char* st = ring + slot * kStageBytes;
    const int4 meta = *reinterpret_cast<const int4*>(st + kMetaOff);
    if (meta.x < 0) break;
    const int n = meta.z;
    if (n > 0) {
      uint16_t* fb = fold + buf * kFoldElems;
      if (j < n) fold_slot(st, j, q, fb);
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kNC) : "memory");
      const int* sseg = reinterpret_cast<const int*>(st + kSegOff);
      for (int k = 0; k < n; k += 16) {
        const int at = meta.y + k;  // the chunk's first slot
        if (at >= tile_end) {       // a tile starts with this chunk
          if (cur >= 0) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int nn = 0; nn < 2; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float p = part[mt][nn][e] + s00;
                  acc[mt][nn][e] = set ? p : acc[mt][nn][e] + p;
                  part[mt][nn][e] = 0.f;
                }
          }
          cur = at / tile;
          tile_end = (cur + 1) * tile;
          set = __ldg(first + cur) == 1;
        }
        // the chunk's ids: lane (g, t) holds those of slots 2t, 2t+1,
        // 2t+8, 2t+9; their least and greatest over the chunk
        const int s0 = sseg[k + 2 * t], s1 = sseg[k + 2 * t + 1];
        const int s8 = sseg[k + 2 * t + 8], s9 = sseg[k + 2 * t + 9];
        int lo = min(min(s0, s1), min(s8, s9));
        int hi = max(max(s0, s1), max(s8, s9));
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, 1));
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, 2));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, 1));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, 2));
        uint32_t bf[2][2];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const uint16_t* col = fb + (8 * nn + g) * kFoldLd + k + 2 * t;
          bf[nn][0] = *reinterpret_cast<const uint32_t*>(col);
          bf[nn][1] = *reinterpret_cast<const uint32_t*>(col + 8);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int o0 = (warp * MT + mt) * 16;
          if (hi < o0 || lo > o0 + 15) continue;  // warp-uniform
          const int og = o0 + g, oh = o0 + g + 8;
          const uint32_t af[4] = {
              (s0 == og ? kOne : 0u) | (s1 == og ? kOne << 16 : 0u),
              (s0 == oh ? kOne : 0u) | (s1 == oh ? kOne << 16 : 0u),
              (s8 == og ? kOne : 0u) | (s9 == og ? kOne << 16 : 0u),
              (s8 == oh ? kOne : 0u) | (s9 == oh ? kOne << 16 : 0u)};
          mma_bf16(part[mt][0], af, bf[0][0], bf[0][1]);
          mma_bf16(part[mt][1], af, bf[1][0], bf[1][1]);
        }
      }
      buf ^= 1;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // after the ids' last use
    if (meta.w) {  // the block ends with this stage
      if (cur >= 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float p = part[mt][nn][e] + s00;
              acc[mt][nn][e] = set ? p : acc[mt][nn][e] + p;
              part[mt][nn][e] = 0.f;
            }
      }
      // acc[mt][n]: output rows (o0 + g, o0 + g + 8) x features 8n + 2t, +1
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const size_t o =
            static_cast<size_t>(meta.x) * OB + (warp * MT + mt) * 16 + g;
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          *reinterpret_cast<float2*>(out + o * kFeat + 8 * nn + 2 * t) =
              make_float2(acc[mt][nn][0], acc[mt][nn][1]);
          *reinterpret_cast<float2*>(out + (o + 8) * kFeat + 8 * nn + 2 * t) =
              make_float2(acc[mt][nn][2], acc[mt][nn][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nn][e] = 0.f;
        }
      }
      cur = -1;
      tile_end = 0;
    }
  }
}

template <int MT>
int launch_seg(const void* vals, const void* masks, const void* segs,
               const void* t2b, const void* first, int T, int tile,
               int n_blocks, const void* s, void* out, cudaStream_t st) {
  auto kernel = seg_reduce_kernel<MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSegSmem));
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<min(n_blocks, sms), kSegThreads, kSegSmem, st>>>(
      static_cast<const float*>(vals), static_cast<const uint32_t*>(masks),
      static_cast<const int*>(segs), static_cast<const int*>(t2b),
      static_cast<const int*>(first), T, tile, n_blocks,
      static_cast<const float*>(s), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

inline int err(cudaError_t e) { return static_cast<int>(e); }

}  // namespace fmt
}  // namespace gnna

extern "C" {

// a [g·block, K] (src 0 int8, 1 f32, 2 uint32 read as int32), s f32
// [8, 128] -> out f32 [8·g, 128]; block·K·element bytes a multiple of 16.
int gnna_stream_sum(const void* a, int src, int g, long long block_bytes,
                    const void* s, void* out, void* stream) {
  using namespace gnna::fmt;
  if (g <= 0 || block_bytes <= 0 || block_bytes % 16 || src < 0 || src > 2)
    return err(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* p = static_cast<const uint4*>(a);
  const float* sp = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  const long long n_vec = block_bytes / 16;
  if (src == kI8)
    stream_sum_kernel<kI8><<<g, kThreads, 0, st>>>(p, n_vec, sp, o);
  else if (src == kF32)
    stream_sum_kernel<kF32><<<g, kThreads, 0, st>>>(p, n_vec, sp, o);
  else
    stream_sum_kernel<kI32><<<g, kThreads, 0, st>>>(p, n_vec, sp, o);
  return err(cudaGetLastError());
}

// vals f32 [T·tile, 128], masks uint32 [T·tile], segs int32 [T·tile] (all
// three 16-byte aligned), t2b (sorted) and first int32 [T], s f32 -> out
// f32 [n_blocks·ob, 16]; ob 128, 256 or 512; tile a multiple of 16.
int gnna_seg_reduce(const void* vals, const void* masks, const void* segs,
                    const void* t2b, const void* first, int T, int tile,
                    int ob, int n_blocks, const void* s, void* out,
                    void* stream) {
  using namespace gnna::fmt;
  const auto mis = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (T < 0 || tile <= 0 || tile % 16 || n_blocks <= 0 || mis(vals) ||
      mis(masks) || mis(segs) ||
      static_cast<long long>(T) * tile >= (1LL << 31))
    return err(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ob) {
    case 128:
      return launch_seg<1>(vals, masks, segs, t2b, first, T, tile, n_blocks,
                           s, out, st);
    case 256:
      return launch_seg<2>(vals, masks, segs, t2b, first, T, tile, n_blocks,
                           s, out, st);
    case 512:
      return launch_seg<4>(vals, masks, segs, t2b, first, T, tile, n_blocks,
                           s, out, st);
    default:
      return err(cudaErrorInvalidValue);
  }
}

}  // extern "C"
