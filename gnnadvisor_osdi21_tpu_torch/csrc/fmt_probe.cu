// Three of the format probe's kernels (bench/fmtprobe.py): a streaming
// read-reduce, a dense int8 slab contracted with a 16-wide feature table,
// and a one-hot segment reduce.  (Its row-major bit slab is walked over its
// set bits in bit_walk.cu.)
//
// Replaces the TPU kernels of gnnadvisor_osdi21_tpu/bench/fmtprobe.py:
//   _sum_kernel   (:53, pallas_call at :63): each [block, K] row block of an
//                 int8, f32 or uint32 [R, K] array summed to one f32 (uint32
//                 words read as int32), plus s [8, 128] -> one [8, 128] tile
//                 per block;
//   _i8_kernel    (:118, pallas_call at :124): out[R, 16] = bf16(A) @ x,
//                 A int8 [R, K], x bf16 [K, 16];
//   _seg_kernel   (:287, pallas_call at :335): per tile of TILE slots,
//                 mask the [TILE, 128] values by a lane-group bit mask, fold
//                 the 128 lanes to 16, and reduce the slots into OB output
//                 rows by a one-hot product; the tile's part is written into
//                 (first tile) or added to its output block.
//
// What bounds them.  Bytes: each reads its big operand once (the [R, K]
// array, slab or [m, 128] values) and writes a small output; the bf16
// tensor cores' 2·16·K flops per row stay far below the byte time.
//
// Design.
// - stream_sum: one CTA per row block, 16-byte loads, four in flight per
//   thread.  Each thread sums exactly (int8 through dp4a into int64, int32
//   words into int64) or in f64 (f32 values), the CTA adds the threads'
//   sums in a fixed tree order, and the block total is rounded to f32 once.
//   So the result does not depend on the launch, and equals the plain
//   version (an f64 sum rounded once) for integer inputs.
// - i8_slab: mma.sync m16n8k16, bf16 operands, f32 accumulate.  The 16
//   features are the MMA's M and graph rows its N, so a warp's feature
//   fragment serves the four n8 tiles (32 rows) it owns.  The contraction
//   runs over the slab columns in an order that lets each lane take its B
//   fragments from one 16-byte load of its graph row: the lane with t =
//   lane % 4 owns bytes 16t..16t+15 of a 64-column int8 run, and the
//   feature table is staged in shared memory in the same order, so the
//   lane's A fragments are 16-byte shared loads too.  The sum is the same
//   in another order.  An int8 value is exact in bf16 and its product with
//   a bf16 feature exact in f32.
// - seg_reduce: one CTA per output block walks the block's tiles in order
//   (t2b is sorted), so "set on the first tile, then add" needs no atomics
//   and each output element is written once.  Per tile the warps fold the
//   slots (lanes 16c..16c+15 of group c sit in four neighbouring threads:
//   three xor shuffles add the eight groups in f32), keeping the two bf16
//   roundings of the TPU kernel; then each warp owns MT m16 tiles of the
//   block's output rows and runs the one-hot product on the tensor cores
//   over the k16 slot chunks whose segment ids meet its rows (the ids are
//   sorted within a tile, so a chunk meets one or two m16 tiles).  The
//   one-hot fragments are built in registers from the staged ids.
//   Blocks that no tile maps to are written as zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gnna {
namespace fmt {

constexpr int kFeat = 16;      // the probes' feature width: one m16 tile
constexpr int kThreads = 256;  // threads per CTA of every kernel here
constexpr int kStrip = 256;    // graph rows per CTA pass: 8 warps x 32
constexpr int kChunk = 512;    // slab columns per staged feature tile
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

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// f32 rounded to the nearest bf16, kept as f32
__device__ __forceinline__ float round_bf16(float v) {
  return __uint_as_float(static_cast<uint32_t>(bf16_bits(v)) << 16);
}

// Two int8 values (low bytes first) as two packed bf16: every int8 value is
// exact in bf16, so the f32's upper half is the bf16.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w) {
  const float lo = static_cast<float>(static_cast<int8_t>(w & 0xFF));
  const float hi = static_cast<float>(static_cast<int8_t>((w >> 8) & 0xFF));
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
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
// i8_slab: rows as the MMA's N
// ---------------------------------------------------------------------------

// Store one warp's four n8 tiles: acc[n] holds features (g, g + 8) x rows
// (2t, 2t + 1) of tile n.
__device__ __forceinline__ void store_rows(float (*acc)[4], int r_w, int R,
                                           int g, int t, float* out) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int r = r_w + 8 * n + 2 * t;
    if (r < R) {
      out[static_cast<size_t>(r) * kFeat + g] = acc[n][0];
      out[static_cast<size_t>(r) * kFeat + g + 8] = acc[n][2];
    }
    if (r + 1 < R) {
      out[static_cast<size_t>(r + 1) * kFeat + g] = acc[n][1];
      out[static_cast<size_t>(r + 1) * kFeat + g + 8] = acc[n][3];
    }
  }
}

// out[R, 16] = bf16(A) @ x, A int8 [R, K] (K a multiple of 64), x bf16
// [K, 16].  CTA i owns rows [i·block_rows, (i+1)·block_rows), in passes of
// kStrip.  Within a 64-column run, lane t's MMA step s takes columns
// 16t + 4s + {0, 1} (k 2t, 2t + 1) and 16t + 4s + {2, 3} (k 2t + 8, 2t + 9).
__global__ void __launch_bounds__(kThreads)
    i8_slab_kernel(const int8_t* __restrict__ a, int R, int K, int block_rows,
                   const uint16_t* __restrict__ x, float* __restrict__ out) {
  constexpr int ld = kChunk + 8;  // bf16 per staged feature row
  __shared__ __align__(16) uint16_t sxt[kFeat * ld];  // x^T chunk [16][ld]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int row_end = min(R, (blockIdx.x + 1) * block_rows);
  for (int p0 = blockIdx.x * block_rows; p0 < row_end; p0 += kStrip) {
    const int r_w = p0 + 32 * warp;  // the warp's first row
    float acc[4][4] = {};
    for (int kc = 0; kc < K; kc += kChunk) {
      const int kn = min(kChunk, K - kc);
      __syncthreads();  // the previous chunk's readers are done
      for (int i = threadIdx.x; i < 2 * kn; i += kThreads) {
        const int k = i >> 1, f0 = 8 * (i & 1);
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(kc + k) * kFeat + f0));
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int f = 0; f < 8; f += 2) {
          sxt[(f0 + f) * ld + k] = static_cast<uint16_t>(w[f / 2] & 0xFFFF);
          sxt[(f0 + f + 1) * ld + k] = static_cast<uint16_t>(w[f / 2] >> 16);
        }
      }
      __syncthreads();
      for (int kk = 0; kk < kn; kk += 64) {
        uint4 bq[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int r = r_w + 8 * n + g;
          bq[n] = r < R ? __ldg(reinterpret_cast<const uint4*>(
                              a + static_cast<size_t>(r) * K + kc + kk +
                              16 * t))
                        : make_uint4(0, 0, 0, 0);
        }
        const uint16_t* xg = sxt + g * ld + kk + 16 * t;
        const uint4 lo0 = *reinterpret_cast<const uint4*>(xg);
        const uint4 lo1 = *reinterpret_cast<const uint4*>(xg + 8);
        const uint4 hi0 = *reinterpret_cast<const uint4*>(xg + 8 * ld);
        const uint4 hi1 = *reinterpret_cast<const uint4*>(xg + 8 * ld + 8);
        const uint32_t xl[8] = {lo0.x, lo0.y, lo0.z, lo0.w,
                                lo1.x, lo1.y, lo1.z, lo1.w};
        const uint32_t xh[8] = {hi0.x, hi0.y, hi0.z, hi0.w,
                                hi1.x, hi1.y, hi1.z, hi1.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t af[4] = {xl[2 * s], xh[2 * s], xl[2 * s + 1],
                                  xh[2 * s + 1]};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const uint32_t w = s == 0 ? bq[n].x
                               : s == 1 ? bq[n].y
                               : s == 2 ? bq[n].z
                                        : bq[n].w;
            mma_bf16(acc[n], af, i8x2_bf16(w), i8x2_bf16(w >> 16));
          }
        }
      }
    }
    store_rows(acc, r_w, R, g, t, out);
  }
}

// ---------------------------------------------------------------------------
// seg_reduce
// ---------------------------------------------------------------------------

// First index of the sorted t2b[0:T] whose value is >= b.
__device__ __forceinline__ int lower_bound(const int* __restrict__ t2b, int T,
                                           int b) {
  int lo = 0, hi = T;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(t2b + mid) < b)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One slot's fold: lane l holds value lanes 4l..4l+3 (group l / 4); the
// slot's 16 folded values end in lanes 0..3 (features 4l..4l+3).
__device__ __forceinline__ float4 fold_slot(float4 q, uint32_t mask, int lane) {
  const float m = static_cast<float>((mask >> (lane >> 2)) & 1u);
  float v[4] = {round_bf16(q.x * m), round_bf16(q.y * m), round_bf16(q.z * m),
                round_bf16(q.w * m)};
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
  return make_float4(v[0], v[1], v[2], v[3]);
}

// out[n_blocks·OB, 16]; OB = 128·MT (MT m16 tiles per warp, 8 warps).
// vals f32 [T·tile, 128], masks uint32 [T·tile], segs int32 [T·tile]
// (sorted within each tile for speed; any order is correct), t2b int32 [T]
// sorted, first int32 [T], s f32 (s[0] is added to every tile's part).
template <int MT>
__global__ void __launch_bounds__(kThreads)
    seg_reduce_kernel(const float* __restrict__ vals,
                      const uint32_t* __restrict__ masks,
                      const int* __restrict__ segs,
                      const int* __restrict__ t2b,
                      const int* __restrict__ first, int T, int tile,
                      const float* __restrict__ s, float* __restrict__ out) {
  constexpr int OB = 128 * MT;
  extern __shared__ __align__(16) uint16_t smem[];
  const int ld = tile + 8;
  uint16_t* svt = smem;                                       // v^T [16][ld]
  int* sseg = reinterpret_cast<int*>(smem + kFeat * ld);      // [tile]
  int* cmin = sseg + tile;                                    // [tile / 16]
  int* cmax = cmin + tile / 16;                               // [tile / 16]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int t_lo = lower_bound(t2b, T, b), t_hi = lower_bound(t2b, T, b + 1);
  const float s00 = __ldg(s);

  float acc[MT][2][4] = {};
  for (int tt = t_lo; tt < t_hi; ++tt) {
    const size_t base = static_cast<size_t>(tt) * tile;
    __syncthreads();  // the previous tile's readers are done
    // --- fold: one slot per warp step, four slots in flight -------------
    for (int i0 = warp; i0 < tile; i0 += 4 * (kThreads / 32)) {
      float4 q[4];
      uint32_t mk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * (kThreads / 32);
        if (i < tile) {
          q[u] = __ldg(reinterpret_cast<const float4*>(vals + (base + i) * 128) +
                       lane);
          mk[u] = __ldg(masks + base + i);
        } else {
          q[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          mk[u] = 0;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * (kThreads / 32);
        const float4 v = fold_slot(q[u], mk[u], lane);  // every lane shuffles
        if (i < tile && lane < 4) {
          svt[(4 * lane + 0) * ld + i] = bf16_bits(v.x);
          svt[(4 * lane + 1) * ld + i] = bf16_bits(v.y);
          svt[(4 * lane + 2) * ld + i] = bf16_bits(v.z);
          svt[(4 * lane + 3) * ld + i] = bf16_bits(v.w);
        }
        if (i < tile && lane == 4) sseg[i] = __ldg(segs + base + i);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < tile / 16; c += kThreads) {
      int lo = sseg[16 * c], hi = lo;
      for (int j = 1; j < 16; ++j) {
        lo = min(lo, sseg[16 * c + j]);
        hi = max(hi, sseg[16 * c + j]);
      }
      cmin[c] = lo;
      cmax[c] = hi;
    }
    __syncthreads();
    // --- one-hot product: part[o, d] = sum of v[i, d] over seg[i] == o ---
    float part[MT][2][4] = {};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int o0 = (warp * MT + mt) * 16;
      for (int c = 0; c < tile / 16; ++c) {
        if (cmax[c] < o0 || cmin[c] > o0 + 15) continue;  // warp-uniform
        const int k = 16 * c;
        const int s0 = sseg[k + 2 * t], s1 = sseg[k + 2 * t + 1];
        const int s8 = sseg[k + 2 * t + 8], s9 = sseg[k + 2 * t + 9];
        const int og = o0 + g, oh = o0 + g + 8;
        const uint32_t af[4] = {
            (s0 == og ? kOne : 0u) | (s1 == og ? kOne << 16 : 0u),
            (s0 == oh ? kOne : 0u) | (s1 == oh ? kOne << 16 : 0u),
            (s8 == og ? kOne : 0u) | (s9 == og ? kOne << 16 : 0u),
            (s8 == oh ? kOne : 0u) | (s9 == oh ? kOne << 16 : 0u)};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint16_t* col = svt + (8 * n + g) * ld + k + 2 * t;
          mma_bf16(part[mt][n], af, *reinterpret_cast<const uint32_t*>(col),
                   *reinterpret_cast<const uint32_t*>(col + 8));
        }
      }
    }
    const bool set = __ldg(first + tt) == 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = part[mt][n][j] + s00;
          acc[mt][n][j] = set ? p : acc[mt][n][j] + p;
        }
  }
  // acc[mt][n]: output rows (o0 + g, o0 + g + 8) x features 8n + 2t, +1
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const size_t o = static_cast<size_t>(b) * OB + (warp * MT + mt) * 16 + g;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      *reinterpret_cast<float2*>(out + o * kFeat + 8 * n + 2 * t) =
          make_float2(acc[mt][n][0], acc[mt][n][1]);
      *reinterpret_cast<float2*>(out + (o + 8) * kFeat + 8 * n + 2 * t) =
          make_float2(acc[mt][n][2], acc[mt][n][3]);
    }
  }
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

// a int8 [R, K] (K a multiple of 64), x bf16 [K, 16] -> out f32 [R, 16];
// block_rows a multiple of 256.
int gnna_i8_slab(const void* a, int R, int K, const void* x, int block_rows,
                 void* out, void* stream) {
  using namespace gnna::fmt;
  if (R <= 0 || K <= 0 || K % 64 || block_rows <= 0 || block_rows % kStrip)
    return err(cudaErrorInvalidValue);
  i8_slab_kernel<<<(R + block_rows - 1) / block_rows, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), R, K, block_rows,
      static_cast<const uint16_t*>(x), static_cast<float*>(out));
  return err(cudaGetLastError());
}

// vals f32 [T·tile, 128], masks uint32 [T·tile], segs int32 [T·tile], t2b
// and first int32 [T], s f32 -> out f32 [n_blocks·ob, 16]; ob 128, 256 or
// 512; tile a multiple of 16 up to 1024.
int gnna_seg_reduce(const void* vals, const void* masks, const void* segs,
                    const void* t2b, const void* first, int T, int tile,
                    int ob, int n_blocks, const void* s, void* out,
                    void* stream) {
  using namespace gnna::fmt;
  if (T < 0 || tile <= 0 || tile % 16 || tile > 1024 || n_blocks <= 0)
    return err(cudaErrorInvalidValue);
  const size_t shared = sizeof(uint16_t) * kFeat * (tile + 8) +
                        sizeof(int) * (tile + 2 * (tile / 16));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GNNA_SEG(MT)                                                         \
  seg_reduce_kernel<MT><<<n_blocks, kThreads, shared, st>>>(                 \
      static_cast<const float*>(vals), static_cast<const uint32_t*>(masks),  \
      static_cast<const int*>(segs), static_cast<const int*>(t2b),           \
      static_cast<const int*>(first), T, tile, static_cast<const float*>(s), \
      static_cast<float*>(out))
  switch (ob) {
    case 128: GNNA_SEG(1); break;
    case 256: GNNA_SEG(2); break;
    case 512: GNNA_SEG(4); break;
    default: return err(cudaErrorInvalidValue);
  }
#undef GNNA_SEG
  return err(cudaGetLastError());
}

}  // extern "C"
