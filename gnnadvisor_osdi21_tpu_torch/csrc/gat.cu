// Multi-head graph attention (GAT, ops/gat.py): the edge softmax, the
// alpha-weighted aggregation in both orders of the edges, and the
// backward's SDDMM, softmax backward and column reduction.
//
// Replaces no TPU kernel: the JAX package has no attention model.  They
// were added for GAT, whose edges carry values (alpha, per edge and head)
// that none of the hybrid layout's kernels (slab.cu, residual*.cu) take,
// and whose backward is the true adjoint: the aggregation walks the edges
// in transposed order, not the forward's order again.
//
// Layout (graphs/gat.py).  The edges, one self-loop a node included, in
// row-owner order (row s: edges (s, d), ``ptr``/``col``) and transposed
// order (row d: edges (s, d), ``idx`` = s, ``pos`` = the edge's row-owner
// position).  Per-edge values are [E, K] f32 in row-owner order.  Node
// features v are [n, K*F] f32 (head h at columns h*F..); the gathered
// operand is a table [rows, K*PH*8] (bf16 or f32) with each head padded
// to PH*8 columns with zeros, so that a 16-byte piece of 8 bf16 values
// (32 bytes in f32) lies in one head.  Edges are cut into chunks of one
// row (at most CHUNK_EDGES); a chunk writes its row, or a partial row that
// a fix-up pass sums with the row's other partials in order.  No atomics:
// every output is written by one thread, and every sum has a fixed order,
// so two runs give the same bits.
//
// What bounds them.  Bytes: each edge gathers one operand row (K*F values,
// 352 bytes at K = 8, F = 22 in bf16) and reads or writes its K values of
// alpha.  The scores and alpha are float32 and small beside the rows.
//
// Design.  The forward adds in edge order, each product rounded, as a
// plain sequential sum does (no FMA contraction: ``__fmul_rn`` and
// ``__fadd_rn``), so that it gives a plain float32 forward's bits where a
// row is one chunk; a bfloat16 operand rounded from values a rounding
// apart would otherwise differ in a whole bf16 step, and a hub's row is
// gathered by a quarter of a million rows.  For a gather, L = K*PH lanes
// take one chunk, one 16-byte piece of each edge's row a lane, loading
// four edges before they add (four loads in flight), and a warp takes G =
// 32/L chunks.  The softmax takes a thread a row and head: the row's
// maximum, the sum of exp(e - max) in edge order, then alpha = exp(e -
// max) / sum.  The column sums (a warp a chunk) give lane l head l % K of
// edges l / K, l / K + 32/K, ..., and the lanes of one head combine by a
// butterfly, whose pairs add the same two values.  The SDDMM (a warp a
// row) dots each edge's gathered row with the row's own dout, sums the
// head's PH pieces at the head's first lane, and that lane writes the
// softmax's backward for the edge and adds it into the row's logit
// gradient.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gatk {

constexpr int kWarps = 8;   // warps a block of threads
constexpr int kUnroll = 4;  // edges a lane loads before it adds

// Eight values from a 16-byte aligned piece of the operand table (bf16
// widens exactly: its bits are the top half of a float's).
__device__ __forceinline__ void load8(const uint16_t* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : __fmul_rn(x, slope);
}

// The row of ``out`` (row >= 0) or of ``partial`` (-1 - row) a chunk
// writes, ``width`` values a row.
__device__ __forceinline__ float* chunk_row(float* out, float* partial,
                                            int dst, int width) {
  return dst >= 0 ? out + static_cast<size_t>(dst) * width
                  : partial + static_cast<size_t>(-1 - dst) * width;
}

}  // namespace gatk

namespace gnna {

struct GatAggArgs {
  const void* table;  // [rows, ld], bf16 (as uint16) or f32
  int ld, K, F, PH;   // row stride; heads; features a head; pieces a head
  const int* idx;     // [E] the table row each edge reads
  const int* pos;     // [E] each edge's row of alpha, or null: its own
  const float* alpha;  // [E, K]
  const int* chunk_lo;
  const int* chunk_hi;
  const int* chunk_dst;
  int chunks;
  float* partial;  // [partials, K*F]
  float* out;      // [num_rows, K*F]
};

// out[r] = sum over the edges of row r of alpha[e, h] * table[idx[e]] (head
// h's features), per chunk, each product rounded and added in edge order.
template <typename T>
__global__ void __launch_bounds__(gatk::kWarps * 32, 4)
    gat_aggregate_kernel(GatAggArgs a) {
  constexpr int U = gatk::kUnroll;
  const int lane = threadIdx.x & 31;
  const int L = a.K * a.PH;
  const int G = 32 / L;
  const int g = lane / L, j = lane - g * L;
  const int chunk = (blockIdx.x * gatk::kWarps + threadIdx.x / 32) * G + g;
  if (g >= G || chunk >= a.chunks) return;
  const int h = j / a.PH, q = j - h * a.PH;
  const int lo = __ldg(a.chunk_lo + chunk), hi = __ldg(a.chunk_hi + chunk);
  const T* table = static_cast<const T*>(a.table) + j * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int e0 = lo; e0 < hi; e0 += U) {
    int r[U], w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u;
      const bool ok = e < hi;
      r[u] = ok ? __ldg(a.idx + e) : -1;
      w[u] = ok ? (a.pos ? __ldg(a.pos + e) : e) : 0;
    }
    float al[U], v[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r[u] >= 0) {
        al[u] = __ldg(a.alpha + static_cast<size_t>(w[u]) * a.K + h);
        gatk::load8(table + static_cast<size_t>(r[u]) * a.ld, v[u]);
      } else {  // adds +0 past the chunk's end: no change to any sum
        al[u] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(al[u], v[u][i]));
  }
  const int width = a.K * a.F;
  float* o = gatk::chunk_row(a.out, a.partial, __ldg(a.chunk_dst + chunk),
                             width) + h * a.F;
  const int f0 = q * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (f0 + i < a.F) o[f0 + i] = acc[i];
}

struct GatFixArgs {
  const float* partial;  // [partials, width]
  int width;
  const int* fix_row;
  const int* fix_ptr;
  float* out;  // [num_rows, width]
};

constexpr int kFixCols = 256;  // the widest row a fix-up sums

// out[fix_row[r]] = sum of partial rows fix_ptr[r]..fix_ptr[r+1]: warp w
// sums partials w, w + 8, ..., then the warps' sums add in warp order.
__global__ void __launch_bounds__(gatk::kWarps * 32)
    gat_fixup_kernel(GatFixArgs a) {
  __shared__ float red[gatk::kWarps][kFixCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int p0 = __ldg(a.fix_ptr + blockIdx.x);
  const int p1 = __ldg(a.fix_ptr + blockIdx.x + 1);
  float s[kFixCols / 32];
#pragma unroll
  for (int i = 0; i < kFixCols / 32; ++i) s[i] = 0.f;
#pragma unroll 4
  for (int p = p0 + warp; p < p1; p += gatk::kWarps) {
    const float* row = a.partial + static_cast<size_t>(p) * a.width;
#pragma unroll
    for (int i = 0; i < kFixCols / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < a.width) s[i] += __ldg(row + c);
    }
  }
#pragma unroll
  for (int i = 0; i < kFixCols / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < a.width) red[warp][c] = s[i];
  }
  __syncthreads();
  float* o = a.out + static_cast<size_t>(__ldg(a.fix_row + blockIdx.x)) *
                         a.width;
  for (int c = threadIdx.x; c < a.width; c += blockDim.x) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < gatk::kWarps; ++w) t += red[w][c];
    o[c] = t;
  }
}

}  // namespace gnna

namespace gat {

struct SoftmaxArgs {
  const int* ptr;
  const int* col;
  const float* s_src;  // [n, K]
  const float* s_dst;  // [n, K]
  int n, K;
  float slope;
  float* alpha;  // [E, K]
};

// alpha[e, h] = softmax over row s's edges e = (s, d) of
// leaky(s_src[s, h] + s_dst[d, h]): the row's maximum, then the sum of
// exp(e - max) in edge order, then each exp(e - max) over the sum.
__global__ void __launch_bounds__(gatk::kWarps * 32)
    softmax_kernel(SoftmaxArgs a) {
  const int lane = threadIdx.x & 31;
  const int K = a.K;
  const int row = (blockIdx.x * gatk::kWarps + threadIdx.x / 32) * (32 / K) +
                  lane / K;
  if (row >= a.n) return;
  const int h = lane % K;
  const int lo = __ldg(a.ptr + row), hi = __ldg(a.ptr + row + 1);
  const float ss = __ldg(a.s_src + static_cast<size_t>(row) * K + h);
  const float* sd = a.s_dst + h;
  auto logit = [&](int e) {
    const size_t d = __ldg(a.col + e);
    return gatk::leaky(__fadd_rn(ss, __ldg(sd + d * K)), a.slope);
  };
  float m = -INFINITY;
  for (int e = lo; e < hi; ++e) m = fmaxf(m, logit(e));
  float l = 0.f;
  for (int e = lo; e < hi; ++e) l = __fadd_rn(l, expf(__fsub_rn(logit(e), m)));
  for (int e = lo; e < hi; ++e)
    a.alpha[static_cast<size_t>(e) * K + h] =
        __fdiv_rn(expf(__fsub_rn(logit(e), m)), l);
}

struct SddmmArgs {
  const int* ptr;
  const int* col;
  int n;
  const void* table;  // [rows, ld] the forward's operand
  int ld, K, F, PH;
  const float* dy;     // [n, K*F] the output's gradient
  const float* out;    // [n, K*F] the forward's output
  const float* alpha;  // [E, K]
  const float* s_src;  // [n, K]
  const float* s_dst;  // [n, K]
  float slope;
  float* de;  // [E, K] the logits' gradient, before the LeakyReLU
  float* ds;  // [n, K] its sum over each row
};

// For the edges e = (s, d) of row s and each head h: dalpha = dy[s, h] .
// table[d, h]; de = alpha (dalpha - dy[s, h] . out[s, h]), times the
// LeakyReLU's slope where its input was not positive; ds[s, h] = sum of
// de over the row.
template <typename T>
__global__ void __launch_bounds__(gatk::kWarps * 32)
    sddmm_kernel(SddmmArgs a) {
  constexpr int U = gatk::kUnroll;
  const int row = blockIdx.x * gatk::kWarps + threadIdx.x / 32;
  if (row >= a.n) return;
  const int lane = threadIdx.x & 31;
  const int K = a.K, L = K * a.PH;
  const int G = 32 / L;
  const int g = lane / L, j = lane - g * L;
  const bool active = g < G;
  const int h = j / a.PH, q = j - h * a.PH;
  const bool first = active && q == 0;  // the head's first lane
  const int f0 = q * 8;
  float dy[8], ov[8];
  float c = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool ok = active && f0 + i < a.F;
    const size_t at = static_cast<size_t>(row) * K * a.F + h * a.F + f0 + i;
    dy[i] = ok ? __ldg(a.dy + at) : 0.f;
    ov[i] = ok ? __ldg(a.out + at) : 0.f;
    c = fmaf(dy[i], ov[i], c);
  }
  float ct = c;
  for (int s = 1; s < a.PH; ++s) ct += __shfl_down_sync(0xffffffffu, c, s);
  const int lo = __ldg(a.ptr + row), hi = __ldg(a.ptr + row + 1);
  const float ss = first ? __ldg(a.s_src + static_cast<size_t>(row) * K + h)
                         : 0.f;
  const T* table = static_cast<const T*>(a.table) + j * 8;
  float acc = 0.f;
  for (int e0 = lo; e0 < hi; e0 += G * U) {
    int d[U];
    float v[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + g + u * G;
      d[u] = active && e < hi ? __ldg(a.col + e) : -1;
      if (d[u] >= 0) {
        gatk::load8(table + static_cast<size_t>(d[u]) * a.ld, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot = fmaf(dy[i], v[u][i], dot);
      float tot = dot;
      for (int s = 1; s < a.PH; ++s)
        tot += __shfl_down_sync(0xffffffffu, dot, s);
      const int e = e0 + g + u * G;
      if (first && d[u] >= 0) {
        const size_t at = static_cast<size_t>(e) * K + h;
        const float pre =
            ss + __ldg(a.s_dst + static_cast<size_t>(d[u]) * K + h);
        const float de = __ldg(a.alpha + at) * (tot - ct);
        const float dp = pre > 0.f ? de : a.slope * de;
        a.de[at] = dp;
        acc += dp;
      }
    }
  }
  float total = acc;
  for (int s = 1; s < G; ++s)
    total += __shfl_down_sync(0xffffffffu, acc, s * L);
  if (g == 0 && first) a.ds[static_cast<size_t>(row) * K + h] = total;
}

struct ColArgs {
  const float* de;  // [E, K] in row-owner order
  const int* pos;   // [E] each transposed edge's row-owner position
  int K;
  const int* chunk_lo;
  const int* chunk_hi;
  const int* chunk_dst;
  int chunks;
  float* partial;  // [partials, K]
  float* out;      // [num_rows, K]
};

// out[d, h] = sum over the transposed row d's edges of de[pos[e], h], per
// chunk.
__global__ void __launch_bounds__(gatk::kWarps * 32)
    col_reduce_kernel(ColArgs a) {
  constexpr int U = gatk::kUnroll;
  const int chunk = blockIdx.x * gatk::kWarps + threadIdx.x / 32;
  if (chunk >= a.chunks) return;
  const int lane = threadIdx.x & 31;
  const int K = a.K, h = lane % K, S = 32 / K;
  const int lo = __ldg(a.chunk_lo + chunk), hi = __ldg(a.chunk_hi + chunk);
  float s = 0.f;
  for (int e0 = lo + lane / K; e0 < hi; e0 += S * U) {
    int p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * S;
      p[u] = e < hi ? __ldg(a.pos + e) : -1;
    }
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = p[u] >= 0 ? __ldg(a.de + static_cast<size_t>(p[u]) * K + h) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) s += v[u];
  }
  for (int off = K; off < 32; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane < K)
    gatk::chunk_row(a.out, a.partial, __ldg(a.chunk_dst + chunk), K)[h] = s;
}

struct ColFixArgs {
  const float* partial;  // [partials, K]
  int K;
  const int* fix_row;
  const int* fix_ptr;
  int rows;
  float* out;  // [num_rows, K]
};

// out[fix_row[r]] = sum of partial rows fix_ptr[r]..fix_ptr[r+1], a warp a
// row.
__global__ void __launch_bounds__(gatk::kWarps * 32)
    col_fixup_kernel(ColFixArgs a) {
  const int r = blockIdx.x * gatk::kWarps + threadIdx.x / 32;
  if (r >= a.rows) return;
  const int lane = threadIdx.x & 31;
  const int K = a.K, h = lane % K, S = 32 / K;
  const int p0 = __ldg(a.fix_ptr + r), p1 = __ldg(a.fix_ptr + r + 1);
  float s = 0.f;
#pragma unroll 4
  for (int p = p0 + lane / K; p < p1; p += S)
    s += __ldg(a.partial + static_cast<size_t>(p) * K + h);
  for (int off = K; off < 32; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane < K) a.out[static_cast<size_t>(__ldg(a.fix_row + r)) * K + h] = s;
}

}  // namespace gat

namespace {

inline int blocks(int items) {
  return (items + gatk::kWarps - 1) / gatk::kWarps;
}

inline bool heads_ok(int K) { return K > 0 && K <= 32 && 32 % K == 0; }

inline bool gather_ok(const void* table, int ld, int K, int F, int PH,
                      int bf16) {
  const int elem = bf16 ? 2 : 4;
  return K > 0 && F > 0 && PH == (F + 7) / 8 && K * PH <= 32 &&
         ld >= K * PH * 8 && (ld * elem) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(table) % 16 == 0;
}

}  // namespace

extern "C" {

// table [rows, ld] (bf16 when ``bf16``, else f32), idx/pos [E] int32 (pos
// may be null), alpha [E, K] f32, the chunk arrays [chunks] int32, fix_row
// [fix_rows] and fix_ptr [fix_rows + 1] int32, partial [partials, K*F] and
// out [num_rows, K*F] f32.
int gnna_gat_aggregate(const void* table, int ld, int bf16, int K, int F,
                       int PH, const void* idx, const void* pos,
                       const void* alpha, const void* chunk_lo,
                       const void* chunk_hi, const void* chunk_dst,
                       int chunks, const void* fix_row, const void* fix_ptr,
                       int fix_rows, void* partial, void* out, void* stream) {
  using namespace gnna;
  if (!gather_ok(table, ld, K, F, PH, bf16) || K * F > kFixCols ||
      chunks < 0 || fix_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GatAggArgs a{table,
               ld,
               K,
               F,
               PH,
               static_cast<const int*>(idx),
               static_cast<const int*>(pos),
               static_cast<const float*>(alpha),
               static_cast<const int*>(chunk_lo),
               static_cast<const int*>(chunk_hi),
               static_cast<const int*>(chunk_dst),
               chunks,
               static_cast<float*>(partial),
               static_cast<float*>(out)};
  if (chunks > 0) {
    const int grid = blocks((chunks + 32 / (K * PH) - 1) / (32 / (K * PH)));
    if (bf16)
      gat_aggregate_kernel<uint16_t><<<grid, gatk::kWarps * 32, 0, st>>>(a);
    else
      gat_aggregate_kernel<float><<<grid, gatk::kWarps * 32, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (fix_rows > 0) {
    GatFixArgs f{static_cast<const float*>(partial), K * F,
                 static_cast<const int*>(fix_row),
                 static_cast<const int*>(fix_ptr), static_cast<float*>(out)};
    gat_fixup_kernel<<<fix_rows, gatk::kWarps * 32, 0, st>>>(f);
  }
  return static_cast<int>(cudaGetLastError());
}

// ptr [n+1], col [E] int32, s_src/s_dst [n, K] f32, alpha [E, K] f32.
int gnna_gat_softmax(const void* ptr, const void* col, const void* s_src,
                     const void* s_dst, int n, int K, float slope,
                     void* alpha, void* stream) {
  using namespace gat;
  if (!heads_ok(K) || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  SoftmaxArgs a{static_cast<const int*>(ptr), static_cast<const int*>(col),
                static_cast<const float*>(s_src),
                static_cast<const float*>(s_dst), n, K, slope,
                static_cast<float*>(alpha)};
  softmax_kernel<<<blocks((n + 32 / K - 1) / (32 / K)), gatk::kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptr [n+1], col [E] int32; table [rows, ld] (bf16 when ``bf16``); dy, out
// [n, K*F], alpha [E, K], s_src/s_dst [n, K] f32; de [E, K], ds [n, K] f32.
int gnna_gat_sddmm(const void* ptr, const void* col, int n, const void* table,
              int ld, int bf16, int K, int F, int PH, const void* dy,
              const void* out, const void* alpha, const void* s_src,
              const void* s_dst, float slope, void* de, void* ds,
              void* stream) {
  using namespace gat;
  if (!gather_ok(table, ld, K, F, PH, bf16) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  SddmmArgs a{static_cast<const int*>(ptr),   static_cast<const int*>(col),
              n,                              table,
              ld,                             K,
              F,                              PH,
              static_cast<const float*>(dy),  static_cast<const float*>(out),
              static_cast<const float*>(alpha),
              static_cast<const float*>(s_src),
              static_cast<const float*>(s_dst),
              slope,                          static_cast<float*>(de),
              static_cast<float*>(ds)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    sddmm_kernel<uint16_t><<<blocks(n), gatk::kWarps * 32, 0, st>>>(a);
  else
    sddmm_kernel<float><<<blocks(n), gatk::kWarps * 32, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// de [E, K] f32, pos [E] int32, the chunk and fix-up arrays as in
// gnna_gat_aggregate, partial [partials, K] and out [num_rows, K] f32.
int gnna_gat_col_reduce(const void* de, const void* pos, int K,
                   const void* chunk_lo, const void* chunk_hi,
                   const void* chunk_dst, int chunks, const void* fix_row,
                   const void* fix_ptr, int fix_rows, void* partial,
                   void* out, void* stream) {
  using namespace gat;
  if (!heads_ok(K) || chunks < 0 || fix_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunks > 0) {
    ColArgs a{static_cast<const float*>(de), static_cast<const int*>(pos),
              K,
              static_cast<const int*>(chunk_lo),
              static_cast<const int*>(chunk_hi),
              static_cast<const int*>(chunk_dst),
              chunks,
              static_cast<float*>(partial),
              static_cast<float*>(out)};
    col_reduce_kernel<<<blocks(chunks), gatk::kWarps * 32, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (fix_rows > 0) {
    ColFixArgs f{static_cast<const float*>(partial), K,
                 static_cast<const int*>(fix_row),
                 static_cast<const int*>(fix_ptr), fix_rows,
                 static_cast<float*>(out)};
    col_fixup_kernel<<<blocks(fix_rows), gatk::kWarps * 32, 0, st>>>(f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
