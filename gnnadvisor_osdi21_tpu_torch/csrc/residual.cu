// Row-major residual combine for the hybrid layout: for every residual
// tile i, out[t2b[i]·OB : +OB, :] += unpack(mask tile i)[OB, S] @
// rows[i·S : +S, :].
//
// Replaces the TPU kernel residual_combine / _resid_kernel
// (gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:354, pallas_call at :387),
// together with the caller's select that zeroes output blocks no tile
// visits (ops/hybrid_agg.py:259-268).
//
// Layout.  mask is uint32 [W, M_pad] with W = OB/32, out-row-major: slot m
// feeds output row o of its block when bit o / W of word mask[o % W, m]
// is set.  rows [M_pad, D] holds the gathered slot rows, M_pad = T·S.
// Tiles are sorted by output block; block_ptr[b] .. block_ptr[b+1] is the
// tile range of block b (computed once, when the layout's tensors are
// built).
//
// What bounds it.  Bytes: the mask (OB/8 bytes per slot) and the gathered
// rows are each read once and every output value is written once; only a
// few mask bits are set per output row.
//
// Design.  The TPU kernel walks tiles in order and carries a block's sum
// in VMEM from one grid step to the next.  GPU blocks run in no order, so
// here one block of threads owns the rows of one output block that 8 of
// the mask's words address (a block of 512 rows is two blocks of threads)
// and one feature tile of up to 32 features, and walks that output
// block's tile range itself.  Warp w of it owns word w: lane k owns output
// row k·W + w, bit k of the word.  For each tile the warp reads its word
// for 32 slots at a time (one coalesced 128-byte load: slots are the
// mask's minor axis), and a 32 x 32 bit transpose across the warp's lanes
// (five shuffle rounds) turns the 32 words into 32 slot bit vectors, one
// per lane's row.  The loads are issued before the tile's slot rows (one
// feature tile of them, as f32) are staged in shared memory, so they
// arrive while it runs; the staging itself keeps eight loads in flight per
// thread, of 16 bytes each where the rows are 16-byte aligned (one load
// per loop trip, used at once, made the kernel 3.5x slower at D = 64 on
// the H100).  Each lane then adds the staged row of every set bit into
// the tile's DT f32 register accumulators, and adds those to the
// block's after the tile (the reference's order: each tile's product,
// then the sum over tiles).  It writes its row's run once; a block with
// no tiles writes zeros, which replaces the select.  The feature tiles
// and halves of one output block are adjacent blocks of threads, so the
// later ones' mask and row reads can hit L2.  No atomics; the order of the
// sum is fixed.

#include "common.cuh"

namespace gnna {

constexpr int kResRowThreads = 256;  // 32 rows for each of 8 mask words
constexpr int kResRowWords = kResRowThreads / 32;
constexpr int kMaxRowTile = 256;  // slots per residual tile, at most
constexpr int kChunks = kMaxRowTile / 32;

// Warp-wide transpose of a 32 x 32 bit matrix: lane i holds row i (bit j
// is entry (i, j)); afterwards lane j holds column j (bit i is entry
// (i, j)).  Each round swaps the off-diagonal s x s blocks of every
// 2s x 2s block.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const uint32_t m = masks[i];
    const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, s);
    x = (lane & s) ? (((y >> s) & m) | (x & ~m)) : ((x & m) | ((y & m) << s));
  }
  return x;
}

constexpr int kInFlight = 8;  // staging loads each thread issues before using any

// tile[s, 0:DT] = rows[s, f0:f0+DT] as f32 for the S slot rows of a tile
// (zeros past D), one element per load, kInFlight loads in flight.
template <typename T, int DT>
__device__ __forceinline__ void stage_rows(const T* __restrict__ rows, int S,
                                           int D, int f0, float* tile) {
  const int total = S * DT;
  for (int base = threadIdx.x; base < total; base += kInFlight * blockDim.x) {
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      const int s = idx / DT;
      const int j = idx - s * DT;
      v[u] = (idx < total && f0 + j < D)
                 ? widen(rows[static_cast<size_t>(s) * D + f0 + j])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      const int s = idx / DT;
      if (idx < total) tile[s * (DT + 4) + idx - s * DT] = v[u];
    }
  }
}

// The same with 16-byte loads, for rows whose D·sizeof(T) is a multiple of
// 16 bytes (each 16-byte piece then lies wholly inside or past D).
template <typename T, int DT>
__device__ __forceinline__ void stage_rows_vec(const T* __restrict__ rows,
                                               int S, int D, int f0,
                                               float* tile) {
  constexpr int kVec = 16 / sizeof(T);  // elements per piece
  constexpr int kPieces = DT / kVec;    // pieces per staged row
  static_assert(DT % kVec == 0, "a staged row is whole pieces");
  const int total = S * kPieces;
  for (int base = threadIdx.x; base < total; base += kInFlight * blockDim.x) {
    uint4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      const int s = idx / kPieces;
      const int f = f0 + (idx - s * kPieces) * kVec;
      v[u] = (idx < total && f < D)
                 ? __ldg(reinterpret_cast<const uint4*>(
                       rows + static_cast<size_t>(s) * D + f))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int idx = base + u * blockDim.x;
      const int s = idx / kPieces;
      if (idx < total)
        widen_piece(v[u], tile + s * (DT + 4) + (idx - s * kPieces) * kVec,
                    static_cast<const T*>(nullptr));
    }
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(kResRowThreads)
    residual_rows_kernel(const uint32_t* __restrict__ mask, int W, int S,
                         int m_pad, const T* __restrict__ rows, int D,
                         bool vec, const int* __restrict__ block_ptr,
                         int splits, int feature_tiles,
                         float* __restrict__ out) {
  constexpr int kStride = DT + 4;  // f32 per staged row (keeps float4 alignment)
  __shared__ __align__(16) float tile[kMaxRowTile * kStride];
  const int lane = threadIdx.x & 31;
  const int f0 = (blockIdx.x % feature_tiles) * DT;
  const int rest = blockIdx.x / feature_tiles;
  const int blk = rest / splits;
  const int w = (rest % splits) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool live = w < W;  // the same for the whole warp
  const uint32_t* word = mask + static_cast<size_t>(live ? w : 0) * m_pad;
  float acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j] = 0.f;

  const int t_end = block_ptr[blk + 1];
  for (int t = block_ptr[blk]; t < t_end; ++t) {
    const size_t slot0 = static_cast<size_t>(t) * S;
    // this warp's mask word for each slot of the tile, in flight while the
    // tile stages
    uint32_t words[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      words[c] = (live && c * 32 + lane < S)
                     ? __ldg(word + slot0 + c * 32 + lane)
                     : 0u;
    __syncthreads();  // the previous tile is consumed
    if (vec)
      stage_rows_vec<T, DT>(rows + slot0 * D, S, D, f0, tile);
    else
      stage_rows<T, DT>(rows + slot0 * D, S, D, f0, tile);
    __syncthreads();
    if (!live) continue;
    // the tile's own sum first, then into the block's: the reference's
    // order (out += mask_tile @ rows_tile), which long sums need to agree
    float part[DT];
#pragma unroll
    for (int j = 0; j < DT; ++j) part[j] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * 32 >= S) break;
      uint32_t hits = transpose32(words[c], lane);  // bit i: slot c·32 + i
      while (hits) {
        const int b = __ffs(hits) - 1;
        hits &= hits - 1;
        add_shared_row<DT>(tile + (c * 32 + b) * kStride, part);
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[j] += part[j];
  }
  if (live) {
    const size_t row = static_cast<size_t>(blk) * W * 32 + lane * W + w;
    store_run<DT>(out + row * D + f0, acc, D - f0 < DT ? D - f0 : DT,
                  (D & 3) == 0);
  }
}

}  // namespace gnna

extern "C" int gnna_residual_combine(const void* mask, int W, int num_tiles,
                                     int S, const void* rows, int D,
                                     const void* block_ptr, int num_rows,
                                     int bf16, void* out, void* stream) {
  using namespace gnna;
  const int ob = 32 * W;
  if (W <= 0 || num_tiles <= 0 || S <= 0 || S > kMaxRowTile || D <= 0 ||
      num_rows % ob)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (D + 7) / 8 * 8;
  const int dt = dp <= 32 ? dp : 32;
  const int wb = W < kResRowWords ? W : kResRowWords;
  const int splits = (W + wb - 1) / wb;
  const int feature_tiles = (D + dt - 1) / dt;
  const int grid = (num_rows / ob) * splits * feature_tiles;
  const int threads = 32 * wb;
  const int m_pad = num_tiles * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  const int* ptr = static_cast<const int*>(block_ptr);
  float* o = static_cast<float*>(out);
  // 16-byte staging loads when every slot row starts 16-byte aligned
  const int elem = bf16 ? 2 : 4;
  const bool vec = (D * elem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
#define GNNA_RES_ROWS_CALL(T, DTV)                                           \
  residual_rows_kernel<T, DTV><<<grid, threads, 0, st>>>(                    \
      m, W, S, m_pad, static_cast<const T*>(rows), D, vec, ptr, splits,      \
      feature_tiles, o)
  GNNA_DISPATCH(bf16, dt, GNNA_RES_ROWS_CALL);
#undef GNNA_RES_ROWS_CALL
  return static_cast<int>(cudaGetLastError());
}
