// Transposed residual combine for the hybrid layout: for every residual
// tile i, out[:, t2b[i]·OB : +OB] += rows_t[:, i·S : +S] @ unpack(mask_s
// tile i)[S, OB].
//
// Replaces the TPU kernel residual_combine_t / _resid_kernel_t
// (gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:649, pallas_call at :679),
// together with the caller's select that zeroes output blocks no tile
// visits (ops/hybrid_agg.py:377-384).
//
// Layout.  mask_s is uint16 [S/16, T·OB], slot-major: slot s of tile i and
// output row o of its block sit in word s % S16, bit s // S16, at lane
// i·OB + o.  rows_t [D, M_pad] holds the gathered slot rows, M_pad = T·S.
// Tiles are sorted by output block; block_ptr[b] .. block_ptr[b+1] is the
// tile range of block b (computed once, when the layout's tensors are
// built).
//
// What bounds it.  Bytes: the mask (S/8 bytes per tile lane) and the
// gathered rows are each read once and every output value is written
// once; only a few mask bits are set per output row.
//
// Design.  The TPU kernel walks tiles in order and carries a block's sum
// in VMEM from one grid step to the next.  GPU blocks run in no order, so
// here one block of threads owns one output block (up to 512 of its rows;
// wider blocks are split over several blocks of threads) and walks that
// block's tile range itself.  For each tile it stages the tile's S slot
// rows (one feature tile of them, as f32) in shared memory with coalesced
// reads.  Each thread issues its S16 mask words for the tile (coalesced:
// lanes are rows) before the staging, so they arrive while it runs, then
// adds the staged row of every set bit into DT f32 register accumulators.
// The block is written once, and a block with no tiles writes zeros,
// which replaces the select.  No atomics; the order of the sum is fixed.

#include "common.cuh"

namespace gnna {

constexpr int kResThreads = 512;  // output rows per block of threads, at most
constexpr int kMaxTile = 256;     // slots per residual tile, at most
constexpr int kMaxWords = kMaxTile / 16;  // mask words per row and tile

template <typename T, int DT>
__global__ void __launch_bounds__(kResThreads)
    residual_kernel(const uint16_t* __restrict__ mask_s, int s16, int ob,
                    int lanes, const T* __restrict__ rows_t, int m_pad,
                    const int* __restrict__ block_ptr, int splits, int D,
                    int num_rows, float* __restrict__ out) {
  constexpr int kStride = DT + 4;  // f32 per staged row (keeps float4 alignment)
  __shared__ __align__(16) float tile[kMaxTile * kStride];
  const int blk = blockIdx.x / splits;
  const int o = (blockIdx.x % splits) * blockDim.x + threadIdx.x;
  const int f0 = blockIdx.y * DT;
  const int S = s16 * 16;
  float acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j] = 0.f;

  const int t_end = block_ptr[blk + 1];
  for (int t = block_ptr[blk]; t < t_end; ++t) {
    // this row's mask words for tile t, in flight while the tile stages
    uint32_t words[kMaxWords];
    const uint16_t* m = mask_s + static_cast<size_t>(t) * ob + o;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w)
      words[w] = (o < ob && w < s16) ? __ldg(m + static_cast<size_t>(w) * lanes)
                                     : 0u;
    __syncthreads();  // the previous tile is consumed
#pragma unroll 4
    for (int idx = threadIdx.x; idx < DT * S; idx += blockDim.x) {
      const int f = idx / S;
      const int s = idx - f * S;
      tile[s * kStride + f] =
          (f0 + f < D)
              ? widen(rows_t[static_cast<size_t>(f0 + f) * m_pad +
                             static_cast<size_t>(t) * S + s])
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      uint32_t word = words[w];
      while (word) {
        const int b = __ffs(word) - 1;
        word &= word - 1;
        add_shared_row<DT>(tile + (b * s16 + w) * kStride, acc);
      }
    }
  }
  if (o < ob) {
    const size_t col = static_cast<size_t>(blk) * ob + o;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      if (f0 + j < D) out[static_cast<size_t>(f0 + j) * num_rows + col] = acc[j];
  }
}

}  // namespace gnna

extern "C" int gnna_residual_combine_t(const void* mask_s, int s16, int ob,
                                       int num_tiles, const void* rows_t,
                                       const void* block_ptr, int num_rows,
                                       int D, int bf16, void* out,
                                       void* stream) {
  using namespace gnna;
  if (ob <= 0 || num_rows % ob || s16 <= 0 || s16 * 16 > kMaxTile || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (D + 7) / 8 * 8;
  const int dt = dp <= 32 ? dp : 32;
  const int threads = ob < kResThreads ? (ob + 31) / 32 * 32 : kResThreads;
  const int splits = (ob + threads - 1) / threads;
  const dim3 grid((num_rows / ob) * splits, (D + dt - 1) / dt);
  const int lanes = num_tiles * ob;
  const int m_pad = num_tiles * s16 * 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* mask = static_cast<const uint16_t*>(mask_s);
  const int* ptr = static_cast<const int*>(block_ptr);
  float* o = static_cast<float*>(out);
#define GNNA_RES_CALL(T, DTV)                                                \
  residual_kernel<T, DTV><<<grid, threads, 0, st>>>(                         \
      mask, s16, ob, lanes, static_cast<const T*>(rows_t), m_pad, ptr,       \
      splits, D, num_rows, o)
  GNNA_DISPATCH(bf16, dt, GNNA_RES_CALL);
#undef GNNA_RES_CALL
  return static_cast<int>(cudaGetLastError());
}
