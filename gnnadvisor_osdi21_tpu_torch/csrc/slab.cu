// Row-major bit-slab SpMM for the diagonal and hot tiers of the hybrid
// layout: out[R, D] = unpack(bits)^T @ x.
//
// Replaces the TPU kernels slab_matmul / _slab_kernel
// (gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:143, pallas_call at :186),
// with its hot_slab_matmul (:212) and diag_slab_matmul (:226) wirings, and
// fused_slab_matmul / _fused_kernel (:259, pallas_call at :294).
//
// Layout.  The slab is the transposed kernels' uint16 [W16, R] (see
// slab.cuh); only the features are row-major: the hot wiring reads a
// global table x_hot [K, Dp], the diagonal wiring reads output row r's own
// block of x [R, Dp], and the output is [R, D] f32.
//
// What bounds it.  Bytes: the slab (W16 words per row, 512 B for K = 4096)
// and the output (D f32 per row) each cross device memory once; the table
// is small (hot) or read once per diagonal block, and a row's few set bits
// cost a few adds each.  At D = 64 the output is half the slab's bytes.
//
// Design.  One thread owns one output row and one feature tile: 64
// features at D = 64 (GIN's hidden width), else up to 32 (DT f32
// accumulators; a thread with all 96 of GIN's input features would
// spill).  It walks the row's slab words (add_slab, shared with the
// transposed kernel) and writes its DT-float run of the output row once,
// with float4 stores where the row is 16-byte aligned.  With more than one
// feature tile, the tiles of a 32-row group are warps of one block of
// threads: they read the same words at nearly the same time, so the
// repeated reads can come from the caches rather than device memory.
// Walking the
// words once per tile still costs time: at D = 64 one 64-wide tile ran
// about 20% faster than two 32-wide ones on the H100.  No atomics, no
// shared scratch; the order of every sum is fixed.

#include "slab.cuh"

namespace gnna {

template <typename T, int DT>
__global__ void __launch_bounds__(kSlabThreads)
    slab_rows_kernel(Slab<T> first, Slab<T> second, int R, int D, int Dp,
                     int tiles_per_block, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int groups = (blockDim.x >> 5) / tiles_per_block;
  const int r = (blockIdx.x * groups + warp / tiles_per_block) * 32 +
                (threadIdx.x & 31);
  const int f0 = (blockIdx.y * tiles_per_block + warp % tiles_per_block) * DT;
  if (r >= R || f0 >= D) return;
  float acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j] = 0.f;
  add_slab<T, DT>(first, r, R, Dp, f0, acc);
  add_slab<T, DT>(second, r, R, Dp, f0, acc);
  store_run<DT>(out + static_cast<size_t>(r) * D + f0, acc,
                D - f0 < DT ? D - f0 : DT, (D & 3) == 0);
}

int launch_rows(const Slab<float>& a32, const Slab<float>& b32, int R, int D,
                int Dp, int bf16, float* out, cudaStream_t stream) {
  // GIN's hidden width in one feature tile: one walk of the words per row
  const int dt = Dp == 64 ? 64 : feature_tile(Dp);
  if (R <= 0 || D <= 0 || D > Dp || Dp % dt)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = Dp / dt;
  const int warps = kSlabThreads / 32;
  const int per_block = tiles < warps ? tiles : warps;  // feature tiles
  const int groups = warps / per_block;                 // 32-row groups
  const dim3 grid((R + 32 * groups - 1) / (32 * groups),
                  (tiles + per_block - 1) / per_block);
  const int threads = 32 * per_block * groups;
#define GNNA_SLAB_ROWS_CALL(T, DTV)                                         \
  slab_rows_kernel<T, DTV><<<grid, threads, 0, stream>>>(                   \
      as_type<T>(a32), as_type<T>(b32), R, D, Dp, per_block, out)
  if (dt == 64) {
    if (bf16)
      GNNA_SLAB_ROWS_CALL(uint16_t, 64);
    else
      GNNA_SLAB_ROWS_CALL(float, 64);
  } else {
    GNNA_DISPATCH(bf16, dt, GNNA_SLAB_ROWS_CALL);
  }
#undef GNNA_SLAB_ROWS_CALL
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnna

extern "C" {

// One slab: ``block`` = 0 for the hot wiring, B for the diagonal wiring.
int gnna_slab_matmul(const void* bits, int w16, int block, const void* table,
                     int R, int D, int Dp, int bf16, void* out, void* stream) {
  using gnna::Slab;
  const Slab<float> a{static_cast<const uint16_t*>(bits), w16,
                      static_cast<const float*>(table), block};
  const Slab<float> none{nullptr, 0, nullptr, 0};
  return gnna::launch_rows(a, none, R, D, Dp, bf16, static_cast<float*>(out),
                           static_cast<cudaStream_t>(stream));
}

// Diagonal and hot slabs in one row pass.
int gnna_fused_slab_matmul(const void* diag_bits, int diag_w16, int diag_b,
                           const void* diag_table, const void* hot_bits,
                           int hot_w16, const void* hot_table, int R, int D,
                           int Dp, int bf16, void* out, void* stream) {
  using gnna::Slab;
  const Slab<float> d{static_cast<const uint16_t*>(diag_bits), diag_w16,
                      static_cast<const float*>(diag_table), diag_b};
  const Slab<float> h{static_cast<const uint16_t*>(hot_bits), hot_w16,
                      static_cast<const float*>(hot_table), 0};
  return gnna::launch_rows(d, h, R, D, Dp, bf16, static_cast<float*>(out),
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
