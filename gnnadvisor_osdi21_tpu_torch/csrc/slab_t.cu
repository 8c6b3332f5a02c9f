// Transposed bit-slab SpMM for the diagonal and hot tiers of the hybrid
// layout: out[D, R] = x_t @ unpack(bits).
//
// Replaces the TPU kernels slab_matmul_t / _slab_kernel_t
// (gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:469, pallas_call at :510) and
// fused_slab_matmul_t / _fused_kernel_t (:556, pallas_call at :588).
//
// Layout.  A slab is uint16 [W16, R] with graph rows (output columns) on
// the minor axis; slab column j sits in word j % W16 at bit j // W16.  The
// hot wiring reads a global K-row table; the diagonal wiring reads, for
// output column r, table rows [(r / B) * B, (r / B + 1) * B).
//
// What bounds it.  The slab bytes: every output column reads W16 words,
// 512 B per column for K = 4096, and only a few of its bits are set (a
// few edges per row).  So the pass streams the slab from device memory
// once and does almost no arithmetic; the bound is slab bytes over the
// card's memory rate.
//
// Design.  The TPU kernel unpacks whole tiles to a dense 0/1 matrix for the
// MXU.  Here one thread owns one output column r: it reads its words
// bits[w, r] (consecutive threads read consecutive addresses, so every
// load is coalesced), eight words ahead, skips zero words, and for each
// set bit adds one table row into DT f32 register accumulators.  Each
// thread writes its column once: no atomics, no shared scratch, and the
// summation order is fixed.  The table is row-major [rows, Dp] (the
// wrapper transposes x_t once), so one set bit costs one contiguous 32-
// to 128-byte read that the L1/L2 caches serve; the whole K = 4096 hot
// table (at most 360 KB) stays in L2, and a diagonal block's rows are
// shared by the B / 256 blocks of threads that read them.  Staging a
// table in shared memory would read every row of it for every block of
// threads, which costs more than the few rows a column's set bits need.
// D wider than 32 is split over gridDim.y in tiles of 32 features.
// The walk over a column's words is add_slab (slab.cuh).

#include "slab.cuh"

namespace gnna {

template <typename T, int DT>
__global__ void __launch_bounds__(kSlabThreads)
    slab_kernel(Slab<T> first, Slab<T> second, int R, int D, int Dp,
                float* __restrict__ out) {
  const int r = blockIdx.x * kSlabThreads + threadIdx.x;
  if (r >= R) return;
  const int f0 = blockIdx.y * DT;
  float acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j] = 0.f;
  add_slab<T, DT>(first, r, R, Dp, f0, acc);
  add_slab<T, DT>(second, r, R, Dp, f0, acc);
#pragma unroll
  for (int j = 0; j < DT; ++j)
    if (f0 + j < D) out[static_cast<size_t>(f0 + j) * R + r] = acc[j];
}

int launch(const Slab<float>& a32, const Slab<float>& b32, int R, int D,
           int Dp, int bf16, float* out, cudaStream_t stream) {
  const int dt = feature_tile(Dp);
  if (R <= 0 || Dp % dt) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + kSlabThreads - 1) / kSlabThreads, Dp / dt);
#define GNNA_SLAB_CALL(T, DTV)                                              \
  slab_kernel<T, DTV><<<grid, kSlabThreads, 0, stream>>>(                   \
      as_type<T>(a32), as_type<T>(b32), R, D, Dp, out)
  GNNA_DISPATCH(bf16, dt, GNNA_SLAB_CALL);
#undef GNNA_SLAB_CALL
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnna

extern "C" {

// One slab: ``block`` = 0 for the hot wiring, B for the diagonal wiring.
int gnna_slab_matmul_t(const void* bits, int w16, int block, const void* table,
                       int R, int D, int Dp, int bf16, void* out,
                       void* stream) {
  using gnna::Slab;
  const Slab<float> a{static_cast<const uint16_t*>(bits), w16,
                      static_cast<const float*>(table), block};
  const Slab<float> none{nullptr, 0, nullptr, 0};
  return gnna::launch(a, none, R, D, Dp, bf16, static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream));
}

// Diagonal and hot slabs in one column pass.
int gnna_fused_slab_matmul_t(const void* diag_bits, int diag_w16, int diag_b,
                             const void* diag_table, const void* hot_bits,
                             int hot_w16, const void* hot_table, int R, int D,
                             int Dp, int bf16, void* out, void* stream) {
  using gnna::Slab;
  const Slab<float> d{static_cast<const uint16_t*>(diag_bits), diag_w16,
                      static_cast<const float*>(diag_table), diag_b};
  const Slab<float> h{static_cast<const uint16_t*>(hot_bits), hot_w16,
                      static_cast<const float*>(hot_table), 0};
  return gnna::launch(d, h, R, D, Dp, bf16, static_cast<float*>(out),
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
