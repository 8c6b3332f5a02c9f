// Asynchronous copies into shared memory on Hopper, as inline PTX:
// mbarriers and bulk copies (the copy engine, "TMA", without a tensor
// map) for the row-major slab stream (slab.cu), tensor-map boxes for the
// probes' bit slabs (bit_walk.cu) and the dense slab ring (dense_slab.cu),
// and 16-byte cp.async with commit groups for the residual's row gather
// (residual.cu).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gnna {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier with ``count`` arrivals per phase (one thread initialises;
// fence and __syncthreads before anyone else uses it).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces ``bytes`` of copies completing on the
// barrier in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory; completion is counted on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One box of a 2-D tensor map (``map`` a __grid_constant__ kernel
// parameter) at element coordinates (x, y) into shared memory (128-byte
// aligned); the whole box's bytes, zeros past the tensor included, are
// counted on ``bar``.
__device__ __forceinline__ void tensor_load_2d(void* dst, const void* map,
                                               int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// 16-byte cp.async (L2 only, no L1 allocation) and its commit groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point lookup
// (no link to libcuda); null where it is missing.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

}  // namespace gnna
