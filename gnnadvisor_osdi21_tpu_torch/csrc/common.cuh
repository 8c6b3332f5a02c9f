// Shared device helpers for the hybrid-layout kernels.
//
// Operands arrive in one of two element types: f32, or bf16 carried as its
// raw 16 bits (uint16_t).  Widening bf16 to f32 is a shift and exact, so
// every kernel accumulates in f32 with plain f32 adds: a 0/1 adjacency
// bit times a value is the value itself, and nothing goes through the
// tensor cores (no TF32 rounding).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gnna {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// acc[0:DT] += row[0:DT] for one row of a row-major table.  ``row`` must be
// 16-byte aligned (tables are padded to a multiple of 8 elements per row).
template <typename T, int DT>
struct RowAdd;

template <int DT>
struct RowAdd<float, DT> {
  static_assert(DT % 4 == 0, "f32 rows are read as float4");
  __device__ __forceinline__ static void add(const float* __restrict__ row,
                                             float* acc) {
    const float4* v = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int i = 0; i < DT / 4; ++i) {
      const float4 q = __ldg(v + i);
      acc[4 * i + 0] += q.x;
      acc[4 * i + 1] += q.y;
      acc[4 * i + 2] += q.z;
      acc[4 * i + 3] += q.w;
    }
  }
};

template <int DT>
struct RowAdd<uint16_t, DT> {
  static_assert(DT % 8 == 0, "bf16 rows are read as 8-element uint4");
  __device__ __forceinline__ static void add(const uint16_t* __restrict__ row,
                                             float* acc) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int i = 0; i < DT / 8; ++i) {
      const uint4 q = __ldg(v + i);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[8 * i + 2 * k] += __uint_as_float(w[k] << 16);
        acc[8 * i + 2 * k + 1] += __uint_as_float(w[k] & 0xFFFF0000u);
      }
    }
  }
};

// acc[0:DT] += row[0:DT] for a row staged in shared memory as f32.
template <int DT>
__device__ __forceinline__ void add_shared_row(const float* row, float* acc) {
  const float4* v = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < DT / 4; ++i) {
    const float4 q = v[i];
    acc[4 * i + 0] += q.x;
    acc[4 * i + 1] += q.y;
    acc[4 * i + 2] += q.z;
    acc[4 * i + 3] += q.w;
  }
}

}  // namespace gnna

// Instantiate KERNEL_CALL(T, DT) for the feature tile ``dt`` and element
// type; ``dt`` is 8, 16, 24 or 32 (the wrapper pads D to fit).
#define GNNA_DISPATCH(bf16, dt, KERNEL_CALL)                       \
  do {                                                             \
    if (bf16) {                                                    \
      switch (dt) {                                                \
        case 8: KERNEL_CALL(uint16_t, 8); break;                   \
        case 16: KERNEL_CALL(uint16_t, 16); break;                 \
        case 24: KERNEL_CALL(uint16_t, 24); break;                 \
        case 32: KERNEL_CALL(uint16_t, 32); break;                 \
        default: return static_cast<int>(cudaErrorInvalidValue);   \
      }                                                            \
    } else {                                                       \
      switch (dt) {                                                \
        case 8: KERNEL_CALL(float, 8); break;                      \
        case 16: KERNEL_CALL(float, 16); break;                    \
        case 24: KERNEL_CALL(float, 24); break;                    \
        case 32: KERNEL_CALL(float, 32); break;                    \
        default: return static_cast<int>(cudaErrorInvalidValue);   \
      }                                                            \
    }                                                              \
  } while (0)
