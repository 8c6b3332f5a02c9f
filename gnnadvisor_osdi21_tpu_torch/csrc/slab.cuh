// The slab operands of the transposed (slab_t.cu) and row-major (slab.cu)
// slab kernels, and the transposed kernel's bit-slab walk.
//
// A slab is uint16 [W16, R] with graph rows on the minor axis; slab column
// j sits in word j % W16 at bit j // W16.  The transposed walk gives one
// thread one graph row r (an output column of the product) and one
// feature tile: the thread reads
// bits[w, r] for every word w (consecutive threads read consecutive
// addresses, so every load is coalesced), eight words ahead, skips zero
// words, and for each set bit adds one row of a row-major table [rows, Dp]
// into DT f32 register accumulators.  The hot wiring reads a global K-row
// table; the diagonal wiring reads, for row r, table rows
// [(r / B) * B, (r / B + 1) * B).  The row-major kernel streams the
// slab through shared memory instead (slab.cu).
#pragma once

#include "common.cuh"

namespace gnna {

constexpr int kSlabThreads = 256;

template <typename T>
struct Slab {
  const uint16_t* bits;  // [w16, R]; w16 == 0: slab absent
  int w16;
  const T* table;  // row-major [rows, Dp]
  int block;       // 0: global table (hot); B: block-local table (diagonal)
};

// The element type is a launch-time flag: the C entry points carry table
// pointers as Slab<float> and reinterpret them for the bf16 instantiation.
template <typename T>
inline Slab<T> as_type(const Slab<float>& s) {
  return Slab<T>{s.bits, s.w16, reinterpret_cast<const T*>(s.table), s.block};
}

template <typename T, int DT>
__device__ __forceinline__ void add_slab(const Slab<T>& s, int r, int R,
                                         int Dp, int f0, float* acc) {
  if (s.w16 == 0) return;
  const size_t first = s.block ? static_cast<size_t>(r / s.block) * s.block : 0;
  const T* base = s.table + first * Dp + f0;
  const uint16_t* col = s.bits + r;
  for (int w0 = 0; w0 < s.w16; w0 += 8) {
    uint32_t words[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      words[k] = (w0 + k < s.w16) ? __ldg(col + static_cast<size_t>(w0 + k) * R)
                                  : 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t w = words[k];
      while (w) {
        const int b = __ffs(w) - 1;
        w &= w - 1;
        const size_t c = static_cast<size_t>(b) * s.w16 + w0 + k;
        RowAdd<T, DT>::add(base + c * Dp, acc);
      }
    }
  }
}

// Tables are padded to Dp columns: Dp <= 32 is one feature tile of width
// Dp, wider tables are split in tiles of 32.
inline int feature_tile(int Dp) { return Dp <= 32 ? Dp : 32; }

}  // namespace gnna
