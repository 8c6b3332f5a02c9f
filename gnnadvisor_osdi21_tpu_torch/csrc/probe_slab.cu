// The legacy uint32 transposed bit slab of the measurement probes,
// contracted over K with a 16-wide feature table on the tensor cores (bf16
// operands).
//
// Replaces the TPU kernel of the probe scripts:
//   _bit_t_kernel  (gnnadvisor_osdi21_tpu/bench/fixprobe.py:63, pallas_call
//                   at :76): out[16, R] = x_t[16, K] @ unpack(bits [K/32, R])
//                   from the legacy uint32 transposed bit slab.
// (The dense slabs of fixprobe and stepprobe, _i8_t_kernel and
// _dense_kernel, run on the streamed ring of dense_slab.cu.)
//
// What bounds it.  Bytes: the slab crosses device memory once (K/8 bytes
// per row) and the output once (64 bytes per row); the table is at most
// 128 KB.  The tensor cores' 2·16·K flops per row stay below the byte time
// at every K of the probes.
//
// Design.  Graph rows are the MMA's N dimension and the 16 features its M,
// so one warp's feature fragment serves all the rows it owns.  A block of
// ``block_rows`` threads owns that many graph rows (the TPU grid step's
// rows over 16: the probes sweep it as the TPU sweeps its block); each warp
// owns 32 of them, four n8 tiles of mma.sync.m16n8k16 (bf16 in, f32
// accumulate).  The K axis is walked in steps of 32 slab columns: the block
// stages the 0/1 tile [32, block_rows] in shared memory as bf16, unpacked
// from one uint32 word's 32 bits, and the matching 16 x 32 feature tile;
// then two k16 MMA steps per n8 tile.  Rows of both tiles are padded by 8
// bf16 so that the fragment loads hit 32 distinct banks.  A 0/1 value is
// exact in bf16 and its product with a bf16 feature is exact in f32, so
// the kernel differs from the plain version by summation order only.
//
// The bit slab puts column j in word j % W32 at bit j // W32: word w holds
// columns w, W32 + w, 2·W32 + w, ...  So the K steps walk words, not runs
// of columns, and the feature tile of word w stages x_t[:, b·W32 + w] at
// tile column b.  The contraction is the same sum in another order.
// No atomics; every output element is written once by one thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace gnna {
namespace probe {

constexpr int kFeat = 16;  // the probes' feature width: one m16 MMA tile
constexpr int kStep = 32;  // slab columns per staged tile (two k16 steps)
constexpr int kPad = 8;    // bf16 pad per shared row: conflict-free fragments
constexpr uint16_t kOne = 0x3F80;  // 1.0 in bf16

enum Src { kBits32 = 0 };

// c[0:4] += A (16 x 16, row-major fragment a) x B (16 x 8, column fragment
// b0, b1): bf16 operands, f32 accumulate (PTX ISA, mma.m16n8k16).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage slab columns [kc, kc + kStep) of rows [r0, r0 + BM) as bf16 into
// sa [kStep][BM + kPad]: the step is word kc / 32 and tile column b is bit b.
template <int SRC>
__device__ __forceinline__ void stage_slab(const void* slab, int R, int kc,
                                           int r0, int BM, uint16_t* sa) {
  static_assert(SRC == kBits32, "the dense slabs run in dense_slab.cu");
  const int ld = BM + kPad;
  const int r = r0 + threadIdx.x;
  const uint32_t w =
      r < R ? __ldg(static_cast<const uint32_t*>(slab) +
                    static_cast<size_t>(kc / 32) * R + r)
            : 0u;
#pragma unroll
  for (int b = 0; b < 32; ++b)
    sa[b * ld + threadIdx.x] = ((w >> b) & 1u) ? kOne : 0;
}

// out = contraction of the slab with the 16-wide bf16 table x.
// TRANS: x is x_t [16, K] and out [16, R] (fixprobe); else x is [K, 16] and
// out [R, 16] (stepprobe).  w32: words of the bit slab (K / 32).
template <int SRC, bool TRANS>
__global__ void __launch_bounds__(512)
    dense_mma_kernel(const void* __restrict__ slab, int K, int R, int w32,
                     const uint16_t* __restrict__ x, float* __restrict__ out) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int BM = blockDim.x;
  uint16_t* sa = smem;                         // [kStep][BM + kPad]
  uint16_t* sx = smem + kStep * (BM + kPad);   // [kFeat][kStep + kPad]
  const int ldx = kStep + kPad;
  const int r0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_warp = (threadIdx.x >> 5) * 32;  // the warp's first row

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kc = 0; kc < K; kc += kStep) {
    stage_slab<SRC>(slab, R, kc, r0, BM, sa);
    for (int i = threadIdx.x; i < kFeat * kStep; i += BM) {
      const int f = i / kStep, b = i % kStep;
      const int j = SRC == kBits32 ? b * w32 + kc / 32 : kc + b;
      sx[f * ldx + b] = TRANS ? x[static_cast<size_t>(f) * K + j]
                              : x[static_cast<size_t>(j) * kFeat + f];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kStep; ks += 16) {
      uint32_t a[4];  // features g, g + 8 x columns 2t, 2t + 1 (+ 8)
      a[0] = *reinterpret_cast<const uint32_t*>(sx + g * ldx + ks + 2 * t);
      a[1] = *reinterpret_cast<const uint32_t*>(sx + (g + 8) * ldx + ks + 2 * t);
      a[2] = *reinterpret_cast<const uint32_t*>(sx + g * ldx + ks + 2 * t + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(sx + (g + 8) * ldx + ks + 2 * t +
                                                8);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint16_t* col = sa + n_warp + 8 * n + g;  // row n0 + g
        const int ld = BM + kPad;
        const uint32_t b0 = col[(ks + 2 * t) * ld] |
                            (static_cast<uint32_t>(col[(ks + 2 * t + 1) * ld])
                             << 16);
        const uint32_t b1 = col[(ks + 2 * t + 8) * ld] |
                            (static_cast<uint32_t>(col[(ks + 2 * t + 9) * ld])
                             << 16);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
    __syncthreads();
  }

  // acc[n]: features (g, g + 8) x rows (2t, 2t + 1) of n8 tile n
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int r = r0 + n_warp + 8 * n + 2 * t;  // R is even: r + 1 < R too
    if (r >= R) continue;
    if (TRANS) {
      *reinterpret_cast<float2*>(out + static_cast<size_t>(g) * R + r) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(out + static_cast<size_t>(g + 8) * R + r) =
          make_float2(acc[n][2], acc[n][3]);
    } else {
      float* o = out + static_cast<size_t>(r) * kFeat;
      o[g] = acc[n][0];
      o[kFeat + g] = acc[n][1];
      o[g + 8] = acc[n][2];
      o[kFeat + g + 8] = acc[n][3];
    }
  }
}

inline bool bad_shape(int K, int R, int block_rows) {
  return K <= 0 || K % kStep || R <= 0 || R % 8 || block_rows < 32 ||
         block_rows > 512 || block_rows % 32;
}

template <int SRC, bool TRANS>
int launch_mma(const void* slab, int K, int R, const void* x, int block_rows,
               void* out, cudaStream_t stream) {
  if (bad_shape(K, R, block_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared =
      sizeof(uint16_t) *
      (kStep * (block_rows + kPad) + kFeat * (kStep + kPad));
  const dim3 grid((R + block_rows - 1) / block_rows);
  dense_mma_kernel<SRC, TRANS><<<grid, block_rows, shared, stream>>>(
      slab, K, R, K / 32, static_cast<const uint16_t*>(x),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probe
}  // namespace gnna

extern "C" {

// bits uint32 [w32, R] (legacy bit-major), x_t bf16 [16, 32·w32] ->
// out f32 [16, R].
int gnna_bit_slab_t(const void* bits, int w32, int R, const void* x_t,
                    int block_rows, void* out, void* stream) {
  using namespace gnna::probe;
  return launch_mma<kBits32, true>(bits, 32 * w32, R, x_t, block_rows, out,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
