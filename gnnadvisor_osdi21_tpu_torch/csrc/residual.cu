// Row-major residual combine for the hybrid layout, with the slot gather
// and the tier sum fused in: for every residual tile i,
// out[t2b[i]·OB : +OB, :] += unpack(mask tile i)[OB, S] @
// x[src[i·S : +S], :], and out = addend + out when an addend is given.
//
// Replaces the TPU kernel residual_combine / _resid_kernel
// (gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:354, pallas_call at :387),
// together with the caller's slot gathers (ops/hybrid_agg.py:248-256,
// XLA ops in the JAX package), its select that zeroes output blocks no
// tile visits (:259-268), and the tier sum h + r.
//
// Layout.  mask is uint32 [W, M_pad] with W = OB/32, out-row-major: slot m
// feeds output row o of its block when bit o / W of word mask[o % W, m]
// is set.  src [M_pad] int32 names each slot's row of x [rows, Dx]
// (res_gather[res_dst], composed when the layout's tensors are built; pad
// slots name a valid row and have no bits).  An id outside x's rows is
// not read (row 0 is staged in its place) and stops the kernel, after
// its tiles and before any output is written, with a device-side assert,
// as index_select's gather does; the assert sits outside the tile loop,
// where a call to it costs no registers.  Tiles are sorted by output block; block_ptr[b] ..
// block_ptr[b+1] is the tile range of block b.
//
// What bounds it.  Bytes: the mask (OB/8 bytes per slot), the ids, the
// gathered x rows (D values per slot, from device memory or L2) and the
// output (and the addend) once.  A slot feeds about one output row, so
// the adds are few.
//
// Design.  A block of threads owns one output block (or 16 of its mask
// words, 512 rows, when OB is wider) and up to 64 features: the whole
// width at D = 64, two halves at D = 96.  It walks the block's tiles in
// block_ptr order through a ring of two or three shared-memory stages:
// every thread issues 16-byte cp.async copies of the tile's slot rows,
// gathered straight from x by src and kept in their own type (bf16 stays
// bf16), and of the tile's mask words, so that the next tiles' rows
// arrive while this one's adds run; the ids of the tile after are loaded
// meanwhile.  Two warps share mask word w, 16 of the block's 32 output
// rows k·W + w each, with their lanes over the features (2 per lane) and
// the rows' accumulators in registers.  For each tile a warp reads its
// word for the tile's slots from shared memory; a ballot of bit k over
// 32 slots is row k's slot set, the same in every lane, so every lane
// walks the same slots and adds its two features of each staged row
// (rows and 32-slot chunks with no bit set are skipped, from a warp OR of
// the words).  Only the loop over rows is unrolled: with the loop over
// chunks unrolled too, the code outgrew the instruction cache and the
// kernel ran almost three times slower on the H100.  Each tile's sum for a row
// is taken first and then added to the row's (the reference's order:
// each tile's product, then the sum over tiles).  The warp writes its
// rows once, each a coalesced run, adding the addend where given; a block
// with no tiles writes zeros (or the addend), which replaces the select.
// No atomics; the order of every sum is fixed.

#include <cassert>

#include "async.cuh"

namespace gnna {

constexpr int kResWords = 16;  // mask words (32 output rows each) per block
constexpr int kWarpsPerWord = 2;  // each takes 16 of a word's 32 rows
constexpr int kRowsPerWarp = 32 / kWarpsPerWord;
constexpr int kResThreads = 32 * kWarpsPerWord * kResWords;
constexpr int kMaxRowTile = 256;  // slots per residual tile, at most
constexpr int kResFeatures = 64;  // features per block of threads
constexpr int kResSmem = 200 * 1024;  // shared memory for the ring, at most

// Two features of a staged row.
__device__ __forceinline__ float2 shared_pair(const uint16_t* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xFFFF0000u));
}
__device__ __forceinline__ float2 shared_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

struct ResidualArgs {
  const uint32_t* mask;  // [W, m_pad]
  int W, S, m_pad;
  const void* x;  // [rows, Dx]
  int rows, Dx;
  const int* src;        // [m_pad]
  const int* block_ptr;  // [n_blocks + 1]
  int splits, feature_tiles, ft;  // words split, feature tiles of ft
  const float* addend;            // [num_rows, D] or null
  int D;
  float* out;  // [num_rows, D]
};

constexpr int kIds = 4;  // slot ids a thread holds for the next tile's gather

// Slot id ``id`` as a row of x: an id outside [0, rows) sets ``bad`` and
// reads row 0.
__device__ __forceinline__ int x_row(int id, int rows, bool& bad) {
  const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(rows);
  bad |= !ok;
  return ok ? id : 0;
}

// The slot ids of tile t that this thread's first kIds·blockDim pieces
// read (the rest, if a tile has more pieces, are read as they are issued).
__device__ __forceinline__ void load_ids(const ResidualArgs& a, int t,
                                         int per_row, int (&id)[kIds]) {
  const int n = a.S * per_row;
  const int* src = a.src + static_cast<size_t>(t) * a.S;
#pragma unroll
  for (int u = 0; u < kIds; ++u) {
    const int q = threadIdx.x + u * blockDim.x;
    id[u] = q < n ? __ldg(src + q / per_row) : 0;
  }
}

// Issue the copies of tile t into a stage: its S slot rows (ft features
// from f0, as 16-byte pieces, gathered by the ids in ``id`` and, past
// them, by ids read here; an id outside x sets ``bad``) and its mask words
// w0 .. w0 + wb.  The ids are checked here, where they are used, and not
// as they load: a check there would wait for each load, which the tile's
// adds otherwise hide.
template <typename T>
__device__ __forceinline__ void stage_tile(const ResidualArgs& a, int t,
                                           int f0, int w0, int wb,
                                           int per_row, const int (&id)[kIds],
                                           bool& bad, T* rows,
                                           uint32_t* words) {
  constexpr int E = 16 / sizeof(T);  // elements per piece
  const T* x = static_cast<const T*>(a.x) + f0;
  const int n = a.S * per_row;
  const int* src = a.src + static_cast<size_t>(t) * a.S;
#pragma unroll
  for (int u = 0; u < kIds; ++u) {
    const int q = threadIdx.x + u * blockDim.x;
    if (q < n) {
      const int s = q / per_row, j = q - s * per_row;
      cp_async16(rows + s * a.ft + j * E,
                 x + static_cast<size_t>(x_row(id[u], a.rows, bad)) * a.Dx +
                     j * E);
    }
  }
  for (int q = threadIdx.x + kIds * blockDim.x; q < n; q += blockDim.x) {
    const int s = q / per_row, j = q - s * per_row;
    cp_async16(rows + s * a.ft + j * E,
               x + static_cast<size_t>(x_row(__ldg(src + s), a.rows, bad)) *
                           a.Dx +
                   j * E);
  }
  const int per_word = a.S / 4;
  const int live = min(wb, a.W - w0);
  for (int q = threadIdx.x; q < live * per_word; q += blockDim.x) {
    const int w = q / per_word, p = q - w * per_word;
    cp_async16(words + w * a.S + 4 * p,
               a.mask + static_cast<size_t>(w0 + w) * a.m_pad +
                   static_cast<size_t>(t) * a.S + 4 * p);
  }
}

template <typename T, int NS>
__global__ void __launch_bounds__(kResThreads, 1)
    residual_gather_kernel(ResidualArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wb = blockDim.x / kWarpsPerWord / 32;  // mask words of the block
  const int stage_bytes = (a.S * a.ft * static_cast<int>(sizeof(T)) +
                           wb * a.S * 4 + 15) / 16 * 16;
  const int fi = blockIdx.x % a.feature_tiles;
  const int rest = blockIdx.x / a.feature_tiles;
  const int blk = rest / a.splits;
  const int w0 = (rest % a.splits) * wb;
  const int f0 = fi * a.ft;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wl = warp / kWarpsPerWord;            // the warp's word in the block
  const int k0 = (warp % kWarpsPerWord) * kRowsPerWarp;  // its first bit
  const int w = w0 + wl;
  const bool live = w < a.W;  // the same for the whole warp
  const bool feat = 2 * lane < a.ft;  // lanes past the tile's width idle
  // pieces of a staged row (the last feature tile may be narrower)
  const int per_row = min(a.ft, a.Dx - f0) / (16 / static_cast<int>(sizeof(T)));

  auto rows_of = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * stage_bytes);
  };
  auto words_of = [&](int slot) {
    return reinterpret_cast<uint32_t*>(smem + slot * stage_bytes +
                                       a.S * a.ft * sizeof(T));
  };

  const int t0 = a.block_ptr[blk];
  const int nt = a.block_ptr[blk + 1] - t0;
  int id[kIds];
  bool bad = false;  // a slot id outside x was met
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nt) {
      load_ids(a, t0 + i, per_row, id);
      stage_tile<T>(a, t0 + i, f0, w0, wb, per_row, id, bad, rows_of(i),
                    words_of(i));
    }
    cp_async_commit();
  }
  // the ids of the next tile to issue load while a tile's adds run
  if (NS - 1 < nt) load_ids(a, t0 + NS - 1, per_row, id);

  float acc[kRowsPerWarp][2];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) acc[k][0] = acc[k][1] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int ahead = i + NS - 1;
    if (ahead < nt)
      stage_tile<T>(a, t0 + ahead, f0, w0, wb, per_row, id, bad,
                    rows_of(ahead % NS), words_of(ahead % NS));
    cp_async_commit();
    if (ahead + 1 < nt) load_ids(a, t0 + ahead + 1, per_row, id);
    cp_async_wait<NS - 1>();  // this thread's copies of tile i landed
    __syncthreads();          // and everyone's
    if (live) {
      const T* rows = rows_of(i % NS);
      const uint32_t* mine = words_of(i % NS) + wl * a.S;
      const int chunks = (a.S + 31) / 32;
      // lane j < 16: bit c set when row k0 + j has a slot in chunk c
      uint32_t row_chunks = 0;
      for (int c = 0; c < chunks; ++c) {
        const uint32_t any = __reduce_or_sync(
            0xFFFFFFFFu, c * 32 + lane < a.S ? mine[c * 32 + lane] : 0u);
        row_chunks |= ((any >> (k0 + (lane & 15))) & 1u) << c;
      }
      // row k0 + k of the warp's word: the tile's sum first.  Only the
      // loop over rows is unrolled (the accumulators stay in registers):
      // with the loop over slot chunks unrolled inside it too, the code
      // outgrew the instruction cache.
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        uint32_t rc = __shfl_sync(0xFFFFFFFFu, row_chunks, k);
        if (!rc) continue;
        float p0 = 0.f, p1 = 0.f;
        while (rc) {
          const int c = __ffs(rc) - 1;
          rc &= rc - 1;
          const int s = c * 32 + lane;
          uint32_t m = __ballot_sync(
              0xFFFFFFFFu, s < a.S && ((mine[s] >> (k0 + k)) & 1u));
          while (m) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            if (feat) {
              const float2 v = shared_pair(rows + (c * 32 + b) * a.ft +
                                           2 * lane);
              p0 += v.x;
              p1 += v.y;
            }
          }
        }
        acc[k][0] += p0;
        acc[k][1] += p1;
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  if (__syncthreads_or(bad)) {  // a slot id outside x: nothing is written
    assert(false && "residual slot id outside the rows of x");
    return;
  }
  if (!live) return;
  const int f = f0 + 2 * lane;
  if (!feat || f >= a.D) return;
  const bool pair = f + 1 < a.D && (a.D & 1) == 0;  // 8-byte aligned pair
  const size_t row0 = static_cast<size_t>(blk) * a.W * 32 + w;
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const size_t at =
        (row0 + static_cast<size_t>(k0 + k) * a.W) * a.D + f;
    float2 v = make_float2(acc[k][0], acc[k][1]);
    if (a.addend) {
      v.x = a.addend[at] + v.x;
      if (f + 1 < a.D) v.y = a.addend[at + 1] + v.y;
    }
    if (pair) {
      *reinterpret_cast<float2*>(a.out + at) = v;
    } else {
      a.out[at] = v.x;
      if (f + 1 < a.D) a.out[at + 1] = v.y;
    }
  }
}

template <typename T>
int launch_gather(ResidualArgs a, int grid, int threads, cudaStream_t st) {
  const int stage_bytes =
      (a.S * a.ft * static_cast<int>(sizeof(T)) +
       threads / (32 * kWarpsPerWord) * a.S * 4 + 15) / 16 * 16;
  const bool three = 3 * stage_bytes <= kResSmem;
  const int smem = (three ? 3 : 2) * stage_bytes;
  auto kernel = three ? residual_gather_kernel<T, 3>
                      : residual_gather_kernel<T, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnna

// x [rows, Dx] (Dx·size a multiple of 16 bytes, Dx >= D), src [M_pad]
// int32 ids of rows of x, addend [num_rows, D] f32 or null.
extern "C" int gnna_residual_combine(const void* mask, int W, int num_tiles,
                                     int S, const void* x, int rows, int Dx,
                                     const void* src, int D,
                                     const void* block_ptr, int num_rows,
                                     const void* addend, int bf16, void* out,
                                     void* stream) {
  using namespace gnna;
  const int ob = 32 * W;
  const int elem = bf16 ? 2 : 4;
  if (W <= 0 || num_tiles <= 0 || S <= 0 || S > kMaxRowTile || S % 4 ||
      rows <= 0 || D <= 0 || Dx < D || (Dx * elem) % 16 || num_rows % ob ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // feature tiles of at most 64, each a whole number of 16-byte pieces
  const int feature_tiles = (Dx + kResFeatures - 1) / kResFeatures;
  const int ft = (Dx / feature_tiles + 7) / 8 * 8;
  const int wb = W < kResWords ? W : kResWords;
  ResidualArgs a{static_cast<const uint32_t*>(mask), W, S, num_tiles * S,
                 x, rows, Dx, static_cast<const int*>(src),
                 static_cast<const int*>(block_ptr), (W + wb - 1) / wb,
                 (Dx + ft - 1) / ft, ft,
                 static_cast<const float*>(addend), D,
                 static_cast<float*>(out)};
  const int grid = (num_rows / ob) * a.splits * a.feature_tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * kWarpsPerWord * wb;
  return bf16 ? launch_gather<uint16_t>(a, grid, threads, st)
              : launch_gather<float>(a, grid, threads, st);
}
