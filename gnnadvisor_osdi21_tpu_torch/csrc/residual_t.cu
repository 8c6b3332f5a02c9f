// Transposed residual combine for the hybrid layout, with the slot gather
// and the tier sum fused in: for every residual tile i,
// out[:, t2b[i]·OB : +OB] += x_t[:, src[i·S : +S]] @ unpack(mask_s tile
// i)[S, OB], and out = addend + out when an addend is given.
//
// Replaces the TPU kernel residual_combine_t / _resid_kernel_t
// (gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:649, pallas_call at :679),
// together with the caller's slot gathers (ops/hybrid_agg.py:366-372,
// XLA ops in the JAX package), its select that zeroes output blocks no
// tile visits (:377-385), and the tier sum out + r (:349-351).
//
// Layout.  mask_s is uint16 [S/16, T·OB], slot-major: slot s of tile i and
// output row o of its block sit in word s % S16, bit s // S16, at lane
// i·OB + o.  The features come from a row-major table x [rows, Dx] (the
// wrapper passes x_t as the transposed view of one, or copies it into
// one); src [T·S] int32 names each slot's row of x (res_gather[res_dst],
// composed when the layout's tensors are built; pad slots name a valid
// row and have no bits).  An id outside x's rows is not read (row 0 is
// staged in its place) and stops the kernel, after its tiles and before
// any output is written, with a device-side assert, as index_select's
// gather does.  Tiles are sorted by output block; block_ptr[b] ..
// block_ptr[b+1] is the tile range of block b.  out and addend are
// [D, num_rows] f32.
//
// What bounds it.  Bytes: the mask (S/8 bytes per tile lane), the ids, the
// gathered x rows (D values per slot, from device memory or L2) and the
// output (and the addend) once.  Only a few mask bits are set per output
// row, so the adds are few.
//
// Design.  The TPU kernel walks tiles in order and carries a block's sum
// in VMEM from one grid step to the next.  GPU blocks run in no order, so
// here one block of threads owns one output block (up to 512 of its rows;
// wider blocks are split over several blocks of threads) and one feature
// tile of up to 32 columns, and walks that block's tile range itself,
// through a ring of two or three shared-memory stages.  Every thread
// issues 16-byte cp.async copies of the tile's slot rows, gathered
// straight from the row-major table by src and kept in their own type
// (bf16 stays bf16), and of the block's mask words for the tile (each of
// the S16 word rows is OB contiguous uint16), so that the next tiles'
// rows and words arrive while this one's adds run; the ids of the tile
// after are loaded meanwhile.  Rows are the minor axis of the mask, so
// one thread owns one output row: it reads its S16 words of the stage (a
// warp's 32 rows are 64 contiguous bytes of each word row: no ballots,
// no bank conflicts) and adds the staged row of every set bit into f32
// registers, in tile order.  (A separate sum per tile, as the row-major
// kernel takes, holds D more registers a thread, left one block of
// threads per SM at D = 22, and ran 20-25% slower on the H100.)
// The thread writes its row once, one value per feature, a warp's 32
// rows a coalesced 128-byte run of out[f], adding the addend where
// given; a block with no tiles writes zeros (or the addend), which
// replaces the select.  No atomics; the order of every sum is fixed.

#include <cassert>

#include "async.cuh"

namespace gnna {

constexpr int kResThreadsT = 512;  // output rows per block of threads, at most
constexpr int kMaxTileT = 256;     // slots per residual tile, at most
constexpr int kResSmemT = 160 * 1024;  // shared memory for the ring, at most
constexpr int kIdsT = 4;  // slot ids a thread holds for the next tile's gather

struct ResidualTArgs {
  const uint16_t* mask;  // [s16, lanes]
  int s16, ob, lanes;
  const void* x;  // [rows, Dx]
  int rows, Dx;
  const int* src;        // [T·S]
  const int* block_ptr;  // [n_blocks + 1]
  int splits;            // blocks of threads per output block
  const float* addend;   // [D, num_rows] or null
  int D, num_rows;
  float* out;  // [D, num_rows]
};

// Slot id ``id`` as a row of x: an id outside [0, rows) sets ``bad`` and
// reads row 0.
__device__ __forceinline__ int x_row_t(int id, int rows, bool& bad) {
  const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(rows);
  bad |= !ok;
  return ok ? id : 0;
}

// The slot ids of tile t that this thread's first kIdsT·blockDim row
// pieces read (the rest, if a tile has more pieces, are read as they are
// issued).
__device__ __forceinline__ void load_ids_t(const ResidualTArgs& a, int t,
                                           int per_row, int (&id)[kIdsT]) {
  const int S = a.s16 * 16;
  const int n = S * per_row;
  const int* src = a.src + static_cast<size_t>(t) * S;
#pragma unroll
  for (int u = 0; u < kIdsT; ++u) {
    const int q = threadIdx.x + u * blockDim.x;
    id[u] = q < n ? __ldg(src + q / per_row) : 0;
  }
}

// Issue the copies of tile t into a stage: its S slot rows (DT features
// from f0, as ``per_row`` 16-byte pieces, gathered by the ids in ``id``
// and, past them, by ids read here; an id outside x sets ``bad``) and the
// S16 word rows of the block's ``nl`` live lanes from lane o0.  The ids are
// checked where the copies use them, not as they load, so the check waits
// for no load.
template <typename T, int DT>
__device__ __forceinline__ void stage_tile_t(const ResidualTArgs& a, int t,
                                             int f0, int o0, int nl,
                                             int per_row,
                                             const int (&id)[kIdsT],
                                             bool& bad, T* rows,
                                             uint16_t* words) {
  constexpr int E = 16 / sizeof(T);  // elements per piece
  const T* x = static_cast<const T*>(a.x) + f0;
  const int S = a.s16 * 16;
  const int n = S * per_row;
  const int* src = a.src + static_cast<size_t>(t) * S;
#pragma unroll
  for (int u = 0; u < kIdsT; ++u) {
    const int q = threadIdx.x + u * blockDim.x;
    if (q < n) {
      const int s = q / per_row, j = q - s * per_row;
      cp_async16(rows + s * DT + j * E,
                 x + static_cast<size_t>(x_row_t(id[u], a.rows, bad)) * a.Dx +
                     j * E);
    }
  }
  for (int q = threadIdx.x + kIdsT * blockDim.x; q < n; q += blockDim.x) {
    const int s = q / per_row, j = q - s * per_row;
    cp_async16(rows + s * DT + j * E,
               x + static_cast<size_t>(x_row_t(__ldg(src + s), a.rows, bad)) *
                       a.Dx +
                   j * E);
  }
  const int per_word = nl / 8;  // 16-byte pieces of a word row
  const uint16_t* m =
      a.mask + static_cast<size_t>(t) * a.ob + o0;
  for (int q = threadIdx.x; q < a.s16 * per_word; q += blockDim.x) {
    const int w = q / per_word, p = q - w * per_word;
    cp_async16(words + w * blockDim.x + 8 * p,
               m + static_cast<size_t>(w) * a.lanes + 8 * p);
  }
}

// acc[0:DT] += row[0:DT] for a staged row (bf16 widened exactly).
template <int DT>
__device__ __forceinline__ void add_staged(const float* row, float* acc) {
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
template <int DT>
__device__ __forceinline__ void add_staged(const uint16_t* row, float* acc) {
  const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < DT / 8; ++i) {
    const uint4 q = v[i];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[8 * i + 2 * k] += __uint_as_float(w[k] << 16);
      acc[8 * i + 2 * k + 1] += __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
}

template <typename T, int DT>
__host__ __device__ __forceinline__ int stage_bytes_t(int s16, int threads) {
  return (s16 * 16 * DT * static_cast<int>(sizeof(T)) + s16 * threads * 2 +
          15) / 16 * 16;
}

template <typename T, int DT, int NS>
__global__ void __launch_bounds__(kResThreadsT)
    residual_t_kernel(ResidualTArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = stage_bytes_t<T, DT>(a.s16, blockDim.x);
  const int S = a.s16 * 16;
  const int blk = blockIdx.x / a.splits;
  const int o0 = (blockIdx.x % a.splits) * blockDim.x;
  const int nl = min(static_cast<int>(blockDim.x), a.ob - o0);  // live lanes
  const int o = o0 + threadIdx.x;  // the thread's row of the block
  const int f0 = blockIdx.y * DT;
  // pieces of a staged row (the last feature tile may be narrower)
  const int per_row = min(DT, a.Dx - f0) / (16 / static_cast<int>(sizeof(T)));

  auto rows_of = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * sb);
  };
  auto words_of = [&](int slot) {
    return reinterpret_cast<uint16_t*>(smem + slot * sb + S * DT * sizeof(T));
  };

  const int t0 = a.block_ptr[blk];
  const int nt = a.block_ptr[blk + 1] - t0;
  int id[kIdsT];
  bool bad = false;  // a slot id outside x was met
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nt) {
      load_ids_t(a, t0 + i, per_row, id);
      stage_tile_t<T, DT>(a, t0 + i, f0, o0, nl, per_row, id, bad,
                          rows_of(i), words_of(i));
    }
    cp_async_commit();
  }
  // the ids of the next tile to issue load while a tile's adds run
  if (NS - 1 < nt) load_ids_t(a, t0 + NS - 1, per_row, id);

  float acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int ahead = i + NS - 1;
    if (ahead < nt)
      stage_tile_t<T, DT>(a, t0 + ahead, f0, o0, nl, per_row, id, bad,
                          rows_of(ahead % NS), words_of(ahead % NS));
    cp_async_commit();
    if (ahead + 1 < nt) load_ids_t(a, t0 + ahead + 1, per_row, id);
    cp_async_wait<NS - 1>();  // this thread's copies of tile i landed
    __syncthreads();          // and everyone's
    if (threadIdx.x < nl) {
      const T* rows = rows_of(i % NS);
      const uint16_t* words = words_of(i % NS) + threadIdx.x;
      for (int w = 0; w < a.s16; ++w) {
        uint32_t m = words[w * blockDim.x];
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          add_staged<DT>(rows + (b * a.s16 + w) * DT, acc);
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  if (__syncthreads_or(bad)) {  // a slot id outside x: nothing is written
    assert(false && "residual slot id outside the rows of x");
    return;
  }
  if (threadIdx.x >= nl) return;
  const size_t col = static_cast<size_t>(blk) * a.ob + o;
  // every addend load is issued before the first store (out may alias it
  // as far as the compiler knows, so it would not move a load past one)
  if (a.addend) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
      if (f0 + j < a.D)
        acc[j] = a.addend[static_cast<size_t>(f0 + j) * a.num_rows + col] +
                 acc[j];
  }
#pragma unroll
  for (int j = 0; j < DT; ++j)
    if (f0 + j < a.D)
      a.out[static_cast<size_t>(f0 + j) * a.num_rows + col] = acc[j];
}

template <typename T, int DT>
int launch_t(const ResidualTArgs& a, dim3 grid, int threads,
             cudaStream_t st) {
  const int sb = stage_bytes_t<T, DT>(a.s16, threads);
  const bool three = 3 * sb <= kResSmemT;
  const int smem = (three ? 3 : 2) * sb;
  auto kernel = three ? residual_t_kernel<T, DT, 3> : residual_t_kernel<T, DT, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The feature tile ``dt`` (8, 16, 24 or 32) as a template argument.
template <typename T>
int launch_typed_t(const ResidualTArgs& a, int dt, dim3 grid, int threads,
                   cudaStream_t st) {
  switch (dt) {
    case 8: return launch_t<T, 8>(a, grid, threads, st);
    case 16: return launch_t<T, 16>(a, grid, threads, st);
    case 24: return launch_t<T, 24>(a, grid, threads, st);
    case 32: return launch_t<T, 32>(a, grid, threads, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gnna

// mask_s [s16, num_tiles·ob] uint16, x [rows, Dx] (Dx·size a multiple of
// 16 bytes, Dx >= D), src [num_tiles·s16·16] int32 ids of rows of x,
// addend [D, num_rows] f32 or null, out [D, num_rows] f32.
extern "C" int gnna_residual_combine_t(const void* mask_s, int s16, int ob,
                                       int num_tiles, const void* x, int rows,
                                       int Dx, const void* src,
                                       const void* block_ptr, int num_rows,
                                       int D, const void* addend, int bf16,
                                       void* out, void* stream) {
  using namespace gnna;
  const int elem = bf16 ? 2 : 4;
  if (ob <= 0 || ob % 8 || num_rows % ob || num_tiles <= 0 || s16 <= 0 ||
      s16 * 16 > kMaxTileT || rows <= 0 || D <= 0 || Dx < D ||
      (Dx * elem) % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(mask_s) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // feature tiles: the whole (padded) width up to 32, else tiles of 32
  const int dp = (D + 7) / 8 * 8;
  const int dt = dp <= 32 ? dp : 32;
  const int threads = ob < kResThreadsT ? (ob + 31) / 32 * 32 : kResThreadsT;
  const int splits = (ob + threads - 1) / threads;
  const dim3 grid((num_rows / ob) * splits, (D + dt - 1) / dt);
  ResidualTArgs a{static_cast<const uint16_t*>(mask_s), s16, ob,
                  num_tiles * ob, x, rows, Dx, static_cast<const int*>(src),
                  static_cast<const int*>(block_ptr), splits,
                  static_cast<const float*>(addend), D, num_rows,
                  static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_typed_t<uint16_t>(a, dt, grid, threads, st)
              : launch_typed_t<float>(a, dt, grid, threads, st);
}
