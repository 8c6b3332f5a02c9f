// The hot tier as per-row lists, features transposed: for every row r,
// out[:, r] = addend[:, r] + Σ x[hot_src[k], :] over k in
// hot_ptr[r] .. hot_ptr[r+1], the addend's term only where one is given.
//
// Replaces no TPU kernel.  The JAX package walks the hot tier as a bit
// slab (slab_matmul_t, gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:469, hot
// wiring, csrc/slab.cu here), shaped for the TPU's matrix unit: [K/16, R]
// uint16, 512 bytes a row at K = 4096, read whole by every aggregation,
// against a table of the hot rows gathered first.  At amazon0505 the hot
// tier holds 7.6 edges a row, 0.19% of the slab's bits, so the walk moves
// about 67 bytes of mostly zero words per edge.  The list holds each
// row's hot edges as the rows of x they read (hot_ids composed in, when
// the layout's tensors are built), 4 bytes an edge and 4 a row, and this
// kernel reads x's table in place: no gather of the hot rows runs first.
//
// Layout.  x is a row-major table [rows, Dx] (the wrapper passes x_t as
// its transposed view, spmm_cuda.row_table_t); ptr [R+1] and src [nnz]
// int32, each row's entries in ascending slab column; out and addend [D,
// R] f32.  An id outside x's rows is not read (row 0 is read in its
// place) and stops the kernel, before its row is written, with a
// device-side assert, as index_select's gather does.
//
// What bounds it.  Device memory: the list and its pointers (once per
// feature tile: later tiles find them in L2), the output written once and
// the addend read once where given; 12.5 + 1.6 MB of list and 26-36 MB of
// output at amazon0505, D = 16, 22.  The rows it adds are the hot rows, at
// most 4096 of Dx values (786 KB of bf16 at D = 96): they come from L1 and
// L2, not from device memory.  At GIN's widths those cached reads reach
// 0.4-0.6 GB an aggregation and may bind first; staging a feature tile of
// the hot rows in shared memory is the lever there.
//
// Design.  Rows are the output's minor axis and their lengths are nearly
// even (mean 7.6, at most 19 at amazon0505), so one thread owns one
// output row and one feature tile (blockIdx.y: the whole padded width up
// to 32 columns, else tiles of 16, whose 4096 hot rows of 32 bytes stay
// in L1 while the SM's blocks walk them): it reads its row's ids, issues
// the 16-byte loads of U entries' table rows at once (their ids first,
// then every piece), and adds them into f32 registers in entry order.  It writes each feature once, a warp's 32
// rows one coalesced 128-byte run of out[f], adding the addend where
// given.  No atomics; the order of every sum is fixed: the entries' order,
// as the plain version adds them.

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace gnna {

constexpr int kHotThreads = 128;  // output rows per block of threads

struct HotListArgs {
  const int* ptr;  // [R + 1]
  const int* src;  // [nnz]
  const void* x;   // [rows, Dx]
  int rows, Dx;
  const float* addend;  // [D, R] or null
  int D, R;
  float* out;  // [D, R]
};

// acc[0:8·P] += the P 16-byte pieces of one table row (bf16 widened
// exactly, f32 as it is).
template <typename T, int P>
__device__ __forceinline__ void add_row(const uint4 (&v)[P], float* acc) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const uint32_t w[4] = {v[p].x, v[p].y, v[p].z, v[p].w};
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[8 * p + 2 * i] += __uint_as_float(w[i] << 16);
        acc[8 * p + 2 * i + 1] += __uint_as_float(w[i] & 0xFFFF0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * p + i] += __uint_as_float(w[i]);
    }
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(kHotThreads)
    hot_list_t_kernel(HotListArgs a) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte piece
  constexpr int P = DT / E;          // pieces per tile row
  // entries whose loads are in flight together
  constexpr int U = DT * sizeof(T) <= 32 ? 4 : 2;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const int f0 = blockIdx.y * DT;
  // pieces inside x's row (the last feature tile may be narrower)
  const int live = min(DT, a.Dx - f0) / E;
  const T* x = static_cast<const T*>(a.x) + f0;
  const int beg = __ldg(a.ptr + r), end = __ldg(a.ptr + r + 1);

  float acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j] = 0.f;
  bool bad = false;  // an id outside x was met

  // entry id's table row in this feature tile: ``live`` of its pieces lie
  // inside x's row, the rest read as zeros; an id outside x sets ``bad``
  // and reads row 0
  auto row_of = [&](int id) {
    const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(a.rows);
    bad |= !ok;
    return reinterpret_cast<const uint4*>(
        x + static_cast<size_t>(ok ? id : 0) * a.Dx);
  };

  int k = beg;
  for (; k + U <= end; k += U) {
    int id[U];
#pragma unroll
    for (int u = 0; u < U; ++u) id[u] = __ldg(a.src + k + u);
    uint4 v[U][P];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint4* row = row_of(id[u]);
#pragma unroll
      for (int p = 0; p < P; ++p)
        v[u][p] = p < live ? __ldg(row + p) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) add_row<T, P>(v[u], acc);
  }
  for (; k < end; ++k) {
    const uint4* row = row_of(__ldg(a.src + k));
    uint4 v[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      v[p] = p < live ? __ldg(row + p) : make_uint4(0, 0, 0, 0);
    add_row<T, P>(v, acc);
  }

  if (bad) {  // an id outside x: this row is not written
    assert(false && "hot list id outside the rows of x");
    return;
  }
  // every addend load is issued before the first store (out may alias it
  // as far as the compiler knows, so it would not move a load past one)
  if (a.addend) {
#pragma unroll
    for (int j = 0; j < DT; ++j)
      if (f0 + j < a.D)
        acc[j] = a.addend[static_cast<size_t>(f0 + j) * a.R + r] + acc[j];
  }
#pragma unroll
  for (int j = 0; j < DT; ++j)
    if (f0 + j < a.D) a.out[static_cast<size_t>(f0 + j) * a.R + r] = acc[j];
}

template <typename T, int DT>
int launch_hot(const HotListArgs& a, cudaStream_t st) {
  const dim3 grid((a.R + kHotThreads - 1) / kHotThreads,
                  (a.D + DT - 1) / DT);
  hot_list_t_kernel<T, DT><<<grid, kHotThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The feature tile ``dt`` (8, 16, 24 or 32) as a template argument.
template <typename T>
int launch_hot_typed(const HotListArgs& a, int dt, cudaStream_t st) {
  switch (dt) {
    case 8: return launch_hot<T, 8>(a, st);
    case 16: return launch_hot<T, 16>(a, st);
    case 24: return launch_hot<T, 24>(a, st);
    case 32: return launch_hot<T, 32>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gnna

// ptr [R+1] and src [nnz] int32, x [rows, Dx] (Dx·size a multiple of 16
// bytes, Dx >= D), addend [D, R] f32 or null, out [D, R] f32.
extern "C" int gnna_hot_list_t(const void* ptr, const void* src,
                               const void* x, int rows, int Dx, int R, int D,
                               const void* addend, int bf16, void* out,
                               void* stream) {
  using namespace gnna;
  const int elem = bf16 ? 2 : 4;
  if (R <= 0 || rows <= 0 || D <= 0 || Dx < D || (Dx * elem) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // feature tiles: the whole (padded) width up to 32, else tiles of 16
  // (at D = 64 and 96 on the H100, 8% and 6% faster than tiles of 32)
  const int dp = (D + 7) / 8 * 8;
  const int dt = dp <= 32 ? dp : 16;
  HotListArgs a{static_cast<const int*>(ptr), static_cast<const int*>(src),
                x, rows, Dx, static_cast<const float*>(addend), D, R,
                static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hot_typed<uint16_t>(a, dt, st)
              : launch_hot_typed<float>(a, dt, st);
}
