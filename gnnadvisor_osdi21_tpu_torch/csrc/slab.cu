// Bit-slab SpMM for the diagonal and hot tiers of the hybrid layout, in
// both feature orientations: out[R, D] = unpack(bits)^T @ x (row-major)
// and out[D, R] = x_t @ unpack(bits) (transposed).
//
// Replaces the TPU kernels slab_matmul / _slab_kernel
// (gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:143, pallas_call at :186),
// with its hot_slab_matmul (:212) and diag_slab_matmul (:226) wirings,
// fused_slab_matmul / _fused_kernel (:259, pallas_call at :294), and their
// transposed twins slab_matmul_t / _slab_kernel_t (:469, pallas_call at
// :510) and fused_slab_matmul_t / _fused_kernel_t (:556, pallas_call at
// :588).
//
// Layout.  A slab is uint16 [W16, R] with graph rows on the minor axis;
// slab column j sits in word j % W16 at bit j // W16.  Both orientations
// read the features from a row-major table [rows, ld] (the transposed
// wrappers pass x_t as the transposed view of one, or copy it into one):
// the hot wiring reads a global table x_hot [K, ld], the diagonal wiring
// output row r's own block of x [R, ld].  Only the output differs: [R, D]
// or [D, R], f32.
//
// What bounds it.  Bytes: the slab (W16 words per row, 512 B for K =
// 4096) and the output (D f32 per row) each cross device memory once.  A
// row has a few set bits (5.6 of 4096 on the amazon0505-scale hot tier),
// and each costs one table row read, which the L2 cache serves (the hot
// table is at most a few hundred KB).
//
// Design.  Tiles of 128 consecutive rows and up to 256 features; a block of
// threads (one producer warp, eight consumer warps of 16 rows each) stays
// resident and walks tiles blockIdx.x, + gridDim.x, ... (as many blocks
// as the SMs hold at once).
// - The producer streams the tiles' slab words through a ring of three
//   shared-memory stages of 32 words with bulk copies (one per word: 256
//   contiguous bytes), each stage guarded by a full and an empty mbarrier,
//   running on into the next tile while the consumers finish this one.
//   The slab crosses device memory once, on the copy engine, and no
//   thread spends registers or instructions on it.  A stage's word rows
//   are 272 bytes apart, so a warp's 16-byte reads of 16 words spread
//   over all 32 banks.
// - A consumer decodes its 16 rows' words of a stage into a list of (row,
//   table row) pairs in shared memory: each lane reads 8 rows of one word
//   (16 bytes), a warp scan of the lanes' bit counts places the pairs, in
//   a fixed order.  The stage is released as soon as it is decoded.
// - After a stage that leaves 64 or more pairs listed (while the ring
//   refills), when the list fills, and at the end of a tile, the warp
//   adds the listed table rows with its lanes over the features (2 per
//   lane: one coalesced 4- or 8-byte load per lane and pair), eight
//   pairs' loads in flight before any is used, into f32 accumulators in
//   shared memory.  Narrow tables split the warp into groups of 4, 8 or
//   16 lanes that take every second, fourth or eighth pair, each into its
//   own accumulators.  (Sixteen or 32 loads in flight were no faster on
//   the H100.)
// - The whole feature width is one walk up to 256 columns (D = 96
//   included); the warp then writes its 16 output rows, summing the
//   groups' accumulators in group order, and zeroes them for the next
//   tile.  Row-major, each row is one contiguous run of the output.
//   Transposed, the warp writes D runs of its 16 rows (64 contiguous
//   bytes, two whole 32-byte sectors, half a warp per run); the
//   accumulator columns are then swizzled per row (col_swizzle), so the
//   half warp's 16 rows of one column fall in 16 different banks.  (Rows
//   padded by two floats instead cost the D = 16 walk its third resident
//   block of threads, and it ran 40% slower than the row-major one on
//   the H100.)  Wider tables (GIN's
//   first layer aggregates at the input width: 500 to 3703 on the repo's
//   datasets) are split into chunks of 256 columns, one per blockIdx.y,
//   each walking the slab on its own; the chunks' blocks walk the same
//   tiles in the same order, so the slab words of a tile are mostly read
//   from L2 after the first.
// No atomics; every sum has a fixed order.  R must be a multiple of 8
// (bulk copies move multiples of 16 bytes).

#include "async.cuh"

namespace gnna {

template <typename T>
struct Slab {
  const uint16_t* bits;  // [w16, R]; w16 == 0: slab absent
  int w16;
  const T* table;  // row-major [rows, ld]
  int block;       // 0: global table (hot); B: block-local table (diagonal)
};

// The element type is a launch-time flag: the C entry points carry table
// pointers as Slab<float> and reinterpret them for the bf16 instantiation.
template <typename T>
inline Slab<T> as_type(const Slab<float>& s) {
  return Slab<T>{s.bits, s.w16, reinterpret_cast<const T*>(s.table), s.block};
}

constexpr int kTileRows = 128;  // graph rows per block of threads
constexpr int kWarpRows = 16;   // rows per consumer warp
constexpr int kConsumers = kTileRows / kWarpRows;
constexpr int kStreamThreads = 32 * (kConsumers + 1);  // + the producer
constexpr int kStageWords = 32;  // slab words per stage
constexpr int kStages = 3;
constexpr int kWordStride = 2 * kTileRows + 16;  // bytes per staged word
constexpr int kStageBytes = kStageWords * kWordStride;
constexpr int kListCap = 512;  // pending pairs per consumer warp
constexpr int kAddAt = 64;     // pending pairs that are added after a stage
constexpr int kBarrierBytes = 128;
constexpr int kChunk = 256;  // table columns one walk holds
// list entry: bit 31 the slab (0 first, 1 second), bits 27-30 the row in
// the warp, bits 0-26 the table row
constexpr uint32_t kRowMask = (1u << 27) - 1;
// A transposed walk keeps column j of a warp's accumulator row i at
// column j ^ col_swizzle(i, Dc): an even offset inside aligned groups of
// w = min(Dc & -Dc, 32) columns (so pairs of columns stay adjacent and
// every column stays inside the row), chosen so that the 16 rows of one
// column, which half a warp reads in the epilogue, fall in 16 banks.
__device__ __forceinline__ int col_swizzle(int i, int Dc) {
  const int w = min(Dc & -Dc, 32);
  return 2 * (((i * w) >> 5) & ((w >> 1) - 1));
}

// Two features of a table row, as loaded (one 4-byte bf16 pair or one
// 8-byte f32 pair), and widened to f32.
template <typename T>
struct Pair;
template <>
struct Pair<uint16_t> {
  using Raw = uint32_t;
  __device__ __forceinline__ static Raw load(const uint16_t* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ static float2 widen(Raw v) {
    return make_float2(__uint_as_float(v << 16),
                       __uint_as_float(v & 0xFFFF0000u));
  }
};
template <>
struct Pair<float> {
  using Raw = float2;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ static float2 widen(Raw v) { return v; }
};

// Table-row registers a lane fills before it adds any (eight bf16 pairs a
// warp at D <= 64).
constexpr int kLoadRegs = 8;

// Add the listed pairs' table rows (``wc`` columns from column c0 of rows
// ``ld`` apart) into the warp's accumulators acc[group][16][Dc] (columns
// swizzled when kT): group g of 32/G lanes takes pairs g, g + 32/G, ...
template <typename T, int G, int NP, bool kT>
__device__ __forceinline__ void add_pairs(const uint32_t* list, int count,
                                          const T* __restrict__ t0,
                                          const T* __restrict__ t1, int ld,
                                          int c0, int wc, int Dc, float* acc,
                                          int lane) {
  using Raw = typename Pair<T>::Raw;
  constexpr int NG = 32 / G;
  constexpr int U = kLoadRegs / (NP * static_cast<int>(sizeof(Raw) / 4));
  __syncwarp();
  const int g = lane / G, lig = lane % G;
  const int pieces = wc / 2;
  float* ag = acc + g * kWarpRows * Dc;
  for (int i0 = g; i0 < count; i0 += NG * U) {
    Raw v[U][NP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NG;
      if (i < count) {
        const uint32_t e = list[i];
        const T* row =
            ((e >> 31) ? t1 : t0) + static_cast<size_t>(e & kRowMask) * ld +
            c0;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          const int p = lig + G * k;
          if (p < pieces) v[u][k] = Pair<T>::load(row + 2 * p);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NG;
      if (i < count) {
        const int rl = (list[i] >> 27) & 15;
        float* a = ag + rl * Dc;
        const int sw = kT ? col_swizzle(rl, Dc) : 0;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          const int p = lig + G * k;
          if (p < pieces) {
            float2* q = reinterpret_cast<float2*>(a + ((2 * p) ^ sw));
            const float2 w = Pair<T>::widen(v[u][k]);
            float2 s = *q;
            s.x += w.x;
            s.y += w.y;
            *q = s;
          }
        }
      }
    }
  }
  __syncwarp();
}

// kT: out is [D, R] (transposed), else [R, D].
template <typename T, int G, int NP, bool kT>
__global__ void __launch_bounds__(kStreamThreads)
    slab_stream_kernel(Slab<T> first, Slab<T> second, int R, int D, int ld,
                       int Dc, float* __restrict__ out) {
  constexpr int NG = 32 / G;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarrierBytes;
  uint32_t* lists = reinterpret_cast<uint32_t*>(ring + kStages * kStageBytes);
  float* accs = reinterpret_cast<float*>(lists + kConsumers * kListCap);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stages_a = (first.w16 + kStageWords - 1) / kStageWords;
  const int stages = stages_a + (second.w16 + kStageWords - 1) / kStageWords;
  const int tiles = (R + kTileRows - 1) / kTileRows;
  // the block's chunk of columns: table columns [c0, c0 + wc), output
  // columns [c0, c0 + dw)
  const int c0 = blockIdx.y * Dc;
  const int wc = min(Dc, ld - c0), dw = min(Dc, D - c0);

  const int acc_floats = kConsumers * NG * kWarpRows * Dc;
  for (int i = threadIdx.x; i < acc_floats; i += blockDim.x) accs[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Persistent: the block walks tiles blockIdx.x, + gridDim.x, ...; the
  // ring's stage count ``seq`` runs on across tiles, so the producer
  // streams the next tile while the consumers finish this one.
  if (warp == kConsumers) {  // producer
    int seq = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int r0 = tile * kTileRows;
      const int nrows = min(kTileRows, R - r0);
      for (int st = 0; st < stages; ++st, ++seq) {
        const int slot = seq % kStages;
        if (seq >= kStages) mbar_wait(&empty[slot], (seq / kStages - 1) & 1);
        const bool b = st >= stages_a;
        const uint16_t* bits = b ? second.bits : first.bits;
        const int w16 = b ? second.w16 : first.w16;
        const int w0 = (b ? st - stages_a : st) * kStageWords;
        const int nw = min(kStageWords, w16 - w0);
        if (lane == 0) mbar_expect_tx(&full[slot], nw * nrows * 2);
        __syncwarp();
        for (int i = lane; i < nw; i += 32)
          bulk_load(ring + slot * kStageBytes + i * kWordStride,
                    bits + static_cast<size_t>(w0 + i) * R + r0, nrows * 2,
                    &full[slot]);
      }
    }
    return;
  }

  // consumer: rows r0 + warp·16 + [0, 16); lane reads 8 of them of one word
  uint32_t* list = lists + warp * kListCap;
  float* acc = accs + warp * NG * kWarpRows * Dc;
  const int half = lane & 1;
  const int row0 = warp * kWarpRows + half * 8;  // first of the lane's rows
  int seq = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * kTileRows;
    const bool rows_ok = r0 + row0 < R;
    int count = 0;  // pending pairs (the same in every lane)
    for (int st = 0; st < stages; ++st, ++seq) {
      const int slot = seq % kStages;
      mbar_wait(&full[slot], (seq / kStages) & 1);
      const bool b = st >= stages_a;
      const int w16 = b ? second.w16 : first.w16;
      const int block = b ? second.block : first.block;
      const int w0 = (b ? st - stages_a : st) * kStageWords;
      const int nw = min(kStageWords, w16 - w0);
      const unsigned char* stage = ring + slot * kStageBytes;
      for (int wr = 0; wr < nw; wr += 16) {
        const int wl = wr + (lane >> 1);  // the lane's word in the stage
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (rows_ok && wl < nw)
          q = *reinterpret_cast<const uint4*>(stage + wl * kWordStride +
                                              row0 * 2);
        const uint32_t v[4] = {q.x, q.y, q.z, q.w};  // rows 2i, 2i + 1
        const int c =
            __popc(v[0]) + __popc(v[1]) + __popc(v[2]) + __popc(v[3]);
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int n = __shfl_up_sync(0xFFFFFFFFu, incl, o);
          if (lane >= o) incl += n;
        }
        const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
        if (total == 0) continue;
        if (count + total > kListCap) {
          add_pairs<T, G, NP, kT>(list, count, first.table, second.table, ld, c0,
                              wc, Dc, acc, lane);
          count = 0;
        }
        // place the lane's pairs at [incl - c, incl) of the round, in
        // chunks of the list's capacity (one chunk unless the round is
        // dense)
        const uint32_t tag = (b ? 1u << 31 : 0u);
        for (int base = 0; base < total; base += kListCap) {
          if (base) {
            add_pairs<T, G, NP, kT>(list, count, first.table, second.table, ld, c0,
                                wc, Dc, acc, lane);
            count = 0;
          }
          int idx = incl - c;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t m = v[i];
            while (m) {
              const int bit = __ffs(m) - 1;
              m &= m - 1;
              if (idx >= base && idx < base + kListCap) {
                const int rl = half * 8 + 2 * i + (bit >> 4);
                const int col = (bit & 15) * w16 + w0 + wl;
                const int r = r0 + warp * kWarpRows + rl;
                const int trow = block ? (r / block) * block + col : col;
                list[count + idx - base] =
                    tag | (static_cast<uint32_t>(rl) << 27) |
                    static_cast<uint32_t>(trow);
              }
              ++idx;
            }
          }
          count += min(kListCap, total - base);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      // add while the ring refills, rather than all at the end
      if (count >= kAddAt) {
        add_pairs<T, G, NP, kT>(list, count, first.table, second.table, ld, c0, wc,
                            Dc, acc, lane);
        count = 0;
      }
    }
    add_pairs<T, G, NP, kT>(list, count, first.table, second.table, ld, c0, wc, Dc,
                        acc, lane);

    // the warp's rows of the chunk; the accumulators are zeroed for the
    // next tile as they are read
    const int first_row = r0 + warp * kWarpRows;
    if (kT) {
      // column j of the warp's 16 rows is one run of out[j]: half a warp
      // per run, two runs per store
      const int i = lane & 15;
      const bool row_ok = first_row + i < R;
      const int sw = col_swizzle(i, Dc);
      float* dst = out + static_cast<size_t>(c0) * R + first_row + i;
      for (int j = lane >> 4; j < wc; j += 2) {
        float* a = acc + i * Dc + (j ^ sw);
        float sum = *a;
        *a = 0.f;
#pragma unroll
        for (int g = 1; g < NG; ++g) {
          sum += a[g * kWarpRows * Dc];
          a[g * kWarpRows * Dc] = 0.f;
        }
        if (row_ok && j < dw) dst[static_cast<size_t>(j) * R] = sum;
      }
    } else {
      // one contiguous run of the output when the chunk is the whole width
      const int n = max(0, min(kWarpRows, R - first_row)) * max(0, dw);
      float* dst = out + static_cast<size_t>(first_row) * D + c0;
      if ((D & 3) == 0) {
        for (int e = 4 * lane; e < n; e += 128) {
          const int i = e / dw, j = e - i * dw;
          float4* a0 = reinterpret_cast<float4*>(acc + i * Dc + j);
          float4 sum = *a0;
          *a0 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int g = 1; g < NG; ++g) {
            float4* ag =
                reinterpret_cast<float4*>(acc + (g * kWarpRows + i) * Dc + j);
            const float4 t = *ag;
            *ag = make_float4(0.f, 0.f, 0.f, 0.f);
            sum.x += t.x;
            sum.y += t.y;
            sum.z += t.z;
            sum.w += t.w;
          }
          *reinterpret_cast<float4*>(dst + static_cast<size_t>(i) * D + j) =
              sum;
        }
      } else {
        for (int e = lane; e < n; e += 32) {
          const int i = e / dw, j = e - i * dw;
          float sum = acc[i * Dc + j];
          acc[i * Dc + j] = 0.f;
#pragma unroll
          for (int g = 1; g < NG; ++g) {
            sum += acc[(g * kWarpRows + i) * Dc + j];
            acc[(g * kWarpRows + i) * Dc + j] = 0.f;
          }
          dst[static_cast<size_t>(i) * D + j] = sum;
        }
      }
    }
    __syncwarp();
  }
}

// ``ld``: the tables' row width; ``Dc``: the columns of one chunk (the
// whole width up to kChunk).
template <typename T, int G, int NP, bool kT>
int launch_stream(const Slab<float>& a32, const Slab<float>& b32, int R, int D,
                  int ld, int Dc, float* out, cudaStream_t stream) {
  constexpr int NG = 32 / G;
  const size_t smem = kBarrierBytes + kStages * kStageBytes +
                      kConsumers * kListCap * 4 +
                      static_cast<size_t>(kConsumers) * NG * kWarpRows * Dc * 4;
  auto kernel = slab_stream_kernel<T, G, NP, kT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many blocks of threads as the SMs hold at once, shared
  // by the chunks
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kStreamThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (ld + Dc - 1) / Dc;
  const int tiles = (R + kTileRows - 1) / kTileRows;
  const dim3 grid(min(tiles, max(1, sms * per_sm / chunks)), chunks);
  kernel<<<grid, kStreamThreads, smem, stream>>>(
      as_type<T>(a32), as_type<T>(b32), R, D, ld, Dc, out);
  return static_cast<int>(cudaGetLastError());
}

// Lanes per pair (G) and pairs of features per lane (NP) for the chunk
// width: the narrowest group that holds a row, whole warps from 64 wide.
template <typename T, bool kT>
int launch_rows_typed(const Slab<float>& a, const Slab<float>& b, int R,
                      int D, int Dp, float* out, cudaStream_t stream) {
  const int Dc = min(Dp, kChunk);
  const int pieces = Dc / 2;
  if (pieces <= 4)
    return launch_stream<T, 4, 1, kT>(a, b, R, D, Dp, Dc, out, stream);
  if (pieces <= 8)
    return launch_stream<T, 8, 1, kT>(a, b, R, D, Dp, Dc, out, stream);
  if (pieces <= 16)
    return launch_stream<T, 16, 1, kT>(a, b, R, D, Dp, Dc, out, stream);
  if (pieces <= 32)
    return launch_stream<T, 32, 1, kT>(a, b, R, D, Dp, Dc, out, stream);
  if (pieces <= 64)
    return launch_stream<T, 32, 2, kT>(a, b, R, D, Dp, Dc, out, stream);
  return launch_stream<T, 32, 4, kT>(a, b, R, D, Dp, Dc, out, stream);
}

bool slab_ok(const Slab<float>& s) {
  return s.w16 == 0 ||
         (s.w16 > 0 && reinterpret_cast<uintptr_t>(s.bits) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(s.table) % 8 == 0);
}

// ``transposed``: out is [D, R], else [R, D]; the tables are [rows, Dp].
int launch_rows(const Slab<float>& a, const Slab<float>& b, int R, int D,
                int Dp, int bf16, int transposed, float* out,
                cudaStream_t stream) {
  if (R <= 0 || R % 8 || R > static_cast<int>(kRowMask) || D <= 0 ||
      D > Dp || Dp % 8 || !slab_ok(a) || !slab_ok(b))
    return static_cast<int>(cudaErrorInvalidValue);
  if (transposed)
    return bf16 ? launch_rows_typed<uint16_t, true>(a, b, R, D, Dp, out, stream)
                : launch_rows_typed<float, true>(a, b, R, D, Dp, out, stream);
  return bf16 ? launch_rows_typed<uint16_t, false>(a, b, R, D, Dp, out, stream)
              : launch_rows_typed<float, false>(a, b, R, D, Dp, out, stream);
}

}  // namespace gnna

extern "C" {

// One slab: ``block`` = 0 for the hot wiring, B for the diagonal wiring;
// ``transposed``: out [D, R] (slab_matmul_t), else [R, D] (slab_matmul).
int gnna_slab_matmul(const void* bits, int w16, int block, const void* table,
                     int R, int D, int Dp, int bf16, int transposed, void* out,
                     void* stream) {
  using gnna::Slab;
  const Slab<float> a{static_cast<const uint16_t*>(bits), w16,
                      static_cast<const float*>(table), block};
  const Slab<float> none{nullptr, 0, nullptr, 0};
  return gnna::launch_rows(a, none, R, D, Dp, bf16, transposed,
                           static_cast<float*>(out),
                           static_cast<cudaStream_t>(stream));
}

// Diagonal and hot slabs in one pass (fused_slab_matmul[_t]).
int gnna_fused_slab_matmul(const void* diag_bits, int diag_w16, int diag_b,
                           const void* diag_table, const void* hot_bits,
                           int hot_w16, const void* hot_table, int R, int D,
                           int Dp, int bf16, int transposed, void* out,
                           void* stream) {
  using gnna::Slab;
  const Slab<float> d{static_cast<const uint16_t*>(diag_bits), diag_w16,
                      static_cast<const float*>(diag_table), diag_b};
  const Slab<float> h{static_cast<const uint16_t*>(hot_bits), hot_w16,
                      static_cast<const float*>(hot_table), 0};
  return gnna::launch_rows(d, h, R, D, Dp, bf16, transposed,
                           static_cast<float*>(out),
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
