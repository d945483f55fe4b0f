// Dense window histogram: pre-projected (row, col) points -> an (H, W)
// raster of counts or float weights. The "pallas" binning backend of
// heatmap_tpu_torch.ops.pallas_kernels.
//
// Replaces heatmap_tpu/ops/pallas_kernels.py::_histogram_kernel (with its
// host bin_rowcol_window_pallas). The TPU kernel zeroes one f32 copy of
// the whole window in VMEM at its first grid step, turns each chunk of
// points into an MXU matmul R @ (w * C) added into it, and writes it out
// once at the last step. On Hopper a histogram is an atomic add per
// point, and the same shape carries over: each private copy of the window
// is zeroed once and flushed once per kernel, by a grid sized to the
// card, not to the points.
//
//   * Bands. A window of up to 256x256 int32 or float32 cells (256 KiB)
//     does not fit one block's shared memory, so its cells are cut into
//     `bands` slices of 2^slice_shift cells (128 KiB: two at a 256x256
//     window), meeting at cell boundaries, not row boundaries (a 255x257
//     window needs no more than a 256x256 one). The grid is `walkers`
//     groups of `bands` neighbouring blocks, one block an SM (the plan in
//     ops/pallas_kernels.py); the blocks of a group walk the same points
//     with a grid stride, 4 points a thread per step in 16-, 16- and
//     4-byte loads of rows, columns and valid bytes, so each thread keeps
//     several loads in flight. Each block localises each point (row -
//     row0, col - col0; dropped unless in the window and its valid byte is
//     set) to a flat cell and adds the points of its own slice with a
//     shared-memory atomic. A point comes from HBM once and from L2 for
//     the group's other blocks.
//   * Each block zeroes its slice once, and at the end adds the slice's
//     non-zero cells to the zeroed raster with one global atomic each.
//   * The alternative measured against it, the same slices in a thread
//     block cluster (each point loaded by one block and added into its
//     owner's slice through distributed shared memory), lost: on the
//     hot-spot data its remote atomics cost more than the bands' second
//     read of each point from L2 (PERF.md).
//   * Counts are int32: order-free and exact up to 2^31 - 1 per cell,
//     where the TPU kernel's f32 sum stops at 2^24. Merging a warp's lanes
//     that hit one cell (__match_any_sync) measured slower in shared
//     memory, so only the global-atomic build below does it.
//   * Weights: float atomics in shared and global memory. Sums of integer
//     weights are exact while every partial sum stays below 2^24;
//     fractional sums depend on the atomics' order (within f32 rounding).
//     A dropped point (or another band's) is never indexed and its weight
//     never read, so a NaN weight outside the window cannot reach the
//     raster.
//   * A window of more than kMaxBands slices, which only an explicit
//     backend="pallas" sends, skips the privatisation and adds straight
//     into the global raster (bands = 0).
//
// Bound: HBM bandwidth. Each point is read once (row and col 4 B each,
// valid 1 B, weight 4 B) and the raster written once; the atomics are
// the work, and the privatisation keeps them on chip.
//
// The entry points zero the raster (cudaMemsetAsync) before the launch;
// the kernels allocate nothing and launch on the caller's stream, and the
// shared-memory limit is set once per process and device. Each entry
// point returns the cudaError_t of its launch, and refuses a plan that
// the kernel was not built for.

#include <cuda_runtime.h>

#include <type_traits>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kQuad = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBands = 8;
constexpr int kSliceBytes = 128 * 1024;
// Blocks of the global-atomic build behind
// hm_window_histogram_counts_global (eight per SM of an H100).
constexpr long long kGlobalBlocks = 1056;

enum Build { kGlobal, kBanded };

struct Points {
  const int* row;
  const int* col;
  const unsigned char* valid;
  const float* weights;
  long long n;
  bool vec;  // row, col 16-byte and valid 4-byte aligned
  int row0, col0, height, width;
};

Points make_points(const void* row, const void* col, const void* valid,
                   const void* weights, long long n, int row0, int col0,
                   int height, int width) {
  Points p;
  p.row = (const int*)row;
  p.col = (const int*)col;
  p.valid = (const unsigned char*)valid;
  p.weights = (const float*)weights;
  p.n = n;
  p.vec = (((unsigned long long)row | (unsigned long long)col) & 15ull) == 0 &&
          ((unsigned long long)valid & 3ull) == 0;
  p.row0 = row0;
  p.col0 = col0;
  p.height = height;
  p.width = width;
  return p;
}

// Flat window cells (-1: dropped) of the kQuad points from i.
__device__ __forceinline__ void load_cells(const Points& p, long long i,
                                           int (&cell)[kQuad]) {
  int r[kQuad], c[kQuad];
  bool ok[kQuad];
  if (p.vec && i + kQuad <= p.n) {
    const int4 rv = __ldg(reinterpret_cast<const int4*>(p.row + i));
    const int4 cv = __ldg(reinterpret_cast<const int4*>(p.col + i));
    r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
    c[0] = cv.x; c[1] = cv.y; c[2] = cv.z; c[3] = cv.w;
    uchar4 vv = make_uchar4(1, 1, 1, 1);
    if (p.valid != nullptr) {
      vv = __ldg(reinterpret_cast<const uchar4*>(p.valid + i));
    }
    ok[0] = vv.x; ok[1] = vv.y; ok[2] = vv.z; ok[3] = vv.w;
  } else {
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      ok[j] = i + j < p.n;
      r[j] = ok[j] ? __ldg(p.row + i + j) : 0;
      c[j] = ok[j] ? __ldg(p.col + i + j) : 0;
      if (ok[j] && p.valid != nullptr) ok[j] = p.valid[i + j] != 0;
    }
  }
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    const long long rr = (long long)r[j] - p.row0;
    const long long cc = (long long)c[j] - p.col0;
    cell[j] = ok[j] && rr >= 0 && rr < p.height && cc >= 0 && cc < p.width
                  ? (int)(rr * p.width + cc)  // < 2^31: the wrapper checks
                  : -1;
  }
}

// kBuild as in Build; kBanded: `bands` slices of 2^slice_shift cells, one
// in each of `bands` neighbouring blocks.
template <typename Acc, Build kBuild>
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(Points p, int bands, int slice_shift,
                     Acc* __restrict__ out) {
  constexpr bool kWeighted = std::is_same_v<Acc, float>;
  // Warp aggregation pays only against global atomics on hot cells.
  constexpr bool kAggregate = kBuild == kGlobal && !kWeighted;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* slice = reinterpret_cast<Acc*>(smem_raw);
  const int cells = p.height * p.width;
  int rank = 0, walker = blockIdx.x, walkers = gridDim.x;
  if constexpr (kBuild == kBanded) {
    rank = blockIdx.x % bands;
    walker = blockIdx.x / bands;
    walkers = gridDim.x / bands;
  }
  const int lo = rank << slice_shift;
  const int mine =
      kBuild == kBanded ? max(0, min(1 << slice_shift, cells - lo)) : 0;
  for (int i = threadIdx.x; i < mine; i += kThreads) slice[i] = 0;
  if constexpr (kBuild == kBanded) __syncthreads();
  const int slice_mask = (1 << slice_shift) - 1;
  const int lane = threadIdx.x & 31;
  const long long step = (long long)walkers * kThreads * kQuad;
  for (long long base = (long long)walker * kThreads * kQuad; base < p.n;
       base += step) {
    const long long i = base + threadIdx.x * kQuad;
    int cell[kQuad];
    load_cells(p, i, cell);
    Acc v[kQuad];
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      if (kBuild == kBanded && cell[j] >= 0 &&
          (cell[j] >> slice_shift) != rank) {
        cell[j] = -1;  // another band's point
      }
      v[j] = 1;
      if constexpr (kWeighted) {
        if (cell[j] >= 0) v[j] = __ldg(p.weights + i + j);
      }
    }
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      if constexpr (kAggregate) {
        const unsigned peers = __match_any_sync(kFull, cell[j]);
        if (cell[j] >= 0 && lane == __ffs(peers) - 1) {
          atomicAdd(out + cell[j], (Acc)__popc(peers));
        }
      } else if (cell[j] >= 0) {
        if constexpr (kBuild == kBanded) {
          atomicAdd(slice + (cell[j] & slice_mask), v[j]);
        } else {
          atomicAdd(out + cell[j], v[j]);
        }
      }
    }
  }
  if constexpr (kBuild == kBanded) {
    __syncthreads();
    for (int i = threadIdx.x; i < mine; i += kThreads) {
      const Acc x = slice[i];
      if (x != 0) atomicAdd(out + lo + i, x);
    }
  }
}

// Zero the raster and launch one build (the banded build's shared-memory
// limit raised to kSliceBytes once per process and device).
template <typename Acc, Build kBuild>
int launch_build(const Points& p, int bands, int slice_shift, long long blocks,
                 void* out, void* stream) {
  const int cells = p.height * p.width;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)cells * sizeof(Acc), s);
  if (e != cudaSuccess || p.n <= 0) return (int)e;
  size_t smem = 0;
  if constexpr (kBuild == kBanded) {
    e = hm::allow_dynamic_smem<histogram_kernel<Acc, kBanded>, kSliceBytes>();
    if (e != cudaSuccess) return (int)e;
    smem = (size_t)((1 << slice_shift) < cells ? (1 << slice_shift) : cells) *
           sizeof(Acc);
  }
  histogram_kernel<Acc, kBuild><<<(unsigned)blocks, kThreads, smem, s>>>(
      p, bands, slice_shift, (Acc*)out);
  return (int)cudaGetLastError();
}

// A plan of `bands` slices of 2^slice_shift cells (bands 0: the global
// build) on `blocks` blocks, checked, then launched.
template <typename Acc>
int launch(const Points& p, int bands, int slice_shift, long long blocks,
           void* out, void* stream) {
  const long long cells = (long long)p.height * p.width;
  if (p.height < 1 || p.width < 1 || cells > 0x7fffffffLL || blocks < 1 ||
      blocks > 0x7fffffffLL || bands < 0 || bands > kMaxBands) {
    return (int)cudaErrorInvalidValue;
  }
  if (bands == 0) {
    return launch_build<Acc, kGlobal>(p, 1, 0, blocks, out, stream);
  }
  if (blocks % bands != 0 || slice_shift < 0 || slice_shift > 30) {
    return (int)cudaErrorInvalidValue;
  }
  const long long slice = 1LL << slice_shift;
  if (bands * slice < cells ||
      (slice < cells ? slice : cells) * (long long)sizeof(Acc) >
          kSliceBytes) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_build<Acc, kBanded>(p, bands, slice_shift, blocks, out,
                                    stream);
}

}  // namespace

// Counts into the int32 raster out (zeroed here); valid may be null
// (every point valid). The plan (ops/pallas_kernels.py): `bands` slices of
// 2^slice_shift cells that together cover the window (0: the
// global-atomic build), on `blocks` blocks in all (a multiple of bands).
extern "C" int hm_window_histogram_counts(const void* row, const void* col,
                                          const void* valid, long long n,
                                          int row0, int col0, int height,
                                          int width, int bands,
                                          int slice_shift, long long blocks,
                                          void* out, void* stream) {
  return launch<int>(
      make_points(row, col, valid, nullptr, n, row0, col0, height, width),
      bands, slice_shift, blocks, out, stream);
}

// Float32 weights into the float32 raster out, on the same plan.
extern "C" int hm_window_histogram_weighted(
    const void* row, const void* col, const void* valid, const void* weights,
    long long n, int row0, int col0, int height, int width, int bands,
    int slice_shift, long long blocks, void* out, void* stream) {
  if (weights == nullptr) return (int)cudaErrorInvalidValue;
  return launch<float>(
      make_points(row, col, valid, weights, n, row0, col0, height, width),
      bands, slice_shift, blocks, out, stream);
}

// Counts through the global-atomic build (warp-aggregated) at any window
// width, never the slices. Nothing in the package calls it: chip_smoke.py
// times it against the partitioned counts kernel at that backend's
// windows (PERF.md).
extern "C" int hm_window_histogram_counts_global(
    const void* row, const void* col, const void* valid, long long n,
    int row0, int col0, int height, int width, void* out, void* stream) {
  long long blocks = (n + kThreads * kQuad - 1) / (kThreads * kQuad);
  if (blocks > kGlobalBlocks) blocks = kGlobalBlocks;
  return launch<int>(
      make_points(row, col, valid, nullptr, n, row0, col0, height, width), 0,
      0, blocks, out, stream);
}
