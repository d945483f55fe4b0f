// Dense window histogram: pre-projected (row, col) points -> an (H, W)
// raster of counts or float weights. The "pallas" binning backend of
// heatmap_tpu_torch.ops.pallas_kernels.
//
// Replaces heatmap_tpu/ops/pallas_kernels.py::_histogram_kernel (with its
// host bin_rowcol_window_pallas). The TPU kernel builds row and column
// one-hots in VMEM and turns each chunk of points into an MXU matmul
// R @ (w * C) accumulated in f32. On Hopper a histogram is an atomic add
// per point; what keeps it cheap is privatisation:
//
//   * The grid is (bands, point chunks). Each block owns one band of
//     band_rows window rows, privatised in shared memory (up to 96 KiB,
//     so a 256x256 int32 window takes 3 bands), and one contiguous chunk
//     of points. It zeroes its band, walks its chunk (neighbouring threads
//     on neighbouring points), localises each point (row - row0,
//     col - col0), drops it unless it lies in the window, in this band and
//     its valid byte is set, and adds it into the band with a shared-memory
//     atomic. Then it flushes the band's non-zero cells to the global
//     raster with one global atomic each. The bands of one chunk are
//     neighbouring blocks, so the chunk's points come from HBM once and
//     from L2 for the other bands.
//   * Counts: lanes of a warp that hit the same cell (clustered GPS data
//     piles thousands of points onto hot cells) are merged with
//     __match_any_sync, and one lane adds the group's size, so hot cells
//     see one shared atomic per warp and distinct cell instead of one per
//     point. Counts are int32: order-free and exact up to 2^31 - 1 per
//     cell, where the TPU kernel's f32 sum stops at 2^24.
//   * Weights: float atomics in shared and global memory. Sums of integer
//     weights are exact while every partial sum stays below 2^24;
//     fractional sums depend on the atomics' order (within f32 rounding).
//   * A dropped point is never indexed and its weight never read, so a
//     NaN weight outside the window cannot reach the raster.
//   * A window too wide for one row in shared memory (over 24,576 int32
//     columns) skips the privatisation and adds straight into the global
//     raster.
//
// Bound: HBM bandwidth. Each point is read once (row and col 4 B each,
// valid 1 B, weight 4 B) and the raster written once; the atomics are
// the work, and privatisation keeps them on chip.
//
// The raster is zeroed by the caller; the kernels allocate nothing and
// launch on the caller's stream. The entry point returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Block and band geometry: 1024 threads with 96 KiB bands fit two blocks
// (64 warps) on each SM of an H100, so many point loads are in flight at
// once to hide their latency. chip_smoke.py times this kernel at the
// 256x256 hot-spot window with 2^25 clustered points (PERF.md).
constexpr int kThreads = 1024;
constexpr long long kBandBytes = 96 * 1024;
constexpr long long kTargetBlocks = 4096;
constexpr long long kMinPointsPerBlock = 8192;

template <typename Acc, bool kShared>
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const int* __restrict__ row, const int* __restrict__ col,
                     const unsigned char* __restrict__ valid,
                     const float* __restrict__ weights, long long n,
                     long long points_per_block, int row0, int col0,
                     int height, int width, int band_rows,
                     Acc* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const int band_lo = kShared ? (int)blockIdx.x * band_rows : 0;
  const int rows_here = kShared ? min(band_rows, height - band_lo) : height;
  const int cells = rows_here * width;  // < 2^31: the wrapper checks h*w
  Acc* band = kShared ? reinterpret_cast<Acc*>(smem_raw) : out;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < cells; i += kThreads) band[i] = 0;
    __syncthreads();
  }
  const long long begin = (long long)blockIdx.y * points_per_block;
  const long long end =
      begin + points_per_block < n ? begin + points_per_block : n;
  // The loop bound is the same for the whole block, so every warp runs
  // whole iterations and __match_any_sync sees all 32 lanes.
  for (long long base = begin; base < end; base += kThreads) {
    const long long i = base + threadIdx.x;
    int cell = -1;
    if (i < end) {
      const long long r = (long long)__ldg(row + i) - row0 - band_lo;
      const long long c = (long long)__ldg(col + i) - col0;
      if (r >= 0 && r < rows_here && c >= 0 && c < width &&
          (valid == nullptr || valid[i] != 0)) {
        cell = (int)(r * width + c);
      }
    }
    if constexpr (std::is_same_v<Acc, int>) {
      const unsigned peers = __match_any_sync(0xffffffffu, cell);
      if (cell >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
        atomicAdd(band + cell, __popc(peers));
      }
    } else {
      if (cell >= 0) atomicAdd(band + cell, __ldg(weights + i));
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    Acc* dst = out + (long long)band_lo * width;
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const Acc v = band[i];
      if (v != 0) atomicAdd(dst + i, v);
    }
  }
}

template <typename Acc>
int launch(const void* row, const void* col, const void* valid,
           const void* weights, long long n, int row0, int col0, int height,
           int width, void* out, void* stream, bool banded = true) {
  if (n <= 0) return (int)cudaSuccess;  // never a zero-size grid
  const long long row_bytes = (long long)width * (long long)sizeof(Acc);
  const bool shared = banded && row_bytes <= kBandBytes;
  const long long band_rows =
      shared ? (kBandBytes / row_bytes < height ? kBandBytes / row_bytes
                                                : height)
             : height;
  const long long n_bands = shared ? (height + band_rows - 1) / band_rows : 1;
  long long chunks = (n + kMinPointsPerBlock - 1) / kMinPointsPerBlock;
  long long cap = kTargetBlocks / n_bands;
  if (cap < 1) cap = 1;
  if (chunks > cap) chunks = cap;
  if (chunks > 65535) chunks = 65535;
  const long long per_block = (n + chunks - 1) / chunks;
  const size_t smem = shared ? (size_t)(band_rows * row_bytes) : 0;
  const dim3 grid((unsigned int)n_bands, (unsigned int)chunks);
  const cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    auto kernel = histogram_kernel<Acc, true>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBandBytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kThreads, smem, s>>>(
        (const int*)row, (const int*)col, (const unsigned char*)valid,
        (const float*)weights, n, per_block, row0, col0, height, width,
        (int)band_rows, (Acc*)out);
  } else {
    histogram_kernel<Acc, false><<<grid, kThreads, 0, s>>>(
        (const int*)row, (const int*)col, (const unsigned char*)valid,
        (const float*)weights, n, per_block, row0, col0, height, width,
        height, (Acc*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// valid may be null (every point valid). Counts go into an int32 raster.
extern "C" int hm_window_histogram_counts(const void* row, const void* col,
                                          const void* valid, long long n,
                                          int row0, int col0, int height,
                                          int width, void* out, void* stream) {
  return launch<int>(row, col, valid, nullptr, n, row0, col0, height, width,
                     out, stream);
}

// Float32 weights into a float32 raster.
extern "C" int hm_window_histogram_weighted(const void* row, const void* col,
                                            const void* valid,
                                            const void* weights, long long n,
                                            int row0, int col0, int height,
                                            int width, void* out,
                                            void* stream) {
  return launch<float>(row, col, valid, weights, n, row0, col0, height, width,
                       out, stream);
}

// Counts through the global-atomic build at any window width, never the
// shared-memory bands. Nothing in the package calls it: chip_smoke.py
// times it against the partitioned counts kernel at that backend's
// windows (PERF.md).
extern "C" int hm_window_histogram_counts_global(
    const void* row, const void* col, const void* valid, long long n,
    int row0, int col0, int height, int width, void* out, void* stream) {
  return launch<int>(row, col, valid, nullptr, n, row0, col0, height, width,
                     out, stream, false);
}
