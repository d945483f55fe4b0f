// Run-length binning of sorted cell ids: the weighted path of the
// large-window ("partitioned") binning backend of
// heatmap_tpu_torch.ops.partitioned.
//
// Replaces heatmap_tpu/ops/partitioned.py::_partition_kernel_weighted
// (with its hosts _partitioned_path and _bin_partitioned_jit). The TPU
// kernel sorts the cell ids into streams, cuts them into chunks, turns
// each chunk that lands in one aligned 256x256 block into a one-hot MXU
// matmul (the weight in the column one-hot) into per-stream block slabs,
// sends the other chunks through a bounded scatter tail, and falls back
// to a full scatter on hostile data. That machinery exists to reach the
// MXU; on Hopper none of it is needed:
//
//   1. hm_window_cell_ids localises each point, in one pass, to an int32
//      cell id r * W + c, with dropped points (out of the window, or
//      invalid) set to the sentinel hw. The caller sorts the ids with
//      torch.sort and gathers the weights by the sort's indices.
//   2. hm_window_run_length_weighted: each thread walks kItems
//      consecutive sorted ids, sums while the id stays the same, and
//      issues ONE atomicAdd into the zeroed raster where a run ends, so a
//      hot cell sees one atomic per thread that touches it instead of
//      one per point. The first sentinel ends the thread's walk
//      (sentinels sort last), so a dropped point's weight is never read.
//
// (The counts path no longer sorts: csrc/window_bucketed.cu.)
//
// Weights accumulate in float32, in sorted order inside a thread and by
// atomics across threads: exact for integer weights with per-cell sums
// below 2^24, within f32 rounding otherwise (the JAX package's own bound
// for its weighted kernel).
//
// Bound: HBM bandwidth, and in practice the sort. Per point the
// localisation reads 9 B (row, col, valid) and writes a 4 B id; the
// run-length pass reads the id and the weight (8 B); the raster is
// written once.
//
// The raster is zeroed by the caller; the kernels allocate nothing and
// launch on the caller's stream. Each entry point returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;

__global__ void cell_ids_kernel(const int* __restrict__ row,
                                const int* __restrict__ col,
                                const unsigned char* __restrict__ valid,
                                long long n, int row0, int col0, int height,
                                int width, int* __restrict__ ids) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int hw = height * width;  // < 2^31: the wrapper checks it
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long r = (long long)__ldg(row + i) - row0;
    const long long c = (long long)__ldg(col + i) - col0;
    const bool ok = r >= 0 && r < height && c >= 0 && c < width &&
                    (valid == nullptr || valid[i] != 0);
    ids[i] = ok ? (int)(r * width + c) : hw;
  }
}

__global__ void run_length_kernel(const int* __restrict__ ids,
                                  const float* __restrict__ weights,
                                  long long n, int hw,
                                  float* __restrict__ out) {
  const long long begin =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kItems;
  if (begin >= n) return;
  const long long end = begin + kItems < n ? begin + kItems : n;
  int run = -1;
  float sum = 0;
  for (long long i = begin; i < end; ++i) {
    const int id = __ldg(ids + i);
    if (id >= hw) break;  // sentinels sort last: nothing real follows
    if (id != run) {
      if (run >= 0) atomicAdd(out + run, sum);
      run = id;
      sum = 0;
    }
    sum += __ldg(weights + i);
  }
  if (run >= 0) atomicAdd(out + run, sum);
}

}  // namespace

// Points -> int32 cell ids, the sentinel height * width for dropped ones.
// valid may be null (every point valid).
extern "C" int hm_window_cell_ids(const void* row, const void* col,
                                  const void* valid, long long n, int row0,
                                  int col0, int height, int width, void* ids,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;  // never a zero-size grid
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond
  cell_ids_kernel<<<(unsigned int)blocks, kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const int*)row, (const int*)col, (const unsigned char*)valid, n, row0,
      col0, height, width, (int*)ids);
  return (int)cudaGetLastError();
}

// Sorted int32 cell ids (sentinel hw for dropped points) and float32
// weights in the ids' sorted order -> float32 sums.
extern "C" int hm_window_run_length_weighted(const void* sorted_ids,
                                             const void* sorted_weights,
                                             long long n, int hw, void* out,
                                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;  // never a zero-size grid
  const long long per_block = (long long)kThreads * kItems;
  const long long blocks = (n + per_block - 1) / per_block;
  run_length_kernel<<<(unsigned int)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int*)sorted_ids, (const float*)sorted_weights, n, hw,
      (float*)out);
  return (int)cudaGetLastError();
}
