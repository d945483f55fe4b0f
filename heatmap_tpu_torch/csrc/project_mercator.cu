// Float64 Web-Mercator projection of a batch of points in one pass: the
// CUDA path of heatmap_tpu_torch.tilemath.mercator.project_points.
//
// Replaces no TPU kernel: the JAX package leaves the projection to XLA,
// which fuses the elementwise chain by itself. In PyTorch the same chain
// (mercator._project_plain) runs as about 30 elementwise kernels, each
// reading or writing a float64 or bool tensor of the whole batch, about
// 630 B a lane, and a nonzero with a stream sync. Here a lane's work stays
// in registers: it reads lat and lon (16 B) and writes the int32 row and
// col and the bool validity (9 B).
//
// Bit-equal to the plain version on the card. Each step is the plain
// version's kernel, in its order: the same libdevice tan, cos and log; the
// reciprocal 1.0 / cos(phi) (Tensor.__rdiv__ is reciprocal() * other); and
// every division by a Python scalar as PyTorch's CUDA division by a CPU
// scalar computes it, a multiply by the reciprocal rounded on the host.
// Every multiply and add is __dmul_rn / __dadd_rn / __dsub_rn, so that nvcc
// contracts nothing into an FMA, which PyTorch's one-op kernels cannot do.
//
// Row edges. A lane whose y * 2^zoom lies within mercator._row_edge_margin
// of an integer (the same formula, in the same order) takes its row from
// the host's scalar formula, as in the plain version. The kernel appends
// such a lane's index to `flagged` through one counter, which a warp bumps
// once for all its flagged lanes, up to `capacity` entries, and counts
// past it: the caller reads the count (its one sync) and runs again with a
// list that large when it overflowed. A flagged lane is written with row 0,
// and col and valid from the column alone; the caller combines those with
// the host's row.
//
// Bound: device memory, 25 B a lane against 3.35 TB/s, and close to it the
// FP64 units (tan, cos, log and three divisions, roughly 150-250 FP64
// operations a lane). Each thread takes kLanes lanes a block-width apart,
// so every load and store of a warp is one contiguous run, and all of a
// thread's loads are in flight before its first tan.
//
// The launcher allocates nothing: the caller passes the outputs and an
// 8-byte counter, which the launcher zeroes on the stream before the
// kernel. It returns the cudaError_t of the memset and the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;
constexpr long long kBlockLanes = (long long)kThreads * kLanes;
constexpr unsigned kFull = 0xffffffffu;

// math.pi, and the reciprocals that PyTorch's CUDA division by a Python
// scalar multiplies by (computed in double on the host, correctly rounded,
// as the compiler folds these).
constexpr double kPi = 3.141592653589793;
constexpr double kInv180 = 1.0 / 180.0;
constexpr double kInv360 = 1.0 / 360.0;
constexpr double kInvPi = 1.0 / kPi;
constexpr double kInv2 = 1.0 / 2.0;
// mercator._EDGE_MARGIN_FACTOR * mercator._EPS64 (2^-52).
constexpr double kMarginPerCell = 16.0 * 0x1p-52;

struct Lane {
  int row;
  int col;
  bool valid;
  bool flagged;
};

__device__ __forceinline__ Lane project(double lat, double lon, double n) {
  // phi = lat * pi / 180
  const double phi = __dmul_rn(__dmul_rn(lat, kPi), kInv180);
  const double t = tan(phi);
  const double s = __ddiv_rn(1.0, cos(phi));
  const double u = __dadd_rn(t, s);
  const double log_u = log(u);
  // ny = (1 - log_u / pi) / 2 * n
  const double ny =
      __dmul_rn(__dmul_rn(__dsub_rn(1.0, __dmul_rn(log_u, kInvPi)), kInv2), n);
  const double frow = floor(ny);
  // _row_edge_margin: c * ((|t| + |s|) / |u| + |log u| + 2), c = 16 eps n.
  const double margin = __dmul_rn(
      __dadd_rn(__dadd_rn(__ddiv_rn(__dadd_rn(fabs(t), fabs(s)), fabs(u)),
                          fabs(log_u)),
                2.0),
      __dmul_rn(kMarginPerCell, n));
  // A NaN margin flags the lane too.
  const bool flagged =
      isfinite(ny) && !(fabs(__dsub_rn(ny, rint(ny))) > margin);
  // fcol = floor((lon + 180) / 360 * n)
  const double fcol =
      floor(__dmul_rn(__dmul_rn(__dadd_rn(lon, 180.0), kInv360), n));
  // NaN fails every comparison, and an infinity one of each pair, so these
  // are the plain version's isfinite-and-in-range tests.
  const bool col_ok = fcol >= 0.0 && fcol < n;
  const bool row_ok = !flagged && frow >= 0.0 && frow < n;
  Lane out;
  out.flagged = flagged;
  out.valid = col_ok && (flagged || row_ok);
  out.row = out.valid && !flagged ? (int)frow : 0;
  out.col = out.valid ? (int)fcol : 0;
  return out;
}

__global__ void __launch_bounds__(kThreads)
    project_kernel(const double* __restrict__ lat,
                   const double* __restrict__ lon, long long n_lanes,
                   double n, int* __restrict__ row, int* __restrict__ col,
                   bool* __restrict__ valid,
                   unsigned long long* __restrict__ count,
                   long long* __restrict__ flagged, long long capacity) {
  const long long base = (long long)blockIdx.x * kBlockLanes + threadIdx.x;
  double la[kLanes], lo[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const long long i = base + (long long)k * kThreads;
    la[k] = i < n_lanes ? __ldg(lat + i) : 0.0;
    lo[k] = i < n_lanes ? __ldg(lon + i) : 0.0;
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < n_lanes) {
      const Lane p = project(la[k], lo[k], n);
      row[i] = p.row;
      col[i] = p.col;
      valid[i] = p.valid;
      bits |= (unsigned)p.flagged << k;
    }
  }
  // Every thread of the block gets here (no early exit), so the warp's
  // shuffles see all 32 lanes. Flagged lanes are rare: one ballot a warp.
  const unsigned mine = __popc(bits);
  if (__ballot_sync(kFull, mine != 0) == 0) return;
  const int lane = threadIdx.x & 31;
  unsigned incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  unsigned long long slot = 0;
  if (lane == 31) slot = atomicAdd(count, (unsigned long long)incl);
  slot = __shfl_sync(kFull, slot, 31) + (incl - mine);
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if ((bits >> k) & 1u) {
      if (slot < (unsigned long long)capacity) {
        flagged[slot] = base + (long long)k * kThreads;
      }
      ++slot;
    }
  }
}

}  // namespace

// Projects n_lanes points (contiguous float64 lat and lon) at `zoom` into
// row, col (int32) and valid (bool); zeroes *count and appends the indices
// of the lanes near a row edge to flagged[0, capacity), counting them all
// in *count. n_lanes 0 launches nothing.
extern "C" int hm_project_mercator(const void* lat, const void* lon,
                                   long long n_lanes, int zoom, void* row,
                                   void* col, void* valid, void* count,
                                   void* flagged, long long capacity,
                                   void* stream) {
  if (n_lanes < 0 || zoom < 0 || zoom > 30 || capacity < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned long long), s);
  if (e != cudaSuccess || n_lanes == 0) return (int)e;
  const long long blocks = (n_lanes + kBlockLanes - 1) / kBlockLanes;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  project_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const double*)lat, (const double*)lon, n_lanes, (double)(1LL << zoom),
      (int*)row, (int*)col, (bool*)valid, (unsigned long long*)count,
      (long long*)flagged, capacity);
  return (int)cudaGetLastError();
}
