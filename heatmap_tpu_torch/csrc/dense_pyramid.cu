// The dense pyramid of a window raster: every coarser level of 2x2 sums,
// from one read of the detail raster. The CUDA path of
// heatmap_tpu_torch.ops.pyramid.pyramid_from_raster.
//
// Replaces no TPU kernel: the JAX package leaves the reshape-sum of
// heatmap_tpu/ops/pyramid.py coarsen_raster to XLA. In PyTorch the same
// chain ran as one torch reduction a level, ten launches from z16 to z6
// for the 8192 x 4096 int32 window of the bulk step, at 14% of the bound
// below (0.382 ms against 0.0534 ms): each level was read back from
// device memory to make the next.
//
// Bound: device memory, 4 B for each level-0 cell read and 4 B for each
// coarser cell written (178,956,928 B at the bulk shape, 53.4 us at
// 3.35 TB/s). Every other level is made on chip from the one read:
//
//   - A block owns a kTile x kTile tile of its input (64 KiB of int32 or
//     float32) and reads it whole before it adds anything: each thread
//     issues 2 x kPairs 16-byte loads along rows, a warp covering one
//     512-byte row of the tile with each.
//   - A thread holds two rows of four cells, so it forms its two level-1
//     cells in registers. It writes them to the output and to shared
//     memory; a warp's level-1 stores are one 256-byte run.
//   - Levels 2..kTileLevels of the tile roll up in shared memory, level by
//     level, each cell written to the output once.
//   - A launch rolls at most kTileLevels levels. Deeper levels take one
//     more launch of the same kernel over the last level written (the
//     bulk step's 64 x 32 level 7, one block), from the caller.
//
// Exactness. Integers add as uint32, so an int32 sum wraps as torch's
// int32 sum does. Every float cell is (a00 + a01) + (a10 + a11) of the
// stored cells below it, each add rounded to nearest with __fadd_rn, so
// nothing contracts or reorders: the plain version adds in that order,
// and the two agree bit for bit.
//
// Shapes. The input is (batch, height, width) with any batch and row
// stride and unit column stride; each output level is contiguous. The
// caller makes sure that both sides of every level but the last are even
// (height and width divide by 2^n_levels). Tiles on the bottom and right
// edges are ragged: their cells past the input load as zero and their
// cells past a level's edge are not stored. Where the layout allows
// (16-byte aligned rows, width a multiple of 4), loads are 16 bytes and
// level-1 stores 8; otherwise one cell at a time.
//
// The launcher allocates nothing and does not synchronise; it returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kTileLevels = 7;  // log2(kTile)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = kTile / 2;           // level-1 side of a tile
constexpr int kPairs = kHalf / kWarps;     // row pairs a warp loads
constexpr int kQuarter = kTile / 4;        // level-2 side of a tile

struct Outputs {
  void* level[kTileLevels];  // level l + 1 of this launch, contiguous
};

// Cells add as uint32 (int32 with a defined wrap) or as float, rounded.
__device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
  return a + b;
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T quad(T a00, T a01, T a10, T a11) {
  return add(add(a00, a01), add(a10, a11));
}

template <typename T>
struct Vec;
template <>
struct Vec<unsigned> {
  using V4 = uint4;
  using V2 = uint2;
};
template <>
struct Vec<float> {
  using V4 = float4;
  using V2 = float2;
};

template <typename T>
__device__ __forceinline__ typename Vec<T>::V2 pair(T x, T y) {
  typename Vec<T>::V2 v;
  v.x = x;
  v.y = y;
  return v;
}

// Four cells of a row from column c on: one 16-byte load where kVec,
// else the cells below `cols` one by one (the rest zero).
template <typename T, bool kVec>
__device__ __forceinline__ typename Vec<T>::V4 load4(const T* p, int c,
                                                     int cols) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const typename Vec<T>::V4*>(p));
  } else {
    typename Vec<T>::V4 v;
    v.x = c < cols ? __ldg(p) : T(0);
    v.y = c + 1 < cols ? __ldg(p + 1) : T(0);
    v.z = c + 2 < cols ? __ldg(p + 2) : T(0);
    v.w = c + 3 < cols ? __ldg(p + 3) : T(0);
    return v;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    pyramid_kernel(const T* __restrict__ in, long long batch_stride,
                   long long row_stride, int height, int width,
                   int tiles_x, int tiles_y, int n_levels, Outputs out) {
  __shared__ __align__(16) T s_a[kHalf * kHalf];
  __shared__ __align__(16) T s_b[kQuarter * kQuarter];

  const int tx = blockIdx.x % tiles_x;
  const int rest = blockIdx.x / tiles_x;
  const int ty = rest % tiles_y;
  const long long b = rest / tiles_y;
  const int r0 = ty * kTile;
  const int c0 = tx * kTile;
  // Rows and columns of the input inside this tile: even, and multiples
  // of 2^n_levels on a ragged edge.
  const int rows = min(kTile, height - r0);
  const int cols = min(kTile, width - c0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = 4 * lane;
  const T* base = in + b * batch_stride + (long long)r0 * row_stride + c0 + c;

  // The whole tile in flight before the first add.
  typename Vec<T>::V4 top[kPairs], bot[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int r = 2 * (warp + kWarps * k);
    if (r < rows && c < cols) {
      top[k] = load4<T, kVec>(base + (long long)r * row_stride, c, cols);
      bot[k] = load4<T, kVec>(base + (long long)(r + 1) * row_stride, c, cols);
    } else {
      top[k].x = top[k].y = top[k].z = top[k].w = T(0);
      bot[k] = top[k];
    }
  }

  // Level 1 from registers.
  {
    const int h1 = height >> 1;
    const int w1 = width >> 1;
    T* out1 = static_cast<T*>(out.level[0]) + b * h1 * (long long)w1;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int i = warp + kWarps * k;
      const T x = quad(top[k].x, top[k].y, bot[k].x, bot[k].y);
      const T y = quad(top[k].z, top[k].w, bot[k].z, bot[k].w);
      *reinterpret_cast<typename Vec<T>::V2*>(&s_a[i * kHalf + 2 * lane]) =
          pair(x, y);
      if (2 * i < rows && c < cols) {
        T* p = out1 + (long long)((r0 >> 1) + i) * w1 + (c0 >> 1) + 2 * lane;
        if constexpr (kVec) {
          *reinterpret_cast<typename Vec<T>::V2*>(p) = pair(x, y);
        } else {
          p[0] = x;
          if (c + 2 < cols) p[1] = y;
        }
      }
    }
  }

  // Levels 2..n_levels in shared memory, ping-ponging between s_a and
  // s_b (each level fits the smaller buffer).
  T* src = s_a;
  T* dst = s_b;
  int side = kHalf;
  for (int l = 2; l <= n_levels; ++l) {
    __syncthreads();
    const int m = side >> 1;
    const int hl = height >> l;
    const int wl = width >> l;
    const int vr = rows >> l;
    const int vc = cols >> l;
    T* outl = static_cast<T*>(out.level[l - 1]) + b * hl * (long long)wl;
    for (int k = threadIdx.x; k < m * m; k += kThreads) {
      const int i = k / m;
      const int j = k - i * m;
      const typename Vec<T>::V2 u =
          *reinterpret_cast<const typename Vec<T>::V2*>(
              &src[2 * i * side + 2 * j]);
      const typename Vec<T>::V2 d =
          *reinterpret_cast<const typename Vec<T>::V2*>(
              &src[(2 * i + 1) * side + 2 * j]);
      const T v = quad(u.x, u.y, d.x, d.y);
      dst[k] = v;
      if (i < vr && j < vc) {
        outl[(long long)((r0 >> l) + i) * wl + (c0 >> l) + j] = v;
      }
    }
    T* t = src;
    src = dst;
    dst = t;
    side = m;
  }
}

template <typename T, bool kVec>
cudaError_t launch(const void* in, long long batch, long long batch_stride,
                   long long row_stride, int height, int width, int n_levels,
                   void* const* levels, cudaStream_t s) {
  const long long tiles_x = (width + kTile - 1) / kTile;
  const long long tiles_y = (height + kTile - 1) / kTile;
  const long long blocks = batch * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  Outputs out = {};
  for (int l = 0; l < n_levels; ++l) out.level[l] = levels[l];
  pyramid_kernel<T, kVec><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(in), batch_stride, row_stride, height, width,
      (int)tiles_x, (int)tiles_y, n_levels, out);
  return cudaGetLastError();
}

}  // namespace

// Rolls `n_levels` (1..7) levels of 2x2 sums over `batch` rasters of
// height x width cells at `in` (element strides batch_stride and
// row_stride, unit column stride) into the contiguous levels[0..n_levels),
// level l of shape (batch, height >> (l + 1), width >> (l + 1)). dtype 0
// is int32, 1 float32. height and width divide by 2^n_levels. No cells
// launch nothing.
extern "C" int hm_dense_pyramid(const void* in, int dtype, long long batch,
                                long long batch_stride, long long row_stride,
                                int height, int width, int n_levels,
                                void* const* levels, void* stream) {
  if (batch < 0 || height < 0 || width < 0 || n_levels < 1 ||
      n_levels > kTileLevels || (dtype != 0 && dtype != 1) ||
      height % (1 << n_levels) || width % (1 << n_levels)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  // 16-byte loads need every row start 16-byte aligned; then the level-1
  // rows (width / 2 cells, even) start 8-byte aligned for the paired
  // stores when level 1 itself does.
  const bool vec = reinterpret_cast<unsigned long long>(in) % 16 == 0 &&
                   row_stride % 4 == 0 &&
                   (batch == 1 || batch_stride % 4 == 0) && width % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(levels[0]) % 8 == 0;
  const long long bs = batch_stride;
  const long long rs = row_stride;
  cudaError_t e;
  if (dtype == 0) {
    e = vec ? launch<unsigned, true>(in, batch, bs, rs, height, width,
                                     n_levels, levels, s)
            : launch<unsigned, false>(in, batch, bs, rs, height, width,
                                      n_levels, levels, s);
  } else {
    e = vec ? launch<float, true>(in, batch, bs, rs, height, width, n_levels,
                                  levels, s)
            : launch<float, false>(in, batch, bs, rs, height, width,
                                   n_levels, levels, s);
  }
  return (int)e;
}
