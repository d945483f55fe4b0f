// Bucketed, privatised window binning: the large-window ("partitioned")
// binning backend of heatmap_tpu_torch.ops.partitioned, for counts and
// for float32 weights.
//
// Replaces heatmap_tpu/ops/partitioned.py::_partition_kernel and
// ::_partition_kernel_weighted (with their hosts _partitioned_path and
// _bin_partitioned_jit). The TPU kernels sort cell ids (the weighted one
// carries the weight as the sort's payload) into streams only to cut
// them into chunks that each land in one aligned 256x256 block, whose
// accumulator they keep on chip (VMEM slabs) while an MXU matmul adds
// the chunk. The idea that carries over is grouping points by aligned
// block, never ordering them by cell.
//
// What replaced what. The first port localised the points to int32 cell
// ids, sorted all of them with torch.sort (radix-sort traffic of about
// 2 GB for 2^25 ids), gathered the weights by the sort's indices and
// added each run of equal ids with one atomic. Now four passes, with the
// window cut into aligned sub-blocks of kSide x kSide cells (a 128x128
// int32 or float32 sub-block is 64 KiB, so it fits a block's shared
// memory; a 256x256 one would not):
//
//   1. count_kernel: grid (bucket groups, point chunks). Each block
//      localises the points of its chunk once (row, col, valid: 9 B a
//      point), drops those outside the window or invalid, and counts
//      points per sub-block of its group in a shared histogram, with
//      __match_any_sync merging the lanes of a warp that hit one
//      sub-block. It adds each non-zero count to the sub-block's global
//      total with one atomicAdd, and keeps the old value it returns: the
//      chunk's own offset inside the sub-block's bucket (chunk_base).
//   2. scan_kernel (one block): exclusive scans of the sub-block totals
//      into bucket starts, and of their work items (ceil(count /
//      item_points)) into item starts.
//   3. scatter_kernel: the same grid and chunks as pass 1. Each block
//      starts its shared cursors at bucket start + chunk_base and writes
//      each kept point's local cell offset (14 bits, as uint16) into its
//      bucket, one shared atomic per warp and sub-block; with weights, it
//      writes the point's float32 weight into a second array at the same
//      slot. The order inside a bucket is free: counts are order-free.
//   4. bin_kernel: one block per work item, at most item_points points of
//      one bucket. It zeroes a shared sub-block, adds its points (1, or
//      the weight) with shared atomics, and flushes each non-zero cell to
//      the zeroed raster with one global atomicAdd. Splitting a hot
//      bucket into items keeps a hot spot (a quarter of the headline's
//      points in a few sub-blocks) from serialising on one SM.
//
// The grid of pass 4 is an upper bound (ceil(n / item_points) + buckets)
// so nothing waits on the host; blocks past the real item count return.
// Sub-blocks on the right and bottom edges are ragged: their cells past
// the window are never hit, so never flushed.
//
// Weights. Pass 3 reads a point's weight only beside its row and column
// (a 16-byte load of 4 weights also holds dropped lanes' weights) and
// stores only kept lanes' weights, so a NaN on a dropped lane never
// reaches the raster; a NaN on a kept lane does (its cell is NaN, as in
// the plain scatter: v != 0 holds for NaN, so the flush carries it).
// Sums are float32 by atomics in an order that changes from run to run:
// exact for integer weights whose per-cell partial sums stay below 2^24,
// within f32 rounding otherwise (the JAX package's own bound).
//
// Bound: HBM bandwidth. The function needs the points read once (9 B, 13
// with a weight) and the raster written once (4 B a cell); the passes
// move about 2^25 x (9 + 9 + 2 + 2) B for counts, 2^25 x (9 + 13 + 6 +
// 6) B with weights, plus zeroing and flushing the raster at the
// headline. Counts are int32, exact to 2^31 - 1 per cell, and
// byte-identical run to run.
//
// The kernels allocate nothing and launch on the caller's stream; the
// entry points zero the raster and the bucket totals themselves
// (cudaMemsetAsync) and set pass 4's shared-memory limit once per
// process and device. Each returns the cudaError_t of its launches, and
// refuses geometry that the kernels were not built for, so the Python
// planning cannot drift.

#include <cuda_runtime.h>

#include <type_traits>

#include "smem_limit.cuh"

namespace {

constexpr int kSideShift = 7;
constexpr int kSide = 1 << kSideShift;
constexpr int kSubCells = kSide * kSide;
constexpr int kThreads = 512;
// Points a thread takes per step of passes 1 and 3, and cells per step
// of pass 4 (one 16-byte load each).
constexpr int kQuad = 4;
constexpr int kCellVec = 8;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
// Largest bucket group of passes 1 and 3 (48 KiB of shared memory).
constexpr int kMaxGroupBuckets = 12288;

struct Geometry {
  int row0, col0, height, width, sub_cols, buckets;
};

// Buckets relative to this block's group (-1: dropped, or another
// group's) and local cell offsets of the kQuad points from i. With vec,
// the rows, columns and valid bytes come in 16-, 16- and 4-byte loads,
// so each thread keeps several points in flight.
__device__ __forceinline__ void load_quad(
    const int* __restrict__ row, const int* __restrict__ col,
    const unsigned char* __restrict__ valid, bool vec, long long i,
    long long end, const Geometry& g, int b0, int group_size,
    int (&bucket)[kQuad], int (&local)[kQuad]) {
  int r[kQuad], c[kQuad];
  bool ok[kQuad];
  if (vec && i + kQuad <= end) {
    const int4 rv = __ldg(reinterpret_cast<const int4*>(row + i));
    const int4 cv = __ldg(reinterpret_cast<const int4*>(col + i));
    r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
    c[0] = cv.x; c[1] = cv.y; c[2] = cv.z; c[3] = cv.w;
    uchar4 vv = make_uchar4(1, 1, 1, 1);
    if (valid != nullptr) {
      vv = __ldg(reinterpret_cast<const uchar4*>(valid + i));
    }
    ok[0] = vv.x; ok[1] = vv.y; ok[2] = vv.z; ok[3] = vv.w;
  } else {
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      ok[j] = i + j < end;
      r[j] = ok[j] ? __ldg(row + i + j) : 0;
      c[j] = ok[j] ? __ldg(col + i + j) : 0;
      if (ok[j] && valid != nullptr) ok[j] = valid[i + j] != 0;
    }
  }
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    const long long rr = (long long)r[j] - g.row0;
    const long long cc = (long long)c[j] - g.col0;
    bucket[j] = -1;
    local[j] = 0;
    if (ok[j] && rr >= 0 && rr < g.height && cc >= 0 && cc < g.width) {
      const int b = ((int)rr >> kSideShift) * g.sub_cols +
                    ((int)cc >> kSideShift) - b0;
      if (b >= 0 && b < group_size) {
        bucket[j] = b;
        local[j] =
            (((int)rr & (kSide - 1)) << kSideShift) | ((int)cc & (kSide - 1));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const int* __restrict__ row, const int* __restrict__ col,
                 const unsigned char* __restrict__ valid, bool vec,
                 long long n, long long per_chunk, Geometry g,
                 int group_buckets, unsigned* __restrict__ bucket_count,
                 unsigned* __restrict__ chunk_base) {
  extern __shared__ unsigned hist[];
  const int b0 = blockIdx.x * group_buckets;
  const int group_size = min(group_buckets, g.buckets - b0);
  for (int i = threadIdx.x; i < group_size; i += kThreads) hist[i] = 0;
  __syncthreads();
  const long long begin = (long long)blockIdx.y * per_chunk;
  const long long end = min(begin + per_chunk, n);
  const int lane = threadIdx.x & 31;
  // A bound uniform over the block: every warp runs whole iterations, so
  // __match_any_sync sees all 32 lanes.
  for (long long base = begin; base < end; base += kThreads * kQuad) {
    int bucket[kQuad], local[kQuad];
    load_quad(row, col, valid, vec, base + threadIdx.x * kQuad, end, g, b0,
              group_size, bucket, local);
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      const unsigned peers = __match_any_sync(kFull, bucket[j]);
      if (bucket[j] >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(hist + bucket[j], __popc(peers));
      }
    }
  }
  __syncthreads();
  unsigned* base_row = chunk_base + (long long)blockIdx.y * g.buckets + b0;
  for (int i = threadIdx.x; i < group_size; i += kThreads) {
    const unsigned v = hist[i];
    if (v != 0) base_row[i] = atomicAdd(bucket_count + b0 + i, v);
  }
}

__device__ __forceinline__ unsigned warp_inclusive_sum(unsigned v,
                                                       int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive scans of the bucket totals (points) and of their work items,
// buckets + 1 entries each; the last entries are the totals.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const unsigned* __restrict__ bucket_count, int buckets,
                int item_points, unsigned* __restrict__ bucket_start,
                unsigned* __restrict__ item_start) {
  __shared__ unsigned warp_points[32], warp_items[32];
  __shared__ unsigned carry_points, carry_items;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry_points = carry_items = 0;
  __syncthreads();
  for (int base = 0; base < buckets; base += kScanThreads) {
    const int b = base + threadIdx.x;
    const unsigned p = b < buckets ? bucket_count[b] : 0;
    const unsigned it = (p + item_points - 1) / item_points;
    const unsigned ip = warp_inclusive_sum(p, lane);
    const unsigned ii = warp_inclusive_sum(it, lane);
    if (lane == 31) {
      warp_points[warp] = ip;
      warp_items[warp] = ii;
    }
    __syncthreads();
    if (warp == 0) {
      warp_points[lane] = warp_inclusive_sum(warp_points[lane], lane);
      warp_items[lane] = warp_inclusive_sum(warp_items[lane], lane);
    }
    __syncthreads();
    const unsigned before_p = warp > 0 ? warp_points[warp - 1] : 0;
    const unsigned before_i = warp > 0 ? warp_items[warp - 1] : 0;
    if (b < buckets) {
      bucket_start[b] = carry_points + before_p + ip - p;
      item_start[b] = carry_items + before_i + ii - it;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      carry_points += warp_points[31];
      carry_items += warp_items[31];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    bucket_start[buckets] = carry_points;
    item_start[buckets] = carry_items;
  }
}

// kWeighted: weights (n float32, 16-byte aligned when vec) are copied to
// wcells at the slot of each kept point's local cell offset.
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int* __restrict__ row, const int* __restrict__ col,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ weights, bool vec, long long n,
                   long long per_chunk, Geometry g, int group_buckets,
                   const unsigned* __restrict__ bucket_start,
                   const unsigned* __restrict__ chunk_base,
                   unsigned short* __restrict__ cells,
                   float* __restrict__ wcells) {
  extern __shared__ unsigned cursor[];
  const int b0 = blockIdx.x * group_buckets;
  const int group_size = min(group_buckets, g.buckets - b0);
  const unsigned* base_row =
      chunk_base + (long long)blockIdx.y * g.buckets + b0;
  // Entries of buckets this chunk never hits are stale and never used.
  for (int i = threadIdx.x; i < group_size; i += kThreads) {
    cursor[i] = bucket_start[b0 + i] + base_row[i];
  }
  __syncthreads();
  const long long begin = (long long)blockIdx.y * per_chunk;
  const long long end = min(begin + per_chunk, n);
  const int lane = threadIdx.x & 31;
  for (long long base = begin; base < end; base += kThreads * kQuad) {
    const long long i = base + threadIdx.x * kQuad;
    int bucket[kQuad], local[kQuad];
    load_quad(row, col, valid, vec, i, end, g, b0, group_size, bucket,
              local);
    float w[kQuad] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kWeighted) {
      if (vec && i + kQuad <= end) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(weights + i));
        w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
      } else {
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          if (bucket[j] >= 0) w[j] = __ldg(weights + i + j);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      const unsigned peers = __match_any_sync(kFull, bucket[j]);
      const int leader = __ffs(peers) - 1;
      unsigned slot = 0;
      if (bucket[j] >= 0 && lane == leader) {
        slot = atomicAdd(cursor + bucket[j], __popc(peers));
      }
      slot = __shfl_sync(kFull, slot, leader);
      if (bucket[j] >= 0) {
        const unsigned s = slot + __popc(peers & ((1u << lane) - 1));
        cells[s] = (unsigned short)local[j];
        if constexpr (kWeighted) wcells[s] = w[j];
      }
    }
  }
}

// Acc is int (counts: each point adds 1) or float (each point adds its
// weight from wcells, at the same slots as cells).
template <typename Acc>
__global__ void __launch_bounds__(kThreads)
    bin_kernel(const unsigned short* __restrict__ cells,
               const float* __restrict__ wcells,
               const unsigned* __restrict__ bucket_start,
               const unsigned* __restrict__ item_start, Geometry g,
               int item_points, Acc* __restrict__ out) {
  extern __shared__ unsigned char sub_raw[];
  Acc* sub = reinterpret_cast<Acc*>(sub_raw);
  const unsigned item = blockIdx.x;
  if (item >= item_start[g.buckets]) return;
  // The bucket of this item: the last b with item_start[b] <= item (an
  // empty bucket shares its start with the next one, so it never wins).
  int lo = 0, hi = g.buckets - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (item_start[mid] <= item) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int b = lo;
  const unsigned first =
      bucket_start[b] + (item - item_start[b]) * (unsigned)item_points;
  const unsigned last = min(first + (unsigned)item_points, bucket_start[b + 1]);
  for (int i = threadIdx.x; i < kSubCells; i += kThreads) sub[i] = 0;
  __syncthreads();
  // kCellVec cells a thread per 16-byte load, from the aligned group
  // that holds `first` (and two 16-byte loads of their weights); cells
  // outside [first, last) are masked.
  for (unsigned base = first & ~(unsigned)(kCellVec - 1); base < last;
       base += kThreads * kCellVec) {
    const unsigned i0 = base + threadIdx.x * kCellVec;
    uint4 v = make_uint4(0, 0, 0, 0);
    float w[kCellVec] = {};
    if (i0 < last) {
      v = __ldg(reinterpret_cast<const uint4*>(cells + i0));
      if constexpr (std::is_same_v<Acc, float>) {
        const float4 lo4 = __ldg(reinterpret_cast<const float4*>(wcells + i0));
        const float4 hi4 =
            __ldg(reinterpret_cast<const float4*>(wcells + i0 + 4));
        w[0] = lo4.x; w[1] = lo4.y; w[2] = lo4.z; w[3] = lo4.w;
        w[4] = hi4.x; w[5] = hi4.y; w[6] = hi4.z; w[7] = hi4.w;
      }
    }
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
    // One shared atomic a point: the cells of a warp are mostly distinct
    // here, where __match_any_sync measured slower than the conflicts it
    // saves.
#pragma unroll
    for (int j = 0; j < kCellVec; ++j) {
      const unsigned i = i0 + j;
      if (i >= first && i < last) {
        Acc* dst = sub + ((words[j >> 1] >> (16 * (j & 1))) & 0xffffu);
        if constexpr (std::is_same_v<Acc, float>) {
          atomicAdd(dst, w[j]);
        } else {
          atomicAdd(dst, 1);
        }
      }
    }
  }
  __syncthreads();
  const int r0 = (b / g.sub_cols) << kSideShift;
  const int c0 = (b % g.sub_cols) << kSideShift;
  Acc* dst = out + (long long)r0 * g.width + c0;
  for (int i = threadIdx.x; i < kSubCells; i += kThreads) {
    const Acc v = sub[i];
    if (v != 0) {  // NaN != 0: a kept NaN weight reaches its cell
      atomicAdd(dst + (long long)(i >> kSideShift) * g.width +
                    (i & (kSide - 1)),
                v);
    }
  }
}

template <typename Acc>
int launch(const void* row, const void* col, const void* valid,
           const void* weights, long long n, int row0, int col0, int height,
           int width, int side, int sub_cols, int buckets, int group_buckets,
           int groups, int chunks, long long per_chunk, int item_points,
           long long items_max, void* bucket_count, void* chunk_base,
           void* bucket_start, void* item_start, void* cells, void* wcells,
           void* out, void* stream) {
  constexpr bool kWeighted = std::is_same_v<Acc, float>;
  if (side != kSide || group_buckets < 1 ||
      group_buckets > kMaxGroupBuckets || buckets < 1 || groups < 1 ||
      chunks < 1 || chunks > 65535 || item_points < 1 || n <= 0 ||
      n > 0x7fffffffLL || height < 1 || width < 1 ||
      (long long)height * width > 0x7fffffffLL ||
      (long long)groups * group_buckets < buckets ||
      (long long)chunks * per_chunk < n ||
      ((unsigned long long)cells & 15ull) != 0 ||
      (kWeighted && (weights == nullptr ||
                     ((unsigned long long)wcells & 15ull) != 0)) ||
      items_max < (n + item_points - 1) / item_points + buckets ||
      items_max > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  // Pass 4's 64 KiB of dynamic shared memory.
  cudaError_t e =
      hm::allow_dynamic_smem<bin_kernel<Acc>, kSubCells * (int)sizeof(Acc)>();
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  e = cudaMemsetAsync(out, 0, (size_t)height * width * sizeof(Acc), s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(bucket_count, 0, (size_t)buckets * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  const Geometry g{row0, col0, height, width, sub_cols, buckets};
  const dim3 grid((unsigned)groups, (unsigned)chunks);
  const bool vec =
      per_chunk % kQuad == 0 &&
      (((unsigned long long)row | (unsigned long long)col |
        (unsigned long long)(kWeighted ? weights : nullptr)) &
       15ull) == 0 &&
      ((unsigned long long)valid & 3ull) == 0;
  const size_t hist_bytes = (size_t)group_buckets * sizeof(unsigned);
  count_kernel<<<grid, kThreads, hist_bytes, s>>>(
      (const int*)row, (const int*)col, (const unsigned char*)valid, vec, n,
      per_chunk, g, group_buckets, (unsigned*)bucket_count,
      (unsigned*)chunk_base);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<1, kScanThreads, 0, s>>>(
      (const unsigned*)bucket_count, buckets, item_points,
      (unsigned*)bucket_start, (unsigned*)item_start);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<kWeighted><<<grid, kThreads, hist_bytes, s>>>(
      (const int*)row, (const int*)col, (const unsigned char*)valid,
      (const float*)weights, vec, n, per_chunk, g, group_buckets,
      (const unsigned*)bucket_start, (const unsigned*)chunk_base,
      (unsigned short*)cells, (float*)wcells);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bin_kernel<Acc><<<(unsigned)items_max, kThreads,
                    kSubCells * sizeof(Acc), s>>>(
      (const unsigned short*)cells, (const float*)wcells,
      (const unsigned*)bucket_start, (const unsigned*)item_start, g,
      item_points, (Acc*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Counts of (row, col) points into the int32 raster out (height x width
// at row0, col0); valid may be null. The geometry comes from
// ops/partitioned.py's plan: sub-blocks of side x side cells, sub_cols
// per row and buckets in all; passes 1 and 3 on a (groups, chunks) grid
// of group_buckets buckets and per_chunk points; pass 4 on items_max
// blocks of at most item_points points. Scratch: bucket_count (buckets),
// chunk_base (chunks x buckets), bucket_start and item_start (buckets + 1
// each), cells (n uint16, 16-byte aligned, with room for the
// kCellVec - 1 cells that pass 4's aligned loads read past n). The
// raster and bucket_count are zeroed here.
extern "C" int hm_window_bucketed_counts(
    const void* row, const void* col, const void* valid, long long n,
    int row0, int col0, int height, int width, int side, int sub_cols,
    int buckets, int group_buckets, int groups, int chunks,
    long long per_chunk, int item_points, long long items_max,
    void* bucket_count, void* chunk_base, void* bucket_start,
    void* item_start, void* cells, void* out, void* stream) {
  return launch<int>(row, col, valid, nullptr, n, row0, col0, height, width,
                     side, sub_cols, buckets, group_buckets, groups, chunks,
                     per_chunk, item_points, items_max, bucket_count,
                     chunk_base, bucket_start, item_start, cells, nullptr,
                     out, stream);
}

// Float32 weights (n, not null) summed into the float32 raster out, on
// the same plan; wcells is scratch for n float32 weights (16-byte
// aligned, with the same kCellVec - 1 elements of room past n as cells).
extern "C" int hm_window_bucketed_weighted(
    const void* row, const void* col, const void* valid, const void* weights,
    long long n, int row0, int col0, int height, int width, int side,
    int sub_cols, int buckets, int group_buckets, int groups, int chunks,
    long long per_chunk, int item_points, long long items_max,
    void* bucket_count, void* chunk_base, void* bucket_start,
    void* item_start, void* cells, void* wcells, void* out, void* stream) {
  return launch<float>(row, col, valid, weights, n, row0, col0, height,
                       width, side, sub_cols, buckets, group_buckets, groups,
                       chunks, per_chunk, item_points, items_max,
                       bucket_count, chunk_base, bucket_start, item_start,
                       cells, wcells, out, stream);
}
