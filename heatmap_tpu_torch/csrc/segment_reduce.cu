// Segmented reduce of a sorted int64 key stream: the cascade's per-level
// reduction in heatmap_tpu_torch.ops.sparse_partitioned.
//
// Replaces heatmap_tpu/ops/sparse_partitioned.py::_segment_kernel (with
// its hosts _channel_path and aggregate_sorted_keys_partitioned). The TPU
// kernel rebuilds counts and keys through one-hot MXU matmuls over 20-bit
// f32 channels; here the reduce is direct int64 arithmetic, exact by
// construction.
//
// What replaced what. The first version ran a head-flag kernel, a
// torch.cumsum of the flags into segment ids, two prefills of the
// outputs and a reduce kernel with one atomic per run: about 40 B of
// traffic per key against the 20 B of the bound, and 2.6x slower than
// torch.unique_consecutive. It is now ONE single-pass scan-and-reduce
// per call plus a small padding epilogue:
//
//   1. Each block takes the next tile of kTile keys from a global
//      atomicAdd counter (never by blockIdx, so a block only ever waits
//      on tiles that are already running). It loads the tile into shared
//      memory with coalesced 16-byte loads; each thread takes kItems
//      consecutive keys from there, plus the key before and after them
//      (the halo), and forms head and tail flags in registers on
//      key(i) = keys[i] >> shift: head = real && key(i) != key(i-1),
//      tail = real && key(i) != key(i+1), with real = key(i) != sentinel.
//      The 16 cascade levels read the one sorted array under a shift.
//   2. The scan carries (heads, last) per thread: the number of heads,
//      and 1 + the position of the latest head. Its operator is (sum,
//      max), because head positions only grow. A block scan in warp
//      shuffles gives each thread its prefix inside the tile.
//   3. Tiles combine by a decoupled look-back (Merrill and Garland): a
//      tile publishes its aggregate, then warp 0 reads up to 32
//      predecessors at a time until it meets one that has published its
//      inclusive prefix, and publishes its own. The flag and both fields
//      are packed in one 64-bit status word, so a status is read and
//      written whole (flag 2 bits | heads 31 | last 31; n < 2^31), and
//      publishing needs no fence.
//   4. Counts need no atomics: the tail lane of a segment knows its
//      segment id (heads so far - 1) and the position of the segment's
//      head (last - 1), so it has unique[seg] = key and counts[seg] =
//      i + 1 - head. The segments that end in a tile are consecutive, so
//      the block stages them in shared memory and stores them coalesced,
//      each slot once. Every slot below min(n_unique, capacity) is
//      written exactly once, and the epilogue writes (sentinel, 0) to the
//      slots from n_unique to capacity. Segments at or past capacity are
//      dropped; n_unique (written by the last tile) counts them all, the
//      overflow signal.
//   5. Weighted (bounded-integer f64 weights, int64 sums): per-thread run
//      sums and one int64 atomicAdd per run piece into sums zeroed by the
//      caller, as before; integer atomics are order-free, so results are
//      byte-identical run to run. A weight outside [0, weight_bound] or
//      not an integer sets *bad, which the caller turns into the
//      n_unique poison.
//
// Bound: HBM bandwidth. Per key 8 B read (16 B weighted), per output slot
// 12 B written (key + count); the status words are 8 B a tile. There is
// no arithmetic to speak of. The look-back spins only while a
// predecessor is still loading its tile. Tiles of 2048 keys (24 KiB of
// shared memory, eight blocks an SM) measured faster on the H100 than
// 4096 (PERF.md).
//
// The kernels allocate nothing and launch on the caller's stream; the
// caller zeroes the status array (and the weighted sums). Each entry
// point returns the cudaError_t of its launches, and refuses a tile size
// other than kTile so the Python planning cannot drift from the kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
// Dynamic shared memory: the padded keys of a tile, then reused for the
// staged outputs (int64 key + int32 count per segment ending there).
constexpr int kSmemBytes = kTile * (int)(sizeof(long long) + sizeof(int));
static_assert(kTile + kTile / kItems <= kTile * 3 / 2,
              "padded keys fit the staging buffer");
static_assert(kSmemBytes <= 48 * 1024, "no opt-in shared memory needed");
constexpr unsigned kFull = 0xffffffffu;

constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kMask31 = (1ull << 31) - 1;

// Heads so far, 1 + the position of the latest head (0: none), and
// (inside a tile only) tails so far.
struct Scan {
  int heads;
  int last;
  int tails;
};

__device__ __forceinline__ Scan combine(Scan a, Scan b) {
  return {a.heads + b.heads, max(a.last, b.last), a.tails + b.tails};
}

__device__ __forceinline__ void publish(unsigned long long* status,
                                        unsigned long long flag, Scan s) {
  const unsigned long long word = flag |
                                  ((unsigned long long)s.heads << 31) |
                                  (unsigned long long)s.last;
  // No fence: a reader uses nothing but this one word, which is stored
  // and loaded whole (volatile, so from L2, never a stale L1 line).
  *reinterpret_cast<volatile unsigned long long*>(status) = word;
}

__device__ __forceinline__ Scan warp_inclusive(Scan v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Scan u{__shfl_up_sync(kFull, v.heads, d),
                 __shfl_up_sync(kFull, v.last, d),
                 __shfl_up_sync(kFull, v.tails, d)};
    if (lane >= d) v = combine(v, u);
  }
  return v;
}

__device__ __forceinline__ Scan warp_reduce(Scan v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v = combine(v, {__shfl_xor_sync(kFull, v.heads, d),
                    __shfl_xor_sync(kFull, v.last, d), 0});
  }
  return v;
}

// The prefix of every tile before `tile`, by warp 0 of the block, after
// the tile has published its aggregate. Lane j reads tile end - 32 + j.
__device__ Scan look_back(const unsigned long long* status, int tile,
                          int lane) {
  Scan excl{0, 0, 0};
  for (int end = tile;; end -= 32) {
    const int idx = end - 32 + lane;
    unsigned long long word = kFlagPrefix;  // before tile 0: empty prefix
    if (idx >= 0) {
      do {
        word = *reinterpret_cast<const volatile unsigned long long*>(
            status + idx);
      } while ((word >> 62) == 0);
    }
    Scan v{(int)((word >> 31) & kMask31), (int)(word & kMask31), 0};
    const unsigned prefixes = __ballot_sync(kFull, (word >> 62) == 2);
    if (prefixes != 0) {
      // Only the tiles from the latest published prefix on count.
      if (lane < 31 - __clz(prefixes)) v = {0, 0, 0};
      return combine(excl, warp_reduce(v));
    }
    excl = combine(excl, warp_reduce(v));
  }
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    segment_kernel(const long long* __restrict__ keys,
                   const double* __restrict__ weights, int n, int shift,
                   long long sentinel, long long capacity,
                   double weight_bound, bool aligned,
                   unsigned long long* __restrict__ status,
                   long long* __restrict__ unique, int* __restrict__ counts,
                   unsigned long long* __restrict__ sums,
                   int* __restrict__ bad, int* __restrict__ n_unique) {
  // kSmemBytes: first the tile's keys (one pad word per kItems, so the
  // threads' row reads are free of bank conflicts), then the outputs of
  // the segments that end in the tile, staged for coalesced stores.
  extern __shared__ long long smem[];
  long long* s_key = smem;
  int* s_count = reinterpret_cast<int*>(smem + kTile);
  __shared__ int s_tile;
  __shared__ long long s_base;
  __shared__ Scan s_warp[kWarps];
  __shared__ Scan s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(status, 1ull);
  __syncthreads();
  const int tile = s_tile;
  unsigned long long* tiles = status + 1;

  // Coalesced load of the tile (16 B a thread where aligned), shifted.
  const long long tile_begin = (long long)tile * kTile;
  const int here = (int)min((long long)kTile, (long long)n - tile_begin);
  if (aligned && here == kTile) {
    // All of a full tile's loads are issued before any is stored, so
    // each thread keeps kItems * 8 bytes in flight.
    const longlong2* p = reinterpret_cast<const longlong2*>(keys + tile_begin);
    longlong2 v[kItems / 2];
#pragma unroll
    for (int r = 0; r < kItems / 2; ++r) {
      v[r] = __ldg(p + threadIdx.x + r * kThreads);
    }
#pragma unroll
    for (int r = 0; r < kItems / 2; ++r) {
      const int x = 2 * (threadIdx.x + r * kThreads);
      const int at = x + x / kItems;
      smem[at] = v[r].x >> shift;
      smem[at + 1] = v[r].y >> shift;
    }
  } else if (aligned) {
    const longlong2* p = reinterpret_cast<const longlong2*>(keys + tile_begin);
    for (int x = threadIdx.x; 2 * x + 1 < here; x += kThreads) {
      const longlong2 v = __ldg(p + x);
      const int at = 2 * x + (2 * x) / kItems;
      smem[at] = v.x >> shift;
      smem[at + 1] = v.y >> shift;
    }
    if ((here & 1) && threadIdx.x == 0) {
      smem[here - 1 + (here - 1) / kItems] =
          __ldg(keys + tile_begin + here - 1) >> shift;
    }
  } else {
    for (int x = threadIdx.x; x < here; x += kThreads) {
      smem[x + x / kItems] = __ldg(keys + tile_begin + x) >> shift;
    }
  }
  __syncthreads();

  const long long begin = tile_begin + threadIdx.x * kItems;
  const int m = max(0, min(kItems, here - (int)threadIdx.x * kItems));
  long long k[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    k[j] = j < m ? smem[threadIdx.x * (kItems + 1) + j] : 0;
  }
  const long long before = (m > 0 && begin > 0)
                               ? __ldg(keys + begin - 1) >> shift
                               : 0;
  const long long after = (begin + kItems < n)
                              ? __ldg(keys + begin + kItems) >> shift
                              : 0;

  unsigned heads = 0, tails = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < m && k[j] != sentinel) {
      const long long i = begin + j;
      const long long prev = j > 0 ? k[j - 1] : before;
      const long long next = j + 1 < kItems ? k[j + 1] : after;
      if (i == 0 || k[j] != prev) heads |= 1u << j;
      if (i + 1 == n || k[j] != next) tails |= 1u << j;
    }
  }
  const Scan mine{__popc(heads),
                  heads ? (int)(begin + 31 - __clz(heads)) + 1 : 0,
                  __popc(tails)};

  // Block scan: this thread's prefix inside the tile, and the tile total.
  // Its barriers also end every thread's reads of the staged keys.
  const Scan inc = warp_inclusive(mine, lane);
  Scan excl{__shfl_up_sync(kFull, inc.heads, 1),
            __shfl_up_sync(kFull, inc.last, 1),
            __shfl_up_sync(kFull, inc.tails, 1)};
  if (lane == 0) excl = {0, 0, 0};
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const Scan w = warp_inclusive(
        lane < kWarps ? s_warp[lane] : Scan{0, 0, 0}, lane);
    // Lane kWarps - 1 holds the tile's total.
    const Scan agg{__shfl_sync(kFull, w.heads, kWarps - 1),
                   __shfl_sync(kFull, w.last, kWarps - 1),
                   __shfl_sync(kFull, w.tails, kWarps - 1)};
    Scan prefix{0, 0, 0};
    if (tile == 0) {
      if (lane == 0) publish(tiles, kFlagPrefix, agg);
    } else {
      if (lane == 0) publish(tiles + tile, kFlagAggregate, agg);
      prefix = look_back(tiles, tile, lane);
      if (lane == 0) publish(tiles + tile, kFlagPrefix, combine(prefix, agg));
    }
    if (lane == 0) {
      s_prefix = {prefix.heads, prefix.last, agg.tails};
      const int n_tiles = (int)(((long long)n + kTile - 1) / kTile);
      if (tile == n_tiles - 1) *n_unique = prefix.heads + agg.heads;
    }
    // s_warp[j] becomes the exclusive prefix of warp j inside the tile.
    const Scan w_excl{__shfl_up_sync(kFull, w.heads, 1),
                      __shfl_up_sync(kFull, w.last, 1),
                      __shfl_up_sync(kFull, w.tails, 1)};
    if (lane < kWarps) s_warp[lane] = lane == 0 ? Scan{0, 0, 0} : w_excl;
  }
  __syncthreads();
  const Scan tile_prefix{s_prefix.heads, s_prefix.last, 0};
  const int tile_tails = s_prefix.tails;
  Scan run = combine(combine(tile_prefix, s_warp[warp]), excl);

  // The segments that end in this tile are consecutive: stage each one's
  // key (and count) at its rank among the tile's tails.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = (int)(begin + j);
    if (heads >> j & 1u) run = {run.heads + 1, i + 1, run.tails};
    if (tails >> j & 1u) {
      const int rank = run.tails++;
      if (rank == 0) s_base = run.heads - 1;
      s_key[rank] = k[j];
      if constexpr (!kWeighted) s_count[rank] = i + 1 - (run.last - 1);
    }
  }
  if constexpr (kWeighted) {
    run = combine(combine(tile_prefix, s_warp[warp]), excl);
    long long run_seg = -1;
    unsigned long long run_sum = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = (int)(begin + j);
      if (heads >> j & 1u) run = {run.heads + 1, i + 1, 0};
      if (j >= m || k[j] == sentinel) continue;
      const double x = weights[i];
      unsigned long long w = 0;
      // The contract check of the JAX kernel: an integer in
      // [0, weight_bound]. NaN fails the first test.
      if (x == floor(x) && x >= 0.0 && x <= weight_bound) {
        w = (unsigned long long)x;
      } else {
        *bad = 1;
      }
      const long long seg = run.heads - 1;
      if (seg >= capacity) continue;
      if (seg != run_seg) {
        if (run_seg >= 0 && run_sum != 0) atomicAdd(sums + run_seg, run_sum);
        run_seg = seg;
        run_sum = 0;
      }
      run_sum += w;
    }
    if (run_seg >= 0 && run_sum != 0) atomicAdd(sums + run_seg, run_sum);
  }
  __syncthreads();
  const long long base = s_base;
  for (int x = threadIdx.x; x < tile_tails && base + x < capacity;
       x += kThreads) {
    unique[base + x] = s_key[x];
    if constexpr (!kWeighted) counts[base + x] = s_count[x];
  }
}

// Slots from n_unique to capacity: the sentinel key and (counts) zero.
__global__ void pad_kernel(const int* __restrict__ n_unique,
                           long long capacity, long long sentinel,
                           long long* __restrict__ unique,
                           int* __restrict__ counts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = *n_unique + (long long)blockIdx.x * blockDim.x +
                     threadIdx.x;
       s < capacity; s += stride) {
    unique[s] = sentinel;
    if (counts != nullptr) counts[s] = 0;
  }
}

template <bool kWeighted>
int launch(const void* keys, const void* weights, long long n, int shift,
           long long sentinel, long long capacity, double weight_bound,
           int tile_keys, void* status, void* unique, void* counts,
           void* sums, void* bad, void* n_unique, void* stream) {
  if (tile_keys != kTile || n <= 0 || n > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned int tiles = (unsigned int)((n + kTile - 1) / kTile);
  const bool aligned = ((unsigned long long)keys & 15ull) == 0;
  segment_kernel<kWeighted><<<tiles, kThreads, kSmemBytes, s>>>(
      (const long long*)keys, (const double*)weights, (int)n, shift,
      sentinel, capacity, weight_bound, aligned,
      (unsigned long long*)status, (long long*)unique, (int*)counts,
      (unsigned long long*)sums, (int*)bad, (int*)n_unique);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || capacity <= 0) return (int)e;
  long long blocks = (capacity + 255) / 256;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond
  pad_kernel<<<(unsigned int)blocks, 256, 0, s>>>(
      (const int*)n_unique, capacity, sentinel, (long long*)unique,
      kWeighted ? nullptr : (int*)counts);
  return (int)cudaGetLastError();
}

}  // namespace

// Sorted int64 keys -> unique keys, int32 counts and n_unique. status:
// 1 + ceil(n / tile_keys) zeroed int64 words.
extern "C" int hm_segment_reduce_counts(const void* keys, long long n,
                                        int shift, long long sentinel,
                                        long long capacity, int tile_keys,
                                        void* status, void* unique,
                                        void* counts, void* n_unique,
                                        void* stream) {
  return launch<false>(keys, nullptr, n, shift, sentinel, capacity, 0.0,
                       tile_keys, status, unique, counts, nullptr, nullptr,
                       n_unique, stream);
}

// The same with float64 weights -> int64 sums (zeroed by the caller) and
// the contract flag bad (zeroed by the caller).
extern "C" int hm_segment_reduce_weighted(
    const void* keys, const void* weights, long long n, int shift,
    long long sentinel, long long capacity, double weight_bound,
    int tile_keys, void* status, void* unique, void* sums, void* bad,
    void* n_unique, void* stream) {
  return launch<true>(keys, weights, n, shift, sentinel, capacity,
                      weight_bound, tile_keys, status, unique, nullptr, sums,
                      bad, n_unique, stream);
}
