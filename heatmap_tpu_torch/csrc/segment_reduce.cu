// Segmented reduce of a sorted int64 key stream: the cascade's per-level
// reduction in heatmap_tpu_torch.ops.sparse_partitioned.
//
// Replaces heatmap_tpu/ops/sparse_partitioned.py::_segment_kernel (with
// its hosts _channel_path and aggregate_sorted_keys_partitioned). The TPU
// kernel rebuilds counts and keys through one-hot MXU matmuls over 20-bit
// f32 channels; here the reduce is direct int64 arithmetic, exact by
// construction:
//
//   1. hm_segment_heads: flags[i] = key(i) != sentinel &&
//      (i == 0 || key(i) != key(i-1)), with key(i) = keys[i] >> shift, so
//      the 16 cascade levels read the one sorted array and never
//      materialise keys >> 2*level.
//   2. The caller scans flags (torch.cumsum) into seg_incl; lane i's
//      segment is seg_incl[i] - 1.
//   3. hm_segment_reduce_*: each thread walks kItems consecutive lanes,
//      sums locally while the segment stays the same and issues one
//      atomicAdd where a run ends. The head lane of a segment writes
//      unique[seg] = key (one writer, no atomic). Sentinel lanes and
//      lanes with seg >= capacity are dropped. Counts accumulate in int32
//      atomics; bounded-integer weights in int64 atomics (the wrapper
//      casts to f64; sums stay below 2^53, so exact). Integer atomics are
//      order-free: results are byte-identical run to run.
//
// Bound: HBM bandwidth. Per element the reduce reads 8 B of key and 4 B
// of seg (8 B more of weight on the weighted path), and it writes 12 B
// per unique slot (key + count). There is no arithmetic to speak of.
// Atomics fire once per run of a segment inside a thread, not once per
// element, so the hot cells of clustered GPS data see at most one atomic
// per thread that touches them.
//
// Outputs are prefilled by the caller (unique with the shifted sentinel,
// sums with zero); the kernels allocate nothing and launch on the
// caller's stream. Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;

__device__ __forceinline__ long long key_at(const long long* __restrict__ keys,
                                            long long i, int shift) {
  return __ldg(keys + i) >> shift;
}

__global__ void heads_kernel(const long long* __restrict__ keys, long long n,
                             int shift, long long sentinel,
                             int* __restrict__ flags) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long k = key_at(keys, i, shift);
    const bool head =
        k != sentinel && (i == 0 || k != key_at(keys, i - 1, shift));
    flags[i] = head ? 1 : 0;
  }
}

// Accumulator of one run: int32 counts, or int64 bounded-integer weights
// (atomicAdd has an overload for each).
template <bool kWeighted>
using Acc = std::conditional_t<kWeighted, unsigned long long, int>;

template <bool kWeighted>
__global__ void reduce_kernel(const long long* __restrict__ keys,
                              const int* __restrict__ seg_incl,
                              const double* __restrict__ weights, long long n,
                              int shift, long long sentinel,
                              long long capacity, double weight_bound,
                              long long* __restrict__ unique,
                              Acc<kWeighted>* __restrict__ sums,
                              int* __restrict__ bad) {
  using T = Acc<kWeighted>;
  const long long begin =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kItems;
  if (begin >= n) return;
  const long long end = begin + kItems < n ? begin + kItems : n;
  long long prev = begin > 0 ? key_at(keys, begin - 1, shift) : 0;
  long long run_seg = -1;
  T run_sum = 0;
  for (long long i = begin; i < end; ++i) {
    const long long k = key_at(keys, i, shift);
    const bool head = i == 0 || k != prev;
    prev = k;
    if (k == sentinel) continue;
    T w = 1;
    if constexpr (kWeighted) {
      const double x = weights[i];
      // The contract check of the JAX kernel: an integer in
      // [0, weight_bound]. NaN fails the first test.
      if (x == floor(x) && x >= 0.0 && x <= weight_bound) {
        w = (T)x;
      } else {
        *bad = 1;
        w = 0;
      }
    }
    const long long s = (long long)seg_incl[i] - 1;
    if (s >= capacity) continue;
    if (head) unique[s] = k;
    if (s != run_seg) {
      if (run_seg >= 0 && run_sum != 0) atomicAdd(sums + run_seg, run_sum);
      run_seg = s;
      run_sum = 0;
    }
    run_sum += w;
  }
  if (run_seg >= 0 && run_sum != 0) atomicAdd(sums + run_seg, run_sum);
}

unsigned int reduce_blocks(long long n) {
  const long long per_block = (long long)kThreads * kItems;
  return (unsigned int)((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" int hm_segment_heads(const void* keys, long long n, int shift,
                                long long sentinel, void* flags, void* stream) {
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond
    heads_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, n, shift, sentinel, (int*)flags);
  }
  return (int)cudaGetLastError();
}

extern "C" int hm_segment_reduce_counts(const void* keys, const void* seg_incl,
                                        long long n, int shift,
                                        long long sentinel, long long capacity,
                                        void* unique, void* counts,
                                        void* stream) {
  if (n > 0) {
    reduce_kernel<false><<<reduce_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (const int*)seg_incl, nullptr, n, shift,
        sentinel, capacity, 0.0, (long long*)unique, (int*)counts, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int hm_segment_reduce_weighted(
    const void* keys, const void* seg_incl, const void* weights, long long n,
    int shift, long long sentinel, long long capacity, double weight_bound,
    void* unique, void* sums, void* bad, void* stream) {
  if (n > 0) {
    reduce_kernel<true><<<reduce_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)keys, (const int*)seg_incl, (const double*)weights,
        n, shift, sentinel, capacity, weight_bound, (long long*)unique,
        (unsigned long long*)sums, (int*)bad);
  }
  return (int)cudaGetLastError();
}
