// Segmented sums for the port's HashAggregation: segmented_sum (float32)
// and segmented_int_sum (int32, wrapping at 2^31), one template for both.
//
// Replaces: src/repro/kernels/segmented_agg.py, segmented_sum (:80) and
// segmented_int_sum (:131). The TPU has no atomics, so those kernels turn
// the scatter-add into a one-hot matmul on the MXU and carry each group
// slab's sum through a sequential grid. Hopper's blocks run in parallel and
// in no order, and it has fast atomics, so this kernel scatters instead.
//
// Bound: bytes. Each row reads a 4-byte group id and a 4-byte value (8 B per
// row; the output is G values); the arithmetic is one add per row. At the
// main path's shapes (1 << 20 rows, G = 16) the floor is 8 MiB over the
// card's memory rate.
//
// Design, against that bound and against atomic contention:
// * A grid-stride loop, one row per thread per step, so loads coalesce.
// * Each warp first folds runs of equal consecutive ids with a segmented
//   shuffle reduction. The engine hands ids sorted by group, so a warp
//   usually issues one atomic per step instead of 32 to the same address.
// * With G <= 8192 (32 KB of 4-byte partials) the run totals go to per-block
//   partials in shared memory with shared atomics; at the end the block adds
//   one global atomic per group whose partial is not zero. Larger G adds the
//   run totals to global memory directly.
// * Ids outside [0, G) are dropped, as in the reference. Integer sums are
//   taken in unsigned arithmetic, so they wrap in two's complement and do
//   not depend on order: the int path is bit-exact. Float sums are added in
//   a different order on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 4;
constexpr int kSharedGroups = 8192;
constexpr unsigned kFullMask = 0xffffffffu;

// accumulator type: float for float sums, unsigned for wrapping int sums
template <typename T> struct Acc;
template <> struct Acc<float> { using type = float; };
template <> struct Acc<int> { using type = unsigned int; };

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
segmented_sum_kernel(const int* __restrict__ gids, const T* __restrict__ vals,
                     long long n, int num_groups, T* __restrict__ out) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* part = reinterpret_cast<A*>(smem_raw);
  A* gout = reinterpret_cast<A*>(out);
  if (kShared) {
    for (int g = threadIdx.x; g < num_groups; g += blockDim.x) part[g] = A(0);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // every lane of a warp shares `base`, so all 32 run the same number of
  // steps and the shuffles below always see the full warp
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    int g = -1;
    A v = A(0);
    if (i < n) {
      g = gids[i];
      v = static_cast<A>(vals[i]);
    }
    // runs of equal consecutive ids: the head lane of each run ends up
    // holding the run's total
    const int gprev = __shfl_up_sync(kFullMask, g, 1);
    const bool head = (lane == 0) || (g != gprev);
    const unsigned heads = __ballot_sync(kFullMask, head);
    const unsigned later = (lane == 31) ? 0u : (heads & (~0u << (lane + 1)));
    const int end = later ? (__ffs(later) - 2) : 31;   // last lane of my run
    for (int off = 1; off < 32; off <<= 1) {
      const A o = __shfl_down_sync(kFullMask, v, off);
      if (lane + off <= end) v = v + o;
    }
    if (head && (unsigned)g < (unsigned)num_groups) {
      if (kShared) atomicAdd(&part[g], v);
      else atomicAdd(&gout[g], v);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int g = threadIdx.x; g < num_groups; g += blockDim.x) {
      const A v = part[g];
      if (v != A(0)) atomicAdd(&gout[g], v);
    }
  }
}

template <typename T>
int launch(const void* gids, const void* vals, long long n, int num_groups,
           void* out, void* stream) {
  if (n <= 0 || num_groups <= 0) return 0;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gids);
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  if (num_groups <= kSharedGroups) {
    const size_t smem = (size_t)num_groups * sizeof(T);
    segmented_sum_kernel<T, true><<<blocks, kThreads, smem, s>>>(g, v, n, num_groups, o);
  } else {
    segmented_sum_kernel<T, false><<<blocks, kThreads, 0, s>>>(g, v, n, num_groups, o);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out must hold num_groups zeros; the sums are added onto it.
extern "C" int segmented_sum_f32(const void* gids, const void* vals, long long n,
                                 int num_groups, void* out, void* stream) {
  return launch<float>(gids, vals, n, num_groups, out, stream);
}

extern "C" int segmented_sum_i32(const void* gids, const void* vals, long long n,
                                 int num_groups, void* out, void* stream) {
  return launch<int>(gids, vals, n, num_groups, out, stream);
}

extern "C" const char* segmented_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
