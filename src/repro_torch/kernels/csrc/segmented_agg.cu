// Segmented aggregates for the port's HashAggregation: segmented_sum
// (float32) and segmented_int_sum (int32, wrapping at 2^31), one template
// for both, and segmented_minmax (float32 or int32, min or max) at the end
// of this file.
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
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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

// ---------------------------------------------------------------------------
// segmented_minmax
//
// Replaces: src/repro/kernels/segmented_agg.py, segmented_minmax (:188).
// There each row block was masked onto a one-hot [rows, G-block] slab
// holding the identity off the row's group, reduced with a plain min/max,
// and merged into the output through the sequential grid. Here the design
// of the sums holds, with min/max in place of the add: warp folds of runs of
// equal (sorted) ids with a segmented shuffle, per-block partials in shared
// memory for G <= 8192, then one global atomic per group that a block saw.
//
// Atomics: int32 uses atomicMin/atomicMax. float32 has no native atomic
// min/max, so every value is mapped to an int32 key whose signed order is
// the IEEE total order (bits ^ ((bits >> 31) & 0x7fffffff): negative
// values' magnitude bits flipped), reduced with the integer atomics, and
// mapped back. A NaN becomes the key that wins the reduction (INT_MIN for
// min, INT_MAX for max), and both keys map back to a NaN, so a NaN in a
// group propagates as jnp.minimum/jnp.maximum propagate it. -0.0 orders
// below +0.0, so a group that holds both zeros gives -0.0 for min and +0.0
// for max, whatever their order; the reference gives the same on the CPU
// (tests/test_torch_minmax_compact.py holds it bit for bit). TPC-H's one
// grouped min/max, Q2's min of ps_supplycost (1.00 and up), holds no zero.
// The result does not depend on the order in which atomics land:
// bit-exact against the plain version.
//
// Bound: bytes, as for the sums: 8 B a row in, the G results out.
// ---------------------------------------------------------------------------

namespace {

__device__ __forceinline__ int f32_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_f32(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

template <bool kFloat, bool kMin>
__device__ __forceinline__ int minmax_key(const void* vals, long long i) {
  if (kFloat) {
    const float x = static_cast<const float*>(vals)[i];
    if (x != x) return kMin ? INT_MIN : INT_MAX;
    return f32_key(x);
  }
  return static_cast<const int*>(vals)[i];
}

template <bool kMin>
__device__ __forceinline__ int pick(int a, int b) {
  return kMin ? (b < a ? b : a) : (b > a ? b : a);
}

template <bool kMin>
__device__ __forceinline__ void atomic_pick(int* p, int v) {
  if (kMin) atomicMin(p, v);
  else atomicMax(p, v);
}

template <bool kFloat, bool kMin, bool kShared>
__global__ void __launch_bounds__(kThreads)
segmented_minmax_kernel(const int* __restrict__ gids, const void* __restrict__ vals,
                        long long n, int num_groups, int ident,
                        int* __restrict__ out_keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* part = reinterpret_cast<int*>(smem_raw);
  if (kShared) {
    for (int g = threadIdx.x; g < num_groups; g += blockDim.x) part[g] = ident;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    int g = -1;
    int v = ident;
    if (i < n) {
      g = gids[i];
      v = minmax_key<kFloat, kMin>(vals, i);
    }
    const int gprev = __shfl_up_sync(kFullMask, g, 1);
    const bool head = (lane == 0) || (g != gprev);
    const unsigned heads = __ballot_sync(kFullMask, head);
    const unsigned later = (lane == 31) ? 0u : (heads & (~0u << (lane + 1)));
    const int end = later ? (__ffs(later) - 2) : 31;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_down_sync(kFullMask, v, off);
      if (lane + off <= end) v = pick<kMin>(v, o);
    }
    if (head && (unsigned)g < (unsigned)num_groups) {
      if (kShared) atomic_pick<kMin>(&part[g], v);
      else atomic_pick<kMin>(&out_keys[g], v);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int g = threadIdx.x; g < num_groups; g += blockDim.x) {
      const int v = part[g];
      if (v != ident) atomic_pick<kMin>(&out_keys[g], v);
    }
  }
}

__global__ void fill_kernel(int* __restrict__ out, int n, int value) {
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n;
       g += gridDim.x * blockDim.x) {
    out[g] = value;
  }
}

__global__ void keys_to_f32_kernel(int* __restrict__ out, int n) {
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n;
       g += gridDim.x * blockDim.x) {
    out[g] = __float_as_int(key_f32(out[g]));
  }
}

int host_f32_key(float x) {
  int b;
  memcpy(&b, &x, sizeof(b));
  return b ^ ((b >> 31) & 0x7fffffff);
}

template <bool kFloat, bool kMin>
int launch_minmax(const void* gids, const void* vals, long long n,
                  int num_groups, void* out, void* stream) {
  if (num_groups <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int ident;
  if (kFloat) ident = host_f32_key(kMin ? INFINITY : -INFINITY);
  else ident = kMin ? INT_MAX : INT_MIN;
  int* keys = static_cast<int*>(out);
  const int gblocks = (num_groups + kThreads - 1) / kThreads;
  const int small = gblocks < kMaxBlocks ? gblocks : kMaxBlocks;
  fill_kernel<<<small, kThreads, 0, s>>>(keys, num_groups, ident);
  if (n > 0) {
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
    const int* g = static_cast<const int*>(gids);
    if (num_groups <= kSharedGroups) {
      segmented_minmax_kernel<kFloat, kMin, true>
          <<<blocks, kThreads, (size_t)num_groups * sizeof(int), s>>>(
              g, vals, n, num_groups, ident, keys);
    } else {
      segmented_minmax_kernel<kFloat, kMin, false>
          <<<blocks, kThreads, 0, s>>>(g, vals, n, num_groups, ident, keys);
    }
  }
  if (kFloat) keys_to_f32_kernel<<<small, kThreads, 0, s>>>(keys, num_groups);
  return (int)cudaGetLastError();
}

}  // namespace

// out: num_groups values of the values' type, overwritten: each group's
// min (is_min != 0) or max, the identity (+-inf, INT_MAX/INT_MIN) where a
// group has no row.
extern "C" int segmented_minmax_f32(const void* gids, const void* vals, long long n,
                                    int num_groups, int is_min, void* out,
                                    void* stream) {
  return is_min ? launch_minmax<true, true>(gids, vals, n, num_groups, out, stream)
                : launch_minmax<true, false>(gids, vals, n, num_groups, out, stream);
}

extern "C" int segmented_minmax_i32(const void* gids, const void* vals, long long n,
                                    int num_groups, int is_min, void* out,
                                    void* stream) {
  return is_min ? launch_minmax<false, true>(gids, vals, n, num_groups, out, stream)
                : launch_minmax<false, false>(gids, vals, n, num_groups, out, stream);
}

extern "C" const char* segmented_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
