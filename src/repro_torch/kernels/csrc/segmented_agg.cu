// Segmented aggregates for the port's HashAggregation: segmented_sum
// (float32) and segmented_int_sum (int32, wrapping at 2^31), one template
// for both, and segmented_minmax (float32 or int32, min or max) at the end
// of this file.
//
// Replaces: src/repro/kernels/segmented_agg.py, segmented_sum (:80) and
// segmented_int_sum (:131). The TPU has no atomics, so those kernels turn
// the scatter-add into a one-hot matmul on the MXU and carry each group
// slab's sum through a sequential grid. Hopper's blocks run in parallel and
// in no order, and it has fast atomics, so this kernel folds runs of equal
// ids and scatters their sums.
//
// Bound: bytes. The function must read every 4-byte id, the 4-byte value
// of every row whose id is in [0, G), and write the G results once (the
// wrapper's zero fill and the adds): n * 4 + n_live * 4 + G * 4 bytes. The
// engine's calls are sorted ids with a tail of dead rows: HashAggregation
// re-aggregates its 2^23-slot accumulator with each batch (n = 2^24 rows,
// most of them dead), and batched serving hands unsorted stacked ids.
//
// Design, against that bound:
// * Rows are read as 4-row chunks, one 16-byte load of ids a thread and,
//   only where a chunk holds a live id, one 16-byte load of values. A
//   chunk whose ids are all outside [0, G) costs no value load, which
//   halves the bytes of a merge. Chunks follow the ids' 16-byte alignment:
//   the first chunk starts up to 3 rows before row 0 (a view at a row
//   offset) and the last may end past n; those two, and every chunk whose
//   values are aligned differently from its ids, load row by row.
// * A warp step is 32 chunks, 128 rows. The grid is persistent (resident
//   CTAs x SMs, from the occupancy API, computed once). The steps are cut
//   into ranges of up to 8 steps (1024 rows, a CTA tile's worth) and the
//   ranges dealt to the warps in turn: a sorted input's live rows, all at
//   its head, spread over many warps. With fewer rows than warps x 1024, a
//   range is cut shorter, down to 2 steps, so that every warp has one. A
//   warp issues the id loads of two steps, then their value loads, before
//   it folds the first, and runs with no barrier; where the two steps hold
//   no live id (a merge's dead tail) it goes on to the next two.
// * Dead rows belong to no run: runs are runs of equal ids among the live
//   rows, so a sorted run interrupted by dead rows is still one run. A
//   thread folds its 4 rows in registers (a run between the chunk's first
//   and last is added at once). A warp joins its 32 chunks by a segmented
//   scan over the chunks' last runs; a run that ends inside the step is
//   added by the lane where it ends. The step's first and last runs join
//   the range's, kept in registers from step to step, and are added when
//   the range ends. A sorted run costs one add per range that holds it.
// * An add is an atomic whose result is unused (a reduction). With G <=
//   8192 (32 KB of 4-byte partials) the adds go to per-CTA partials in
//   shared memory, and each resident CTA adds its nonzero partials to the
//   output at its end; larger G adds to the output directly.
// * Ids outside [0, G) are dropped, negative ones included. Integer sums
//   are taken in unsigned arithmetic, so they wrap in two's complement and
//   do not depend on order: the int path is bit-exact. Float sums are added
//   in another order than the plain version's.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 4;     // segmented_minmax's grid
constexpr int kSharedGroups = 8192;
constexpr unsigned kFullMask = 0xffffffffu;

// the sums' partition: a thread's chunk of rows, a warp's step of 32
// chunks, the steps a warp loads before it folds the first, the most steps
// a warp's range holds
constexpr int kChunkRows = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kStepsAhead = 2;
constexpr int kRangeSteps = 8;

// accumulator type: float for float sums, unsigned for wrapping int sums
template <typename T> struct Acc;
template <> struct Acc<float> { using type = float; };
template <> struct Acc<int> { using type = unsigned int; };

// The runs of a range of rows, live rows only: the first run's id and sum,
// the last run's, and whether the range is one run (then first == last).
template <typename A>
struct Runs {
  int fk, lk;
  A fs, ls;
  bool one;
};

template <typename A, bool kShared>
__device__ __forceinline__ void add_run(int key, A sum, A* part, A* out) {
  if (kShared) atomicAdd(&part[key], sum);
  else atomicAdd(&out[key], sum);
}

__device__ __forceinline__ int live_or_dead(int g, int num_groups) {
  return (unsigned)g < (unsigned)num_groups ? g : -1;
}

// The ids of the chunk whose first row is r0, a dead or absent row as -1.
__device__ __forceinline__ int4 load_ids(const int* __restrict__ gids,
                                         long long r0, long long n,
                                         int num_groups) {
  int4 g;
  if (r0 >= 0 && r0 + kChunkRows <= n) {
    g = __ldcs(reinterpret_cast<const int4*>(gids + r0));
  } else {
    // the head (a base that is not 16-byte aligned) or the tail (n % 4
    // rows): rows lo .. hi - 1 of the chunk exist
    const long long lo = -r0;
    const long long hi = n - r0;
    g.x = (0 >= lo && 0 < hi) ? __ldcs(gids + r0 + 0) : -1;
    g.y = (1 >= lo && 1 < hi) ? __ldcs(gids + r0 + 1) : -1;
    g.z = (2 >= lo && 2 < hi) ? __ldcs(gids + r0 + 2) : -1;
    g.w = (3 >= lo && 3 < hi) ? __ldcs(gids + r0 + 3) : -1;
  }
  g.x = live_or_dead(g.x, num_groups);
  g.y = live_or_dead(g.y, num_groups);
  g.z = live_or_dead(g.z, num_groups);
  g.w = live_or_dead(g.w, num_groups);
  return g;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const int* p, unsigned v[4]) {
  const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// The values of a chunk's live rows (0 elsewhere); none for a dead chunk.
// `vec`: the values share the ids' alignment, so a full chunk is one load.
template <typename T, typename A>
__device__ __forceinline__ void load_vals(const T* __restrict__ vals,
                                          long long r0, long long n, bool vec,
                                          int4 g, A v[4]) {
  v[0] = v[1] = v[2] = v[3] = A(0);
  if ((g.x & g.y & g.z & g.w) < 0) return;   // all four dead: no load
  if (vec && r0 >= 0 && r0 + kChunkRows <= n) {
    load4(vals + r0, v);
  } else {
    if (g.x >= 0) v[0] = static_cast<A>(__ldcs(vals + r0 + 0));
    if (g.y >= 0) v[1] = static_cast<A>(__ldcs(vals + r0 + 1));
    if (g.z >= 0) v[2] = static_cast<A>(__ldcs(vals + r0 + 2));
    if (g.w >= 0) v[3] = static_cast<A>(__ldcs(vals + r0 + 3));
  }
}

// A thread's chunk folded in registers: the runs of its live rows, a run
// between the first and the last added at once. Returns false when no row
// is live.
template <typename A, bool kShared>
__device__ __forceinline__ bool fold_chunk(int4 g4, const A v[4], Runs<A>& r,
                                           A* part, A* out) {
  const int g[4] = {g4.x, g4.y, g4.z, g4.w};
  bool have = false;
  r.fk = r.lk = -1;
  r.fs = r.ls = A(0);
  r.one = true;
#pragma unroll
  for (int k = 0; k < kChunkRows; ++k) {
    if (g[k] < 0) continue;
    if (!have) {
      have = true;
      r.fk = r.lk = g[k];
      r.ls = v[k];
    } else if (g[k] == r.lk) {
      r.ls += v[k];
    } else {
      if (r.one) {
        r.fs = r.ls;
        r.one = false;
      } else {
        add_run<A, kShared>(r.lk, r.ls, part, out);
      }
      r.lk = g[k];
      r.ls = v[k];
    }
  }
  if (r.one) r.fs = r.ls;
  return have;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

__device__ __forceinline__ unsigned warp_sum(unsigned x) {
  return __reduce_add_sync(kFullMask, x);
}

// A warp step's 32 chunks joined, in lane order: every run that ends
// inside the step and does not hold its first live row is added here.
// Returns false when no lane has a live row, else the joined first and
// last runs in `w`, the same in every lane (lane 0's sums are the ones
// added).
template <typename A, bool kShared>
__device__ __forceinline__ bool fold_warp(bool have, Runs<A> r, int lane,
                                          Runs<A>& w, A* part, A* out) {
  const unsigned live = __ballot_sync(kFullMask, have);
  if (live == 0) return false;
  if (live != kFullMask) {
    // a lane with no live row continues the nearest live lane before it
    // (its last id), else the one after it (its first id), with sum 0
    const unsigned before = live & ((1u << lane) - 1u);
    const unsigned after = live & ~((2u << lane) - 1u);
    const int kb = __shfl_sync(kFullMask, r.lk, before ? 31 - __clz(before) : 0);
    const int ka = __shfl_sync(kFullMask, r.fk, after ? __ffs(after) - 1 : 0);
    if (!have) {
      r.fk = r.lk = before ? kb : ka;
      r.fs = r.ls = A(0);
      r.one = true;
    }
  }
  const int k0 = __shfl_sync(kFullMask, r.fk, 0);
  if (__all_sync(kFullMask, r.one && r.fk == k0)) {
    // one run over all 32 lanes (a sorted run longer than the step)
    const A s = warp_sum(r.ls);
    w = Runs<A>{k0, k0, s, s, true};
    return true;
  }
  // segmented inclusive scan over the lanes' last runs: a lane that is one
  // run of the id its predecessor ended with continues its segment
  const int prev_lk = __shfl_up_sync(kFullMask, r.lk, 1);
  const int next_fk = __shfl_down_sync(kFullMask, r.fk, 1);
  const bool joins = lane > 0 && prev_lk == r.fk;
  const unsigned heads = __ballot_sync(kFullMask, !(joins && r.one));
  const int start = 31 - __clz(heads & ((2u << lane) - 1u));
  A s = r.ls;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const A o = __shfl_up_sync(kFullMask, s, off);
    if (lane - off >= start) s += o;
  }
  const A s_prev = __shfl_up_sync(kFullMask, s, 1);
  const int start_prev = __shfl_up_sync(kFullMask, start, 1);
  const bool one0 = __shfl_sync(kFullMask, (int)r.one, 0);
  // the run of my last row ends in my lane
  const bool ends = lane == 31 || next_fk != r.lk;
  // the lane where the first run (from lane 0's first live row) ends
  // holds it; lane 31 holds the last
  bool holds_first = false;
  A first = A(0);
  if (!r.one) {
    const A e = r.fs + (joins ? s_prev : A(0));
    if (lane == 0 || (joins && start_prev == 0 && one0)) {
      holds_first = true;
      first = e;
    } else {
      add_run<A, kShared>(r.fk, e, part, out);
    }
    if (lane != 31 && ends) add_run<A, kShared>(r.lk, s, part, out);
  } else if (ends) {
    if (start == 0 && one0) {
      holds_first = true;
      first = s;
    } else if (lane != 31) {
      add_run<A, kShared>(r.lk, s, part, out);
    }
  }
  // (all 32 lanes one run took the path above, so the first run is not
  // the last)
  const int src = __ffs(__ballot_sync(kFullMask, holds_first)) - 1;
  w.fk = __shfl_sync(kFullMask, r.fk, src);
  w.fs = __shfl_sync(kFullMask, first, src);
  w.lk = __shfl_sync(kFullMask, r.lk, 31);
  w.ls = __shfl_sync(kFullMask, s, 31);
  w.one = false;
  return true;
}

// The runs so far (`acc`, none while `open` is false) followed by the next
// runs (`next`), in every lane alike: a run that becomes interior is added
// by lane 0; the first run is held, the last stays open.
template <typename A, bool kShared>
__device__ __forceinline__ void join_runs(bool& open, Runs<A>& acc,
                                          const Runs<A>& next, int lane,
                                          A* part, A* out) {
  if (!open) {
    open = true;
    acc = next;
  } else if (acc.lk == next.fk) {
    const A joined = acc.ls + next.fs;
    if (acc.one && next.one) {
      acc.fs = acc.ls = joined;
    } else if (acc.one) {
      acc = Runs<A>{acc.fk, next.lk, joined, next.ls, false};
    } else if (next.one) {
      acc.ls = joined;
    } else {
      if (lane == 0) add_run<A, kShared>(acc.lk, joined, part, out);
      acc.lk = next.lk;
      acc.ls = next.ls;
    }
  } else {
    // acc's last run ends; it is interior unless it is acc's first
    if (!acc.one && lane == 0) add_run<A, kShared>(acc.lk, acc.ls, part, out);
    if (!next.one && lane == 0) add_run<A, kShared>(next.fk, next.fs, part, out);
    acc.one = false;
    acc.lk = next.lk;
    acc.ls = next.ls;
  }
}

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
  // chunk c holds rows 4c - a .. 4c - a + 3, a = the ids' rows before their
  // first 16-byte boundary; step s holds chunks 32s .. 32s + 31
  const int a = (int)((reinterpret_cast<uintptr_t>(gids) >> 2) & 3);
  const bool vec = (int)((reinterpret_cast<uintptr_t>(vals) >> 2) & 3) == a;
  const long long chunks = (n + a + kChunkRows - 1) / kChunkRows;
  const long long steps = (chunks + 31) / 32;
  const long long warps = (long long)gridDim.x * kWarps;
  long long range = (steps + warps - 1) / warps;
  range = (range + kStepsAhead - 1) / kStepsAhead * kStepsAhead;
  if (range > kRangeSteps) range = kRangeSteps;
  const int lane = threadIdx.x & 31;
  for (long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       k * range < steps; k += warps) {
    const long long s_end = (k + 1) * range < steps ? (k + 1) * range : steps;
    bool open = false;
    Runs<A> acc{-1, -1, A(0), A(0), true};
    for (long long st = k * range; st < s_end; st += kStepsAhead) {
      int4 g[kStepsAhead];
      A v[kStepsAhead][kChunkRows];
      long long r0[kStepsAhead];
      int dead = -1;
#pragma unroll
      for (int u = 0; u < kStepsAhead; ++u) {
        r0[u] = ((st + u) * 32 + lane) * kChunkRows - a;
        g[u] = st + u < s_end ? load_ids(gids, r0[u], n, num_groups)
                              : make_int4(-1, -1, -1, -1);
        dead &= g[u].x & g[u].y & g[u].z & g[u].w;
      }
      // no live id in the warp's steps (a merge's dead tail): nothing to do
      if (__all_sync(kFullMask, dead < 0)) continue;
#pragma unroll
      for (int u = 0; u < kStepsAhead; ++u)
        load_vals<T, A>(vals, r0[u], n, vec, g[u], v[u]);
#pragma unroll
      for (int u = 0; u < kStepsAhead; ++u) {
        Runs<A> r, w;
        const bool have = fold_chunk<A, kShared>(g[u], v[u], r, part, gout);
        if (fold_warp<A, kShared>(have, r, lane, w, part, gout))
          join_runs<A, kShared>(open, acc, w, lane, part, gout);
      }
    }
    // the range's first and last runs
    if (open && lane == 0) {
      add_run<A, kShared>(acc.fk, acc.fs, part, gout);
      if (!acc.one) add_run<A, kShared>(acc.lk, acc.ls, part, gout);
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

// resident CTAs of a kernel variant on the card, computed once
template <typename T, bool kShared>
int resident_blocks() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const size_t smem = kShared ? (size_t)kSharedGroups * sizeof(T) : 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, segmented_sum_kernel<T, kShared>, kThreads, smem) !=
        cudaSuccess) {
      (void)cudaGetLastError();
      per_sm = 1;
    }
    return (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 132);
  }();
  return blocks;
}

template <typename T>
int launch(const void* gids, const void* vals, long long n, int num_groups,
           void* out, void* stream) {
  if (n <= 0 || num_groups <= 0) return 0;
  // a CTA for every 1024 rows, at most the resident ones
  const long long a = (long long)((reinterpret_cast<uintptr_t>(gids) >> 2) & 3);
  const long long tiles = ((n + a + kChunkRows - 1) / kChunkRows + kThreads - 1)
                          / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gids);
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  if (num_groups <= kSharedGroups) {
    const long long most = resident_blocks<T, true>();
    const int blocks = (int)(tiles < most ? tiles : most);
    const size_t smem = (size_t)num_groups * sizeof(T);
    segmented_sum_kernel<T, true><<<blocks, kThreads, smem, s>>>(g, v, n, num_groups, o);
  } else {
    const long long most = resident_blocks<T, false>();
    const int blocks = (int)(tiles < most ? tiles : most);
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
