// Segmented reductions for the port's HashAggregation: segmented_sum
// (float32), segmented_int_sum (int32, wrapping at 2^31) and
// segmented_minmax (float32 or int32, min or max), one template over the
// combining operation for all three.
//
// Replaces: src/repro/kernels/segmented_agg.py, segmented_sum (:80),
// segmented_int_sum (:131) and segmented_minmax (:188). The TPU has no
// atomics, so those kernels turn the scatter into a one-hot matmul on the
// MXU (sums) or a masked [rows, G-block] slab reduced with a plain min/max,
// and carry each group slab's result through a sequential grid. Hopper's
// blocks run in parallel and in no order, and it has fast atomics, so this
// kernel folds runs of equal ids and scatters their results.
//
// Bound: bytes. The function must read every 4-byte id, the 4-byte value
// of every row whose id is in [0, G), and write the G results once (the
// sums: the wrapper's zero fill and the adds; min/max: the identity fill
// and the updates): n * 4 + n_live * 4 + G * 4 bytes. The engine's calls
// are sorted ids with a tail of dead rows: HashAggregation re-aggregates
// its 2^23-slot accumulator with each batch (n = 2^24 rows, most of them
// dead), Q2's grouped min hands 800,000 rows to 2^20 groups, and batched
// serving hands unsorted stacked ids.
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
//   and last is combined at once). A warp joins its 32 chunks by a
//   segmented scan over the chunks' last runs; a run that ends inside the
//   step is written by the lane where it ends. The step's first and last
//   runs join the range's, kept in registers from step to step, and are
//   written when the range ends. A sorted run costs one update per range
//   that holds it.
// * An update is an atomic whose result is unused (a reduction). With G <=
//   8192 (32 KB of 4-byte partials) the updates go to per-CTA partials in
//   shared memory, set to the identity, and each resident CTA writes its
//   partials that moved to the output at its end; larger G updates the
//   output directly.
// * Ids outside [0, G) are dropped, negative ones included. Integer sums
//   are taken in unsigned arithmetic, so they wrap in two's complement and
//   do not depend on order: the int path is bit-exact. Float sums are added
//   in another order than the plain version's. Min and max do not depend
//   on order: bit-exact.
//
// Min/max (MinMaxOp): int32 folds and updates with atomicMin/atomicMax.
// float32 has no native atomic min/max, so every value is folded as an
// int32 key whose signed order is the IEEE total order (bits ^ ((bits >>
// 31) & 0x7fffffff): negative values' magnitude bits flipped); a NaN
// becomes the key that wins (INT_MIN for min, INT_MAX for max), so a NaN
// in a group propagates as jnp.minimum/jnp.maximum propagate it. Before an
// update of the output the key is mapped back to its float bits (a NaN to
// 0xFFFFFFFF for min, 0x7FFFFFFF for max), and the output, set to the
// identity's bits (+inf, -inf), is updated in place by integer atomics on
// the bits split by sign: the total order is the signed order of the bits
// among non-negative ones, the reverse unsigned order among negative ones,
// and every negative below every non-negative, so for min a non-negative
// bits value goes by atomicMin on int and a negative one by atomicMax on
// unsigned (for max the other two). No pass maps keys back over the G
// outputs. -0.0 orders below +0.0, so a group that holds both zeros gives
// -0.0 for min and +0.0 for max, whatever their order; the reference gives
// the same on the CPU (tests/test_torch_minmax_compact.py holds it bit for
// bit). TPC-H's one grouped min/max, Q2's min of ps_supplycost (1.00 and
// up), holds no zero. The G outputs are written once: the identity by a
// fill kernel of 16-byte stores, then the reduction's updates.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedGroups = 8192;
constexpr unsigned kFullMask = 0xffffffffu;

// the partition: a thread's chunk of rows, a warp's step of 32 chunks, the
// steps a warp loads before it folds the first, the most steps a warp's
// range holds
constexpr int kChunkRows = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kStepsAhead = 2;
constexpr int kRangeSteps = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

__device__ __forceinline__ unsigned warp_sum(unsigned x) {
  return __reduce_add_sync(kFullMask, x);
}

// accumulator type: float for float sums, unsigned for wrapping int sums
template <typename T> struct Acc;
template <> struct Acc<float> { using type = float; };
template <> struct Acc<int> { using type = unsigned int; };

// The combining operation of a reduction: the accumulator type A, its
// identity, a value's accumulator, the fold of two accumulators, a warp's
// fold of 32 lanes, and the update of a per-CTA shared partial and of the
// output (A* over the output's memory).
template <typename T>
struct SumOp {
  using In = T;
  using A = typename Acc<T>::type;
  __device__ static A identity() { return A(0); }
  __device__ static A of(T x) { return static_cast<A>(x); }
  __device__ static A combine(A a, A b) { return a + b; }
  __device__ static A warp_all(A x) { return warp_sum(x); }
  __device__ static void to_shared(A* p, A v) { atomicAdd(p, v); }
  __device__ static void to_out(A* p, A v) { atomicAdd(p, v); }
};

// the key of a float whose signed order is the IEEE total order; a NaN is
// the key that wins
template <bool kMin>
__device__ __forceinline__ int f32_key(float x) {
  if (x != x) return kMin ? INT_MIN : INT_MAX;
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// a key's float bits (the map is its own inverse)
__device__ __forceinline__ int key_bits(int k) { return k ^ ((k >> 31) & 0x7fffffff); }

// min or max: int32 keys (float32 values by f32_key); the output starts
// from out_identity(), the fill's
template <typename T, bool kMin>
struct MinMaxOp {
  using In = T;
  using A = int;
  static constexpr bool kFloat = std::is_same<T, float>::value;
  // +inf's key and -inf's key (bits 0xFF800000 ^ 0x7FFFFFFF)
  __host__ __device__ static constexpr A identity() {
    return kFloat ? (kMin ? 0x7F800000 : (int)0x807FFFFFu) : (kMin ? INT_MAX : INT_MIN);
  }
  // the output's starting bits: +inf or -inf, or the int32 extreme
  __host__ __device__ static constexpr int out_identity() {
    return kFloat ? (kMin ? 0x7F800000 : (int)0xFF800000u) : identity();
  }
  __device__ static A of(T x) {
    if constexpr (kFloat) return f32_key<kMin>(x);
    else return x;
  }
  __device__ static A combine(A a, A b) { return kMin ? (b < a ? b : a) : (b > a ? b : a); }
  __device__ static A warp_all(A x) {
    return kMin ? __reduce_min_sync(kFullMask, x) : __reduce_max_sync(kFullMask, x);
  }
  __device__ static void to_shared(A* p, A v) {
    if (kMin) atomicMin(p, v);
    else atomicMax(p, v);
  }
  __device__ static void to_out(A* p, A v) {
    if (!kFloat) {
      to_shared(p, v);
      return;
    }
    // the total order on the bits: signed among the non-negative, the
    // reverse of unsigned among the negative
    const int bits = key_bits(v);
    unsigned* u = reinterpret_cast<unsigned*>(p);
    if (bits >= 0) {
      if (kMin) atomicMin(p, bits);
      else atomicMax(p, bits);
    } else {
      if (kMin) atomicMax(u, (unsigned)bits);
      else atomicMin(u, (unsigned)bits);
    }
  }
};

// The runs of a range of rows, live rows only: the first run's id and
// result, the last run's, and whether the range is one run (then first ==
// last).
template <typename A>
struct Runs {
  int fk, lk;
  A fs, ls;
  bool one;
};

template <typename Op, bool kShared>
__device__ __forceinline__ void add_run(int key, typename Op::A v,
                                        typename Op::A* part,
                                        typename Op::A* out) {
  if (kShared) Op::to_shared(&part[key], v);
  else Op::to_out(&out[key], v);
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

__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load4(const int* p, int x[4]) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// The values of a chunk's live rows (the identity elsewhere); none for a
// dead chunk. `vec`: the values share the ids' alignment, so a full chunk
// is one load.
template <typename Op>
__device__ __forceinline__ void load_vals(const typename Op::In* __restrict__ vals,
                                          long long r0, long long n, bool vec,
                                          int4 g, typename Op::A v[4]) {
  v[0] = v[1] = v[2] = v[3] = Op::identity();
  if ((g.x & g.y & g.z & g.w) < 0) return;   // all four dead: no load
  if (vec && r0 >= 0 && r0 + kChunkRows <= n) {
    typename Op::In x[4];
    load4(vals + r0, x);
#pragma unroll
    for (int k = 0; k < kChunkRows; ++k) v[k] = Op::of(x[k]);
  } else {
    if (g.x >= 0) v[0] = Op::of(__ldcs(vals + r0 + 0));
    if (g.y >= 0) v[1] = Op::of(__ldcs(vals + r0 + 1));
    if (g.z >= 0) v[2] = Op::of(__ldcs(vals + r0 + 2));
    if (g.w >= 0) v[3] = Op::of(__ldcs(vals + r0 + 3));
  }
}

// A thread's chunk folded in registers: the runs of its live rows, a run
// between the first and the last written at once. Returns false when no
// row is live.
template <typename Op, bool kShared, typename A = typename Op::A>
__device__ __forceinline__ bool fold_chunk(int4 g4, const A v[4], Runs<A>& r,
                                           A* part, A* out) {
  const int g[4] = {g4.x, g4.y, g4.z, g4.w};
  bool have = false;
  r.fk = r.lk = -1;
  r.fs = r.ls = Op::identity();
  r.one = true;
#pragma unroll
  for (int k = 0; k < kChunkRows; ++k) {
    if (g[k] < 0) continue;
    if (!have) {
      have = true;
      r.fk = r.lk = g[k];
      r.ls = v[k];
    } else if (g[k] == r.lk) {
      r.ls = Op::combine(r.ls, v[k]);
    } else {
      if (r.one) {
        r.fs = r.ls;
        r.one = false;
      } else {
        add_run<Op, kShared>(r.lk, r.ls, part, out);
      }
      r.lk = g[k];
      r.ls = v[k];
    }
  }
  if (r.one) r.fs = r.ls;
  return have;
}

// A warp step's 32 chunks joined, in lane order: every run that ends
// inside the step and does not hold its first live row is written here.
// Returns false when no lane has a live row, else the joined first and
// last runs in `w`, the same in every lane (lane 0's results are the ones
// written).
template <typename Op, bool kShared, typename A = typename Op::A>
__device__ __forceinline__ bool fold_warp(bool have, Runs<A> r, int lane,
                                          Runs<A>& w, A* part, A* out) {
  const unsigned live = __ballot_sync(kFullMask, have);
  if (live == 0) return false;
  if (live != kFullMask) {
    // a lane with no live row continues the nearest live lane before it
    // (its last id), else the one after it (its first id), with the
    // identity
    const unsigned before = live & ((1u << lane) - 1u);
    const unsigned after = live & ~((2u << lane) - 1u);
    const int kb = __shfl_sync(kFullMask, r.lk, before ? 31 - __clz(before) : 0);
    const int ka = __shfl_sync(kFullMask, r.fk, after ? __ffs(after) - 1 : 0);
    if (!have) {
      r.fk = r.lk = before ? kb : ka;
      r.fs = r.ls = Op::identity();
      r.one = true;
    }
  }
  const int k0 = __shfl_sync(kFullMask, r.fk, 0);
  if (__all_sync(kFullMask, r.one && r.fk == k0)) {
    // one run over all 32 lanes (a sorted run longer than the step)
    const A s = Op::warp_all(r.ls);
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
    if (lane - off >= start) s = Op::combine(s, o);
  }
  const A s_prev = __shfl_up_sync(kFullMask, s, 1);
  const int start_prev = __shfl_up_sync(kFullMask, start, 1);
  const bool one0 = __shfl_sync(kFullMask, (int)r.one, 0);
  // the run of my last row ends in my lane
  const bool ends = lane == 31 || next_fk != r.lk;
  // the lane where the first run (from lane 0's first live row) ends
  // holds it; lane 31 holds the last
  bool holds_first = false;
  A first = Op::identity();
  if (!r.one) {
    const A e = joins ? Op::combine(r.fs, s_prev) : r.fs;
    if (lane == 0 || (joins && start_prev == 0 && one0)) {
      holds_first = true;
      first = e;
    } else {
      add_run<Op, kShared>(r.fk, e, part, out);
    }
    if (lane != 31 && ends) add_run<Op, kShared>(r.lk, s, part, out);
  } else if (ends) {
    if (start == 0 && one0) {
      holds_first = true;
      first = s;
    } else if (lane != 31) {
      add_run<Op, kShared>(r.lk, s, part, out);
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
// runs (`next`), in every lane alike: a run that becomes interior is
// written by lane 0; the first run is held, the last stays open.
template <typename Op, bool kShared, typename A = typename Op::A>
__device__ __forceinline__ void join_runs(bool& open, Runs<A>& acc,
                                          const Runs<A>& next, int lane,
                                          A* part, A* out) {
  if (!open) {
    open = true;
    acc = next;
  } else if (acc.lk == next.fk) {
    const A joined = Op::combine(acc.ls, next.fs);
    if (acc.one && next.one) {
      acc.fs = acc.ls = joined;
    } else if (acc.one) {
      acc = Runs<A>{acc.fk, next.lk, joined, next.ls, false};
    } else if (next.one) {
      acc.ls = joined;
    } else {
      if (lane == 0) add_run<Op, kShared>(acc.lk, joined, part, out);
      acc.lk = next.lk;
      acc.ls = next.ls;
    }
  } else {
    // acc's last run ends; it is interior unless it is acc's first
    if (!acc.one && lane == 0) add_run<Op, kShared>(acc.lk, acc.ls, part, out);
    if (!next.one && lane == 0) add_run<Op, kShared>(next.fk, next.fs, part, out);
    acc.one = false;
    acc.lk = next.lk;
    acc.ls = next.ls;
  }
}

// The reduction of one launch: every warp's ranges of steps, then (shared
// partials) the CTA's partials that moved written to the output.
template <typename Op, bool kShared>
__device__ __forceinline__ void reduce_rows(const int* __restrict__ gids,
                                            const typename Op::In* __restrict__ vals,
                                            long long n, int num_groups,
                                            typename Op::A* __restrict__ out) {
  using A = typename Op::A;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* part = reinterpret_cast<A*>(smem_raw);
  if (kShared) {
    for (int g = threadIdx.x; g < num_groups; g += blockDim.x) part[g] = Op::identity();
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
    Runs<A> acc{-1, -1, Op::identity(), Op::identity(), true};
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
        load_vals<Op>(vals, r0[u], n, vec, g[u], v[u]);
#pragma unroll
      for (int u = 0; u < kStepsAhead; ++u) {
        Runs<A> r, w;
        const bool have = fold_chunk<Op, kShared>(g[u], v[u], r, part, out);
        if (fold_warp<Op, kShared>(have, r, lane, w, part, out))
          join_runs<Op, kShared>(open, acc, w, lane, part, out);
      }
    }
    // the range's first and last runs
    if (open && lane == 0) {
      add_run<Op, kShared>(acc.fk, acc.fs, part, out);
      if (!acc.one) add_run<Op, kShared>(acc.lk, acc.ls, part, out);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int g = threadIdx.x; g < num_groups; g += blockDim.x) {
      const A v = part[g];
      if (v != Op::identity()) Op::to_out(&out[g], v);
    }
  }
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
segmented_sum_kernel(const int* __restrict__ gids, const T* __restrict__ vals,
                     long long n, int num_groups, T* __restrict__ out) {
  reduce_rows<SumOp<T>, kShared>(gids, vals, n, num_groups,
                                 reinterpret_cast<typename SumOp<T>::A*>(out));
}

template <typename T, bool kMin, bool kShared>
__global__ void __launch_bounds__(kThreads)
segmented_minmax_kernel(const int* __restrict__ gids, const T* __restrict__ vals,
                        long long n, int num_groups, T* __restrict__ out) {
  reduce_rows<MinMaxOp<T, kMin>, kShared>(gids, vals, n, num_groups,
                                          reinterpret_cast<int*>(out));
}

// out[0..n) = value: the words before the first 16-byte boundary, then
// 16-byte stores, then the tail
__global__ void __launch_bounds__(kThreads)
fill_kernel(int* __restrict__ out, long long n, int value) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = (long long)((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4;
  if (head > n) head = n;
  const long long vecs = (n - head) / 4;
  const long long rest = head + vecs * 4;
  if (tid < head) out[tid] = value;
  if (tid < n - rest) out[rest + tid] = value;
  int4* body = reinterpret_cast<int4*>(out + head);
  const int4 v = make_int4(value, value, value, value);
  for (long long i = tid; i < vecs; i += stride) body[i] = v;
}

// the resident CTAs of a kernel with `smem` bytes of shared memory
int resident(const void* kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
      cudaSuccess) {
    (void)cudaGetLastError();
    per_sm = 1;
  }
  return (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 132);
}

// resident() on the current device (the caller runs with its tensors'
// device current), computed once for each device, kernel and size
int resident_on_device(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> most;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(dev, kernel, smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = most.find(key);
  if (it == most.end()) it = most.emplace(key, resident(kernel, smem)).first;
  return it->second;
}

// a CTA for every 1024 rows, at most `most`
int grid_of(const void* gids, long long n, int most) {
  const long long a = (long long)((reinterpret_cast<uintptr_t>(gids) >> 2) & 3);
  const long long tiles = ((n + a + kChunkRows - 1) / kChunkRows + kThreads - 1) / kThreads;
  return (int)(tiles < most ? tiles : most);
}

template <typename T>
int launch(const void* gids, const void* vals, long long n, int num_groups,
           void* out, void* stream) {
  if (n <= 0 || num_groups <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gids);
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  if (num_groups <= kSharedGroups) {
    const int most = resident_on_device((const void*)segmented_sum_kernel<T, true>,
                                        (size_t)kSharedGroups * sizeof(T));
    const size_t smem = (size_t)num_groups * sizeof(T);
    segmented_sum_kernel<T, true><<<grid_of(gids, n, most), kThreads, smem, s>>>(
        g, v, n, num_groups, o);
  } else {
    const int most = resident_on_device((const void*)segmented_sum_kernel<T, false>, 0);
    segmented_sum_kernel<T, false><<<grid_of(gids, n, most), kThreads, 0, s>>>(
        g, v, n, num_groups, o);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kMin>
int launch_minmax(const void* gids, const void* vals, long long n,
                  int num_groups, void* out, void* stream) {
  if (num_groups <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gids);
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  // the identity, 16 bytes a thread a store
  const long long fill_blocks = ((long long)num_groups + 4 * kThreads - 1) / (4 * kThreads);
  const int fill_most = resident_on_device((const void*)fill_kernel, 0);
  const int ident = MinMaxOp<T, kMin>::out_identity();
  fill_kernel<<<(int)(fill_blocks < fill_most ? fill_blocks : fill_most), kThreads, 0, s>>>(
      static_cast<int*>(out), num_groups, ident);
  if (n > 0) {
    if (num_groups <= kSharedGroups) {
      const int most = resident_on_device(
          (const void*)segmented_minmax_kernel<T, kMin, true>,
          (size_t)kSharedGroups * sizeof(int));
      segmented_minmax_kernel<T, kMin, true>
          <<<grid_of(gids, n, most), kThreads, (size_t)num_groups * sizeof(int), s>>>(
              g, v, n, num_groups, o);
    } else {
      const int most =
          resident_on_device((const void*)segmented_minmax_kernel<T, kMin, false>, 0);
      segmented_minmax_kernel<T, kMin, false><<<grid_of(gids, n, most), kThreads, 0, s>>>(
          g, v, n, num_groups, o);
    }
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

// out: num_groups values of the values' type, overwritten: each group's
// min (is_min != 0) or max, the identity (+-inf, INT_MAX/INT_MIN) where a
// group has no row.
extern "C" int segmented_minmax_f32(const void* gids, const void* vals, long long n,
                                    int num_groups, int is_min, void* out,
                                    void* stream) {
  return is_min ? launch_minmax<float, true>(gids, vals, n, num_groups, out, stream)
                : launch_minmax<float, false>(gids, vals, n, num_groups, out, stream);
}

extern "C" int segmented_minmax_i32(const void* gids, const void* vals, long long n,
                                    int num_groups, int is_min, void* out,
                                    void* stream) {
  return is_min ? launch_minmax<int, true>(gids, vals, n, num_groups, out, stream)
                : launch_minmax<int, false>(gids, vals, n, num_groups, out, stream);
}

extern "C" const char* segmented_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
