// The join's open-addressing hash table: its build (build_table), its
// single-match probe (hash_probe) and its expansion probe
// (hash_probe_multi).
//
// Replaces: src/repro/kernels/hash_probe.py, build_table (:122, a jnp
// while_loop, not Pallas), hash_probe (:174) and hash_probe_multi (:209),
// two pallas_calls whose table sat in VMEM, which capped it at 2^18 slots. On the H100 the table lives
// in device memory (2^22 slots = 32 MiB of keys and values at TPC-H SF 1)
// and its random reads hit the 50 MB L2.
//
// Build. The table must come out bit for bit as the reference's, because
// the expansion probe reads duplicate keys in run order (ascending row).
// The reference inserts in rounds: in round i every unplaced valid row
// bids for slot (home + i) & mask if that slot holds empty_key, and the
// lowest row index among the bidders of a slot takes it. So the rows of
// one home (a group) move in lock-step: in round i they all bid for slot
// h + i, one group bids for a slot in a round, and the group nearest the
// slot bids first. The same table comes out of one scan of the slots with
// a stack of groups: at slot s push group s (if any), then the top group
// pops its lowest row into s; if that row's key is empty_key (a ghost,
// which leaves the slot looking empty) the next group below pops into the
// same s, until a real key or the stack's bottom. Ghost pops only lower
// the stack, so where the ghost-free level L(s) = max(0, L(s-1) + cnt(s)
// - 1) is 0 the scan splits into independent clusters. With n < T rows
// some slot has L = 0, and the cyclic table is exact from the second lap.
// Here that is a fixed number of launches, none of which depends on the
// keys, with no read-back and no synchronisation:
//   1. build_compact_kernel: one pass over the validity (1 B a row) packs
//      each valid row as (home << 32 | row) at its rank among the valid
//      rows (a decoupled look-back over tiles of 8,192 rows; a tile's
//      valid rows then read their keys together, a row a thread), counts
//      the homes' radix digits of every pass, and zeroes the look-back
//      words of the sort tiles that start in its output;
//   2. build_sort_kernel, ceil(log2 T / 8) times: a stable LSD radix sort
//      pass of 8 bits (a warp ranks its 32 rows a step with match.any, a
//      tile's digit offsets come from a look-back per digit over tiles of
//      4,096 rows); the last pass writes the sorted homes and each row's
//      (key, value). From here the work follows the valid rows, not n;
//   3. build_levels_kernel: the ghost-free levels in closed form. With
//      D_i = i - home_i over the sorted positions, a group's incoming
//      level on the second lap is D_i - min(-L_end, min_{k <= i} D_k),
//      where L_end = (m - T) - min(0, min D, m - T) is the level at the
//      end of the first lap; so one prefix minimum (a look-back again)
//      gives every cluster's first group;
//   4. build_resolve_kernel: a thread a cluster walks its slots with the
//      stack of groups, each its next row and end (the top in registers,
//      the rest in scratch that the cluster's own sorted positions own),
//      and writes tk/tv; clusters are short at the planner's load factor
//      (<= 0.5).
// The scratch is the wrapper's, sized by n (hash_table_build_scratch_bytes:
// 24 B a row and 2 KiB a tile of 4,096); nothing beyond tk/tv is sized by T.
//   When n >= T the valid rows can fill the table, no slot need be a cut,
// and the reference stops after T rounds. Such calls (chosen by shape, by
// the wrapper) take the round kernels: in each round every unplaced row
// bids for its slot if that slot is empty (atomicMin on `winner`), the
// winner writes it; the host reads the unplaced count back every kChunk
// rounds. HashJoin never builds such a table.
//
// Bound: bytes, in both functions. The build reads each row's validity
// once (1 B) and each valid row's key and value, and writes the table once
// (8 B a slot); its sort moves 8 B a valid row a pass. The probe reads
// each key (4 B) and the table, and writes found (1 B) and the value (4
// B) a key; its table reads are scattered, one request a slot walked and
// one a hit, and at the main path's shapes those requests, not the bytes,
// set its time. The expansion probe writes a count (4 B) and max_matches
// slots (4 B each) a key, and reads on past its first hit to the end of
// the key's run. The build's latency is set by its launches
// (ceil(log2 T / 8) + 3 and a memset) and by its longest cluster, walked
// by one thread.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;
// the expansion probe's staged rows: a CTA's shared memory without the
// opt-in, and the most a block may opt in to on the H100
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kMaxStagedBytes = 227 * 1024;
constexpr int kChunk = 8;   // rounds between two reads of the unplaced count
constexpr unsigned kFull = 0xffffffffu;

int blocks_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
}

// ---------------------------------------------------------------------------
// build: compaction, radix sort, levels, clusters
// ---------------------------------------------------------------------------

constexpr int kItems = 16;                      // rows a thread of a tile
constexpr int kTile = kThreads * kItems;        // 4,096 rows a sort / level tile
constexpr int kCompactItems = 32;               // rows a thread of a compaction tile
constexpr int kCompactTile = kThreads * kCompactItems;   // 8,192 rows
constexpr int kDigits = 256;
constexpr int kMaxPasses = 4;                   // T <= 2^30: 30 bits
// grid caps of the ticket loops: enough blocks to fill the card, few
// enough that a build of few valid rows does not pay for idle ones
constexpr int kCompactBlocks = 132 * 8;
constexpr int kSortBlocks = 132 * 4;
constexpr int kLookBatch = 8;   // predecessors a sort look-back reads at once
constexpr int kRun = 8;         // rows a cluster's walk copies at once
// a look-back word: flag in the high 32 bits (0 not yet published), value
// in the low 32
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
// ~9 s at the card's clock: a look-back that waits longer traps, so a lost
// word is a launch failure and not a hung card
constexpr long long kHangCycles = 1LL << 34;

// the build's scratch header, zeroed by a memset before the launches
struct BuildHeader {
  int ticket[2 + kMaxPasses];   // compact, levels, one a sort pass
  int m;                        // valid rows (written by the compaction)
  int gmin;                     // min over the sorted positions of i - home_i
  int pad[2];
  int hist[kMaxPasses * kDigits];   // each pass's digit counts
};

// relaxed stores and loads: a look-back reads only the counts in the
// words themselves, so it needs each word whole, not what its writer wrote
// before it (the rows a tile writes are read by the next launch); relaxed
// loads of several words go out together where acquire loads would not,
// and a relaxed store waits for no earlier write
__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned r;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(r));
  return r;
}

struct SumOp {
  static constexpr int kIdentity = 0;
  __device__ static __forceinline__ int op(int a, int b) { return a + b; }
  __device__ static __forceinline__ int warp(int v) {
    return (int)__reduce_add_sync(kFull, (unsigned)v);
  }
};

struct MinOp {
  static constexpr int kIdentity = INT_MAX;
  __device__ static __forceinline__ int op(int a, int b) { return a < b ? a : b; }
  __device__ static __forceinline__ int warp(int v) { return __reduce_min_sync(kFull, v); }
};

// exclusive scan of one value a thread over the block (kThreads), with the
// block's aggregate; `warp_s` is kWarps ints of shared memory. Every thread
// of the block calls it
template <typename Op>
__device__ __forceinline__ int block_exclusive(int v, int* warp_s, int* aggregate) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = Op::op(incl, y);
  }
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_s[lane] : Op::kIdentity;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w = Op::op(w, y);
    }
    if (lane < kWarps) warp_s[lane] = w;
  }
  __syncthreads();
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = Op::kIdentity;
  const int before = warp ? warp_s[warp - 1] : Op::kIdentity;
  *aggregate = warp_s[kWarps - 1];
  __syncthreads();   // warp_s may be written again
  return Op::op(before, excl);
}

// the combined values of tiles [0, tile) from their look-back words, by
// one warp, 32 words at a time (tile > 0)
template <typename Op>
__device__ __forceinline__ int look_back(const unsigned long long* status, int tile, int lane) {
  int acc = Op::kIdentity;
  for (int last = tile - 1;; last -= 32) {
    const int i = last - lane;
    unsigned long long w = i >= 0 ? load_status(status + i)
                                  : (kPrefix | (unsigned)Op::kIdentity);
    const long long t0 = clock64();
    while (__any_sync(kFull, (w >> 32) == 0)) {
      if ((w >> 32) == 0) w = load_status(status + i);
      if (clock64() - t0 > kHangCycles) __trap();
    }
    const unsigned prefixes = __ballot_sync(kFull, (w >> 32) == 2);
    const int v = (int)(unsigned)w;
    if (prefixes) {
      // the nearest predecessor with a prefix, and the aggregates after it
      const int stop = __ffs(prefixes) - 1;
      return Op::op(acc, Op::warp(lane <= stop ? v : Op::kIdentity));
    }
    acc = Op::op(acc, Op::warp(v));
  }
}

// the tile's exclusive prefix by the look-back, published; every thread of
// the block calls it and gets the prefix
template <typename Op>
__device__ __forceinline__ int tile_prefix(unsigned long long* status, int tile, int aggregate,
                                           int* prefix_s) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int excl = Op::kIdentity;
    if (tile == 0) {
      if (lane == 0) store_status(status, kPrefix | (unsigned)aggregate);
    } else {
      if (lane == 0) store_status(status + tile, kAggregate | (unsigned)aggregate);
      excl = look_back<Op>(status, tile, lane);
      if (lane == 0) store_status(status + tile, kPrefix | (unsigned)Op::op(excl, aggregate));
    }
    if (lane == 0) *prefix_s = excl;
  }
  __syncthreads();
  return *prefix_s;
}

// the next tile of a ticket loop, for the whole block
__device__ __forceinline__ int next_tile(int* ticket, int* tile_s) {
  __syncthreads();   // the block is done with the previous tile's shared state
  if (threadIdx.x == 0) *tile_s = atomicAdd(ticket, 1);
  __syncthreads();
  return *tile_s;
}

// 1. the valid rows, packed as (home << 32 | row) in row order, and the
// digit counts of each radix pass
__global__ void __launch_bounds__(kThreads)
build_compact_kernel(const int32_t* __restrict__ keys, const unsigned char* __restrict__ valid,
                     long long n, int vec, uint32_t mask, int passes,
                     BuildHeader* __restrict__ hdr, unsigned long long* __restrict__ cstatus,
                     unsigned long long* __restrict__ sstatus,
                     unsigned long long* __restrict__ lstatus,
                     unsigned long long* __restrict__ out) {
  __shared__ int hist_s[kMaxPasses * kDigits];
  __shared__ int rows_s[kCompactTile];   // the tile's valid rows, in order
  __shared__ int warp_s[kWarps];
  __shared__ int tile_s, prefix_s;
  for (int i = threadIdx.x; i < passes * kDigits; i += kThreads) hist_s[i] = 0;
  const int tiles = (int)((n + kCompactTile - 1) / kCompactTile);
  for (;;) {
    const int tile = next_tile(&hdr->ticket[0], &tile_s);
    if (tile >= tiles) break;
    const long long r0 =
        (long long)tile * kCompactTile + (long long)kCompactItems * threadIdx.x;
    uint32_t bits = 0;   // bit j: row r0 + j is valid
    if (valid == nullptr) {
      const long long left = n - r0;
      bits = left >= kCompactItems ? ~0u : left > 0 ? (1u << left) - 1u : 0u;
    } else if (vec && r0 + kCompactItems <= n) {
#pragma unroll
      for (int q = 0; q < kCompactItems / 16; ++q) {
        const uint4 w = *reinterpret_cast<const uint4*>(valid + r0 + 16 * q);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if ((words[i] >> (8 * b)) & 0xffu) bits |= 1u << (16 * q + 4 * i + b);
      }
    } else {
      for (int j = 0; j < kCompactItems; ++j)
        if (r0 + j < n && valid[r0 + j]) bits |= 1u << j;
    }
    int aggregate;
    const int before = block_exclusive<SumOp>(__popc(bits), warp_s, &aggregate);
    // the tile's valid rows in order into shared memory, so that the block
    // then reads their keys together, a row a thread
    for (int k = before; bits; ++k) {
      rows_s[k] = (int)(tile * kCompactTile + kCompactItems * threadIdx.x) + __ffs(bits) - 1;
      bits &= bits - 1;
    }
    const int excl = tile_prefix<SumOp>(cstatus, tile, aggregate, &prefix_s);
    if (tile == tiles - 1 && threadIdx.x == 0) hdr->m = excl + aggregate;
    // the look-back words of the sort and level tiles whose first row this
    // tile writes
    for (long long j = ((long long)excl + kTile - 1) / kTile;
         j * kTile < (long long)excl + aggregate; ++j) {
      sstatus[j * kDigits + threadIdx.x] = 0ull;
      if (threadIdx.x == 0) lstatus[j] = 0ull;
    }
    for (int i = threadIdx.x; i < aggregate; i += kThreads) {
      const int row = rows_s[i];
      const uint32_t home = repro_hash::hash32(keys[row]) & mask;
      out[excl + i] = ((unsigned long long)home << 32) | (unsigned long long)(unsigned)row;
      for (int p = 0; p < passes; ++p)
        atomicAdd(&hist_s[p * kDigits + ((home >> (8 * p)) & 0xffu)], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kDigits; i += kThreads)
    if (hist_s[i]) atomicAdd(&hdr->hist[i], hist_s[i]);
}

// 2. one stable LSD pass over the home's bits [8 pass, 8 pass + 8): a
// warp ranks 32 rows a step (match.any), the tile's digit offsets come
// from a serial look-back per digit over the tiles' words, tagged with
// the pass (a word of an earlier pass reads as not yet published). The
// last pass writes the sorted homes and each row's (key | value << 32)
__global__ void __launch_bounds__(kThreads)
build_sort_kernel(const unsigned long long* __restrict__ in,
                  unsigned long long* __restrict__ out, int32_t* __restrict__ homes,
                  const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
                  int pass, int last, BuildHeader* __restrict__ hdr,
                  unsigned long long* __restrict__ sstatus) {
  __shared__ int wh[kWarps][kDigits];   // a warp's running count, then offset, of a digit
  __shared__ int start_s[kDigits];      // the digit's first position in the pass
  __shared__ int base_s[kDigits];       // the digit's first position in this tile
  __shared__ int warp_s[kWarps];
  __shared__ int tile_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = threadIdx.x;
  const int shift = 32 + 8 * pass;
  const int m = hdr->m;
  // a block past the rows' tiles takes no ticket: with few valid rows most
  // of the grid leaves at once, and the ticket's atomics are those of the
  // blocks that work (every tile below m still gets a block that loops)
  if ((long long)blockIdx.x * kTile >= m) return;
  const unsigned long long agg_flag = (unsigned long long)(2 * pass + 1) << 32;
  const unsigned long long pre_flag = (unsigned long long)(2 * pass + 2) << 32;
  for (bool first = true;; first = false) {
    const int tile = next_tile(&hdr->ticket[2 + pass], &tile_s);
    const long long e0 = (long long)tile * kTile;
    if (e0 >= m) break;
    if (first) {
      int total;
      start_s[d] = block_exclusive<SumOp>(hdr->hist[pass * kDigits + d], warp_s, &total);
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wh[w][d] = 0;
    __syncthreads();
    unsigned long long x[kItems];
    int rank[kItems];
    const long long w0 = e0 + (long long)warp * (kItems * 32) + lane;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const long long e = w0 + it * 32;
      const bool here = e < m;
      x[it] = here ? in[e] : 0ull;
      const int dg = here ? (int)((x[it] >> shift) & 0xffu) : kDigits;
      const unsigned peers = __match_any_sync(kFull, dg);
      const int before = here ? wh[warp][dg] : 0;
      __syncwarp();
      if (here && lane == __ffs(peers) - 1) wh[warp][dg] = before + __popc(peers);
      __syncwarp();
      rank[it] = before + __popc(peers & lanemask_lt());
    }
    __syncthreads();
    // thread d: the warps' offsets of digit d and the tile's count
    int count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wh[w][d];
      wh[w][d] = count;
      count += c;
    }
    unsigned long long* st = sstatus + (long long)tile * kDigits + d;
    int excl = 0;
    if (tile == 0) {
      store_status(st, pre_flag | (unsigned)count);
    } else {
      store_status(st, agg_flag | (unsigned)count);
      // kLookBatch predecessors' words at a time, loaded together; tile 0
      // publishes a prefix, so the walk stops at or above it
      const long long t0 = clock64();
      bool found = false;
      for (long long j = tile - 1; !found; j -= kLookBatch) {
        unsigned long long w[kLookBatch];
#pragma unroll
        for (int u = 0; u < kLookBatch; ++u)
          w[u] = j - u >= 0 ? load_status(sstatus + (j - u) * kDigits + d) : pre_flag;
#pragma unroll
        for (int u = 0; u < kLookBatch; ++u) {
          if (found) break;
          while ((w[u] & ~0xffffffffull) < agg_flag) {
            w[u] = load_status(sstatus + (j - u) * kDigits + d);
            if (clock64() - t0 > kHangCycles) __trap();
          }
          excl += (int)(unsigned)w[u];
          found = (w[u] & ~0xffffffffull) == pre_flag;
        }
      }
      store_status(st, pre_flag | (unsigned)(excl + count));
    }
    base_s[d] = start_s[d] + excl;
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const long long e = w0 + it * 32;
      if (e >= m) continue;
      const int dg = (int)((x[it] >> shift) & 0xffu);
      const int pos = base_s[dg] + wh[warp][dg] + rank[it];
      if (last) {
        const int row = (int)(unsigned)x[it];
        homes[pos] = (int32_t)(x[it] >> 32);
        out[pos] = (unsigned long long)(unsigned)keys[row] |
                   ((unsigned long long)(unsigned)vals[row] << 32);
      } else {
        out[pos] = x[it];
      }
    }
  }
}

// 3. excl[i] = min over sorted positions k < i of (k - home_k) (INT_MAX at
// 0), and the minimum over all of them into the header
__global__ void __launch_bounds__(kThreads)
build_levels_kernel(const int32_t* __restrict__ homes, int32_t* __restrict__ excl,
                    BuildHeader* __restrict__ hdr, unsigned long long* __restrict__ lstatus) {
  __shared__ int warp_s[kWarps];
  __shared__ int tile_s, prefix_s;
  const int m = hdr->m;
  if ((long long)blockIdx.x * kTile >= m) return;   // as in build_sort_kernel
  for (;;) {
    const int tile = next_tile(&hdr->ticket[1], &tile_s);
    const long long i0 = (long long)tile * kTile;
    if (i0 >= m) break;
    const long long r0 = i0 + (long long)kItems * threadIdx.x;
    int dv[kItems];
    int dmin = INT_MAX;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = r0 + j;
      dv[j] = i < m ? (int)(i - homes[i]) : INT_MAX;
      dmin = min(dmin, dv[j]);
    }
    int aggregate;
    const int before = block_exclusive<MinOp>(dmin, warp_s, &aggregate);
    const int prefix = tile_prefix<MinOp>(lstatus, tile, aggregate, &prefix_s);
    if (threadIdx.x == 0 && (long long)(m - 1) / kTile == tile) hdr->gmin = min(prefix, aggregate);
    int run = min(prefix, before);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = r0 + j;
      if (i < m) excl[i] = run;
      run = min(run, dv[j]);
    }
  }
}

// 4. one cluster, from its first group at sorted position p: the stack of
// groups, each its next row and its end in sorted positions (the top in
// registers, the rest at stk[(p + k) % m], positions the cluster owns),
// walked slot by slot
__device__ void resolve_cluster(int p, int m, long long t, int32_t empty_key,
                                const int32_t* __restrict__ homes,
                                const unsigned long long* __restrict__ kv,
                                int2* __restrict__ stk, int32_t* __restrict__ tk,
                                int32_t* __restrict__ tv) {
  const uint32_t mask = (uint32_t)(t - 1);
  long long s = homes[p];   // the slot, unwrapped
  long long lap = 0;        // t once the next group has wrapped to position 0
  long long level = 0;      // the ghost-free level
  int q = p;                // the next group to push
  long long hq = s;         // its home, unwrapped
  int top = -1, top_end = 0, depth = 0;
  for (;;) {
    long long pushed = 0;
    if (hq == s) {
      if (top >= 0) {
        stk[p + depth < m ? p + depth : p + depth - m] = make_int2(top, top_end);
        ++depth;
      }
      top = q;
      const int32_t h = homes[q];
      do {
        ++q;
      } while (q < m && homes[q] == h);
      top_end = q;
      pushed = q - top;
      if (q == m) {
        q = 0;
        lap = t;
      }
      hq = homes[q] + lap;
    }
    // the pops at s: the top, then below it while the popped row is a ghost
    int cur = top, end = top_end, at = -1, k = depth;
    while (cur >= 0) {
      const unsigned long long e = kv[cur];
      const int32_t key = (int32_t)(unsigned)e;
      tk[s & mask] = key;
      tv[s & mask] = (int32_t)(e >> 32);
      const int next = cur + 1 < end ? cur + 1 : -1;
      if (at < 0) {
        top = next;
      } else {
        stk[at].x = next;
      }
      if (key != empty_key) break;
      cur = -1;
      while (k > 0) {
        --k;
        const int a = p + k < m ? p + k : p + k - m;
        const int2 c = stk[a];
        if (c.x >= 0) {
          cur = c.x;
          end = c.y;
          at = a;
          break;
        }
      }
    }
    while (top < 0 && depth > 0) {
      --depth;
      const int2 c = stk[p + depth < m ? p + depth : p + depth - m];
      top = c.x;
      top_end = c.y;
    }
    level = level + pushed - 1 > 0 ? level + pushed - 1 : 0;
    if (level == 0) return;
    ++s;
    if (top < 0) {
      // no row to place before the next group: skip the empty slots
      const long long gap = hq - s;
      if (gap >= level) return;
      level -= gap;
      s += gap;
      continue;
    }
    // the top alone fills the slots before the next group's home while its
    // rows are real keys: kRun rows at a time, their loads out together;
    // it keeps a row, so the level stays above 0. A ghost is left to the
    // loop above
    while (s + kRun <= hq && top + kRun < top_end) {
      unsigned long long e[kRun];
#pragma unroll
      for (int u = 0; u < kRun; ++u) e[u] = kv[top + u];
      int u = 0;
#pragma unroll
      for (; u < kRun; ++u) {
        const int32_t key = (int32_t)(unsigned)e[u];
        if (key == empty_key) break;
        tk[(s + u) & mask] = key;
        tv[(s + u) & mask] = (int32_t)(e[u] >> 32);
      }
      top += u;
      s += u;
      level -= u;
      if (u < kRun) break;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
build_resolve_kernel(const int32_t* __restrict__ homes, const unsigned long long* __restrict__ kv,
                     const int32_t* __restrict__ excl, int2* __restrict__ stk,
                     const BuildHeader* __restrict__ hdr, int table_size, int32_t empty_key,
                     int32_t* __restrict__ tk, int32_t* __restrict__ tv) {
  const int m = hdr->m;
  const long long t = table_size;
  const long long mt = (long long)m - t;
  const long long lowest = min(0LL, min((long long)hdr->gmin, mt));
  const long long l_end = mt - lowest;   // the ghost-free level after slot T - 1
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const int32_t h = homes[i];
    if (i > 0 && homes[i - 1] == h) continue;   // not a group's first row
    const long long cut = min(-l_end, (long long)excl[i]);
    if ((long long)i - h > cut) continue;       // its incoming level is not 0
    resolve_cluster(i, m, t, empty_key, homes, kv, stk, tk, tv);
  }
}

// ---------------------------------------------------------------------------
// build when n >= T: the reference's rounds
// ---------------------------------------------------------------------------

// round `r`: every unplaced row bids for its slot if the slot is empty
__global__ void __launch_bounds__(kThreads)
hash_build_claim_kernel(const int32_t* __restrict__ keys,
                        const unsigned char* __restrict__ placed, long long n,
                        const int32_t* __restrict__ tk,
                        int32_t* __restrict__ winner, uint32_t mask,
                        int32_t empty_key, uint32_t r) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (placed[i]) continue;
    const uint32_t s = (repro_hash::hash32(keys[i]) + r) & mask;
    if (tk[s] == empty_key) atomicMin(winner + s, (int32_t)i);
  }
}

// round `r`: the winner of each slot writes it and resets the slot's bid;
// with `unplaced` set, the rows still unplaced are counted into it
__global__ void __launch_bounds__(kThreads)
hash_build_place_kernel(const int32_t* __restrict__ keys,
                        const int32_t* __restrict__ vals,
                        unsigned char* __restrict__ placed, long long n,
                        int32_t* __restrict__ tk, int32_t* __restrict__ tv,
                        int32_t* __restrict__ winner, uint32_t mask,
                        uint32_t r, int* __restrict__ unplaced) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned left = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (placed[i]) continue;
    const int32_t key = keys[i];
    const uint32_t s = (repro_hash::hash32(key) + r) & mask;
    // only this round's winner can read its own index here: every slot
    // that was bid for is taken in the round it was bid for, and its bid
    // is reset to INT_MAX by its winner
    if (winner[s] == (int32_t)i) {
      tk[s] = key;
      tv[s] = vals[i];
      winner[s] = INT_MAX;
      placed[i] = 1;
    } else {
      ++left;
    }
  }
  if (unplaced != nullptr) {
    // every thread of the block reaches this point, so the full-warp
    // reduction is safe; one atomic per warp
    const unsigned warp_left = __reduce_add_sync(0xffffffffu, left);
    if ((threadIdx.x & 31) == 0 && warp_left) atomicAdd(unplaced, (int)warp_left);
  }
}

// ---------------------------------------------------------------------------
// the single-match probe
// ---------------------------------------------------------------------------

// A key a thread, its run walked slot by slot from its home slot
// (probe_one, shared with the fused probe). The main path hands it batches
// of up to 2^20 keys, most of whose runs end at the first slot, against
// tables from 2^6 to 2^24 slots: the cost is the number of scattered
// requests (one for tk a slot, one for tv a hit), and reading the home
// slot's 16- or 32-byte group whole, or four keys a thread, only added
// requests (PERF.md). The keys are read and found and vals written with
// the evict-first hint (__ldcs/__stcs): streamed once, they leave the L2
// to the table.
__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ tv,
                  uint32_t mask, int max_probes, int32_t empty_key,
                  const int32_t* __restrict__ keys, long long n,
                  unsigned char* __restrict__ found,
                  int32_t* __restrict__ vals) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t v;
    const bool hit = repro_hash::probe_one(tk, tv, mask, max_probes,
                                           empty_key, __ldcs(keys + i), &v);
    __stcs(found + i, (unsigned char)hit);
    __stcs(vals + i, v);
  }
}

// ---------------------------------------------------------------------------
// the expansion probe
// ---------------------------------------------------------------------------

// A key a thread, in probe_multi's order. At the main path's shapes (m =
// 4, up to 2^20 keys; at TPC-H Q9 every key matches and walks on to its
// run's end, 3.4 slots a key) the cost is in the scattered table reads and
// the stores. Stored a slot at a time, one warp store instruction writes
// 32 words 4 m bytes apart (16 sectors, 8 useful bytes each, at m = 4). So
// the row is built whole before it is stored:
//   * m = 2, 4, 8 with T >= 4 and tk on a 16-byte boundary
//     (hash_probe_multi_kernel<M>): the run read a 16-byte group of 4
//     slots at a time (probe_multi_row<M>), the row in registers, stored
//     zeros included as one 8- or 16-byte store (two 16-byte stores of one
//     32-byte sector at m = 8);
//   * other m, or tables under 4 slots or off their 16-byte boundary,
//     whose rows fit a CTA's shared memory
//     (hash_probe_multi_staged_kernel): each thread writes its row (the
//     matches, then zeros) into the CTA's tile of kThreads rows, and the
//     CTA stores the tile's words in order;
//   * wider rows (hash_probe_multi_slots_kernel): a store a slot.
// Keys are read and counts and rows written with the evict-first hint:
// streamed once, they leave the L2 to the table.

__device__ __forceinline__ void store_row(int32_t* p, const int32_t (&r)[2]) {
  __stcs(reinterpret_cast<int2*>(p), make_int2(r[0], r[1]));
}

__device__ __forceinline__ void store_row(int32_t* p, const int32_t (&r)[4]) {
  __stcs(reinterpret_cast<int4*>(p), make_int4(r[0], r[1], r[2], r[3]));
}

__device__ __forceinline__ void store_row(int32_t* p, const int32_t (&r)[8]) {
  __stcs(reinterpret_cast<int4*>(p), make_int4(r[0], r[1], r[2], r[3]));
  __stcs(reinterpret_cast<int4*>(p) + 1, make_int4(r[4], r[5], r[6], r[7]));
}

template <int M>
__global__ void __launch_bounds__(kThreads)
hash_probe_multi_kernel(const int32_t* __restrict__ tk,
                        const int32_t* __restrict__ tv, uint32_t mask,
                        int max_probes, int32_t empty_key,
                        const int32_t* __restrict__ keys, long long n,
                        int32_t* __restrict__ count,
                        int32_t* __restrict__ slots) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t row[M];
    const int c = repro_hash::probe_multi_row<M>(
        tk, tv, mask, max_probes, empty_key, __ldcs(keys + i), row);
    store_row(slots + i * M, row);
    __stcs(count + i, c);
  }
}

__global__ void __launch_bounds__(kThreads)
hash_probe_multi_staged_kernel(const int32_t* __restrict__ tk,
                               const int32_t* __restrict__ tv, uint32_t mask,
                               int max_probes, int32_t empty_key,
                               const int32_t* __restrict__ keys, long long n,
                               int max_matches, int32_t* __restrict__ count,
                               int32_t* __restrict__ slots) {
  extern __shared__ __align__(16) int32_t staged_rows[];
  for (long long base = (long long)blockIdx.x * kThreads; base < n;
       base += (long long)gridDim.x * kThreads) {
    const long long i = base + threadIdx.x;
    if (i < n) {
      __stcs(count + i, repro_hash::probe_multi(
                            tk, tv, mask, max_probes, empty_key, __ldcs(keys + i),
                            max_matches, staged_rows + threadIdx.x * max_matches));
    }
    __syncthreads();
    const long long rows = n - base < kThreads ? n - base : kThreads;
    int32_t* dst = slots + base * max_matches;
    for (long long w = threadIdx.x; w < rows * max_matches; w += kThreads)
      __stcs(dst + w, staged_rows[w]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
hash_probe_multi_slots_kernel(const int32_t* __restrict__ tk,
                              const int32_t* __restrict__ tv, uint32_t mask,
                              int max_probes, int32_t empty_key,
                              const int32_t* __restrict__ keys, long long n,
                              int max_matches, int32_t* __restrict__ count,
                              int32_t* __restrict__ slots) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    __stcs(count + i, repro_hash::probe_multi(tk, tv, mask, max_probes, empty_key,
                                              __ldcs(keys + i), max_matches,
                                              slots + i * max_matches));
  }
}

// the build's scratch: the header and the compaction's words (zeroed), the
// sort's and the levels' words (zeroed by the compaction where used), two
// 8-byte buffers a row, the sorted homes and the prefix minima
struct BuildScratch {
  BuildHeader* hdr;
  unsigned long long *cstatus, *sstatus, *lstatus, *buf[2];
  int32_t *homes, *excl;
  long long zero_bytes, bytes;
};

long long align256(long long x) { return (x + 255) & ~255LL; }

BuildScratch build_scratch(void* base, long long n) {
  const long long ctiles = (n + kCompactTile - 1) / kCompactTile;
  const long long tiles = (n + kTile - 1) / kTile;
  char* p = static_cast<char*>(base);
  BuildScratch s;
  long long at = align256(sizeof(BuildHeader));
  s.hdr = reinterpret_cast<BuildHeader*>(p);
  s.cstatus = reinterpret_cast<unsigned long long*>(p + at);
  at = align256(at + ctiles * 8);
  s.zero_bytes = at;
  s.sstatus = reinterpret_cast<unsigned long long*>(p + at);
  at = align256(at + tiles * kDigits * 8);
  s.lstatus = reinterpret_cast<unsigned long long*>(p + at);
  at = align256(at + tiles * 8);
  for (int i = 0; i < 2; ++i) {
    s.buf[i] = reinterpret_cast<unsigned long long*>(p + at);
    at = align256(at + n * 8);
  }
  s.homes = reinterpret_cast<int32_t*>(p + at);
  at = align256(at + n * 4);
  s.excl = reinterpret_cast<int32_t*>(p + at);
  s.bytes = align256(at + n * 4);
  return s;
}

bool build_args_ok(long long n, int table_size) {
  return table_size > 0 && (table_size & (table_size - 1)) == 0 && n >= 0 &&
         n <= (long long)INT_MAX;
}

int log2_of(int table_size) {
  int b = 0;
  while ((1 << b) < table_size) ++b;
  return b;
}

}  // namespace

// Bytes of device scratch that hash_table_build needs for n rows (n <
// table_size): the wrapper allocates them and passes them in.
extern "C" long long hash_table_build_scratch_bytes(long long n) {
  if (n < 0) return 0;
  BuildScratch s = build_scratch(nullptr, n);
  return s.bytes;
}

// Inserts n < table_size (key, value) rows into a table of `table_size`
// slots (a power of two), `valid` (bool[n]) or every row, in
// ceil(log2(table_size) / 8) + 3 launches and one memset, none of which
// reads anything back. On entry tk holds empty_key everywhere and tv
// zeros; scratch holds at least hash_table_build_scratch_bytes(n) bytes.
// Returns the first CUDA error, or 0.
extern "C" int hash_table_build(const void* keys, const void* vals, const void* valid,
                                long long n, int table_size, int empty_key, void* tk,
                                void* tv, void* scratch, long long scratch_bytes,
                                void* stream) {
  if (!build_args_ok(n, table_size) || n >= table_size) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  BuildScratch sc = build_scratch(scratch, n);
  if (scratch_bytes < sc.bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int passes = (log2_of(table_size) + 7) / 8;
  const long long ctiles = (n + kCompactTile - 1) / kCompactTile;
  const long long tiles = (n + kTile - 1) / kTile;
  const int cgrid = (int)(ctiles < kCompactBlocks ? ctiles : kCompactBlocks);
  const int grid = (int)(tiles < kSortBlocks ? tiles : kSortBlocks);
  const int32_t* k = static_cast<const int32_t*>(keys);
  const int32_t* v = static_cast<const int32_t*>(vals);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, (size_t)sc.zero_bytes, st);
  if (rc != cudaSuccess) return (int)rc;
  const int vec = reinterpret_cast<uintptr_t>(valid) % 16 == 0;
  build_compact_kernel<<<cgrid, kThreads, 0, st>>>(
      k, static_cast<const unsigned char*>(valid), n, vec, (uint32_t)table_size - 1u, passes,
      sc.hdr, sc.cstatus, sc.sstatus, sc.lstatus, sc.buf[0]);
  for (int p = 0; p < passes; ++p) {
    build_sort_kernel<<<grid, kThreads, 0, st>>>(sc.buf[p & 1], sc.buf[(p + 1) & 1], sc.homes,
                                                 k, v, p, p == passes - 1, sc.hdr,
                                                 sc.sstatus);
  }
  // the sorted (key, value) rows are in buf[passes & 1]; the other buffer
  // holds the clusters' stacks
  build_levels_kernel<<<grid, kThreads, 0, st>>>(sc.homes, sc.excl, sc.hdr, sc.lstatus);
  build_resolve_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      sc.homes, sc.buf[passes & 1], sc.excl, reinterpret_cast<int2*>(sc.buf[(passes + 1) & 1]),
      sc.hdr, table_size, (int32_t)empty_key, static_cast<int32_t*>(tk),
      static_cast<int32_t*>(tv));
  return (int)cudaGetLastError();
}

// The round build, for n >= table_size rows (the wrapper's shape rule). On
// entry tk holds empty_key everywhere, tv zeros, winner INT_MAX
// everywhere, placed[i] = !valid[i]; `unplaced` is one device int of
// scratch. Returns the first CUDA error, or 0. Synchronises `stream` once
// every kChunk rounds to read the unplaced count.
extern "C" int hash_table_build_rounds(const void* keys, const void* vals, void* placed,
                                       long long n, int table_size, int empty_key, void* tk,
                                       void* tv, void* winner, void* unplaced,
                                       void* stream) {
  if (!build_args_ok(n, table_size)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  const uint32_t mask = (uint32_t)table_size - 1u;
  int* count = static_cast<int*>(unplaced);
  uint32_t r = 0;
  while (r < (uint32_t)table_size) {
    const uint32_t left_rounds = (uint32_t)table_size - r;
    const uint32_t chunk = left_rounds < (uint32_t)kChunk ? left_rounds : kChunk;
    for (uint32_t c = 0; c < chunk; ++c, ++r) {
      hash_build_claim_kernel<<<blocks, kThreads, 0, s>>>(
          static_cast<const int32_t*>(keys),
          static_cast<const unsigned char*>(placed), n,
          static_cast<const int32_t*>(tk), static_cast<int32_t*>(winner),
          mask, (int32_t)empty_key, r);
      const bool last = c + 1 == chunk;
      if (last) cudaMemsetAsync(count, 0, sizeof(int), s);
      hash_build_place_kernel<<<blocks, kThreads, 0, s>>>(
          static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
          static_cast<unsigned char*>(placed), n, static_cast<int32_t*>(tk),
          static_cast<int32_t*>(tv), static_cast<int32_t*>(winner), mask, r,
          last ? count : nullptr);
    }
    int left = 0;
    cudaError_t err = cudaMemcpyAsync(&left, count, sizeof(int),
                                      cudaMemcpyDeviceToHost, s);
    if (err == cudaSuccess) err = cudaStreamSynchronize(s);
    if (err != cudaSuccess) return (int)err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (left == 0) break;
  }
  return (int)cudaGetLastError();
}

// found[i] = key i is in the table, vals[i] = its value (0 if not found).
extern "C" int hash_table_probe(const void* tk, const void* tv, int table_size,
                                int max_probes, int empty_key, const void* keys,
                                long long n, void* found, void* vals,
                                void* stream) {
  if (table_size <= 0 || (table_size & (table_size - 1)) != 0 || n < 0 ||
      max_probes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  hash_probe_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tk), static_cast<const int32_t*>(tv),
      (uint32_t)table_size - 1u, max_probes, (int32_t)empty_key,
      static_cast<const int32_t*>(keys), n, static_cast<unsigned char*>(found),
      static_cast<int32_t*>(vals));
  return (int)cudaGetLastError();
}

// count[i] = the matches of key i (at most max_matches), slots[i, :count[i]]
// their values in run order, slots[i, count[i]:] = 0. The route is set by
// max_matches and, for the whole-row stores, by the alignment of slots and
// tk and the table's size.
extern "C" int hash_table_probe_multi(const void* tk, const void* tv,
                                      int table_size, int max_probes,
                                      int empty_key, const void* keys,
                                      long long n, int max_matches, void* count,
                                      void* slots, void* stream) {
  if (table_size <= 0 || (table_size & (table_size - 1)) != 0 || n < 0 ||
      max_probes < 0 || max_matches < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for(n);
  const int32_t* k = static_cast<const int32_t*>(tk);
  const int32_t* v = static_cast<const int32_t*>(tv);
  const uint32_t mask = (uint32_t)table_size - 1u;
  const int32_t* pk = static_cast<const int32_t*>(keys);
  int32_t* c = static_cast<int32_t*>(count);
  int32_t* out = static_cast<int32_t*>(slots);
  // a whole row is one aligned store of 4 m or 16 bytes, the run read in
  // 16-byte groups of slots
  const bool rows = (max_matches == 2 || max_matches == 4 || max_matches == 8) &&
                    reinterpret_cast<uintptr_t>(slots) % (max_matches == 2 ? 8 : 16) == 0 &&
                    table_size >= 4 && reinterpret_cast<uintptr_t>(tk) % 16 == 0;
  const size_t staged = (size_t)kThreads * max_matches * sizeof(int32_t);
  if (rows && max_matches == 2) {
    hash_probe_multi_kernel<2><<<grid, kThreads, 0, st>>>(
        k, v, mask, max_probes, empty_key, pk, n, c, out);
  } else if (rows && max_matches == 4) {
    hash_probe_multi_kernel<4><<<grid, kThreads, 0, st>>>(
        k, v, mask, max_probes, empty_key, pk, n, c, out);
  } else if (rows) {
    hash_probe_multi_kernel<8><<<grid, kThreads, 0, st>>>(
        k, v, mask, max_probes, empty_key, pk, n, c, out);
  } else if (staged <= kMaxStagedBytes) {
    if (staged > kDefaultSharedBytes) {
      const cudaError_t rc = cudaFuncSetAttribute(
          hash_probe_multi_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)staged);
      if (rc != cudaSuccess) return (int)rc;
    }
    hash_probe_multi_staged_kernel<<<grid, kThreads, staged, st>>>(
        k, v, mask, max_probes, empty_key, pk, n, max_matches, c, out);
  } else {
    hash_probe_multi_slots_kernel<<<grid, kThreads, 0, st>>>(
        k, v, mask, max_probes, empty_key, pk, n, max_matches, c, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hash_table_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
