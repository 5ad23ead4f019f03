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
// So the insert stays round-synchronous, as in the reference: in round i
// every unplaced row wants slot (home + i) & mask if that slot is empty at
// the start of the round; the lowest row index among those that want a
// slot wins it (atomicMin on `winner`), writes its key and value and is
// placed; the others go on to round i + 1. Rows that are invalid start out
// placed. Each round is two launches over the rows, claim then place, so
// that no row reads a slot another row writes in the same round. The host
// loop reads back the number of unplaced rows every kChunk rounds and stops
// when it is 0, or after T rounds (the reference's bound). Rounds past the
// last placement do nothing, so the result does not depend on kChunk.
//
// Bound: bytes, in both functions. The build reads each row's key, value
// and validity once (9 B) and writes the table once (8 B a slot); the
// probe reads each key (4 B) and the table, and writes found (1 B) and the
// value (4 B) a key. The arithmetic (a hash and a compare a slot) is far
// below the card's rate. What costs is the number of rounds (the longest
// displacement + 1: a few at the sparse loads the planner's row bounds
// give, hundreds where many keys repeat), two launches each, and one
// dependent random read of 4 B per probe step, which fetches a 32 B sector.
// The expansion probe writes a count (4 B) and max_matches slots (4 B each)
// a key, and reads on past its first hit to the end of the key's run.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hash_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kChunk = 8;   // rounds between two reads of the unplaced count

int blocks_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
}

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
    found[i] = repro_hash::probe_one(tk, tv, mask, max_probes, empty_key,
                                     keys[i], &v);
    vals[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
hash_probe_multi_kernel(const int32_t* __restrict__ tk,
                        const int32_t* __restrict__ tv, uint32_t mask,
                        int max_probes, int32_t empty_key,
                        const int32_t* __restrict__ keys, long long n,
                        int max_matches, int32_t* __restrict__ count,
                        int32_t* __restrict__ slots) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    count[i] = repro_hash::probe_multi(tk, tv, mask, max_probes, empty_key,
                                       keys[i], max_matches,
                                       slots + i * max_matches);
  }
}

}  // namespace

// Inserts n (key, value) rows into a table of `table_size` slots (a power
// of two). On entry tk holds empty_key everywhere, tv zeros, winner
// INT_MAX everywhere, placed[i] = !valid[i]; `unplaced` is one device int
// of scratch. Returns the first CUDA error, or 0. Synchronises `stream`
// once every kChunk rounds to read the unplaced count.
extern "C" int hash_table_build(const void* keys, const void* vals,
                                void* placed, long long n, int table_size,
                                int empty_key, void* tk, void* tv,
                                void* winner, void* unplaced, void* stream) {
  if (table_size <= 0 || (table_size & (table_size - 1)) != 0 || n < 0 ||
      n > (long long)INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
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
// their values in run order, slots[i, count[i]:] = 0.
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
  hash_probe_multi_kernel<<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tk), static_cast<const int32_t*>(tv),
      (uint32_t)table_size - 1u, max_probes, (int32_t)empty_key,
      static_cast<const int32_t*>(keys), n, max_matches,
      static_cast<int32_t*>(count), static_cast<int32_t*>(slots));
  return (int)cudaGetLastError();
}

extern "C" const char* hash_table_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
