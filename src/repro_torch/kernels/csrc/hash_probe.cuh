// The join hash and the linear probes: the single-match probe, shared by
// the standalone probe (hash_table.cu) and the probe variant of the fused
// morsel kernel (fused_morsel.cu), and the expansion probe (hash_table.cu).
//
// Replaces: src/repro/kernels/hash_probe.py, _hash (:25), probe_loop (:33)
// and probe_loop_multi (:63). There a block of 1024 probe keys advanced
// together through a masked fori_loop over a table held in VMEM. On Hopper
// each thread walks its own key's run and stops at its first hit (or, for
// the expansion probe, at its max_matches-th) or at an empty slot; the
// table (up to 2^25 slots) stays in device memory and is read through the
// L2.
#pragma once

#include <stdint.h>

namespace repro_hash {

// Murmur3-style partial finalizer in uint32: x ^= x >> 16;
// x *= 0x85EBCA6B; x ^= x >> 13. The home slot is this & (T - 1).
__device__ __forceinline__ uint32_t hash32(int32_t key) {
  uint32_t x = (uint32_t)key;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  return x;
}

// Linear probe of `key` over at most `max_probes` slots from its home slot.
// A slot equal to `key` is a hit (its value goes to *val); a slot equal to
// `empty_key` ends the run. A key equal to `empty_key` therefore reports a
// hit on the first empty slot, as in the reference: callers mask it.
__device__ __forceinline__ bool probe_one(const int32_t* __restrict__ tk,
                                          const int32_t* __restrict__ tv,
                                          uint32_t mask, int max_probes,
                                          int32_t empty_key, int32_t key,
                                          int32_t* val) {
  const uint32_t home = hash32(key) & mask;
  for (int i = 0; i < max_probes; ++i) {
    const uint32_t s = (home + (uint32_t)i) & mask;
    const int32_t k = __ldg(tk + s);
    if (k == key) {
      *val = __ldg(tv + s);
      return true;
    }
    if (k == empty_key) break;
  }
  *val = 0;
  return false;
}

// Expansion probe of `key`: walks the run from its home slot for at most
// `max_probes` slots and appends the value of every slot whose key equals
// `key` to out[0..max_matches), in run order (build_table places
// duplicates along the run in ascending row order), stopping at the first
// empty slot or once max_matches values are out. Returns the count and
// writes 0 to out[count..max_matches), as the reference leaves its zero
// initialisation there. As with probe_one, a key equal to `empty_key`
// counts the first empty slot as one match: callers mask it.
__device__ __forceinline__ int probe_multi(const int32_t* __restrict__ tk,
                                           const int32_t* __restrict__ tv,
                                           uint32_t mask, int max_probes,
                                           int32_t empty_key, int32_t key,
                                           int max_matches, int32_t* out) {
  const uint32_t home = hash32(key) & mask;
  int count = 0;
  for (int i = 0; i < max_probes && count < max_matches; ++i) {
    const uint32_t s = (home + (uint32_t)i) & mask;
    const int32_t k = __ldg(tk + s);
    if (k == key) out[count++] = __ldg(tv + s);
    if (k == empty_key) break;
  }
  for (int c = count; c < max_matches; ++c) out[c] = 0;
  return count;
}

// probe_multi with max_matches = M, the row in registers: row[0..count)
// the matches in run order, row[count..M) 0. A match goes to the register
// its index names by an unrolled select, so the row stays out of local
// memory. The run's keys are read a 16-byte group of 4 slots at a time
// (tk 16-byte aligned, T >= 4), from the group that holds the home slot:
// an expansion probe walks on past its match to the run's end (3.4 slots
// a key at TPC-H Q9), so a group load replaces several scattered ones.
// The slots are visited in the same order, and the walk stops where
// probe_multi stops.
template <int M>
__device__ __forceinline__ int probe_multi_row(const int32_t* __restrict__ tk,
                                               const int32_t* __restrict__ tv,
                                               uint32_t mask, int max_probes,
                                               int32_t empty_key, int32_t key,
                                               int32_t (&row)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) row[j] = 0;
  const uint32_t home = hash32(key) & mask;
  int count = 0;
  int i = 0;
  bool go = max_probes > 0;
  while (go) {
    const uint32_t s = (home + (uint32_t)i) & mask;
    const uint32_t base = s & ~3u;
    const int4 q = __ldg(reinterpret_cast<const int4*>(tk + base));
    const int32_t ks[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (go && j >= (int)(s & 3u)) {
        if (ks[j] == key) {
          const int32_t v = __ldg(tv + base + j);
#pragma unroll
          for (int c = 0; c < M; ++c)
            if (c == count) row[c] = v;
          ++count;
        }
        ++i;
        go = ks[j] != empty_key && i < max_probes && count < M;
      }
    }
  }
  return count;
}

}  // namespace repro_hash
