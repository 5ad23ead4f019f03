// Stream-compaction addresses: the exclusive prefix sum of a row mask, and
// its total.
//
// Replaces: src/repro/kernels/block_prefix_sum.py, block_prefix_sum (:40).
// There each 1024-row block took its exclusive positions from a triangular
// matmul on the MXU and carried the running total through the sequential
// grid in its output ref. Hopper's blocks run in parallel and in no order,
// so nothing carries from one block to the next by itself. Here one pass
// (a decoupled look-back scan) does the work:
//   - a CTA takes the next tile of kTileRows (16,384) rows from a counter
//     (atomicAdd), so a tile only ever waits on tiles already started and
//     the pass cannot deadlock;
//   - a tile is four sections of 4 rows a thread, so that a warp reads 128
//     and writes 512 contiguous bytes a section; each thread loads a 4-byte
//     word of mask bytes a section, turns it into 0/1 bytes and scans it in
//     a register (a multiply by 0x01010101), then the tile scans the thread
//     counts of the four sections at once, 16 bits each of a 64-bit word
//     (warp shuffles, then the warp totals);
//   - warp 0 publishes the tile's status word, flag and value packed into
//     64 bits (aggregate-ready, or prefix-ready with the inclusive prefix),
//     written with release and read with acquire, and looks back over its
//     predecessors' words 32 at a time, summing aggregates until it meets
//     a prefix; then it publishes its own prefix;
//   - positions go out as one 16-byte store a section; the last tile writes
//     the total.
// Integer arithmetic throughout, so the result is exact and does not depend
// on the order in which blocks run. The counter and the status words are
// the wrapper's scratch, zeroed by a memset on the same stream.
//
// Bound: bytes. The mask is read once (1 B a row) and the positions written
// once (4 B a row); the status words are 8 B per kTileRows rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSections = 4;          // a word of 4 rows a thread in each
constexpr int kSectionRows = 4 * kThreads;
constexpr int kTileRows = kSections * kSectionRows;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// the status word's flag, in its high 32 bits; 0 means not yet published
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// 1 in each byte of w that is not 0, else 0
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return w & 0x01010101u;
}

// inclusive scan of one value a lane across a warp
template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// the exclusive prefix of tile `tile` (> 0) from its predecessors' status
// words, by one warp, 32 words at a time
__device__ __forceinline__ unsigned look_back(const unsigned long long* status, int tile,
                                              int lane) {
  unsigned excl = 0;
  for (int last = tile - 1;; last -= 32) {
    const int i = last - lane;
    // past tile 0 there is nothing: a prefix of 0 (never reached, since
    // tile 0 publishes a prefix)
    unsigned long long w = i >= 0 ? load_status(status + i) : kPrefix;
    while (__any_sync(kFullMask, (w >> 32) == 0))
      if ((w >> 32) == 0) w = load_status(status + i);
    const unsigned prefixes = __ballot_sync(kFullMask, (w >> 32) == 2);
    if (prefixes) {
      // the nearest predecessor with a prefix, and the aggregates after it
      const int stop = __ffs(prefixes) - 1;
      return excl + __reduce_add_sync(kFullMask, lane <= stop ? (unsigned)w : 0u);
    }
    excl += __reduce_add_sync(kFullMask, (unsigned)w);
  }
}

// rows r..r + 3 as a word of 0/1 bytes: one 4-byte load when the mask is
// 4-byte aligned and the rows are all there
__device__ __forceinline__ uint32_t load_word(const unsigned char* __restrict__ mask,
                                              long long n, long long r, int vec) {
  if (vec && r + 4 <= n) return nonzero_bytes(*reinterpret_cast<const uint32_t*>(mask + r));
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (r + b < n && mask[r + b] != 0) w |= 1u << (8 * b);
  return w;
}

__global__ void __launch_bounds__(kThreads)
block_prefix_sum_kernel(const unsigned char* __restrict__ mask, long long n, int vec,
                        int* __restrict__ pos, int* __restrict__ total,
                        unsigned long long* __restrict__ scratch) {
  __shared__ int tile_s;
  __shared__ unsigned long long warp_incl[kWarps];
  __shared__ unsigned excl_s;
  unsigned long long* status = scratch + 1;   // scratch[0] is the tile counter
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = (int)atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  const int tile = tile_s;
  // thread t holds rows 4t..4t + 3 of each section: a warp reads 128 and
  // writes 512 contiguous bytes a section
  const long long r0 = (long long)tile * kTileRows + 4LL * threadIdx.x;
  uint32_t bits[kSections];
  unsigned long long packed = 0;   // the sections' counts, 16 bits each
#pragma unroll
  for (int i = 0; i < kSections; ++i) {
    bits[i] = load_word(mask, n, r0 + (long long)i * kSectionRows, vec);
    packed |= (unsigned long long)(bits[i] * 0x01010101u >> 24) << (16 * i);
  }

  // the tile's scan of the four sections' counts at once (a section holds
  // at most 4096 set rows)
  const unsigned long long incl = warp_inclusive_scan(packed, lane);
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  if (warp == 0) warp_incl[lane] = warp_inclusive_scan(warp_incl[lane], lane);
  __syncthreads();
  const unsigned long long sections = warp_incl[kWarps - 1];
  unsigned aggregate = 0;
#pragma unroll
  for (int i = 0; i < kSections; ++i) aggregate += (unsigned)(sections >> (16 * i)) & 0xffffu;

  // the tile's exclusive prefix, by the decoupled look-back
  if (warp == 0) {
    unsigned excl = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, kPrefix | aggregate);
    } else {
      if (lane == 0) store_status(status + tile, kAggregate | aggregate);
      excl = look_back(status, tile, lane);
      if (lane == 0) store_status(status + tile, kPrefix | (excl + aggregate));
    }
    if (lane == 0) excl_s = excl;
  }
  __syncthreads();
  if (tile == (int)gridDim.x - 1 && threadIdx.x == 0) *total = (int)(excl_s + aggregate);

  // each row's position: the tile's prefix, the earlier sections, this
  // section's earlier threads, the earlier rows of this word (in-word
  // inclusive byte sums are at most 4, so no carries)
  const unsigned long long before = (warp ? warp_incl[warp - 1] : 0ull) + incl - packed;
  unsigned start = excl_s;
#pragma unroll
  for (int i = 0; i < kSections; ++i) {
    const long long r = r0 + (long long)i * kSectionRows;
    const unsigned first = start + ((unsigned)(before >> (16 * i)) & 0xffffu);
    const uint32_t excl_bytes = bits[i] * 0x01010101u - bits[i];
    const int4 p = make_int4((int)(first + (excl_bytes & 0xffu)),
                             (int)(first + ((excl_bytes >> 8) & 0xffu)),
                             (int)(first + ((excl_bytes >> 16) & 0xffu)),
                             (int)(first + (excl_bytes >> 24)));
    if (r + 4 <= n) {
      *reinterpret_cast<int4*>(pos + r) = p;
    } else {
      if (r < n) pos[r] = p.x;
      if (r + 1 < n) pos[r + 1] = p.y;
      if (r + 2 < n) pos[r + 2] = p.z;
    }
    start += (unsigned)(sections >> (16 * i)) & 0xffffu;
  }
}

}  // namespace

// mask: bool[n] (one byte a row, any alignment); pos: int32[n], 16-byte
// aligned; total: one int32; scratch: 8 * (ceil(n / kTileRows) + 1) bytes
// (the tile counter and one status word a tile), zeroed here. Returns
// cudaGetLastError() after the memset and the launch.
extern "C" int block_prefix_sum_run(const void* mask, long long n, void* pos,
                                    void* total, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > (long long)INT32_MAX || reinterpret_cast<uintptr_t>(pos) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaMemsetAsync(total, 0, sizeof(int), s);
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  cudaError_t rc = cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * 8, s);
  if (rc != cudaSuccess) return (int)rc;
  const int vec = reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  block_prefix_sum_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const unsigned char*>(mask), n, vec, static_cast<int*>(pos),
      static_cast<int*>(total), static_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}

extern "C" const char* block_prefix_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
