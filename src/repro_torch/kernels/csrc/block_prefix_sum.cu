// Stream-compaction addresses: the exclusive prefix sum of a row mask, and
// its total.
//
// Replaces: src/repro/kernels/block_prefix_sum.py, block_prefix_sum (:40).
// There each 1024-row block took its exclusive positions from a triangular
// matmul on the MXU and carried the running total through the sequential
// grid in its output ref. Hopper's blocks run in parallel and in no order,
// so nothing carries from one block to the next; the scan takes three
// launches instead:
//   1. every block of 1024 rows counts its set rows (a ballot and a popc a
//      warp, the warp counts summed in shared memory) into block_sums;
//   2. one block scans block_sums in place into exclusive block offsets,
//      1024 at a time with a running carry, and writes the total;
//   3. every block recomputes its warps' ballots, takes each row's position
//      inside its warp as __popc(ballot & lanemask_lt), the warp offsets as
//      an exclusive scan of the warp counts in shared memory, and adds its
//      block offset.
// Integer arithmetic throughout, so the result is exact and does not depend
// on the order in which blocks run.
//
// Bound: bytes. The mask is read twice (1 B a row each time) and the
// positions written once (4 B a row); the block sums are 4 B per 1024 rows.
// A decoupled look-back scan would read the mask once, in one launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;    // one row a thread, 32 warps a block
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ unsigned row_ballot(const unsigned char* __restrict__ mask,
                                               long long n, bool* set) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  *set = i < n && mask[i] != 0;
  return __ballot_sync(kFullMask, *set);
}

// pass 1: the set rows of each block
__global__ void __launch_bounds__(kThreads)
block_count_kernel(const unsigned char* __restrict__ mask, long long n,
                   int* __restrict__ block_sums) {
  __shared__ int warp_counts[kThreads / 32];
  bool set;
  const unsigned ballot = row_ballot(mask, n, &set);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int total = __reduce_add_sync(kFullMask, warp_counts[lane]);
    if (lane == 0) block_sums[blockIdx.x] = total;
  }
}

// inclusive scan of one value a lane across a warp
__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// pass 2: exclusive scan of the block sums, in place, by one block; the
// total goes to *total
__global__ void __launch_bounds__(kThreads)
scan_block_sums_kernel(int* __restrict__ sums, int nblocks, int* __restrict__ total) {
  __shared__ int warp_incl[kThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nblocks; base += kThreads) {
    const int idx = base + threadIdx.x;
    const int v = idx < nblocks ? sums[idx] : 0;
    const int x = warp_inclusive_scan(v, lane);
    if (lane == 31) warp_incl[warp] = x;
    __syncthreads();
    if (warp == 0) warp_incl[lane] = warp_inclusive_scan(warp_incl[lane], lane);
    __syncthreads();
    const int before = carry + (warp ? warp_incl[warp - 1] : 0) + x - v;
    if (idx < nblocks) sums[idx] = before;
    __syncthreads();   // every thread has read carry and warp_incl
    if (threadIdx.x == 0) carry += warp_incl[kThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

// pass 3: each row's exclusive position
__global__ void __launch_bounds__(kThreads)
positions_kernel(const unsigned char* __restrict__ mask, long long n,
                 const int* __restrict__ block_offsets, int* __restrict__ pos) {
  __shared__ int warp_excl[kThreads / 32];
  bool set;
  const unsigned ballot = row_ballot(mask, n, &set);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_excl[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int c = warp_excl[lane];
    warp_excl[lane] = warp_inclusive_scan(c, lane) - c;
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const unsigned lanemask_lt = (1u << lane) - 1u;
    pos[i] = block_offsets[blockIdx.x] + warp_excl[warp] + __popc(ballot & lanemask_lt);
  }
}

}  // namespace

// mask: bool[n] (one byte a row); pos: int32[n]; total: one int32;
// scratch: one int32 per 1024 rows (the block sums). Returns cudaGetLastError()
// after the launches.
extern "C" int block_prefix_sum_run(const void* mask, long long n, void* pos,
                                    void* total, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > (long long)INT32_MAX) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaMemsetAsync(total, 0, sizeof(int), s);
  const long long nblocks = (n + kThreads - 1) / kThreads;
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  int* sums = static_cast<int*>(scratch);
  block_count_kernel<<<(unsigned)nblocks, kThreads, 0, s>>>(m, n, sums);
  scan_block_sums_kernel<<<1, kThreads, 0, s>>>(sums, (int)nblocks,
                                                static_cast<int*>(total));
  positions_kernel<<<(unsigned)nblocks, kThreads, 0, s>>>(m, n, sums,
                                                          static_cast<int*>(pos));
  return (int)cudaGetLastError();
}

extern "C" const char* block_prefix_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
