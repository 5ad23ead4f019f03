// Radix histogram: the exchange's metadata phase, rows per partition.
//
// Replaces: src/repro/kernels/radix_histogram.py, radix_histogram (:36).
// There each 2048-row block built a one-hot [rows, P] matrix, summed it on
// the MXU, and carried the counts through the sequential grid in its output
// ref (zeroed at program_id 0, then +=). Hopper's blocks run in parallel and
// in no order, so nothing carries from one block to the next:
//   - a grid-stride loop over the int32 ids, warp-aligned so that every lane
//     of a warp runs every iteration;
//   - for P <= 8192, a per-block histogram in shared memory (32 KB); the
//     lanes of a warp that hold the same id are grouped by __match_any_sync
//     and their leader adds the group's size, so a warp with few distinct
//     ids (the exchange's W or W*W partitions) makes few shared atomics;
//   - then one atomicAdd per non-zero bin into the zeroed global int32[P];
//   - above 8192 bins the same grouped atomics go straight to global memory.
// Ids outside [0, P), negatives too, are skipped. All integer, so the
// counts are exact whatever order the blocks run in.
//
// Bound: bytes. Each id is read once (4 B) and each count written once; the
// exchange gives it W*W bins, so the flush is negligible. Loads are 4 B a
// lane (coalesced); a vectorised int4 load would cut the instruction count.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemBins = 8192;   // 32 KB of shared memory
constexpr int kBlocksPerSM = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// id: this lane's id in [0, P), or -1 for none. The lanes that hold the
// same id add their count through one leader (every lane of the warp calls
// this together).
__device__ __forceinline__ void add_grouped(int* hist, int id) {
  const unsigned peers = __match_any_sync(kFullMask, id);
  const int lane = threadIdx.x & 31;
  if (id >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[id], __popc(peers));
}

__global__ void __launch_bounds__(kThreads)
histogram_shared_kernel(const int* __restrict__ ids, long long n, int num_bins,
                        int* __restrict__ counts) {
  __shared__ int hist[kSmemBins];
  for (int p = threadIdx.x; p < num_bins; p += kThreads) hist[p] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    int id = i < n ? ids[i] : -1;
    if ((unsigned)id >= (unsigned)num_bins) id = -1;
    add_grouped(hist, id);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < num_bins; p += kThreads) {
    const int c = hist[p];
    if (c) atomicAdd(&counts[p], c);
  }
}

__global__ void __launch_bounds__(kThreads)
histogram_global_kernel(const int* __restrict__ ids, long long n, int num_bins,
                        int* __restrict__ counts) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    int id = i < n ? ids[i] : -1;
    if ((unsigned)id >= (unsigned)num_bins) id = -1;
    add_grouped(counts, id);
  }
}

}  // namespace

// ids: int32[n]; counts: int32[num_bins], zeroed here on the stream before
// the launch. n == 0 launches nothing (the counts are only zeroed). Returns
// cudaGetLastError() after the launch.
extern "C" int radix_histogram_run(const void* ids, long long n, int num_bins,
                                   void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || num_bins <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)num_bins, s);
  if (rc != cudaSuccess || n == 0) return (int)rc;
  int device = 0, sms = 0;
  if ((rc = cudaGetDevice(&device)) != cudaSuccess) return (int)rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
      != cudaSuccess) return (int)rc;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSM) blocks = (long long)sms * kBlocksPerSM;
  const int* in = static_cast<const int*>(ids);
  int* out = static_cast<int*>(counts);
  if (num_bins <= kSmemBins) {
    histogram_shared_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(in, n, num_bins, out);
  } else {
    histogram_global_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(in, n, num_bins, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* radix_histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
