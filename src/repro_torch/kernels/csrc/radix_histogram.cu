// Radix histogram: the exchange's metadata phase, rows per partition.
//
// Replaces: src/repro/kernels/radix_histogram.py, radix_histogram (:36).
// There each 2048-row block built a one-hot [rows, P] matrix, summed it on
// the MXU, and carried the counts through the sequential grid in its output
// ref (zeroed at program_id 0, then +=). Hopper's blocks run in parallel and
// in no order, so nothing carries from one block to the next. Two entry
// points:
//
// partition_histogram_run -- the exchange's metadata phase as one pass, the
// kernel the main path launches (one launch a repartition). It also takes
// the place of the reference's partition hash (src/repro/core/relational.py,
// hash_combine :48 and partition_ids :347, jnp that XLA fuses into one pass
// on the TPU; in eager torch it was some twenty int64 kernels a key column
// and source). For each row of each of the W source tables it computes the
// reference's hash_combine in uint32, bit for bit (each key column through
// the murmur3 finalizer masked to 0x7FFFFFFE, a bytes column folded first
// as folded * 31 + byte over its lanes, mixed as h ^ (hc + 0x9E3779B9 +
// (h << 6) + (h >> 2)), the result masked to 0x7FFFFFFE), writes
// pid = h mod W (W for a dead row) into the flat pids at the source's
// offset, and counts the (source, destination) bins:
//   - one launch for all W sources: the launcher copies the per-source
//     pointers, lengths and offsets into a parameter struct passed by
//     value (no device-side pointer array, no host-to-device copy);
//   - a warp step is 32 chunks of 4 rows of one source; chunks follow the
//     first int32 key column's 16-byte boundaries (else the pids'), so a
//     view at a row offset starts with a short head chunk; each array that
//     is aligned on that grid loads (stores) a chunk as one int4 (the
//     validity as one 4-byte word), the others and the head and tail
//     chunks row by row; the validity comes first, and a chunk of four dead
//     rows loads no key (the exchange hands it tables of 2^23 slots with
//     few live rows);
//   - W <= 8, so a lane counts its live rows per destination in 16-bit
//     fields of two 64-bit registers; a warp adds its W sums into a
//     per-block shared histogram when its source changes (and every 16,383
//     steps), and the block adds its W * W bins to the zeroed output once.
//     No shared atomic a row: placement sends every row to an even worker,
//     so half the bins are hot.
//
// radix_histogram_run -- the standalone port of the TPU kernel over int32
// ids (ids outside [0, P), negatives too, are skipped):
//   - a grid-stride loop over the ids, warp-aligned so that every lane of a
//     warp runs every iteration;
//   - for P <= 8192, a per-block histogram in shared memory (32 KB); the
//     lanes of a warp that hold the same id are grouped by __match_any_sync
//     and their leader adds the group's size;
//   - then one atomicAdd per non-zero bin into the zeroed global int32[P];
//   - above 8192 bins the same grouped atomics go straight to global memory.
// All integer, so the counts are exact whatever order the blocks run in.
//
// Bound: bytes. The metadata pass reads 1 B of validity a row and the key
// bytes of the live rows (4 B a row for an int32 column, a byte a lane for
// a bytes column), and writes 4 B of pid a row; the hash is some ten
// integer operations a column and row. The standalone histogram reads each id once
// (4 B); its W * W counts are negligible.
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

// ---------------------------------------------------------------------------
// the exchange's metadata pass
// ---------------------------------------------------------------------------

constexpr int kMaxSources = 8;     // W <= 8: at most 64 (source, destination) bins
constexpr int kMaxKeyCols = 16;
constexpr int kPartThreads = 256;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kChunkRows = 4;      // rows a lane of a warp step
constexpr int kStepChunks = 32;    // chunks a warp step
// bits of PartitionArgs::vec beside the key columns' (bit k: column k)
constexpr unsigned kVecValid = 1u << 30;
constexpr unsigned kVecPids = 1u << 31;

struct PartitionArgs {
  // keys[s][k]: source s's key column k, int32[n] (width 0) or
  // uint8[n, width] with rows stride[s][k] bytes apart
  const void* keys[kMaxSources][kMaxKeyCols];
  int stride[kMaxSources][kMaxKeyCols];
  int width[kMaxKeyCols];
  const unsigned char* valid[kMaxSources];   // bool[n]
  long long n[kMaxSources];
  long long out_at[kMaxSources];     // the source's first row in pids
  long long step_at[kMaxSources + 1];   // its first warp step; the total last
  int head[kMaxSources];   // chunk c covers rows [4c - head, 4c - head + 4)
  unsigned vec[kMaxSources];   // the arrays aligned on the chunk grid
  int num_cols;
  int num_sources;
  int* pids;     // int32[sum n]
  int* counts;   // int32[W * W], zeroed before the launch
};

// The reference's hash32 before its cast: the murmur3 finalizer, masked.
__device__ __forceinline__ uint32_t fmix_masked(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x & 0x7FFFFFFEu;
}

// One column's mix into the running hash (hash_combine's `mix`).
__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t u) {
  return h ^ (fmix_masked(u) + 0x9E3779B9u + (h << 6) + (h >> 2));
}

__device__ __forceinline__ bool in_rows(long long r, long long n) {
  return r >= 0 && r < n;
}

// A lane's live rows by destination, in 16-bit fields of two registers
// (destinations 0-3 in lo, 4-7 in hi): W-independent, so no variant keeps
// an array of W counts. A lane adds at most 4 rows a warp step, and a warp
// flushes at least every kFlushSteps steps, so no field overflows.
constexpr int kFlushSteps = 16383;

struct LaneCounts {
  unsigned long long lo, hi;
  __device__ __forceinline__ void add(int p) {
    const unsigned long long one = 1ull << (16 * (p & 3));
    if (p < 4) lo += one;
    else hi += one;
  }
  __device__ __forceinline__ unsigned get(int d) const {
    return (unsigned)(((d < 4 ? lo : hi) >> (16 * (d & 3))) & 0xFFFFu);
  }
};

// A row's destination (W for a dead row); a live row is counted.
template <int W>
__device__ __forceinline__ int count_row(LaneCounts& cnt, bool live,
                                         uint32_t h) {
  const int p = live ? (int)((h & 0x7FFFFFFEu) % (uint32_t)W) : W;
  if (live) cnt.add(p);
  return p;
}

// The warp's per-destination counts of source `src` into the block's bins.
template <int W>
__device__ __forceinline__ void flush_counts(LaneCounts& cnt, int* hist,
                                             int src) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 0; d < W; ++d) {
    const unsigned v = __reduce_add_sync(kFullMask, cnt.get(d));
    if (lane == 0 && v) atomicAdd(&hist[src * W + d], (int)v);
  }
  cnt.lo = cnt.hi = 0;
}

template <int W>
__global__ void __launch_bounds__(kPartThreads)
partition_histogram_kernel(const __grid_constant__ PartitionArgs a) {
  __shared__ int hist[W * W];
  for (int i = threadIdx.x; i < W * W; i += kPartThreads) hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long total = a.step_at[a.num_sources];
  const long long warps = (long long)gridDim.x * kPartWarps;
  LaneCounts cnt = {0ull, 0ull};
  int src = -1;   // warp-uniform: a warp's steps go up, so do their sources
  int since = 0;  // the warp's steps since its last flush
  for (long long step = (long long)blockIdx.x * kPartWarps + (threadIdx.x >> 5);
       step < total; step += warps) {
    int s = src < 0 ? 0 : src;
    while (step >= a.step_at[s + 1]) ++s;
    if (s != src || since == kFlushSteps) {
      if (src >= 0) flush_counts<W>(cnt, hist, src);
      src = s;
      since = 0;
    }
    ++since;
    const long long n = a.n[s];
    const long long r0 =
        ((step - a.step_at[s]) * kStepChunks + lane) * kChunkRows - a.head[s];
    const bool full = r0 >= 0 && r0 + kChunkRows <= n;
    const unsigned vec = full ? a.vec[s] : 0u;
    bool live[kChunkRows];
    const unsigned char* v = a.valid[s] + r0;
    if (vec & kVecValid) {
      const unsigned w4 = __ldg(reinterpret_cast<const unsigned*>(v));
#pragma unroll
      for (int j = 0; j < kChunkRows; ++j) live[j] = (w4 >> (8 * j)) & 0xffu;
    } else {
#pragma unroll
      for (int j = 0; j < kChunkRows; ++j)
        live[j] = in_rows(r0 + j, n) && __ldg(v + j);
    }
    // a chunk of dead rows reads no key
    uint32_t h[kChunkRows] = {0u, 0u, 0u, 0u};
    if (live[0] || live[1] || live[2] || live[3]) {
      for (int k = 0; k < a.num_cols; ++k) {
        uint32_t u[kChunkRows];
        const int width = a.width[k];
        if (width == 0) {
          const int* p = static_cast<const int*>(a.keys[s][k]) + r0;
          if (vec & (1u << k)) {
            const int4 kv = __ldg(reinterpret_cast<const int4*>(p));
            u[0] = (uint32_t)kv.x; u[1] = (uint32_t)kv.y;
            u[2] = (uint32_t)kv.z; u[3] = (uint32_t)kv.w;
          } else {
#pragma unroll
            for (int j = 0; j < kChunkRows; ++j)
              u[j] = in_rows(r0 + j, n) ? (uint32_t)__ldg(p + j) : 0u;
          }
        } else {
          const unsigned char* p = static_cast<const unsigned char*>(a.keys[s][k]);
          const long long stride = a.stride[s][k];
#pragma unroll
          for (int j = 0; j < kChunkRows; ++j) {
            uint32_t folded = 0u;
            if (in_rows(r0 + j, n)) {
              const unsigned char* row = p + (r0 + j) * stride;
              for (int b = 0; b < width; ++b) folded = folded * 31u + __ldg(row + b);
            }
            u[j] = folded;
          }
        }
#pragma unroll
        for (int j = 0; j < kChunkRows; ++j) h[j] = mix(h[j], u[j]);
      }
    }
    const int4 pid = make_int4(count_row<W>(cnt, live[0], h[0]),
                               count_row<W>(cnt, live[1], h[1]),
                               count_row<W>(cnt, live[2], h[2]),
                               count_row<W>(cnt, live[3], h[3]));
    int* o = a.pids + a.out_at[s] + r0;
    if (vec & kVecPids) {
      *reinterpret_cast<int4*>(o) = pid;
    } else {
      if (in_rows(r0, n)) o[0] = pid.x;
      if (in_rows(r0 + 1, n)) o[1] = pid.y;
      if (in_rows(r0 + 2, n)) o[2] = pid.z;
      if (in_rows(r0 + 3, n)) o[3] = pid.w;
    }
  }
  if (src >= 0) flush_counts<W>(cnt, hist, src);
  __syncthreads();
  for (int i = threadIdx.x; i < W * W; i += kPartThreads) {
    const int c = hist[i];
    if (c) atomicAdd(&a.counts[i], c);
  }
}

constexpr int kMaxDevices = 64;

// The grid of partition_histogram_kernel<W>: resident blocks a SM (from
// the occupancy of this variant) times the SMs, both read once for each
// device (the current one: the caller runs with its tensors' device
// current), at most one warp a step.
template <int W>
cudaError_t launch_partition(const PartitionArgs& a, cudaStream_t s) {
  static int per_sm_of[kMaxDevices];
  static int sms_of[kMaxDevices];
  cudaError_t rc;
  int device = 0;
  if ((rc = cudaGetDevice(&device)) != cudaSuccess) return rc;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  int per_sm = per_sm_of[device], sms = sms_of[device];
  if (per_sm == 0) {
    int blocks = 0;
    if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device)) != cudaSuccess) return rc;
    if ((rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, partition_histogram_kernel<W>, kPartThreads, 0))
        != cudaSuccess) return rc;
    per_sm = blocks > 0 ? blocks : 1;
    sms_of[device] = sms;
    per_sm_of[device] = per_sm;
  }
  const long long steps = a.step_at[a.num_sources];
  long long grid = (steps + kPartWarps - 1) / kPartWarps;
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  partition_histogram_kernel<W><<<(unsigned)grid, kPartThreads, 0, s>>>(a);
  return cudaGetLastError();
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

// The exchange's metadata pass over W = num_sources source tables.
// keys: num_sources * num_cols device pointers, source-major; strides: the
// same count of row strides in bytes (read for bytes columns only); widths:
// num_cols lane counts, 0 for an int32 column; valid: num_sources bool[n]
// pointers; n: num_sources row counts. Writes pids int32[sum n] (each
// source's rows at the sum of the earlier sources' n) and counts
// int32[W * W] (zeroed here on the stream first). Returns
// cudaErrorInvalidValue for W outside [1, 8], num_cols outside [1, 16] or
// a negative n, else cudaGetLastError() after the launch; no rows launch
// nothing.
extern "C" int partition_histogram_run(const unsigned long long* keys,
                                       const long long* strides,
                                       const int* widths, int num_cols,
                                       const unsigned long long* valid,
                                       const long long* n, int num_sources,
                                       void* pids, void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = num_sources;
  if (w < 1 || w > kMaxSources || num_cols < 1 || num_cols > kMaxKeyCols) {
    return (int)cudaErrorInvalidValue;
  }
  PartitionArgs a;
  a.num_cols = num_cols;
  a.num_sources = w;
  a.pids = static_cast<int*>(pids);
  a.counts = static_cast<int*>(counts);
  for (int k = 0; k < num_cols; ++k) {
    if (widths[k] < 0) return (int)cudaErrorInvalidValue;
    a.width[k] = widths[k];
  }
  const uintptr_t out = reinterpret_cast<uintptr_t>(pids);
  long long at = 0, step = 0;
  for (int src = 0; src < w; ++src) {
    if (n[src] < 0) return (int)cudaErrorInvalidValue;
    const unsigned long long* kp = keys + (long long)src * num_cols;
    // the chunk grid: 16-byte boundaries of the first int32 key column,
    // else of the pids
    int anchor = -1;
    for (int k = 0; k < num_cols && anchor < 0; ++k)
      if (widths[k] == 0) anchor = k;
    const uintptr_t base = anchor >= 0 ? (uintptr_t)kp[anchor]
                                       : out + 4 * (uintptr_t)at;
    const int head = n[src] > 0 ? (int)((base & 15u) >> 2) : 0;
    unsigned vec = 0;
    for (int k = 0; k < num_cols; ++k) {
      a.keys[src][k] = reinterpret_cast<const void*>(kp[k]);
      a.stride[src][k] = (int)strides[(long long)src * num_cols + k];
      if (widths[k] == 0 && ((kp[k] - 4 * (unsigned long long)head) & 15u) == 0)
        vec |= 1u << k;
    }
    if (((valid[src] - (unsigned long long)head) & 3u) == 0) vec |= kVecValid;
    if (((out + 4 * ((uintptr_t)at - head)) & 15u) == 0) vec |= kVecPids;
    a.valid[src] = reinterpret_cast<const unsigned char*>(valid[src]);
    a.n[src] = n[src];
    a.out_at[src] = at;
    a.head[src] = head;
    a.vec[src] = vec;
    a.step_at[src] = step;
    const long long chunks = (n[src] + head + kChunkRows - 1) / kChunkRows;
    step += (chunks + kStepChunks - 1) / kStepChunks;
    at += n[src];
  }
  a.step_at[w] = step;
  cudaError_t rc = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)(w * w), s);
  if (rc != cudaSuccess || step == 0) return (int)rc;
  switch (w) {
    case 1: rc = launch_partition<1>(a, s); break;
    case 2: rc = launch_partition<2>(a, s); break;
    case 3: rc = launch_partition<3>(a, s); break;
    case 4: rc = launch_partition<4>(a, s); break;
    case 5: rc = launch_partition<5>(a, s); break;
    case 6: rc = launch_partition<6>(a, s); break;
    case 7: rc = launch_partition<7>(a, s); break;
    default: rc = launch_partition<8>(a, s); break;
  }
  return (int)rc;
}

extern "C" const char* radix_histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
