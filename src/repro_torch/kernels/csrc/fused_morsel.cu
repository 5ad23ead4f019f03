// Fused per-morsel pipeline: a run of FilterProject stages over one morsel
// in one launch, as a fixed kernel that interprets a small typed register
// program over tiles of rows held in shared memory.
//
// Replaces: src/repro/core/fused.py, fused_morsel_program (:78), with its
// probe variant (probe_loop, src/repro/kernels/hash_probe.py:33). There the
// stages' expression trees were traced into one Pallas kernel per query
// shape, and each 1024-row block flowed filter -> project -> probe through
// VMEM, with the join's table resident there. A CUDA kernel cannot be
// traced from Python, and writing and compiling CUDA source per query
// would put nvcc on the query path; so the host lowers the stages
// (repro_torch/core/fused.py, lower_stages) into a flat list of typed
// instructions over 32-bit registers, and this kernel, built once from
// this source, runs that list.
//
// Bound: bytes. Each row reads its input columns and validity once and
// writes its output columns and validity once (Q1: 29 B in and 29 B out per
// row; Q6: 13 B in and 5 B out); a few dozen register operations per row
// are far below the card's arithmetic rate. With a probe each row also
// writes found and bidx (5 B) and walks its key's run in the table, which
// stays in device memory (up to 2^25 slots; its hot part sits in the L2).
//
// Design: the tile interpreter of fused_interp.cuh, as the reference's
// 1024-row block: a CTA of 256 threads takes a tile of 1024 rows, four a
// thread, copies the tile's input columns and validity into shared memory
// with cp.async (the next tile's in flight while this one computes), and
// runs the program one instruction at a time over the tile, its registers
// slots of shared memory and its constants one word for the whole tile.
// It replaced one thread a row walking the whole program, which decoded
// every instruction for every row, kept its registers in local memory and
// had one load in flight at a time.
// * FILTER ANDs into the validity of the thread's four rows, held in its
//   registers; STORE32 writes 16 bytes a thread, STORE8 and the validity 4.
// * The probe is the last instruction: the host lowers the probe key (the
//   raw int column, or the injective pack of several) into a slot, and
//   PROBE walks the four keys' runs one after another (hash_probe.cuh's
//   probe_one, shared with the standalone probe) and stores found (masked
//   by the row's final validity and by key != empty_key, as the reference
//   masks it; 4 bytes a thread) and bidx (16 bytes). Every row is probed,
//   dead ones too, so bidx equals the reference's everywhere.
// * A fixed-width bytes column (uint8[n, width], Q22's c_phone) is read one
//   byte a row: its slot carries its row width, and LOADB loads byte b of
//   the row, zero-extended. The host lowers PrefixCode to LOADBs and int32
//   arithmetic, and SQL's LIKE (BytesMatch) to a BYTESMATCH, which walks
//   the row's windows against a pattern of the plan's pool (copied into
//   shared memory with the code). A bytes column a stage only carries is
//   never loaded: the host hands back the input tensor.
// * EXTRACT(YEAR ...) is the ALU instruction YEAR: the reference's table of
//   year starts, as a clamp to 1969..2039 and the 1461-day leap cycle.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fused_interp.cuh"
#include "hash_probe.cuh"

using namespace repro_fused;

namespace {

struct Probe {
  const int32_t* tk;   // table keys and values, int32[mask + 1]
  const int32_t* tv;
  uint32_t mask;
  int max_probes;
  int32_t empty_key;
  unsigned char* found;
  int32_t* bidx;
};

__global__ void __launch_bounds__(kThreads)
fused_morsel_kernel(const __grid_constant__ Plan p, const __grid_constant__ Columns cols,
                    const __grid_constant__ Probe probe,
                    const unsigned char* __restrict__ valid_in,
                    unsigned char* __restrict__ valid_out, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  prologue(p, cols, valid_in, smem, nullptr, 1, n_tiles, n);
  const Smem m = carve(p, smem);
  int it = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const unsigned char* stage = next_stage(p, cols, valid_in, m.ring, tile, n_tiles, n, it);
    const long long r0 = tile * kTileRows + kRowsPerThread * threadIdx.x;
    const int v = group_rows(r0, n);
    // bit k: row k of the thread's four is valid
    uint32_t valid = nonzero(fetch(kKindRing8 << kKindShift, m, stage, m.uni));
    for (int pc = 0; pc < p.n_tile; ++pc) {
      const int4 in = m.code[pc];
      if (exec_store(in, m, stage, m.uni, cols, r0, v)) continue;
      if (in.x == OP_FILTER) {
        valid &= nonzero(fetch(in.z, m, stage, m.uni));
      } else if (in.x == OP_PROBE) {
        const uint4 key4 = fetch(in.z, m, stage, m.uni);
        const int32_t key[kRowsPerThread] = {s(key4.x), s(key4.y), s(key4.z), s(key4.w)};
        int32_t val[kRowsPerThread];
        uint32_t hit = 0;
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          int32_t x = 0;
          const bool h = k < v && repro_hash::probe_one(probe.tk, probe.tv, probe.mask,
                                                        probe.max_probes, probe.empty_key,
                                                        key[k], &x);
          val[k] = x;
          if (h && key[k] != probe.empty_key) hit |= 1u << k;
        }
        store8(probe.found, r0, v, bytes_of(hit & valid));
        store32(probe.bidx, r0, v,
                make_uint4((uint32_t)val[0], (uint32_t)val[1], (uint32_t)val[2],
                           (uint32_t)val[3]));
      } else {
        exec_vec(in, m, stage, m.uni, cols, r0, v);
      }
    }
    store8(valid_out, r0, v, bytes_of(valid));
    after_tile(p, cols, valid_in, m.ring, tile, n_tiles, n);
  }
}

}  // namespace

// plan: the packed TilePlan (repro_torch/core/fused.py), plan_len int32s;
// in_ptrs/out_ptrs: host arrays of device pointers; in_widths: each
// input's row width if it is a bytes column, else 0. tk/tv/found/bidx are
// the probe's table and outputs, null when the program has no PROBE.
// Returns cudaErrorInvalidValue for a bad plan or a plan larger than the
// card's shared memory, else cudaGetLastError() after the launch.
extern "C" int fused_morsel_run(const int* plan, int plan_len,
                                const unsigned long long* in_ptrs,
                                const int* in_widths, int n_in,
                                const unsigned long long* out_ptrs, int n_out,
                                const void* valid_in, void* valid_out,
                                long long n, const void* tk, const void* tv,
                                int table_size, int max_probes, int empty_key,
                                void* found, void* bidx, void* stream) {
  Plan p;
  if (!read_plan(plan, plan_len, in_widths, n_in, n_out, false, 0, &p)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < p.n_tile; ++k) {
    if (p.ins[k].x == OP_PROBE &&
        (tk == nullptr || tv == nullptr || found == nullptr || bidx == nullptr ||
         table_size <= 0 || (table_size & (table_size - 1)) != 0)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (n <= 0) return 0;
  Columns c;
  memset(&c, 0, sizeof(c));
  for (int k = 0; k < n_in; ++k) {
    c.in[k] = reinterpret_cast<const void*>(in_ptrs[k]);
    c.width[k] = in_widths[k];
  }
  for (int k = 0; k < n_out; ++k) c.out[k] = reinterpret_cast<void*>(out_ptrs[k]);
  Probe pr;
  pr.tk = static_cast<const int32_t*>(tk);
  pr.tv = static_cast<const int32_t*>(tv);
  pr.mask = table_size > 0 ? (uint32_t)table_size - 1u : 0u;
  pr.max_probes = max_probes;
  pr.empty_key = (int32_t)empty_key;
  pr.found = static_cast<unsigned char*>(found);
  pr.bidx = static_cast<int32_t*>(bidx);
  const long long smem = smem_bytes(p, 1);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  int blocks = 0;
  const cudaError_t err = grid_for(reinterpret_cast<const void*>(fused_morsel_kernel),
                                   (int)smem, n_tiles, &blocks);
  if (err != cudaSuccess) return (int)err;
  fused_morsel_kernel<<<blocks, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      p, c, pr, static_cast<const unsigned char*>(valid_in),
      static_cast<unsigned char*>(valid_out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_morsel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
