// Fused per-morsel pipeline: a run of FilterProject stages over one morsel
// in one launch, as a fixed kernel that interprets a small typed register
// program.
//
// Replaces: src/repro/core/fused.py, fused_morsel_program (:78), with its
// probe variant (probe_loop, src/repro/kernels/hash_probe.py:33). There the
// stages' expression trees were traced into one Pallas kernel per query
// shape, and each 1024-row block flowed filter -> project -> probe through
// VMEM, with the join's table resident there. A CUDA kernel cannot be traced from Python, and
// writing and compiling CUDA source per query would put nvcc on the query
// path; so the host lowers the stages (repro_torch/core/fused.py,
// lower_stages) into a flat list of typed instructions over 32-bit
// registers, and this kernel, built once from this source, runs that list.
//
// Bound: bytes. Each row reads its input columns and validity once and
// writes its output columns and validity once (Q1: 29 B in and 29 B out per
// row; Q6: 13 B in and 5 B out); a few dozen register operations per row
// are far below the card's arithmetic rate. With a probe each row also
// writes found and bidx (5 B) and walks its key's run in the table, which
// stays in device memory (up to 2^25 slots; its hot part sits in the L2).
//
// Design:
// * One thread per row, grid-stride. Loads and stores of neighbouring rows
//   are neighbouring addresses, so they coalesce.
// * Every intermediate stays in the thread's registers (the array `r`),
//   as the TPU kernel kept it in VMEM: nothing between stages touches
//   device memory.
// * The program and the column pointers travel in the launch's parameter
//   space (constant memory). Every thread reads the same instruction at the
//   same time, which the constant cache broadcasts.
// * Float arithmetic uses the round-to-nearest intrinsics, so no multiply
//   and add fuse into an FMA: results are bit-identical to the plain
//   PyTorch version. Integer arithmetic is unsigned, so it wraps.
// * The probe is the last instruction: the host lowers the probe key (the
//   raw int column, or the injective pack of several) into registers, and
//   PROBE walks that key's run (hash_probe.cuh, shared with the standalone
//   probe) and stores found (masked by the row's final validity and by
//   key != empty_key, as the reference masks it) and bidx. Every row is
//   probed, dead ones too, so bidx equals the reference's everywhere.
// * A fixed-width bytes column (uint8[n, width], Q22's c_phone) is read one
//   byte at a time: its slot carries its row width, and LOADB loads byte b
//   of the row, zero-extended. The host lowers PrefixCode to LOADBs and
//   int32 arithmetic.
//
// The interpreter (opcodes, limits, loads and arithmetic) lives in
// fused_interp.cuh, shared with the batched variant in fused_batch.cu.
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
fused_morsel_kernel(const Program prog, const Columns cols, const Probe probe,
                    const unsigned char* __restrict__ valid_in,
                    unsigned char* __restrict__ valid_out, long long n) {
  uint32_t r[kMaxRegs] = {};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool valid = valid_in[i] != 0;
    for (int pc = 0; pc < prog.n_instr; ++pc) {
      const int4 in = prog.ins[pc];
      if (is_load(in.x)) {
        r[in.y] = load(in, cols, i);
        continue;
      }
      const uint32_t a = r[in.z];
      const uint32_t b = r[in.w];
      switch (in.x) {
        case OP_STORE32: static_cast<uint32_t*>(cols.out[in.y])[i] = a; continue;
        case OP_STORE8: static_cast<unsigned char*>(cols.out[in.y])[i] = a != 0; continue;
        case OP_FILTER: valid = valid && (a != 0); continue;
        case OP_PROBE: {
          int32_t v;
          const bool hit = repro_hash::probe_one(probe.tk, probe.tv, probe.mask,
                                                 probe.max_probes,
                                                 probe.empty_key, s(a), &v);
          probe.found[i] = hit && valid && s(a) != probe.empty_key;
          probe.bidx[i] = v;
          continue;
        }
        default: {
          uint32_t x;
          if (alu(in.x, a, b, &x)) r[in.y] = x;
        }
      }
    }
    valid_out[i] = valid;
  }
}

}  // namespace

// prog: n_instr * 4 host int32s; in_ptrs/out_ptrs: host arrays of device
// pointers; in_widths: each input's row width if it is a bytes column, else
// 0. tk/tv/found/bidx are the probe's table and outputs, null when the
// program has no PROBE. Returns cudaGetLastError() after the launch.
extern "C" int fused_morsel_run(const int* prog, int n_instr,
                                const unsigned long long* in_ptrs,
                                const int* in_widths, int n_in,
                                const unsigned long long* out_ptrs, int n_out,
                                const void* valid_in, void* valid_out,
                                long long n, const void* tk, const void* tv,
                                int table_size, int max_probes, int empty_key,
                                void* found, void* bidx, void* stream) {
  if (!valid_program(prog, n_instr, in_widths, n_in, n_out)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < n_instr; ++k) {
    const int op = prog[4 * k];
    if (op == OP_PARAM || op == OP_LOOP || op == OP_LFILTER) {
      return (int)cudaErrorInvalidValue;   // the batched kernel's
    }
    if (op == OP_PROBE &&
        (tk == nullptr || tv == nullptr || found == nullptr || bidx == nullptr ||
         table_size <= 0 || (table_size & (table_size - 1)) != 0)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (n <= 0) return 0;
  Program p;
  memset(&p, 0, sizeof(p));
  p.n_instr = n_instr;
  memcpy(p.ins, prog, sizeof(int4) * (size_t)n_instr);
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
  fused_morsel_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, c, pr, static_cast<const unsigned char*>(valid_in),
      static_cast<unsigned char*>(valid_out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_morsel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
