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
// The opcode numbers and the limits below are mirrored in
// repro_torch/core/fused.py; a test parses this file to hold them equal.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hash_probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kMaxInstr = 160;
constexpr int kMaxCols = 24;
constexpr int kMaxRegs = 48;

enum Op : int {
  OP_LOAD32 = 0,   // r[dst] = 32-bit column a at this row
  OP_LOAD8 = 1,    // r[dst] = bool column a at this row (0 or 1)
  OP_CONST = 2,    // r[dst] = bits a
  OP_STORE32 = 3,  // 32-bit output column dst = r[a]
  OP_STORE8 = 4,   // bool output column dst = r[a] != 0
  OP_FILTER = 5,   // validity &= r[a] != 0
  OP_ADD_I32 = 6,
  OP_SUB_I32 = 7,
  OP_MUL_I32 = 8,
  OP_NEG_I32 = 9,
  OP_ADD_F32 = 10,
  OP_SUB_F32 = 11,
  OP_MUL_F32 = 12,
  OP_DIV_F32 = 13,
  OP_NEG_F32 = 14,
  OP_EQ_I32 = 15,
  OP_NE_I32 = 16,
  OP_LT_I32 = 17,
  OP_LE_I32 = 18,
  OP_GT_I32 = 19,
  OP_GE_I32 = 20,
  OP_EQ_F32 = 21,
  OP_NE_F32 = 22,
  OP_LT_F32 = 23,
  OP_LE_F32 = 24,
  OP_GT_F32 = 25,
  OP_GE_F32 = 26,
  OP_AND = 27,      // (r[a] != 0) & (r[b] != 0)
  OP_OR = 28,       // (r[a] != 0) | (r[b] != 0)
  OP_NOT = 29,      // r[a] == 0
  OP_I32_TO_F32 = 30,
  OP_PROBE = 31,    // probe the join's table with key r[a]; store found, bidx
  OP_LOADB = 32,    // r[dst] = byte b of this row of bytes column a
};

struct Program {
  int n_instr;
  int4 ins[kMaxInstr];   // (op, dst, a, b)
};

struct Columns {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int width[kMaxCols];   // row width of a bytes input column, else 0
};

struct Probe {
  const int32_t* tk;   // table keys and values, int32[mask + 1]
  const int32_t* tv;
  uint32_t mask;
  int max_probes;
  int32_t empty_key;
  unsigned char* found;
  int32_t* bidx;
};

__device__ __forceinline__ float f(uint32_t bits) { return __uint_as_float(bits); }
__device__ __forceinline__ uint32_t u(float x) { return __float_as_uint(x); }
__device__ __forceinline__ int32_t s(uint32_t bits) { return (int32_t)bits; }

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
      // loads and constants carry immediates in a and b, not registers
      const bool imm = in.x == OP_LOAD32 || in.x == OP_LOAD8 ||
                       in.x == OP_CONST || in.x == OP_LOADB;
      const uint32_t a = imm ? 0u : r[in.z];
      const uint32_t b = imm ? 0u : r[in.w];
      uint32_t x = 0;
      switch (in.x) {
        case OP_LOAD32: x = static_cast<const uint32_t*>(cols.in[in.z])[i]; break;
        case OP_LOAD8: x = static_cast<const unsigned char*>(cols.in[in.z])[i] != 0; break;
        case OP_CONST: x = (uint32_t)in.z; break;
        case OP_LOADB:
          x = static_cast<const unsigned char*>(cols.in[in.z])[i * cols.width[in.z] + in.w];
          break;
        case OP_STORE32: static_cast<uint32_t*>(cols.out[in.y])[i] = a; continue;
        case OP_STORE8: static_cast<unsigned char*>(cols.out[in.y])[i] = a != 0; continue;
        case OP_FILTER: valid = valid && (a != 0); continue;
        case OP_ADD_I32: x = a + b; break;
        case OP_SUB_I32: x = a - b; break;
        case OP_MUL_I32: x = a * b; break;
        case OP_NEG_I32: x = 0u - a; break;
        case OP_ADD_F32: x = u(__fadd_rn(f(a), f(b))); break;
        case OP_SUB_F32: x = u(__fsub_rn(f(a), f(b))); break;
        case OP_MUL_F32: x = u(__fmul_rn(f(a), f(b))); break;
        case OP_DIV_F32: x = u(__fdiv_rn(f(a), f(b))); break;
        case OP_NEG_F32: x = a ^ 0x80000000u; break;
        case OP_EQ_I32: x = s(a) == s(b); break;
        case OP_NE_I32: x = s(a) != s(b); break;
        case OP_LT_I32: x = s(a) < s(b); break;
        case OP_LE_I32: x = s(a) <= s(b); break;
        case OP_GT_I32: x = s(a) > s(b); break;
        case OP_GE_I32: x = s(a) >= s(b); break;
        case OP_EQ_F32: x = f(a) == f(b); break;
        case OP_NE_F32: x = f(a) != f(b); break;
        case OP_LT_F32: x = f(a) < f(b); break;
        case OP_LE_F32: x = f(a) <= f(b); break;
        case OP_GT_F32: x = f(a) > f(b); break;
        case OP_GE_F32: x = f(a) >= f(b); break;
        case OP_AND: x = (a != 0) & (b != 0); break;
        case OP_OR: x = (a != 0) | (b != 0); break;
        case OP_NOT: x = a == 0; break;
        case OP_I32_TO_F32: x = u(__int2float_rn(s(a))); break;
        case OP_PROBE: {
          int32_t v;
          const bool hit = repro_hash::probe_one(probe.tk, probe.tv, probe.mask,
                                                 probe.max_probes,
                                                 probe.empty_key, s(a), &v);
          probe.found[i] = hit && valid && s(a) != probe.empty_key;
          probe.bidx[i] = v;
          continue;
        }
        default: continue;
      }
      r[in.y] = x;
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
  if (n_instr < 0 || n_instr > kMaxInstr || n_in < 0 || n_in > kMaxCols ||
      n_out < 0 || n_out > kMaxCols) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < n_instr; ++k) {
    const int* ins = prog + 4 * k;
    if (ins[0] == OP_LOADB &&
        (ins[2] < 0 || ins[2] >= n_in || ins[3] < 0 || ins[3] >= in_widths[ins[2]])) {
      return (int)cudaErrorInvalidValue;
    }
    if (prog[4 * k] == OP_PROBE &&
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
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  fused_morsel_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, c, pr, static_cast<const unsigned char*>(valid_in),
      static_cast<unsigned char*>(valid_out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_morsel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
