// The register-program interpreter shared by the fused per-morsel kernel
// (fused_morsel.cu) and its inter-query batched variant (fused_batch.cu).
//
// The host (repro_torch/core/fused.py, lower_stages) lowers a run of
// FilterProject stages into a flat list of typed instructions over 32-bit
// registers, (op, dst, a, b) each; a kernel runs the list with one thread
// per row. This header holds what both kernels execute the same way: the
// opcodes, the limits, the program and column tables that travel in the
// launch's parameter space, the loads, and the arithmetic, comparison and
// logic instructions. Each kernel handles its own stores and control
// instructions (FILTER and PROBE in fused_morsel.cu; PARAM, LOOP and
// LFILTER in fused_batch.cu).
//
// Float arithmetic uses the round-to-nearest intrinsics, so no multiply
// and add fuse into an FMA: results are bit-identical to the plain PyTorch
// version. Integer arithmetic is unsigned, so it wraps.
//
// The opcode numbers and the limits below are mirrored in
// repro_torch/core/fused.py; a test parses this file to hold them equal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_fused {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kMaxInstr = 160;
constexpr int kMaxCols = 24;
constexpr int kMaxRegs = 48;
constexpr int kMaxLanes = 64;

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
  OP_PARAM = 33,    // r[dst] = parameter slot a of the current lane
  OP_LOOP = 34,     // start of a lane loop: lane = 0
  OP_LFILTER = 35,  // lane mask bit &= r[a] != 0; next lane, back to the LOOP
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

__device__ __forceinline__ float f(uint32_t bits) { return __uint_as_float(bits); }
__device__ __forceinline__ uint32_t u(float x) { return __float_as_uint(x); }
__device__ __forceinline__ int32_t s(uint32_t bits) { return (int32_t)bits; }

// Loads and constants carry immediates in a and b, not registers.
__device__ __forceinline__ bool is_load(int op) {
  return op == OP_LOAD32 || op == OP_LOAD8 || op == OP_CONST || op == OP_LOADB;
}

__device__ __forceinline__ uint32_t load(const int4 in, const Columns& cols,
                                         long long i) {
  switch (in.x) {
    case OP_LOAD32: return static_cast<const uint32_t*>(cols.in[in.z])[i];
    case OP_LOAD8: return static_cast<const unsigned char*>(cols.in[in.z])[i] != 0;
    case OP_CONST: return (uint32_t)in.z;
    default:  // OP_LOADB
      return static_cast<const unsigned char*>(cols.in[in.z])[i * cols.width[in.z] + in.w];
  }
}

// One arithmetic, comparison or logic instruction on the register values
// a and b; false for an opcode that is none of those.
__device__ __forceinline__ bool alu(int op, uint32_t a, uint32_t b, uint32_t* x) {
  switch (op) {
    case OP_ADD_I32: *x = a + b; return true;
    case OP_SUB_I32: *x = a - b; return true;
    case OP_MUL_I32: *x = a * b; return true;
    case OP_NEG_I32: *x = 0u - a; return true;
    case OP_ADD_F32: *x = u(__fadd_rn(f(a), f(b))); return true;
    case OP_SUB_F32: *x = u(__fsub_rn(f(a), f(b))); return true;
    case OP_MUL_F32: *x = u(__fmul_rn(f(a), f(b))); return true;
    case OP_DIV_F32: *x = u(__fdiv_rn(f(a), f(b))); return true;
    case OP_NEG_F32: *x = a ^ 0x80000000u; return true;
    case OP_EQ_I32: *x = s(a) == s(b); return true;
    case OP_NE_I32: *x = s(a) != s(b); return true;
    case OP_LT_I32: *x = s(a) < s(b); return true;
    case OP_LE_I32: *x = s(a) <= s(b); return true;
    case OP_GT_I32: *x = s(a) > s(b); return true;
    case OP_GE_I32: *x = s(a) >= s(b); return true;
    case OP_EQ_F32: *x = f(a) == f(b); return true;
    case OP_NE_F32: *x = f(a) != f(b); return true;
    case OP_LT_F32: *x = f(a) < f(b); return true;
    case OP_LE_F32: *x = f(a) <= f(b); return true;
    case OP_GT_F32: *x = f(a) > f(b); return true;
    case OP_GE_F32: *x = f(a) >= f(b); return true;
    case OP_AND: *x = (a != 0) & (b != 0); return true;
    case OP_OR: *x = (a != 0) | (b != 0); return true;
    case OP_NOT: *x = a == 0; return true;
    case OP_I32_TO_F32: *x = u(__int2float_rn(s(a))); return true;
    default: return false;
  }
}

// Host-side checks shared by both entry points: the instruction count and
// every byte load's column and offset. Returns false on a bad program.
inline bool valid_program(const int* prog, int n_instr, const int* in_widths,
                          int n_in, int n_out) {
  if (n_instr < 0 || n_instr > kMaxInstr || n_in < 0 || n_in > kMaxCols ||
      n_out < 0 || n_out > kMaxCols) {
    return false;
  }
  for (int k = 0; k < n_instr; ++k) {
    const int* ins = prog + 4 * k;
    if (ins[0] == OP_LOADB &&
        (ins[2] < 0 || ins[2] >= n_in || ins[3] < 0 || ins[3] >= in_widths[ins[2]])) {
      return false;
    }
  }
  return true;
}

inline int blocks_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace repro_fused
