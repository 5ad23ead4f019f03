// Inter-query batched fused pipeline: the shared projections and the
// predicate lanes of B stacked queries over one morsel, in one launch.
//
// Replaces: src/repro/core/fused.py, fused_batch_program (:178), with the
// stage walk it traces, src/repro/core/batch.py, apply_batched_stages
// (:317). There a Pallas kernel evaluated the stages once per 1024-row
// block in VMEM, with one unrolled copy of every filter per member lane
// and each lane's parameters broadcast into the block. Here the host lowers
// the stages (repro_torch/core/fused.py, lower_stages with batch=True) into
// the register program of fused_interp.cuh, the interpreter that
// fused_morsel.cu runs, and this kernel runs it with a loop over the lanes
// around each filter.
//
// Bound: bytes. Each row reads the input columns the program loads and its
// validity once, and writes its computed output columns once and one mask
// byte per lane (B bytes). Columns the stages pass through unchanged are
// not copied: the host hands back the input tensor, as the plain version
// does. The small-query aggregate at B = 32 (l_quantity, l_extendedprice,
// l_discount and the validity in; rev and 32 mask bytes out) moves about
// 49 B a row; its few hundred register operations a row are far below the
// card's arithmetic rate.
//
// Design:
// * One thread per row, grid-stride, as in fused_morsel.cu. Every
//   intermediate stays in the thread's registers; filters never narrow the
//   validity (the shared projections are validity-blind), they AND into
//   the row's lane mask.
// * The row's live lanes are one 64-bit word, so a launch takes at most 64
//   lanes; the host launches once per run of 64 lanes of a wider batch,
//   each with its slice of the parameters and its rows of the masks (every
//   launch writes the same lane-invariant stored columns). A filter stage is
//   LOOP, a body, LFILTER: the lane-invariant parts of the predicate are
//   computed once before the LOOP (the host hoists them), and the body,
//   with its PARAM loads of the lane's parameters, runs only for the lanes
//   still live, lowest first. A row with no live lane skips the body. The
//   host never reads a register the body wrote once the loop is over, so
//   skipping it is safe.
// * Parameters are one int32 array [slots, B] in device memory (int32,
//   date32 and bool values as int32, float32 as its bits). Every thread of
//   a warp reads the same word, which the cache broadcasts.
// * At the end each thread writes its B mask bytes lane-major, masks[b * n
//   + i]: for each lane, neighbouring threads write neighbouring bytes.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fused_interp.cuh"

using namespace repro_fused;

namespace {

__device__ __forceinline__ int lowest_lane(uint64_t live) {
  return __ffsll((long long)live) - 1;
}

__global__ void __launch_bounds__(kThreads)
fused_batch_kernel(const Program prog, const Columns cols,
                   const uint32_t* __restrict__ params, int lanes,
                   const unsigned char* __restrict__ valid_in,
                   unsigned char* __restrict__ masks, long long n) {
  uint32_t r[kMaxRegs] = {};
  const uint64_t all = lanes == 64 ? ~0ull : ((1ull << lanes) - 1ull);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint64_t live = valid_in[i] != 0 ? all : 0ull;
    int lane = 0;
    int loop_pc = 0;
    for (int pc = 0; pc < prog.n_instr; ++pc) {
      const int4 in = prog.ins[pc];
      if (is_load(in.x)) {
        r[in.y] = load(in, cols, i);
        continue;
      }
      switch (in.x) {
        case OP_PARAM:
          r[in.y] = params[(long long)in.z * lanes + lane];
          continue;
        case OP_LOOP:
          // a: the distance to the loop's LFILTER
          loop_pc = pc;
          if (live == 0ull) {
            pc += in.z;   // no live lane: past the LFILTER
          } else {
            lane = lowest_lane(live);
          }
          continue;
        case OP_LFILTER: {
          if (r[in.z] == 0u) live &= ~(1ull << lane);
          const uint64_t rest = lane < 63 ? live & (~0ull << (lane + 1)) : 0ull;
          if (rest != 0ull) {
            lane = lowest_lane(rest);
            pc = loop_pc;   // ++pc: the body's first instruction
          }
          continue;
        }
        case OP_STORE32:
          static_cast<uint32_t*>(cols.out[in.y])[i] = r[in.z];
          continue;
        case OP_STORE8:
          static_cast<unsigned char*>(cols.out[in.y])[i] = r[in.z] != 0u;
          continue;
        default: {
          uint32_t x;
          if (alu(in.x, r[in.z], r[in.w], &x)) r[in.y] = x;
        }
      }
    }
    for (int b = 0; b < lanes; ++b) {
      masks[(long long)b * n + i] = (unsigned char)((live >> b) & 1ull);
    }
  }
}

// Host-side check of the batched program's control instructions: no FILTER
// or PROBE, every PARAM slot in range, and every LOOP's distance landing on
// its own LFILTER with no LOOP or LFILTER between them.
bool valid_lanes(const int* prog, int n_instr, int n_slots) {
  int open = -1;
  for (int k = 0; k < n_instr; ++k) {
    const int* ins = prog + 4 * k;
    switch (ins[0]) {
      case OP_FILTER:
      case OP_PROBE:
        return false;
      case OP_PARAM:
        if (ins[2] < 0 || ins[2] >= n_slots) return false;
        break;
      case OP_LOOP:
        if (open >= 0 || ins[2] <= 0 || k + ins[2] >= n_instr ||
            prog[4 * (k + ins[2])] != OP_LFILTER) {
          return false;
        }
        open = k;
        break;
      case OP_LFILTER:
        if (open < 0 || open + prog[4 * open + 2] != k) return false;
        open = -1;
        break;
      default:
        break;
    }
  }
  return open < 0;
}

}  // namespace

// prog: n_instr * 4 host int32s; in_ptrs/out_ptrs: host arrays of device
// pointers (the outputs the program stores, in STORE order); in_widths:
// each input's row width if it is a bytes column, else 0; params: device
// int32[n_slots * lanes], slot-major; masks: device bool[lanes * n].
// Returns cudaGetLastError() after the launch.
extern "C" int fused_batch_run(const int* prog, int n_instr,
                               const unsigned long long* in_ptrs,
                               const int* in_widths, int n_in,
                               const unsigned long long* out_ptrs, int n_out,
                               const void* params, int n_slots, int lanes,
                               const void* valid_in, void* masks, long long n,
                               void* stream) {
  if (!valid_program(prog, n_instr, in_widths, n_in, n_out) || lanes < 1 ||
      lanes > kMaxLanes || n_slots < 0 || (n_slots > 0 && params == nullptr) ||
      !valid_lanes(prog, n_instr, n_slots)) {
    return (int)cudaErrorInvalidValue;
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
  fused_batch_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, c, static_cast<const uint32_t*>(params), lanes,
      static_cast<const unsigned char*>(valid_in),
      static_cast<unsigned char*>(masks), n);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
