// Inter-query batched fused pipeline: the shared projections and the
// predicate lanes of B stacked queries over one morsel, in one launch.
//
// Replaces: src/repro/core/fused.py, fused_batch_program (:178), with the
// stage walk it traces, src/repro/core/batch.py, apply_batched_stages
// (:317). There a Pallas kernel evaluated the stages once per 1024-row
// block in VMEM, with one unrolled copy of every filter per member lane
// and each lane's parameters broadcast into the block. Here the host lowers
// the stages (repro_torch/core/fused.py, lower_stages with batch=True) into
// the program of fused_interp.cuh, the tile interpreter that
// fused_morsel.cu runs, and this kernel runs it with a loop over the lanes
// around each filter.
//
// Bound: bytes. Each row reads the input columns the program loads and its
// validity once, and writes its computed output columns once and one mask
// byte per lane (B bytes). Columns the stages pass through unchanged are
// not copied: the host hands back the input tensor, as the plain version
// does. The small-query aggregate at B = 32 (l_quantity, l_extendedprice,
// l_discount and the validity in; rev and 32 mask bytes out) moves about
// 49 B a row; its hundred-odd register operations a row are far below the
// card's arithmetic rate.
//
// Design: the tile interpreter of fused_interp.cuh (a CTA of 256 threads
// over a tile of 1024 rows, four a thread; columns copied into shared
// memory by cp.async, the next tile's in flight; registers as slots of
// shared memory). It replaced one thread a row that walked the program
// once for each of the row's live lanes, read every PARAM from device
// memory for every row and lane, and wrote its B mask bytes one at a time.
// * The row's live lanes are one 64-bit word, so a launch takes at most 64
//   lanes; the host launches once per run of 64 lanes of a wider batch,
//   each with its slice of the parameters and its rows of the masks (every
//   launch writes the same lane-invariant stored columns). A thread keeps
//   its four rows' words in its registers. Filters never narrow the
//   validity (the shared projections are validity-blind); a filter stage
//   is LOOP, a body, LFILTER: the lane-invariant parts of the predicate are
//   computed once before the LOOP (the host hoists them), and the body
//   runs over the rows for each lane, lowest first, and LFILTER clears the
//   lane's bit of each row that fails.
// * A body of one ALU instruction feeding its LFILTER (the serving
//   programs' `column < parameter`) takes a path of its own: its operands
//   fetched once for all lanes, a uniform one each lane's word, the
//   opcode's branch once, the result in registers.
// * A lane none of whose rows in the warp's 128 is live is skipped: the
//   warp ORs its live words (__reduce_or_sync) at the LOOP. The skip is a
//   warp's, not the tile's (a __syncthreads_or a lane): no barrier, and a
//   finer grain. A body that runs on rows already dead in its lane is
//   safe: nothing reads its registers after its LFILTER, and float
//   instructions do not trap.
// * Parameters are one int32 array [slots, B] in device memory (int32,
//   date32 and bool values as int32, float32 as its bits). A PARAM is a
//   uniform slot: the CTA reads each lane's parameters once, into its
//   uniform table, with everything computed from them alone.
// * A stacked LIKE or EXTRACT(YEAR ...) predicate runs the interpreter's
//   BYTESMATCH and YEAR, as the morsel kernel does; both are
//   lane-invariant, so the host computes them once before the lane loop.
// * At the end each thread writes, for each lane, its four rows' mask
//   bytes as one 4-byte store to masks[b * n + i] (lane-major: for each
//   lane, neighbouring threads write neighbouring words).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fused_interp.cuh"

using namespace repro_fused;

namespace {

__device__ __forceinline__ uint4 splat(uint32_t x) { return make_uint4(x, x, x, x); }

// Clears lane bit `bit` of each of the four rows whose bit in `keep` is 0.
__device__ __forceinline__ void lfilter(uint64_t (&live)[kRowsPerThread], uint32_t keep,
                                       uint64_t bit) {
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (!((keep >> k) & 1u)) live[k] &= ~bit;
  }
}

// The lanes `todo` of a loop whose body is one ALU instruction `in`
// feeding its LFILTER (a filter `column < parameter`): an operand that is
// not uniform is fetched once for all lanes, a uniform one is each lane's
// word, the opcode's branch is taken once, and the result stays in
// registers.
__device__ __forceinline__ void one_op_lanes(const int4 in, const Smem& m,
                                            const unsigned char* stage, int n_uniform,
                                            uint64_t todo,
                                            uint64_t (&live)[kRowsPerThread]) {
  const int low = (1 << kKindShift) - 1;
  const bool ua = (in.z >> kKindShift) == kKindUniform;
  const bool ub = (in.w >> kKindShift) == kKindUniform;
  const uint4 A0 = ua ? splat(0u) : fetch(in.z, m, stage, m.uni);
  const uint4 B0 = ub ? splat(0u) : fetch(in.w, m, stage, m.uni);
  switch (in.x) {
#define REPRO_CASE(o, e)                                            \
  case o:                                                           \
    while (todo != 0ull) {                                          \
      const int lane = __ffsll((long long)todo) - 1;                \
      todo &= todo - 1ull;                                          \
      const uint32_t* uni = m.uni + lane * n_uniform;               \
      const uint4 A = ua ? splat(uni[in.z & low]) : A0;             \
      const uint4 B = ub ? splat(uni[in.w & low]) : B0;             \
      uint32_t a = A.x, b = B.x;                                    \
      uint32_t keep = (e) != 0u;                                    \
      a = A.y;                                                      \
      b = B.y;                                                      \
      keep |= (uint32_t)((e) != 0u) << 1;                           \
      a = A.z;                                                      \
      b = B.z;                                                      \
      keep |= (uint32_t)((e) != 0u) << 2;                           \
      a = A.w;                                                      \
      b = B.w;                                                      \
      keep |= (uint32_t)((e) != 0u) << 3;                           \
      (void)b;                                                      \
      lfilter(live, keep, 1ull << lane);                            \
    }                                                               \
    break;
    REPRO_FUSED_ALU(REPRO_CASE)
#undef REPRO_CASE
    default:
      break;
  }
}

// One CTA an SM is enough to bound its registers: with no minimum, ptxas
// held this kernel to 48 registers once BYTESMATCH's row walk was inlined
// beside the lane loop, and spilled.
__global__ void __launch_bounds__(kThreads, 1)
fused_batch_kernel(const __grid_constant__ Plan p, const __grid_constant__ Columns cols,
                   const uint32_t* __restrict__ params, int lanes,
                   const unsigned char* __restrict__ valid_in,
                   unsigned char* __restrict__ masks, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  prologue(p, cols, valid_in, smem, params, lanes, n_tiles, n);
  const Smem m = carve(p, smem);
  const uint64_t all = lanes == 64 ? ~0ull : ((1ull << lanes) - 1ull);
  int it = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const unsigned char* stage = next_stage(p, cols, valid_in, m.ring, tile, n_tiles, n, it);
    const long long r0 = tile * kTileRows + kRowsPerThread * threadIdx.x;
    const int v = group_rows(r0, n);
    const uint32_t valid = nonzero(fetch(kKindRing8 << kKindShift, m, stage, m.uni));
    uint64_t live[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) live[k] = (valid >> k) & 1u ? all : 0ull;
    for (int pc = 0; pc < p.n_tile; ++pc) {
      const int4 in = m.code[pc];
      // outside a loop every uniform word is the same in every lane's row
      if (exec_store(in, m, stage, m.uni, cols, r0, v)) continue;
      if (in.x != OP_LOOP) {
        exec_vec(in, m, stage, m.uni, cols, r0, v);
        continue;
      }
      const int end = pc + in.z;   // the loop's LFILTER
      const uint64_t mine = live[0] | live[1] | live[2] | live[3];
      uint64_t todo = (uint64_t)__reduce_or_sync(~0u, (uint32_t)mine) |
                      (uint64_t)__reduce_or_sync(~0u, (uint32_t)(mine >> 32)) << 32;
      const int4 body = m.code[pc + 1];
      if (end == pc + 2 && is_alu(body.x) && body.y == m.code[end].z) {
        one_op_lanes(body, m, stage, p.n_uniform, todo, live);
        todo = 0ull;
      }
      while (todo != 0ull) {
        const int b = __ffsll((long long)todo) - 1;
        todo &= todo - 1ull;
        const uint32_t* uni = m.uni + b * p.n_uniform;
        for (int q = pc + 1; q < end; ++q) exec_vec(m.code[q], m, stage, uni, cols, r0, v);
        lfilter(live, nonzero(fetch(m.code[end].z, m, stage, uni)), 1ull << b);
      }
      pc = end;
    }
    // lane b's four bytes: bit b of each row's word, lanes 0-31 from the
    // low halves, 32-63 from the high ones
    unsigned char* out = masks + r0;
    const bool whole = v == kRowsPerThread &&
                       ((reinterpret_cast<uintptr_t>(out) | (uintptr_t)n) & 3u) == 0;
    for (int half = 0; half < 2; ++half) {
      uint32_t w0 = (uint32_t)(live[0] >> (32 * half)), w1 = (uint32_t)(live[1] >> (32 * half));
      uint32_t w2 = (uint32_t)(live[2] >> (32 * half)), w3 = (uint32_t)(live[3] >> (32 * half));
      const int count = lanes - 32 * half < 32 ? lanes - 32 * half : 32;
      for (int b = 0; b < count; ++b, out += n) {
        const uint32_t bytes = (w0 & 1u) | (w1 & 1u) << 8 | (w2 & 1u) << 16 | (w3 & 1u) << 24;
        w0 >>= 1;
        w1 >>= 1;
        w2 >>= 1;
        w3 >>= 1;
        if (whole) {
          *reinterpret_cast<uint32_t*>(out) = bytes;
        } else {
          store8(out, 0, v, bytes);
        }
      }
    }
    after_tile(p, cols, valid_in, m.ring, tile, n_tiles, n);
  }
}

}  // namespace

// plan: the packed TilePlan (repro_torch/core/fused.py) of a batch
// program, plan_len int32s; in_ptrs/out_ptrs: host arrays of device
// pointers (the outputs the program stores, in STORE order); in_widths:
// each input's row width if it is a bytes column, else 0; params: device
// int32[n_slots * lanes], slot-major; masks: device bool[lanes * n].
// Returns cudaErrorInvalidValue for a bad plan or a plan larger than the
// card's shared memory, else cudaGetLastError() after the launch.
extern "C" int fused_batch_run(const int* plan, int plan_len,
                               const unsigned long long* in_ptrs,
                               const int* in_widths, int n_in,
                               const unsigned long long* out_ptrs, int n_out,
                               const void* params, int n_slots, int lanes,
                               const void* valid_in, void* masks, long long n,
                               void* stream) {
  Plan p;
  if (lanes < 1 || lanes > kMaxLanes || n_slots < 0 ||
      (n_slots > 0 && params == nullptr) ||
      !read_plan(plan, plan_len, in_widths, n_in, n_out, true, n_slots, &p)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  Columns c;
  memset(&c, 0, sizeof(c));
  for (int k = 0; k < n_in; ++k) {
    c.in[k] = reinterpret_cast<const void*>(in_ptrs[k]);
    c.width[k] = in_widths[k];
  }
  for (int k = 0; k < n_out; ++k) c.out[k] = reinterpret_cast<void*>(out_ptrs[k]);
  const long long smem = smem_bytes(p, lanes);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  int blocks = 0;
  const cudaError_t err = grid_for(reinterpret_cast<const void*>(fused_batch_kernel),
                                   (int)smem, n_tiles, &blocks);
  if (err != cudaSuccess) return (int)err;
  fused_batch_kernel<<<blocks, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      p, c, static_cast<const uint32_t*>(params), lanes,
      static_cast<const unsigned char*>(valid_in), static_cast<unsigned char*>(masks), n);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
