// The tile interpreter shared by the fused per-morsel kernel
// (fused_morsel.cu) and its inter-query batched variant (fused_batch.cu).
//
// The host (repro_torch/core/fused.py) lowers a run of FilterProject stages
// into a flat list of typed instructions over 32-bit registers, (op, dst,
// a, b) each (lower_registers), then gives every register a slot and lays
// the program out for the kernels (assign_slots). A kernel runs it one
// instruction at a time over a tile of kTileRows rows held in shared
// memory: a CTA of kThreads threads, each owning kRowsPerThread
// consecutive rows of the tile.
//
// Design (replacing one thread a row that walked the whole program with
// its registers in a local-memory array):
// * The plan (TilePlan on the host) travels in the launch's parameter
//   space. Its tile code is copied once per CTA into shared memory; each
//   instruction is decoded once per four rows, and the branch on its
//   opcode is the same for the whole warp.
// * Registers are slots in dynamic shared memory, laid out [slot][tile
//   row]: a thread reads and writes its four rows of a slot as one 16-byte
//   access (a warp's 512 bytes in four wavefronts, no bank conflict). No
//   array is indexed at run time in a thread's registers, so nothing lives
//   in local memory.
// * Uniform slots: a CONST, a PARAM, or an ALU instruction on uniform
//   operands only, has one value for the whole tile. The CTA evaluates
//   them once, one thread a lane, into a table [lane][uniform slot]; the
//   tile code no longer holds them.
// * Loads ahead of use: LOAD32 and LOAD8 read input columns, which the
//   program never writes, so a tile's loads (and its validity) are all
//   issued at its start as cp.async copies, into a two-stage ring: the
//   next tile's copies are in flight while this one computes
//   (cp.async.commit_group / wait_group; a thread copies exactly the bytes
//   it later reads, so no barrier is needed). A 32-bit column takes one
//   16-byte copy a thread, or four of 4 bytes when its base is not 16-byte
//   aligned; a bool column one 4-byte copy, or byte loads when its base is
//   not 4-byte aligned. Rows past n are zero-filled and never read from
//   device memory. A plan too large for two stages runs with one (the host
//   decides; a program at kMaxRegs still fits).
// * The grid is persistent: as many CTAs as fit on the card at the plan's
//   shared memory, each striding over the tiles.
// * Two instructions read more than a word: LOADB one byte of a bytes
//   column's row (uint8[n, W]), and BYTESMATCH (SQL LIKE over such a
//   column) the row's W bytes, both from device memory through the
//   read-only path, a row at a time. BYTESMATCH's pattern is a record in
//   the plan's byte pool, which the CTA copies into shared memory beside
//   the tile code once: a warp's threads compare different bytes of it at
//   once, which shared memory serves without the constant cache's
//   serialisation.
// * YEAR (EXTRACT(YEAR FROM date32)) is an ALU instruction, exact against
//   the reference's table of year starts 1970-2039 (every day before 1970
//   is 1969, every day from 2039 on is 2039).
//
// Float arithmetic uses the round-to-nearest intrinsics, so no multiply
// and add fuse into an FMA: results are bit-identical to the plain PyTorch
// version. Integer arithmetic is unsigned, so it wraps.
//
// The opcode numbers and the constants below are mirrored in
// repro_torch/core/fused.py (OPS, LIMITS); a test parses this file to hold
// them equal.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace repro_fused {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = 1024;
constexpr int kMaxInstr = 160;
constexpr int kMaxCols = 24;
constexpr int kMaxRegs = 48;
constexpr int kMaxLanes = 64;
// uniform slot u is register kUniformBase + u in the host's program
constexpr int kUniformBase = 64;
constexpr int kStages = 2;
// the dynamic shared memory a block may ask for on sm_90
constexpr int kMaxSmem = 232448;
// an operand: (kind << kKindShift) | byte offset (or uniform index)
constexpr int kKindShift = 24;
constexpr int kKindComp = 0;     // a computed slot
constexpr int kKindRing32 = 1;   // a loaded 32-bit column, in the stage
constexpr int kKindRing8 = 2;    // a loaded bool column, in the stage
constexpr int kKindUniform = 3;  // the uniform table's word
constexpr int kPlanHeader = 8;
// the pattern pool's bytes
constexpr int kMaxPool = 256;
static_assert(kTileRows == kThreads * kRowsPerThread, "a tile is the CTA's rows");

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
  OP_LOOP = 34,     // start of a lane loop: a = the distance to its LFILTER
  OP_LFILTER = 35,  // lane mask bit &= r[a] != 0; next lane, back to the LOOP
  OP_YEAR = 36,     // r[dst] = the year of day r[a] (clamped to 1969..2039)
  OP_BYTESMATCH = 37,  // r[dst] = this row of bytes column a matches pool record b
};

// The plan: header (n_tile, n_uni, n_loads, n_uniform, stages,
// stage_bytes, comp_bytes, n_pool), the tile code, then the uniform code
// (op, uniform dst, a, b), then the loads (column, width 4 or 1, offset in
// the stage), then the pattern pool's n_pool bytes in 16-byte groups. A
// pattern record: its mode (0 contains, 1 startswith, 2 endswith), its
// number of parts, then each part's length and bytes.
struct Plan {
  int n_tile, n_uni, n_loads, n_uniform, stages, stage_bytes, comp_bytes, n_pool;
  int4 ins[kMaxInstr];
  int4 loads[kMaxCols];
  int4 pool[kMaxPool / 16];
};

// The 16-byte groups of a pool of n bytes.
__host__ __device__ inline int pool_groups(int n) { return (n + 15) / 16; }

struct Columns {
  const void* in[kMaxCols];
  void* out[kMaxCols];
  int width[kMaxCols];   // row width of a bytes input column, else 0
};

__device__ __forceinline__ float f(uint32_t bits) { return __uint_as_float(bits); }
__device__ __forceinline__ uint32_t u(float x) { return __float_as_uint(x); }
__device__ __forceinline__ int32_t s(uint32_t bits) { return (int32_t)bits; }

// The year of day d (days since 1970-01-01), as the reference's
// searchsorted over the year starts of 1970-2039 gives it: 1969 before
// 1970, 2039 from 2039-01-01 (day 25202) on. Between, every fourth year
// from 1972 is a leap year (2000 is one), so the days from 1969-01-01 run
// in cycles of 1461 whose first three years are common.
__device__ __forceinline__ uint32_t year_of(int32_t d) {
  if (d < 0) return 1969u;
  if (d >= 25202) return 2039u;
  return (uint32_t)(1969 + (4 * (d + 365) + 3) / 1461);
}

// The arithmetic, comparison and logic instructions, as expressions of the
// operand values a and b.
#define REPRO_FUSED_ALU(X)                                      \
  X(OP_ADD_I32, a + b)                                          \
  X(OP_SUB_I32, a - b)                                          \
  X(OP_MUL_I32, a * b)                                          \
  X(OP_NEG_I32, 0u - a)                                         \
  X(OP_ADD_F32, u(__fadd_rn(f(a), f(b))))                       \
  X(OP_SUB_F32, u(__fsub_rn(f(a), f(b))))                       \
  X(OP_MUL_F32, u(__fmul_rn(f(a), f(b))))                       \
  X(OP_DIV_F32, u(__fdiv_rn(f(a), f(b))))                       \
  X(OP_NEG_F32, a ^ 0x80000000u)                                \
  X(OP_EQ_I32, (uint32_t)(s(a) == s(b)))                        \
  X(OP_NE_I32, (uint32_t)(s(a) != s(b)))                        \
  X(OP_LT_I32, (uint32_t)(s(a) < s(b)))                         \
  X(OP_LE_I32, (uint32_t)(s(a) <= s(b)))                        \
  X(OP_GT_I32, (uint32_t)(s(a) > s(b)))                         \
  X(OP_GE_I32, (uint32_t)(s(a) >= s(b)))                        \
  X(OP_EQ_F32, (uint32_t)(f(a) == f(b)))                        \
  X(OP_NE_F32, (uint32_t)(f(a) != f(b)))                        \
  X(OP_LT_F32, (uint32_t)(f(a) < f(b)))                         \
  X(OP_LE_F32, (uint32_t)(f(a) <= f(b)))                        \
  X(OP_GT_F32, (uint32_t)(f(a) > f(b)))                         \
  X(OP_GE_F32, (uint32_t)(f(a) >= f(b)))                        \
  X(OP_AND, (uint32_t)((a != 0u) & (b != 0u)))                  \
  X(OP_OR, (uint32_t)((a != 0u) | (b != 0u)))                   \
  X(OP_NOT, (uint32_t)(a == 0u))                                \
  X(OP_I32_TO_F32, u(__int2float_rn(s(a))))                    \
  X(OP_YEAR, year_of(s(a)))

// One instruction on one value (the uniform table); false for an opcode
// that is not an ALU instruction.
__device__ __forceinline__ bool alu(int op, uint32_t a, uint32_t b, uint32_t* x) {
  switch (op) {
#define REPRO_CASE(o, e) \
  case o:                \
    *x = (e);            \
    return true;
    REPRO_FUSED_ALU(REPRO_CASE)
#undef REPRO_CASE
    default:
      return false;
  }
}

// One instruction on a thread's four rows: one branch on the opcode.
__device__ __forceinline__ uint4 alu4(int op, const uint4 A, const uint4 B) {
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  switch (op) {
#define REPRO_CASE(o, e)            \
  case o: {                         \
    uint32_t a = A.x, b = B.x;      \
    x.x = (e);                      \
    a = A.y;                        \
    b = B.y;                        \
    x.y = (e);                      \
    a = A.z;                        \
    b = B.z;                        \
    x.z = (e);                      \
    a = A.w;                        \
    b = B.w;                        \
    x.w = (e);                      \
    (void)b;                        \
    break;                          \
  }
    REPRO_FUSED_ALU(REPRO_CASE)
#undef REPRO_CASE
    default:
      break;
  }
  return x;
}

// ---------------------------------------------------------------------------
// the CTA's shared memory and the loads
// ---------------------------------------------------------------------------

// The regions of a CTA's dynamic shared memory (TilePlan.smem_bytes).
struct Smem {
  const int4* code;       // the tile code
  const unsigned char* pool;  // the pattern pool
  unsigned char* comp;    // computed slots, [slot][kTileRows] uint32
  unsigned char* ring;    // the load stages
  uint32_t* uni;          // the uniform table, [lane][n_uniform]
};

__device__ __forceinline__ Smem carve(const Plan& p, unsigned char* smem) {
  Smem m;
  m.code = reinterpret_cast<const int4*>(smem);
  m.pool = smem + 16 * p.n_tile;
  m.comp = smem + 16 * (p.n_tile + pool_groups(p.n_pool));
  m.ring = m.comp + p.comp_bytes;
  m.uni = reinterpret_cast<uint32_t*>(m.ring + p.stages * p.stage_bytes);
  return m;
}

// Rows of the group of four at r0 below n: 4, fewer in the last group of a
// ragged tail, 0 past it.
__device__ __forceinline__ int group_rows(long long r0, long long n) {
  const long long left = n - r0;
  return left >= kRowsPerThread ? kRowsPerThread : (left > 0 ? (int)left : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 (or 4) bytes, of which the first `bytes` come from src
// and the rest are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The v rows from r0 of a 32-bit column into a thread's 16 bytes of its
// slot, zero past v.
__device__ __forceinline__ void copy32(uint32_t* dst, const uint32_t* col, long long r0,
                                      int v) {
  if ((reinterpret_cast<uintptr_t>(col) & 15u) == 0) {
    cp_async16(dst, v > 0 ? col + r0 : col, 4 * v);
  } else {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      cp_async4(dst + k, k < v ? col + r0 + k : col, k < v ? 4 : 0);
    }
  }
}

// The v rows from r0 of a bool column into a thread's 4 bytes of its slot.
__device__ __forceinline__ void copy8(uint32_t* dst, const unsigned char* col,
                                     long long r0, int v) {
  if ((reinterpret_cast<uintptr_t>(col) & 3u) == 0) {
    cp_async4(dst, v > 0 ? col + r0 : col, v);
  } else {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (k < v) w |= (uint32_t)col[r0 + k] << (8 * k);
    }
    *dst = w;
  }
}

// Issues (and commits as one group) the copies of the thread's rows of a
// tile into a stage: its validity at offset 0, then every loaded column.
__device__ __forceinline__ void issue_loads(const Plan& p, const Columns& cols,
                                           const unsigned char* valid_in,
                                           unsigned char* stage, long long tile,
                                           long long n) {
  const int t = threadIdx.x;
  const long long r0 = tile * kTileRows + kRowsPerThread * t;
  const int v = group_rows(r0, n);
  copy8(reinterpret_cast<uint32_t*>(stage) + t, valid_in, r0, v);
  for (int k = 0; k < p.n_loads; ++k) {
    const int4 ld = p.loads[k];
    if (ld.y == 4) {
      copy32(reinterpret_cast<uint32_t*>(stage + ld.z) + kRowsPerThread * t,
             static_cast<const uint32_t*>(cols.in[ld.x]), r0, v);
    } else {
      copy8(reinterpret_cast<uint32_t*>(stage + ld.z) + t,
            static_cast<const unsigned char*>(cols.in[ld.x]), r0, v);
    }
  }
  cp_async_commit();
}

// Waits for this tile's copies; with two stages, first issues the next
// tile's into the other stage (the thread is done with it).
__device__ __forceinline__ const unsigned char* next_stage(
    const Plan& p, const Columns& cols, const unsigned char* valid_in,
    unsigned char* ring, long long tile, long long n_tiles, long long n, int it) {
  const int stage = p.stages == 2 ? (it & 1) : 0;
  const long long next = tile + gridDim.x;
  if (p.stages == 2 && next < n_tiles) {
    issue_loads(p, cols, valid_in, ring + (stage ^ 1) * p.stage_bytes, next, n);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  return ring + stage * p.stage_bytes;
}

// With one stage, the next tile's copies go out once this tile is done.
__device__ __forceinline__ void after_tile(const Plan& p, const Columns& cols,
                                          const unsigned char* valid_in,
                                          unsigned char* ring, long long tile,
                                          long long n_tiles, long long n) {
  const long long next = tile + gridDim.x;
  if (p.stages == 1 && next < n_tiles) issue_loads(p, cols, valid_in, ring, next, n);
}

// The CTA's setup: the first tile's copies, the tile code into shared
// memory, and the uniform table, a thread a lane (params: int32[slots,
// lanes], null for a program without PARAM). Ends in a barrier.
__device__ __forceinline__ void prologue(const Plan& p, const Columns& cols,
                                        const unsigned char* valid_in,
                                        unsigned char* smem, const uint32_t* params,
                                        int lanes, long long n_tiles, long long n) {
  const Smem m = carve(p, smem);
  if (blockIdx.x < n_tiles) issue_loads(p, cols, valid_in, m.ring, blockIdx.x, n);
  int4* code = reinterpret_cast<int4*>(smem);
  for (int k = threadIdx.x; k < p.n_tile; k += blockDim.x) code[k] = p.ins[k];
  for (int k = threadIdx.x; k < pool_groups(p.n_pool); k += blockDim.x) {
    code[p.n_tile + k] = p.pool[k];
  }
  for (int lane = threadIdx.x; lane < lanes; lane += blockDim.x) {
    uint32_t* row = m.uni + lane * p.n_uniform;
    for (int k = 0; k < p.n_uni; ++k) {
      const int4 in = p.ins[p.n_tile + k];
      uint32_t x = 0;
      if (in.x == OP_CONST) {
        x = (uint32_t)in.z;
      } else if (in.x == OP_PARAM) {
        x = params[(long long)in.z * lanes + lane];
      } else {
        alu(in.x, row[in.z], row[in.w], &x);
      }
      row[in.y] = x;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// operands, vector instructions and stores on a thread's four rows
// ---------------------------------------------------------------------------

// A thread's four rows of an operand; uni is the current lane's row of the
// uniform table.
__device__ __forceinline__ uint4 fetch(int e, const Smem& m, const unsigned char* stage,
                                      const uint32_t* uni) {
  const int off = e & ((1 << kKindShift) - 1);
  const int t = threadIdx.x;
  switch (e >> kKindShift) {
    case kKindComp:
      return reinterpret_cast<const uint4*>(m.comp + off)[t];
    case kKindRing32:
      return reinterpret_cast<const uint4*>(stage + off)[t];
    case kKindRing8: {
      const uint32_t w = reinterpret_cast<const uint32_t*>(stage + off)[t];
      return make_uint4((w & 0xFFu) != 0u, (w & 0xFF00u) != 0u, (w & 0xFF0000u) != 0u,
                        (w >> 24) != 0u);
    }
    default: {
      const uint32_t x = uni[off];
      return make_uint4(x, x, x, x);
    }
  }
}

// Whether the w bytes of `row` hold the m bytes of `pat` at `at`.
__device__ __forceinline__ bool bytes_at(const unsigned char* row, int at,
                                        const unsigned char* pat, int m) {
  for (int k = 0; k < m; ++k) {
    if (__ldg(row + at + k) != pat[k]) return false;
  }
  return true;
}

// One row of a bytes column (w bytes) against the pattern record `rec`,
// with the reference's semantics (src/repro/core/expr.py, BytesMatch):
// contains finds the parts in order, each from where the previous one's
// first hit ended, and a part longer than the row never matches;
// startswith compares the first bytes; endswith compares the last bytes of
// the row trimmed of trailing spaces (a row of spaces has length 0).
__device__ __forceinline__ bool match_row(const unsigned char* row, int w,
                                         const unsigned char* rec) {
  const int mode = rec[0];
  const unsigned char* part = rec + 2;
  int m = part[0];
  if (mode == 1) return m <= w && bytes_at(row, 0, part + 1, m);
  if (mode == 2) {
    int len = w;
    while (len > 0 && __ldg(row + len - 1) == (unsigned char)' ') --len;
    return m <= len && bytes_at(row, len - m, part + 1, m);
  }
  int from = 0;
  for (int k = 0; k < rec[1]; ++k, part += 1 + m) {
    m = part[0];
    int at = from;
    while (at + m <= w && !bytes_at(row, at, part + 1, m)) ++at;
    if (at + m > w) return false;
    from = at + m;
  }
  return true;
}

// An ALU instruction, a LOADB or a BYTESMATCH into the thread's four rows
// of a computed slot. LOADB and BYTESMATCH read a row at a time (a bytes
// column's row is not a word).
__device__ __forceinline__ void exec_vec(const int4 in, const Smem& m,
                                        const unsigned char* stage, const uint32_t* uni,
                                        const Columns& cols, long long r0, int v) {
  uint4 x;
  if (in.x == OP_BYTESMATCH) {
    const unsigned char* col = static_cast<const unsigned char*>(cols.in[in.z]);
    const int w = cols.width[in.z];
    uint32_t hit = 0;
#pragma unroll 1
    for (int k = 0; k < v; ++k) {
      hit |= (uint32_t)match_row(col + (r0 + k) * w, w, m.pool + in.w) << k;
    }
    x = make_uint4(hit & 1u, (hit >> 1) & 1u, (hit >> 2) & 1u, (hit >> 3) & 1u);
  } else if (in.x == OP_LOADB) {
    const unsigned char* col = static_cast<const unsigned char*>(cols.in[in.z]);
    const long long w = cols.width[in.z];
    uint32_t b[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) b[k] = k < v ? col[(r0 + k) * w + in.w] : 0u;
    x = make_uint4(b[0], b[1], b[2], b[3]);
  } else {
    x = alu4(in.x, fetch(in.z, m, stage, uni), fetch(in.w, m, stage, uni));
  }
  reinterpret_cast<uint4*>(m.comp + (in.y & ((1 << kKindShift) - 1)))[threadIdx.x] = x;
}

// Bit k: row k of the four is not 0.
__device__ __forceinline__ uint32_t nonzero(const uint4 x) {
  return (x.x != 0u) | (x.y != 0u) << 1 | (x.z != 0u) << 2 | (x.w != 0u) << 3;
}

// Four bits as four bytes of 0 or 1.
__device__ __forceinline__ uint32_t bytes_of(uint32_t bits) {
  return (bits & 1u) | (bits & 2u) << 7 | (bits & 4u) << 14 | (bits & 8u) << 21;
}

// The v rows from r0 of a 32-bit output: one 16-byte store for a whole,
// aligned group, else one a row.
__device__ __forceinline__ void store32(void* out, long long r0, int v, const uint4 x) {
  uint32_t* p = static_cast<uint32_t*>(out) + r0;
  if (v == kRowsPerThread && (reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    *reinterpret_cast<uint4*>(p) = x;
    return;
  }
  const uint32_t w[kRowsPerThread] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (k < v) p[k] = w[k];
  }
}

// The v rows from r0 of a bool output, four bytes packed in `bytes`: one
// 4-byte store for a whole, aligned group, else one a row.
__device__ __forceinline__ void store8(void* out, long long r0, int v, uint32_t bytes) {
  unsigned char* p = static_cast<unsigned char*>(out) + r0;
  if (v == kRowsPerThread && (reinterpret_cast<uintptr_t>(p) & 3u) == 0) {
    *reinterpret_cast<uint32_t*>(p) = bytes;
    return;
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (k < v) p[k] = (unsigned char)(bytes >> (8 * k));
  }
}

// A STORE32 or STORE8 instruction; false for any other.
__device__ __forceinline__ bool exec_store(const int4 in, const Smem& m,
                                          const unsigned char* stage, const uint32_t* uni,
                                          const Columns& cols, long long r0, int v) {
  if (in.x == OP_STORE32) {
    store32(cols.out[in.y], r0, v, fetch(in.z, m, stage, uni));
    return true;
  }
  if (in.x == OP_STORE8) {
    store8(cols.out[in.y], r0, v, bytes_of(nonzero(fetch(in.z, m, stage, uni))));
    return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// host side: the plan's checks and the launch's shape
// ---------------------------------------------------------------------------

__host__ __device__ inline bool is_alu(int op) {
  return (op >= OP_ADD_I32 && op <= OP_I32_TO_F32) || op == OP_YEAR;
}

// A pattern record at `off` of the pool's n bytes: a mode of 0-2, at least
// one part (exactly one unless it is contains), all inside the pool.
inline bool valid_record(const unsigned char* pool, int n, int off) {
  if (off < 0 || off + 2 > n) return false;
  const int mode = pool[off], parts = pool[off + 1];
  if (mode > 2 || parts < 1 || (mode != 0 && parts != 1)) return false;
  int at = off + 2;
  for (int k = 0; k < parts; ++k) {
    if (at >= n) return false;
    at += 1 + pool[at];
    if (at > n) return false;
  }
  return true;
}

// An operand of the tile code: a whole computed slot, a whole slot of the
// stage, or a word of the uniform table.
inline bool valid_operand(int e, const Plan& p) {
  if (e < 0) return false;
  const int off = e & ((1 << kKindShift) - 1);
  switch (e >> kKindShift) {
    case kKindComp:
      return off % 16 == 0 && off + 4 * kTileRows <= p.comp_bytes;
    case kKindRing32:
      return off % 16 == 0 && off >= kTileRows && off + 4 * kTileRows <= p.stage_bytes;
    case kKindRing8:
      return off % 16 == 0 && off >= kTileRows && off + kTileRows <= p.stage_bytes;
    case kKindUniform:
      return off < p.n_uniform;
    default:
      return false;
  }
}

inline bool valid_comp(int e, const Plan& p) {
  return (e >> kKindShift) == kKindComp && valid_operand(e, p);
}

// Reads and checks a packed plan (fused.py, TilePlan.packed) into `p`:
// counts and offsets inside the plan's shared memory, every operand and
// column in range, and only the instructions the kernel runs (`batch`:
// PARAM, LOOP and LFILTER, with n_slots parameter slots; else FILTER and
// PROBE). Returns false on a bad plan.
inline bool read_plan(const int* plan, int len, const int* in_widths, int n_in,
                      int n_out, bool batch, int n_slots, Plan* p) {
  if (plan == nullptr || len < kPlanHeader || n_in < 0 || n_in > kMaxCols ||
      n_out < 0 || n_out > kMaxCols) {
    return false;
  }
  p->n_tile = plan[0];
  p->n_uni = plan[1];
  p->n_loads = plan[2];
  p->n_uniform = plan[3];
  p->stages = plan[4];
  p->stage_bytes = plan[5];
  p->comp_bytes = plan[6];
  p->n_pool = plan[7];
  if (p->n_pool < 0 || p->n_pool > kMaxPool || p->n_tile < 0 || p->n_uni < 0 ||
      p->n_tile + p->n_uni > kMaxInstr ||
      p->n_loads < 0 || p->n_loads > kMaxCols || p->n_uniform < 0 ||
      p->n_uniform > kMaxRegs || (p->stages != 1 && p->stages != kStages) ||
      p->stage_bytes < kTileRows || p->stage_bytes % kTileRows != 0 ||
      p->stage_bytes > kMaxSmem || p->comp_bytes < 0 ||
      p->comp_bytes % (4 * kTileRows) != 0 || p->comp_bytes > kMaxSmem ||
      len != kPlanHeader + 4 * (p->n_tile + p->n_uni + p->n_loads + pool_groups(p->n_pool))) {
    return false;
  }
  const int* ins = plan + kPlanHeader;
  for (int k = 0; k < p->n_tile + p->n_uni; ++k) {
    p->ins[k] = make_int4(ins[4 * k], ins[4 * k + 1], ins[4 * k + 2], ins[4 * k + 3]);
  }
  const int* lds = ins + 4 * (p->n_tile + p->n_uni);
  for (int k = 0; k < p->n_loads; ++k) {
    const int4 ld = make_int4(lds[4 * k], lds[4 * k + 1], lds[4 * k + 2], 0);
    if (ld.x < 0 || ld.x >= n_in || in_widths[ld.x] != 0 || (ld.y != 1 && ld.y != 4) ||
        ld.z < kTileRows || ld.z % 16 != 0 || ld.z + ld.y * kTileRows > p->stage_bytes) {
      return false;
    }
    p->loads[k] = ld;
  }
  const int* words = lds + 4 * p->n_loads;
  for (int k = 0; k < pool_groups(p->n_pool); ++k) {
    p->pool[k] = make_int4(words[4 * k], words[4 * k + 1], words[4 * k + 2], words[4 * k + 3]);
  }
  const unsigned char* pool = reinterpret_cast<const unsigned char*>(p->pool);
  int open = -1;   // the open LOOP
  for (int k = 0; k < p->n_tile; ++k) {
    const int4 in = p->ins[k];
    if (open >= 0 && in.x != OP_LFILTER && !is_alu(in.x) && in.x != OP_LOADB &&
        in.x != OP_BYTESMATCH) {
      return false;   // a loop body holds ALU instructions, LOADBs and BYTESMATCHes
    }
    bool ok;
    if (is_alu(in.x)) {
      ok = valid_comp(in.y, *p) && valid_operand(in.z, *p) && valid_operand(in.w, *p);
    } else if (in.x == OP_LOADB) {
      ok = valid_comp(in.y, *p) && in.z >= 0 && in.z < n_in && in.w >= 0 &&
           in.w < in_widths[in.z];
    } else if (in.x == OP_BYTESMATCH) {
      ok = valid_comp(in.y, *p) && in.z >= 0 && in.z < n_in && in_widths[in.z] > 0 &&
           valid_record(pool, p->n_pool, in.w);
    } else if (in.x == OP_STORE32 || in.x == OP_STORE8) {
      ok = in.y >= 0 && in.y < n_out && valid_operand(in.z, *p);
    } else if (in.x == OP_FILTER || in.x == OP_PROBE) {
      ok = !batch && valid_operand(in.z, *p);
    } else if (in.x == OP_LOOP) {
      ok = batch && open < 0 && in.z > 0 && k + in.z < p->n_tile &&
           p->ins[k + in.z].x == OP_LFILTER;
      open = k;
    } else if (in.x == OP_LFILTER) {
      ok = batch && open >= 0 && open + p->ins[open].z == k && valid_operand(in.z, *p);
      open = -1;
    } else {
      ok = false;
    }
    if (!ok) return false;
  }
  if (open >= 0) return false;
  for (int k = p->n_tile; k < p->n_tile + p->n_uni; ++k) {
    const int4 in = p->ins[k];
    bool ok = in.y >= 0 && in.y < p->n_uniform;
    if (in.x == OP_PARAM) {
      ok = ok && batch && in.z >= 0 && in.z < n_slots;
    } else if (is_alu(in.x)) {
      ok = ok && in.z >= 0 && in.z < p->n_uniform && in.w >= 0 && in.w < p->n_uniform;
    } else {
      ok = ok && in.x == OP_CONST;
    }
    if (!ok) return false;
  }
  return true;
}

// Dynamic shared memory of a CTA running `lanes` lanes.
inline long long smem_bytes(const Plan& p, int lanes) {
  return 16LL * (p.n_tile + pool_groups(p.n_pool)) + p.comp_bytes +
         (long long)p.stages * p.stage_bytes + 4LL * lanes * p.n_uniform;
}

// The persistent grid of `kernel` at `smem` bytes over n_tiles tiles: the
// CTAs that fit on the card at once, at most one a tile. The kernel is
// allowed the device's whole opt-in shared memory once (a smaller
// allowance set later could refuse another thread's larger plan), and the
// CTAs a card holds are cached per device, kernel and size.
inline cudaError_t grid_for(const void* kernel, int smem, long long n_tiles, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> allowed;   // -> opt-in bytes
  static std::map<std::pair<std::pair<int, const void*>, int>, int> per_card;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto kkey = std::make_pair(dev, kernel);
  const auto key = std::make_pair(kkey, smem);
  std::lock_guard<std::mutex> lock(mu);
  auto opt = allowed.find(kkey);
  if (opt == allowed.end()) {
    int optin = 0;
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      dev)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    optin)) != cudaSuccess) {
      return err;
    }
    opt = allowed.emplace(kkey, optin).first;
  }
  if (smem > opt->second) return cudaErrorInvalidValue;
  auto it = per_card.find(key);
  if (it == per_card.end()) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                             smem)) != cudaSuccess) {
      return err;
    }
    if (per_sm < 1) return cudaErrorInvalidValue;
    it = per_card.emplace(key, per_sm * sms).first;
  }
  *blocks = (int)(n_tiles < it->second ? n_tiles : it->second);
  return cudaSuccess;
}

}  // namespace repro_fused
