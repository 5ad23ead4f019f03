// Blocked flash attention, forward: softmax(q k^T * D^-0.5) v over
// [B*H, S, D], causal or full, in float32, bfloat16 or float16.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention (:71),
// kernel body _kernel (:27). There one grid step held a [BQ, D] Q tile in
// VMEM and ran a sequential loop over [BK, D] K/V tiles with the online
// softmax's running max m, sum l and accumulator acc in float32, masked
// scores as NEG_INF = -1e30, stopped at the diagonal when causal, and wrote
// acc / max(l, 1e-30) in the input dtype. Here one CTA does the same for a
// Q tile of one (b, h), streaming K/V tiles through shared memory:
//   - the grid is one-dimensional, B*H fastest, so no dimension meets
//     gridDim.y's 65,535 limit; the Q tiles run last to first, so with
//     causal the longest rows start first;
//   - K tiles are taken from the first of the CTA's range upward. Without
//     a split that is tile 0, which holds column 0, which every row sees,
//     so after it each row's running max is a real score and a masked
//     -1e30 gives exp(-1e30 - m) = 0 (the split is below);
//   - with causal, K tiles past the Q tile's last row are not read, as the
//     Pallas loop stops at :57-63;
//   - the head dim is zero-filled in shared memory up to DP in {64, 128,
//     192, 256} (the kernels' template width), and rows past S up to the
//     tile; columns past S are masked. D > 256 is refused.
//
// float32 (attn_tf32x3_kernel): 3xTF32 on the tensor cores. One TF32
// product (10 mantissa bits, about 5e-4 relative) misses the reference's
// 2e-5; three do not: each float32 operand x is split once into TF32 parts
// big = rna(x) and small = rna(x - big), and every product of Q K^T and of
// P V is small*big + big*small + big*big on mma.sync m16n8k8 (tf32) with
// float32 accumulators, small*small (2^-22 relative) left out, the order
// of CUTLASS's OpMultiplyAddFastF32 (PyTorch's float32 memory-efficient
// SDPA). FlashAttention-2's layout: four warps, 16 Q rows each, a 64-row
// Q tile; the row statistics stay in a quad of lanes. The m16n8 score
// accumulator gives a lane keys 2t, 2t + 1 where P V's A fragment wants
// k = t, t + 4; since P V sums over keys, the accumulator serves as A as it
// lies when V's B fragment reads keys 2t (k = t) and 2t + 1 (k = t + 4).
// K/V tiles of 32 keys come through a ring of two stages by cp.async (16
// bytes when d % 4 == 0 and the bases allow, else 4), rows padded by 4
// floats so that every fragment read is free of bank conflicts; tile j + 1
// loads while tile j computes. Q's fragments stay in registers up to DP =
// 128 (split once at DP = 64, at each use at 128) and in shared memory
// above. Small grids split over K as the wgmma kernel's do (below), with a
// float32 combine.
//
// bfloat16 / float16 on Hopper (attn_wgmma_kernel), every 16-bit input
// that TMA can address (d % 8 == 0, 16-byte-aligned bases): a CTA holds a
// 128-row Q tile and runs three warpgroups. One thread of the third (the
// producer, its registers given up by setmaxnreg) loads Q once and K/V
// tiles into a ring of stages by TMA (cp.async.bulk.tensor over a 3-D
// [B*H, S, D] map, 128-byte swizzle, an mbarrier a tile; the map's zero
// fill covers rows past S in the head and columns past D up to DP). The
// other two, 64 Q rows each, run wgmma.mma_async m64nNk16 with float32
// accumulators: S = Q K^T from shared memory, then O += P V with P in
// registers (rounded to the input dtype, as the oracle's probs are) and V
// read MN-major. The product of tile j + 1 is issued before tile j's P V,
// so tile j + 1's exponentials and row statistics run while P V does, and
// the two warpgroups take turns issuing their products (named barriers,
// FlashAttention-3's ping-pong), so one's softmax runs while the other's
// products do; a stage goes back to the producer when its P V is done.
// The exponentials are ex2.approx.ftz (exp2f without fast math wraps the
// SFU's instruction in a subnormal fix-up). K/V tiles are 128
// keys up to DP = 128 and 64 above (the O accumulator is DP / 2 floats a
// thread); the ring is as deep as 227 KB allows, two stages at DP = 256.
//   A split over K: when B*H * ceil(S / 128) CTAs fill fewer than the
// card's SMs, each (head, Q tile) is split into nsplit ranges of its K
// tiles, as many as fill the SMs. Each split writes float32 partials (m,
// l, acc) into the wrapper's scratch, and attn_combine_kernel rescales
// and sums them. A row whose range lies past its diagonal sees only masked
// columns, so its max stays -1e30 and each column adds exp(0) = 1 to l and
// a value row to acc: the split writes such a row as l = 0, acc = 0.
//
// bfloat16 / float16 with d % 8 != 0 or an unaligned base (attn_mma_kernel,
// chosen by shape before the launch): mma.sync m16n8k16 with float32
// accumulators for both Q K^T and P V, FlashAttention-2's layout: four
// warps, each owning 16 rows of a 64-row Q tile, so the row statistics stay
// in a quad of lanes; the score accumulators become P's A fragments in
// registers; V's B fragments come from ldmatrix.trans. Q, K and V tiles
// are loaded element by element.
//
// Every path takes scores in the log2 domain (scale * log2 e) for 2^x.
//
// Bound: at the repository's shapes (S >= 1024, D >= 64) operations:
// 4 * S^2 * D per (b, h), halved when causal, against 4 * S * D elements
// of memory; in float32 three TF32 products make one. In bfloat16 the exponentials (S^2 / 2 per head with causal)
// also cost SFU time, about half the tensor-core bound at qwen2-1.5B's
// train_4k shape and as much as it at D = 64; the wgmma kernel overlaps
// them with the products.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxD = 256;

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the K tiles a Q tile [q0, q0 + bq) reads: up to its last row's tile when
// causal, else all
__device__ __forceinline__ int k_tiles(int q0, int bq, int bk, int s, int causal) {
  const int row_hi = min(q0 + bq, s) - 1;
  return causal ? row_hi / bk + 1 : ceil_div(s, bk);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

constexpr int kTfRows = 64;      // Q rows of a CTA: 16 a warp
constexpr int kTfThreads = 128;
constexpr int kTfBK = 32;        // keys of a K/V tile

// Q's A fragments stay in registers up to DP = 128: split once at DP = 64
// (the compiler keeps both parts across the K loop), raw and split at each
// use at DP = 128, where both parts beside O's DP / 2 accumulators spill.
// Above, Q stays in shared memory
template <int DP>
__host__ __device__ constexpr bool tf_qreg() { return DP <= 128; }
template <int DP>
__host__ __device__ constexpr bool tf_qsplit_once() { return DP <= 64; }
// row stride in floats: 4 floats of padding make the fragment reads of Q
// and K (8 rows by 4 columns) and of V (keys 2t, 2t + 1 by 8 columns) fall
// in 32 distinct banks
template <int DP>
__host__ __device__ constexpr int tf_ld() { return DP + 4; }
// two stages of K and of V, and Q when it is not in registers
template <int DP>
__host__ __device__ constexpr int tf_smem_bytes() {
  return (4 * kTfBK + (tf_qreg<DP>() ? 0 : kTfRows)) * tf_ld<DP>() * 4;
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as a .b32
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// the same, as a volatile instruction, which the compiler does not hoist
// out of a loop (a split of loop-invariant registers kept whole would
// double them)
__device__ __forceinline__ uint32_t to_tf32_here(float x) {
  uint32_t r;
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small + O(2^-22 |x|), each a TF32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in float32 from the TF32 parts of both: the small products first,
// into `cs`, then the big one, into `c` (CUTLASS's OpMultiplyAddFastF32
// order; `cs` may be `c`); small * small (2^-22 relative) is left out
__device__ __forceinline__ void mma_3xtf32(float* c, float* cs, const uint32_t* ab,
                                           const uint32_t* as, float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(cs, as, bb0, bb1);   // small * big
  mma_tf32(cs, ab, bs0, bs1);   // big * small
  mma_tf32(c, ab, bb0, bb1);    // big * big
}

template <bool kHere = false>
__device__ __forceinline__ void split4(const float* a, uint32_t* big, uint32_t* small) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kHere) {
      big[i] = to_tf32_here(a[i]);
      small[i] = to_tf32_here(a[i] - __uint_as_float(big[i]));
    } else {
      split_tf32(a[i], big[i], small[i]);
    }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of src [s, d] into dst [ROWS, LD] by cp.async, zero
// past s and past d: 16-byte pieces when `vec` (d % 4 == 0, 16-byte-aligned
// bases), else 4 bytes an element
template <int DP, int ROWS>
__device__ __forceinline__ void tf_tile(float* dst, const float* __restrict__ src, int r0, int s,
                                        int d, int vec) {
  constexpr int LD = tf_ld<DP>();
  if (vec) {
    for (int idx = threadIdx.x; idx < ROWS * (DP / 4); idx += kTfThreads) {
      const int r = idx / (DP / 4), c = (idx - r * (DP / 4)) * 4, gr = r0 + r;
      const bool in = gr < s && c < d;
      cp_async16(dst + r * LD + c, in ? src + (long long)gr * d + c : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += kTfThreads) {
      const int r = idx / DP, c = idx - r * DP, gr = r0 + r;
      const bool in = gr < s && c < d;
      cp_async4(dst + r * LD + c, in ? src + (long long)gr * d + c : src, in ? 4 : 0);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kTfThreads)
attn_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ part, int bh, int s, int d, int causal,
                   float scale_log2, int nsplit, int vec) {
  constexpr int BK = kTfBK, LD = tf_ld<DP>();
  constexpr int NT = BK / 8;   // score n-tiles (and P V k-steps) of a warp
  constexpr int DT = DP / 8;   // output n-tiles (and Q K^T k-steps)
  constexpr bool QREG = tf_qreg<DP>();
  extern __shared__ float4 tf_smem[];
  float* Ks = reinterpret_cast<float*>(tf_smem);   // [2][BK][LD]
  float* Vs = Ks + 2 * BK * LD;                    // [2][BK][LD]
  float* Qs = Vs + 2 * BK * LD;                    // [kTfRows][LD] unless QREG
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = ceil_div(s, kTfRows);
  const int head = blockIdx.x % bh;
  const int rest = blockIdx.x / bh;
  const int split = rest % nsplit;
  const int q0 = (nq - 1 - rest / nsplit) * kTfRows;
  const int nkt = k_tiles(q0, kTfRows, BK, s, causal);
  const int per = ceil_div(nkt, nsplit);
  const int kt_begin = min(split * per, nkt), kt_end = min(kt_begin + per, nkt);
  const long long base = (long long)head * s * d;
  const float* qh = q + base;
  const float* kh = k + base;
  const float* vh = v + base;
  const int rw = q0 + warp * 16;              // the warp's first row
  const int row0 = rw + g, row1 = row0 + 8;   // this lane's rows

  auto load_kv = [&](int tile, int stage) {
    tf_tile<DP, BK>(Ks + stage * BK * LD, kh, tile * BK, s, d, vec);
    tf_tile<DP, BK>(Vs + stage * BK * LD, vh, tile * BK, s, d, vec);
  };
  if (kt_begin < kt_end) {
    if (!QREG) tf_tile<DP, kTfRows>(Qs, qh, q0, s, d, vec);
    load_kv(kt_begin, 0);
    cp_async_commit();
  }
  // Q's A fragments of k-step kk: rows g, g + 8 by columns 8 kk + t, + 4
  float qf[QREG ? DT : 1][4];
  if (QREG) {
#pragma unroll
    for (int kk = 0; kk < (QREG ? DT : 1); ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e & 1 ? row1 : row0, col = 8 * kk + t + (e & 2) * 2;
        qf[kk][e] = row < s && col < d ? qh[(long long)row * d + col] : 0.f;
      }
  }

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      load_kv(kt + 1, st ^ 1);   // the next tile arrives while this one computes
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this tile (and Q) are in for every warp
    const float* kb = Ks + st * BK * LD;
    const float* vb = Vs + st * BK * LD;

    // S = Q K^T: the score tile n holds keys 8 n + 2 t, + 1 of rows g, g + 8.
    // The small products go into accumulators of their own, added at the
    // end: twice the independent chains of mma (a tile has only NT), and
    // the big products' sum is not rounded at the small ones' scale
    float sc[NT][4], sl[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = sl[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      float a[4];
      if (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[QREG ? kk : 0][e];
      } else {
        const float* qa = Qs + (warp * 16 + g) * LD + 8 * kk + t;
        a[0] = qa[0];
        a[1] = qa[8 * LD];
        a[2] = qa[4];
        a[3] = qa[8 * LD + 4];
      }
      uint32_t ab[4], as[4];
      split4<QREG && !tf_qsplit_once<DP>()>(a, ab, as);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kp = kb + (n * 8 + g) * LD + 8 * kk + t;
        mma_3xtf32(sc[n], sl[n], ab, as, kp[0], kp[4]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] += sl[n][e];

    // scale, mask, online softmax; a row's scores are in its quad of lanes
    const int k0 = kt * BK;
    const bool masked = k0 + BK > s || (causal && k0 + BK - 1 > rw);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (masked) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= s || (causal && col > row)) x = kNegInf;
        }
        sc[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = exp2f(sc[n][0] - mn0);
      sc[n][1] = exp2f(sc[n][1] - mn0);
      sc[n][2] = exp2f(sc[n][2] - mn1);
      sc[n][3] = exp2f(sc[n][3] - mn1);
      rs0 += sc[n][0] + sc[n][1];
      rs1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * alpha0 + rs0;   // this lane's part of the row sums
    l1 = l1 * alpha1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P V. The k-step j of P V is score tile j with its keys in the
    // order k = t <-> key 2 t, k = t + 4 <-> key 2 t + 1: P's accumulators
    // are its A fragment as they lie, and V's B fragment reads keys 2 t and
    // 2 t + 1 of column 8 n + g
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float a[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
      uint32_t ab[4], as[4];
      split4(a, ab, as);
      const float* vp = vb + (8 * j + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) mma_3xtf32(acc[n], acc[n], ab, as, vp[8 * n], vp[LD + 8 * n]);
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (nsplit == 1) {
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    float* oh = o + base;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        if (row < s && col < d) oh[(long long)row * d + col] = acc[n][e] / (e < 2 ? d0 : d1);
      }
  } else {
    // float32 partials for attn_combine_kernel, laid out as the wgmma
    // kernel's; a row that saw only masked columns writes l = 0, acc = 0
    const float w0 = m0 == kNegInf ? 0.f : 1.f, w1 = m1 == kNegInf ? 0.f : 1.f;
    const long long rows = (long long)bh * s;
    const long long r0 = ((long long)split * bh + head) * s + row0, r1 = r0 + 8;
    float* pm = part + nsplit * rows * d;
    float* pl = pm + nsplit * rows;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        if (col >= d) continue;
        if (e < 2 && row0 < s) part[r0 * d + col] = acc[n][e] * w0;
        if (e >= 2 && row1 < s) part[r1 * d + col] = acc[n][e] * w1;
      }
    if (t == 0) {
      if (row0 < s) { pm[r0] = m0; pl[r0] = l0 * w0; }
      if (row1 < s) { pm[r1] = m1; pl[r1] = l1 * w1; }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 / float16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;      // Q rows of a tile: 16 a warp
constexpr int kMmaThreads = 128;

struct Bf16 {
  static constexpr bool kBf16 = true;
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    uint32_t r;
    memcpy(&r, &h, 4);
    return r;
  }
  __device__ static __forceinline__ uint16_t store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __device__ static __forceinline__ void mma(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct F16 {
  static constexpr bool kBf16 = false;
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    uint32_t r;
    memcpy(&r, &h, 4);
    return r;
  }
  __device__ static __forceinline__ uint16_t store(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
  __device__ static __forceinline__ void mma(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// K/V tile rows: 64 up to DP = 128; 32 above, to keep the accumulators of
// DP / 2 floats a thread plus the scores in registers
template <int DP>
__host__ __device__ constexpr int mma_bk() { return DP <= 128 ? 64 : 32; }

// row stride in elements: 16 bytes of padding make the 8 rows a quad of
// lanes (or ldmatrix) reads fall in distinct banks when DP % 64 == 0
template <int DP>
__host__ __device__ constexpr int mma_ld() { return DP + 8; }

template <int DP>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (kMmaRows + 2 * mma_bk<DP>()) * mma_ld<DP>() * 2;
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// rows [r0, r0 + rows) of src [s, d] into dst [rows, LD], zero past s and
// past d, element by element (the rows of this kernel's inputs are not
// 16-byte pieces, or their bases are not 16-byte aligned)
template <int DP>
__device__ __forceinline__ void mma_tile(uint16_t* dst, const uint16_t* __restrict__ src,
                                         int r0, int rows, int s, int d) {
  constexpr int LD = mma_ld<DP>();
  for (int idx = threadIdx.x; idx < rows * DP; idx += kMmaThreads) {
    const int r = idx / DP, c = idx - r * DP, gr = r0 + r;
    dst[r * LD + c] = (gr < s && c < d) ? src[(long long)gr * d + c] : (uint16_t)0;
  }
}

template <typename Tr, int DP>
__global__ void __launch_bounds__(kMmaThreads)
attn_mma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int bh,
                int s, int d, int causal, float scale_log2) {
  constexpr int BK = mma_bk<DP>(), LD = mma_ld<DP>();
  constexpr int NT = BK / 8;   // score n-tiles of a warp
  constexpr int DT = DP / 8;   // output n-tiles of a warp
  extern __shared__ uint4 mma_smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(mma_smem);
  uint16_t* Ks = Qs + kMmaRows * LD;
  uint16_t* Vs = Ks + BK * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const int nq = ceil_div(s, kMmaRows);
  const int head = blockIdx.x % bh;
  const int q0 = (nq - 1 - (int)(blockIdx.x / bh)) * kMmaRows;
  const long long base = (long long)head * s * d;
  const uint16_t* qh = q + base;
  const uint16_t* kh = k + base;
  const uint16_t* vh = v + base;

  mma_tile<DP>(Qs, qh, q0, kMmaRows, s, d);
  mma_tile<DP>(Ks, kh, 0, BK, s, d);
  mma_tile<DP>(Vs, vh, 0, BK, s, d);

  // this lane's rows: row0 (c0, c1 of each tile) and row0 + 8 (c2, c3)
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int last = k_tiles(q0, kMmaRows, BK, s, causal);
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // Q and this K tile are in
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint16_t* qa = Qs + (wr + g) * LD + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8),
                             ld32(qa + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint16_t* kb = Ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        Tr::mma(sc[n], a, ld32(kb), ld32(kb + 8));
      }
    }
    __syncthreads();   // every warp is done with this K tile
    if (kt + 1 < last) mma_tile<DP>(Ks, kh, k0 + BK, BK, s, d);

    // scale, mask, online softmax; a row's scores are in its quad of lanes
    const bool masked = k0 + BK > s || (causal && k0 + BK - 1 > q0 + wr);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (masked) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= s || (causal && col > row)) x = kNegInf;
        }
        sc[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = exp2f(sc[n][0] - mn0);
      sc[n][1] = exp2f(sc[n][1] - mn0);
      sc[n][2] = exp2f(sc[n][2] - mn1);
      sc[n][3] = exp2f(sc[n][3] - mn1);
      rs0 += sc[n][0] + sc[n][1];
      rs1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * alpha0 + rs0;   // this lane's part of the row sums
    l1 = l1 * alpha1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    __syncthreads();   // this V tile is in
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the score tiles 2 kk and 2 kk + 1 are P's A fragment for keys
      // [16 kk, 16 kk + 16), in the input dtype
      const uint32_t a[4] = {Tr::pack(sc[2 * kk][0], sc[2 * kk][1]),
                             Tr::pack(sc[2 * kk][2], sc[2 * kk][3]),
                             Tr::pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             Tr::pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      // lane i addresses row i % 8 of 8x8 block i / 8: keys +0 / +8,
      // columns +0 / +8
      const uint16_t* vb = Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                           (lane >> 4) * 8;
#pragma unroll
      for (int n2 = 0; n2 < DP / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + n2 * 16);
        Tr::mma(acc[2 * n2], a, b[0], b[1]);
        Tr::mma(acc[2 * n2 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // every warp is done with this V tile
    if (kt + 1 < last) mma_tile<DP>(Vs, vh, k0 + BK, BK, s, d);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  uint16_t* oh = o + base;
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t + (e & 1);
      const int row = e < 2 ? row0 : row1;
      if (row < s && col < d)
        oh[(long long)row * d + col] = Tr::store(acc[n][e] / (e < 2 ? d0 : d1));
    }
}

// ---------------------------------------------------------------------------
// bfloat16 / float16 on Hopper: TMA ring, producer warp, wgmma
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;                           // Q rows of a CTA
constexpr int kWgConsumers = kWgRows / 64;             // 64 rows a warpgroup
constexpr int kWgThreads = 128 * (kWgConsumers + 1);   // and the producer's
constexpr int kChunk = 64;          // columns of a 128-byte swizzled chunk
constexpr int kSmemMax = 232448;    // the 227 KB a block may have
constexpr long long kHangCycles = 1LL << 34;   // ~9 s: a lost barrier traps

// K/V tile rows: 128 up to DP = 128, 64 above (O is DP / 2 floats a thread)
template <int DP>
__host__ __device__ constexpr int wg_bk() { return DP <= 128 ? 128 : 64; }
template <int DP>
__host__ __device__ constexpr int wg_q_bytes() { return kWgRows * DP * 2; }
template <int DP>
__host__ __device__ constexpr int wg_kv_bytes() { return wg_bk<DP>() * DP * 2; }
// stages of the K/V ring: as many as fit, at most 4
template <int DP>
__host__ __device__ constexpr int wg_stages() {
  const int n = (kSmemMax - 2048 - wg_q_bytes<DP>()) / (2 * wg_kv_bytes<DP>());
  return n < 4 ? n : 4;
}
// 1024 bytes to align the tiles, Q, the ring, the barriers
template <int DP>
__host__ __device__ constexpr int wg_smem_bytes() {
  return 1024 + wg_q_bytes<DP>() + 2 * wg_stages<DP>() * wg_kv_bytes<DP>() + 128;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// arrives on `bar` where `pred` holds; predicated inside the PTX, so the
// warp does not diverge
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(bar), "r"((uint32_t)pred) : "memory");
}

// waits for the completion of the barrier's phase of parity `parity`. The
// loop is inside the PTX, so the compiler sees no divergent path before the
// wgmma that follows; a barrier that does not complete within kHangCycles
// traps, so a lost arrival is a launch failure and not a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .s64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.s64 t1, t1, t0;\n"
      "setp.gt.s64 p, t1, %2;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity), "l"(kHangCycles) : "memory");
}

// the consumer warpgroups' turns at the tensor cores: warpgroup w issues
// its products after bar.sync on named barrier 1 + w, then gives the turn
// to the other by bar.arrive on its barrier, so that one's softmax runs
// while the other's products do
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(2 * 128) : "memory");
}
__device__ __forceinline__ void turn_give(int to) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(1 + to), "n"(2 * 128) : "memory");
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at `addr`: 8-row groups 1024
// bytes apart, `lbo` bytes between 64-column chunks (read when MN-major)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// O += P V for one K/V tile: P in registers (BK / 16 fragments of four),
// V [BK, DP] at `vb` in chunks of [BK, 64], MN-major
template <typename Tr, int DP, int BK>
__device__ __forceinline__ void wg_pv(float (&oacc)[DP / 2], uint32_t (&pa)[BK / 4],
                                      uint32_t vb) {
  wgmma::hold(oacc);
  wgmma::hold(pa);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma::rs<DP, Tr::kBf16>(oacc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                             sw128_desc(vb + kk * 16 * 128, BK * 128));
  wgmma::commit();
}

// S = Q K^T for one K tile: issues the products of Q's 64 rows at `qa`
// with the tile at `kb`, both in chunks of 64 columns, K-major
template <typename Tr, int DP, int BK>
__device__ __forceinline__ void wg_s(float (&sacc)[BK / 2], uint32_t qa, uint32_t kb) {
  wgmma::hold(sacc);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma::ss<BK, Tr::kBf16>(sacc, sw128_desc(qa + (kk >> 2) * kWgRows * 128 + (kk & 3) * 32, 16),
                             sw128_desc(kb + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16), kk > 0);
  wgmma::commit();
}

// 2^x by the SFU's ex2.approx with subnormal results flushed to 0 (exp2f
// without fast math adds instructions around it to keep them; a
// probability below 2^-126 of the row's max adds nothing to its sum)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// scale, mask and the online softmax of K tile kt's scores, in place: the
// exponentials relative to the new running max, whose ratio to the old one
// is alpha; a row's scores are in its quad of lanes (rows row0 and row1 of
// the warp whose first row is rw)
template <int BK>
__device__ __forceinline__ void wg_softmax(float (&sacc)[BK / 2], int kt, int s, int causal,
                                           float scale_log2, int rw, int row0, int row1,
                                           int t, float& m0, float& m1, float& l0, float& l1,
                                           float& alpha0, float& alpha1) {
  const int k0 = kt * BK;
  const bool masked = k0 + BK > s || (causal && k0 + BK - 1 > rw);
  // two partial maxima and sums a row, to halve the chains of dependent
  // instructions
  float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sacc[4 * n + e] * scale_log2;
      if (masked) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        if (col >= s || (causal && col > row)) x = kNegInf;
      }
      sacc[4 * n + e] = x;
      mx[(e >> 1) + 2 * (n & 1)] = fmaxf(mx[(e >> 1) + 2 * (n & 1)], x);
    }
  float mx0 = fmaxf(mx[0], mx[2]), mx1 = fmaxf(mx[1], mx[3]);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  alpha0 = fast_exp2(m0 - mn0);
  alpha1 = fast_exp2(m1 - mn1);
  float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    sacc[4 * n] = fast_exp2(sacc[4 * n] - mn0);
    sacc[4 * n + 1] = fast_exp2(sacc[4 * n + 1] - mn0);
    sacc[4 * n + 2] = fast_exp2(sacc[4 * n + 2] - mn1);
    sacc[4 * n + 3] = fast_exp2(sacc[4 * n + 3] - mn1);
    rs[2 * (n & 1)] += sacc[4 * n] + sacc[4 * n + 1];
    rs[1 + 2 * (n & 1)] += sacc[4 * n + 2] + sacc[4 * n + 3];
  }
  l0 = l0 * alpha0 + (rs[0] + rs[2]);   // this lane's part of the row sums
  l1 = l1 * alpha1 + (rs[1] + rs[3]);
  m0 = mn0;
  m1 = mn1;
}

// O times each row's ratio of its old to its new running max
template <int DP>
__device__ __forceinline__ void wg_rescale(float (&oacc)[DP / 2], float alpha0, float alpha1) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    oacc[4 * n] *= alpha0;
    oacc[4 * n + 1] *= alpha0;
    oacc[4 * n + 2] *= alpha1;
    oacc[4 * n + 3] *= alpha1;
  }
}

// P in the input dtype as the A fragments of P V: score tiles 2 kk and
// 2 kk + 1 hold keys [16 kk, 16 kk + 16)
template <typename Tr, int BK>
__device__ __forceinline__ void wg_pack(uint32_t (&pa)[BK / 4], const float (&sacc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[4 * kk] = Tr::pack(sacc[8 * kk], sacc[8 * kk + 1]);
    pa[4 * kk + 1] = Tr::pack(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pa[4 * kk + 2] = Tr::pack(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pa[4 * kk + 3] = Tr::pack(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

template <typename Tr, int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, uint16_t* __restrict__ o,
                  float* __restrict__ part, int bh, int s, int d, int causal,
                  float scale_log2, int nsplit) {
  constexpr int BK = wg_bk<DP>(), NCH = DP / kChunk, ST = wg_stages<DP>();
  constexpr int QB = wg_q_bytes<DP>(), KVB = wg_kv_bytes<DP>();
  static_assert(ST >= 2, "the K/V ring needs two stages");
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  // Q: NCH chunks of [kWgRows, 64]; stage st: K at ring + 2 st KVB, V after
  // it, each NCH chunks of [BK, 64]; then the barriers
  const uint32_t qs = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t ring = qs + QB;
  const uint32_t q_full = ring + 2 * ST * KVB;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * ST, empty = v_full + 8 * ST;

  const int nq = ceil_div(s, kWgRows);
  const int head = blockIdx.x % bh;
  const int rest = blockIdx.x / bh;
  const int split = rest % nsplit;
  const int q0 = (nq - 1 - rest / nsplit) * kWgRows;
  const int nkt = k_tiles(q0, kWgRows, BK, s, causal);
  const int per = ceil_div(nkt, nsplit);
  const int kt_begin = min(split * per, nkt), kt_end = min(kt_begin + per, nkt);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, kWgConsumers * 4);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup and warp indices from lane 0, so the compiler sees them
  // uniform: no wgmma lies in a divergent path
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0);
  if (wg == kWgConsumers) {
    // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 128 * kWgConsumers && kt_begin < kt_end) {
      mbar_expect_tx(q_full, QB);
      for (int c = 0; c < NCH; ++c)
        tma_load(qs + c * kWgRows * 128, &tq, q_full, c * kChunk, q0, head);
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int it = kt - kt_begin, st = it % ST;
        if (it >= ST) mbar_wait(empty + 8 * st, (it / ST - 1) & 1);
        const uint32_t kb = ring + 2 * st * KVB, vb = kb + KVB;
        mbar_expect_tx(k_full + 8 * st, KVB);
        for (int c = 0; c < NCH; ++c)
          tma_load(kb + c * BK * 128, &tk, k_full + 8 * st, c * kChunk, kt * BK, head);
        mbar_expect_tx(v_full + 8 * st, KVB);
        for (int c = 0; c < NCH; ++c)
          tma_load(vb + c * BK * 128, &tv, v_full + 8 * st, c * kChunk, kt * BK, head);
      }
    }
  } else {
    // a consumer warpgroup: 64 Q rows, 16 a warp
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rw = q0 + 64 * wg + 16 * warp;   // the warp's first row
    const int row0 = rw + g, row1 = row0 + 8;  // this lane's rows
    const uint32_t qa = qs + wg * 64 * 128;    // this warpgroup's rows of each chunk
    float oacc[DP / 2], sacc[BK / 2];
    uint32_t pa[BK / 4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    // the first tile is peeled off the loop, so that every wgmma wait in
    // the loop runs on every path: the compiler then keeps P V in flight
    // through the softmax. Warpgroup 0 takes the first turn
    if (kt_begin < kt_end) {
      if (wg == 0) turn_give(0);
      mbar_wait(q_full, 0);
      mbar_wait(k_full, 0);
      turn_wait(wg);
      wg_s<Tr, DP, BK>(sacc, qa, ring);
      turn_give(wg ^ 1);
      wgmma::wait<0>();
      wgmma::hold(sacc);
      float alpha0, alpha1;
      wg_softmax<BK>(sacc, kt_begin, s, causal, scale_log2, rw, row0, row1, t, m0, m1, l0,
                     l1, alpha0, alpha1);
      wg_pack<Tr, BK>(pa, sacc);
      for (int kt = kt_begin + 1; kt < kt_end; ++kt) {
        const int it = kt - kt_begin, st = it % ST, pst = (it - 1) % ST;
        // S of this tile, then P V of the previous one, in this
        // warpgroup's turn
        mbar_wait(k_full + 8 * st, (it / ST) & 1);
        mbar_wait(v_full + 8 * pst, ((it - 1) / ST) & 1);
        turn_wait(wg);
        wg_s<Tr, DP, BK>(sacc, qa, ring + 2 * st * KVB);
        // O to the previous tile's max while S runs, then its P V
        wg_rescale<DP>(oacc, alpha0, alpha1);
        wg_pv<Tr, DP, BK>(oacc, pa, ring + 2 * pst * KVB + KVB);
        turn_give(wg ^ 1);
        wgmma::wait<1>();   // S is in; P V runs on
        wgmma::hold(sacc);
        wg_softmax<BK>(sacc, kt, s, causal, scale_log2, rw, row0, row1, t, m0, m1, l0, l1,
                       alpha0, alpha1);
        wgmma::wait<0>();   // P V is done: its stage goes back to the producer
        wgmma::hold(oacc);
        wgmma::hold(pa);
        mbar_arrive_if(empty + 8 * pst, lane == 0);
        wg_pack<Tr, BK>(pa, sacc);
      }
      // the last tile's P V; warpgroup 1 passes no turn after it, since
      // warpgroup 0 takes none
      const int it = kt_end - 1 - kt_begin, st = it % ST;
      mbar_wait(v_full + 8 * st, (it / ST) & 1);
      turn_wait(wg);
      wg_rescale<DP>(oacc, alpha0, alpha1);
      wg_pv<Tr, DP, BK>(oacc, pa, ring + 2 * st * KVB + KVB);
      if (wg == 0) turn_give(1);
      wgmma::wait<0>();
      wgmma::hold(oacc);
      wgmma::hold(pa);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (nsplit == 1) {
      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      uint16_t* oh = o + (long long)head * s * d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * t;   // d % 8 == 0: both columns or neither
        if (col >= d) continue;
        if (row0 < s)
          *reinterpret_cast<uint32_t*>(oh + (long long)row0 * d + col) =
              Tr::pack(oacc[4 * n] / d0, oacc[4 * n + 1] / d0);
        if (row1 < s)
          *reinterpret_cast<uint32_t*>(oh + (long long)row1 * d + col) =
              Tr::pack(oacc[4 * n + 2] / d1, oacc[4 * n + 3] / d1);
      }
    } else {
      // float32 partials for attn_combine_kernel: acc [nsplit, bh, s, d],
      // then m and l [nsplit, bh, s]. A row that saw only masked columns
      // (max still -1e30) writes l = 0 and acc = 0
      const float w0 = m0 == kNegInf ? 0.f : 1.f, w1 = m1 == kNegInf ? 0.f : 1.f;
      const long long rows = (long long)bh * s;
      const long long r0 = ((long long)split * bh + head) * s + row0, r1 = r0 + 8;
      float* pm = part + nsplit * rows * d;
      float* pl = pm + nsplit * rows;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col >= d) continue;
        if (row0 < s)
          *reinterpret_cast<float2*>(part + r0 * d + col) =
              make_float2(oacc[4 * n] * w0, oacc[4 * n + 1] * w0);
        if (row1 < s)
          *reinterpret_cast<float2*>(part + r1 * d + col) =
              make_float2(oacc[4 * n + 2] * w1, oacc[4 * n + 3] * w1);
      }
      if (t == 0) {
        if (row0 < s) { pm[r0] = m0; pl[r0] = l0 * w0; }
        if (row1 < s) { pm[r1] = m1; pl[r1] = l1 * w1; }
      }
    }
  }
}

// the split over K: out = sum_i 2^(m_i - M) acc_i / max(sum_i 2^(m_i - M)
// l_i, 1e-30), M = max_i m_i, over the nsplit partials of a row; a thread
// for Out::kCols columns of a row, stored in the output dtype
constexpr int kCombineThreads = 256;

template <typename Tr>
struct Pack2 {   // 16-bit output, two columns a thread (d % 8 == 0)
  using T = uint16_t;
  static constexpr int kCols = 2;
  __device__ static __forceinline__ void store(T* o, const float* a) {
    *reinterpret_cast<uint32_t*>(o) = Tr::pack(a[0], a[1]);
  }
};

struct F32Out {  // float32 output, a column a thread (any d)
  using T = float;
  static constexpr int kCols = 1;
  __device__ static __forceinline__ void store(T* o, const float* a) { o[0] = a[0]; }
};

template <typename Out>
__global__ void __launch_bounds__(kCombineThreads)
attn_combine_kernel(const float* __restrict__ part, typename Out::T* __restrict__ o, int bh,
                    int s, int d, int nsplit) {
  constexpr int C = Out::kCols;
  const long long rows = (long long)bh * s;
  const int per_row = d / C;
  const long long idx = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  if (idx >= rows * per_row) return;
  const long long row = idx / per_row;
  const int col = (int)(idx - row * per_row) * C;
  const float* pm = part + nsplit * rows * d;
  const float* pl = pm + nsplit * rows;
  float mx = kNegInf;
  for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, pm[sp * rows + row]);
  float l = 0.f, a[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const float w = exp2f(pm[sp * rows + row] - mx);
    const float* ap = part + (sp * rows + row) * d + col;
    l += w * pl[sp * rows + row];
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] += w * ap[c];
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] /= den;
  Out::store(o + row * d + col, a);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Tr, int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int bh,
                       int s, int d, int causal, float scale, unsigned blocks,
                       cudaStream_t st) {
  constexpr int smem = mma_smem_bytes<DP>();
  cudaError_t rc = cudaFuncSetAttribute(
      attn_mma_kernel<Tr, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  attn_mma_kernel<Tr, DP><<<blocks, kMmaThreads, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), bh, s, d, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

template <typename Tr>
cudaError_t launch_mma_d(const void* q, const void* k, const void* v, void* o, int bh,
                         int s, int d, int causal, float scale, unsigned blocks,
                         cudaStream_t st) {
  if (d <= 64) return launch_mma<Tr, 64>(q, k, v, o, bh, s, d, causal, scale, blocks, st);
  if (d <= 128) return launch_mma<Tr, 128>(q, k, v, o, bh, s, d, causal, scale, blocks, st);
  if (d <= 192) return launch_mma<Tr, 192>(q, k, v, o, bh, s, d, causal, scale, blocks, st);
  return launch_mma<Tr, 256>(q, k, v, o, bh, s, d, causal, scale, blocks, st);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry
// point query, so the library needs no -lcuda; null where it is missing
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// a 3-D map of [bh, s, d] (d innermost) read in boxes of [rows, 64] with a
// 128-byte swizzle; rows past s in a head and columns past d read as zeros
bool tensor_map(CUtensorMap* map, const void* p, int dtype, int bh, int s, int d,
                int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kChunk, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                3, const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the wgmma kernel takes a 16-bit input that TMA can address: rows of 16-byte
// pieces and 16-byte-aligned bases; any other goes to attn_mma_kernel
bool wgmma_shape(const void* q, const void* k, const void* v, const void* o, int d,
                 int dtype) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  return dtype != 0 && d % 8 == 0 && bases % 16 == 0;
}

// the card's SMs (per device, read once), or 0
int sm_count() {
  static int sms_of[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int sms = dev < 64 ? sms_of[dev] : 0;
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return 0;
    }
    if (dev < 64) sms_of[dev] = sms;
  }
  return sms;
}

// splits of each (head, Q tile) over its K tiles: 1 when the `ctas` CTAs
// fill the card's SMs, else as many as fill them, at most `most` (the K
// tiles of the longest Q tile). nsplit * CTAs <= SMs, so the partials stay
// small
int splits(long long ctas, int most) {
  const int sms = sm_count();
  if (sms == 0 || ctas >= sms) return 1;
  const int n = (int)(sms / ctas);
  return n < most ? n : most;
}

// the wgmma kernel's: 128-row Q tiles
int wgmma_splits(int bh, int s, int d) {
  const int bk = d <= 128 ? wg_bk<128>() : wg_bk<256>();
  return splits((long long)bh * ceil_div(s, kWgRows), ceil_div(s, bk));
}

// the float32 kernel's: 64-row Q tiles, 32-key K tiles
int tf_splits(int bh, int s) {
  return splits((long long)bh * ceil_div(s, kTfRows), ceil_div(s, kTfBK));
}

long long wgmma_scratch_bytes(int bh, int s, int d, int nsplit) {
  return nsplit > 1 ? (long long)nsplit * bh * s * (d + 2) * 4 : 0;
}

template <int DP>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* o, int bh, int s,
                          int d, int causal, float scale, void* scratch, int nsplit,
                          cudaStream_t st) {
  constexpr int smem = tf_smem_bytes<DP>();
  static_assert(smem <= kSmemMax, "the float32 kernel's shared memory");
  cudaError_t rc = cudaFuncSetAttribute(
      attn_tf32x3_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const int vec = d % 4 == 0 && bases % 16 == 0;
  const long long blocks = (long long)bh * ceil_div(s, kTfRows) * nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_tf32x3_kernel<DP><<<(unsigned)blocks, kTfThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(scratch), bh,
      s, d, causal, scale * kLog2e, nsplit, vec);
  rc = cudaGetLastError();
  if (rc != cudaSuccess || nsplit == 1) return rc;
  const long long elems = (long long)bh * s * d;
  attn_combine_kernel<F32Out><<<(unsigned)((elems + kCombineThreads - 1) / kCombineThreads),
                                kCombineThreads, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<float*>(o), bh, s, d, nsplit);
  return cudaGetLastError();
}

cudaError_t launch_tf32x3_d(const void* q, const void* k, const void* v, void* o, int bh,
                            int s, int d, int causal, float scale, void* scratch, int nsplit,
                            cudaStream_t st) {
  if (d <= 64) return launch_tf32x3<64>(q, k, v, o, bh, s, d, causal, scale, scratch, nsplit, st);
  if (d <= 128)
    return launch_tf32x3<128>(q, k, v, o, bh, s, d, causal, scale, scratch, nsplit, st);
  if (d <= 192)
    return launch_tf32x3<192>(q, k, v, o, bh, s, d, causal, scale, scratch, nsplit, st);
  return launch_tf32x3<256>(q, k, v, o, bh, s, d, causal, scale, scratch, nsplit, st);
}

template <typename Tr, int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int bh,
                         int s, int d, int dtype, int causal, float scale, void* scratch,
                         int nsplit, cudaStream_t st) {
  constexpr int smem = wg_smem_bytes<DP>();
  static_assert(smem <= kSmemMax, "the wgmma kernel's shared memory");
  cudaError_t rc = cudaFuncSetAttribute(
      attn_wgmma_kernel<Tr, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, dtype, bh, s, d, kWgRows) ||
      !tensor_map(&tk, k, dtype, bh, s, d, wg_bk<DP>()) ||
      !tensor_map(&tv, v, dtype, bh, s, d, wg_bk<DP>())) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = (long long)bh * ceil_div(s, kWgRows) * nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_wgmma_kernel<Tr, DP><<<(unsigned)blocks, kWgThreads, smem, st>>>(
      tq, tk, tv, static_cast<uint16_t*>(o), static_cast<float*>(scratch), bh, s, d,
      causal, scale * kLog2e, nsplit);
  rc = cudaGetLastError();
  if (rc != cudaSuccess || nsplit == 1) return rc;
  const long long pairs = (long long)bh * s * (d / 2);
  attn_combine_kernel<Pack2<Tr>><<<(unsigned)((pairs + kCombineThreads - 1) / kCombineThreads),
                                   kCombineThreads, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<uint16_t*>(o), bh, s, d, nsplit);
  return cudaGetLastError();
}

template <typename Tr>
cudaError_t launch_wgmma_d(const void* q, const void* k, const void* v, void* o, int bh,
                           int s, int d, int dtype, int causal, float scale,
                           void* scratch, int nsplit, cudaStream_t st) {
  if (d <= 64)
    return launch_wgmma<Tr, 64>(q, k, v, o, bh, s, d, dtype, causal, scale, scratch, nsplit, st);
  if (d <= 128)
    return launch_wgmma<Tr, 128>(q, k, v, o, bh, s, d, dtype, causal, scale, scratch, nsplit, st);
  if (d <= 192)
    return launch_wgmma<Tr, 192>(q, k, v, o, bh, s, d, dtype, causal, scale, scratch, nsplit, st);
  return launch_wgmma<Tr, 256>(q, k, v, o, bh, s, d, dtype, causal, scale, scratch, nsplit, st);
}

}  // namespace

// Bytes of float32 scratch that flash_attention_run needs for a [bh, s,
// d] of `dtype` whose CTAs are split over K (0 when they are not): the
// wrapper allocates them and passes them in.
extern "C" long long flash_attention_scratch_bytes(int bh, int s, int d, int dtype) {
  if (bh < 1 || s < 1 || d < 1 || d > kMaxD || dtype < 0 || dtype > 2) return 0;
  if (dtype == 0) return wgmma_scratch_bytes(bh, s, d, tf_splits(bh, s));
  if (d % 8) return 0;
  return wgmma_scratch_bytes(bh, s, d, wgmma_splits(bh, s, d));
}

// q, k, v, o: device [bh, s, d], contiguous, all of one dtype (0 float32,
// 1 bfloat16, 2 float16); scale: d^-0.5; scratch: scratch_bytes of device
// memory, at least flash_attention_scratch_bytes(bh, s, d, dtype). bh == 0
// or s == 0 launches nothing. Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a shape, dtype or scratch the
// kernels do not take.
extern "C" int flash_attention_run(const void* q, const void* k, const void* v, void* o,
                                   int bh, int s, int d, int dtype, int causal,
                                   float scale, void* scratch, long long scratch_bytes,
                                   void* stream) {
  if (bh < 0 || s < 0 || d < 1 || d > kMaxD || dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (bh == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int nsplit = tf_splits(bh, s);
    if (scratch_bytes < wgmma_scratch_bytes(bh, s, d, nsplit)) return (int)cudaErrorInvalidValue;
    return (int)launch_tf32x3_d(q, k, v, o, bh, s, d, causal, scale, scratch, nsplit, st);
  }
  if (wgmma_shape(q, k, v, o, d, dtype)) {
    const int nsplit = wgmma_splits(bh, s, d);
    if (scratch_bytes < wgmma_scratch_bytes(bh, s, d, nsplit)) return (int)cudaErrorInvalidValue;
    return (int)(dtype == 1
                     ? launch_wgmma_d<Bf16>(q, k, v, o, bh, s, d, dtype, causal, scale,
                                            scratch, nsplit, st)
                     : launch_wgmma_d<F16>(q, k, v, o, bh, s, d, dtype, causal, scale,
                                           scratch, nsplit, st));
  }
  const long long blocks = (long long)bh * ((s + kMmaRows - 1) / kMmaRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  return (int)(dtype == 1 ? launch_mma_d<Bf16>(q, k, v, o, bh, s, d, causal, scale, nb, st)
                          : launch_mma_d<F16>(q, k, v, o, bh, s, d, causal, scale, nb, st));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
