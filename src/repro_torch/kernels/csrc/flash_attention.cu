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
//   - K tiles are taken from tile 0 upward. Tile 0 holds column 0, which
//     every row sees, so after it each row's running max is a real score
//     and a masked -1e30 gives exp(-1e30 - m) = 0. A split over K would
//     break that (a row whose max is still -1e30 gets exp(0) = 1 for each
//     masked column) and would have to handle it;
//   - with causal, K tiles past the Q tile's last row are not read, as the
//     Pallas loop stops at :57-63;
//   - the head dim is zero-filled in shared memory up to DP in {64, 128,
//     192, 256} (the kernel's template width), and rows past S up to the
//     tile; columns past S are masked. D > 256 is refused.
//
// float32 (attn_f32_kernel): FFMA only, no TF32 and no tensor cores (the
// reference's 2e-5 tolerance rules TF32 out). 256 threads, a 64 x 64 score
// tile, each thread 4 rows x 4 columns of it; Q, K (then V, in the same
// buffer) and P in shared memory, read as float4.
//
// bfloat16 / float16 (attn_mma_kernel): mma.sync m16n8k16 with float32
// accumulators for both Q K^T and P V, FlashAttention-2's layout: four
// warps, each owning 16 rows of a 64-row Q tile, so the row statistics stay
// in a quad of lanes; the score accumulators become P's A fragments in
// registers (cast to the input dtype, as the oracle casts probs); V's B
// fragments come from ldmatrix.trans. K and V tiles arrive by cp.async,
// the next K tile during this tile's softmax and P V, the next V tile
// during the next Q K^T. Scores are taken in the log2 domain (scale *
// log2 e) for exp2f.
//
// Bound: at the repository's shapes (S >= 1024, D >= 64) operations:
// 4 * S^2 * D per (b, h), halved when causal, against 4 * S * D elements
// of memory. In bfloat16 the exponentials (S^2 / 2 per head with causal)
// also cost SFU time, about half the tensor-core bound at qwen2-1.5B's
// train_4k shape. This first version is mma.sync, not wgmma, with one
// K and one V buffer; wgmma, TMA, warp specialisation and overlapping the
// exponentials with the products are its redesign.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxD = 256;

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the K tiles a Q tile [q0, q0 + bq) reads: up to its last row's tile when
// causal, else all
__device__ __forceinline__ int k_tiles(int q0, int bq, int bk, int s, int causal) {
  const int row_hi = min(q0 + bq, s) - 1;
  return causal ? row_hi / bk + 1 : ceil_div(s, bk);
}

// ---------------------------------------------------------------------------
// float32: FFMA
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;      // Q rows and K columns of a tile
constexpr int kF32Threads = 256;  // 16 x 16: 4 x 4 scores each

template <int DP>
__host__ __device__ constexpr int f32_smem_bytes() {
  return (2 * kF32Rows * (DP + 4) + kF32Rows * (kF32Rows + 4)) * 4;
}

// rows [r0, r0 + kF32Rows) of src [s, d] into dst [kF32Rows, DP + 4],
// zero past s and past d
template <int DP>
__device__ __forceinline__ void f32_tile(float* dst, const float* __restrict__ src,
                                         int r0, int s, int d) {
  for (int idx = threadIdx.x; idx < kF32Rows * DP; idx += kF32Threads) {
    const int r = idx / DP, c = idx - r * DP, gr = r0 + r;
    dst[r * (DP + 4) + c] = (gr < s && c < d) ? src[(long long)gr * d + c] : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int bh,
                int s, int d, int causal, float scale) {
  constexpr int LD = DP + 4, LP = kF32Rows + 4, NC = DP / 64;
  extern __shared__ float4 f32_smem[];
  float* Qs = reinterpret_cast<float*>(f32_smem);
  float* KV = Qs + kF32Rows * LD;   // the K tile, then the V tile
  float* Ps = KV + kF32Rows * LD;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = ceil_div(s, kF32Rows);
  const int head = blockIdx.x % bh;
  const int q0 = (nq - 1 - (int)(blockIdx.x / bh)) * kF32Rows;
  const long long base = (long long)head * s * d;

  f32_tile<DP>(Qs, q + base, q0, s, d);
  // rows ty + 16 i; scores of columns tx + 16 j; outputs of columns
  // 64 c + 4 tx + e
  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  const int last = k_tiles(q0, kF32Rows, kF32Rows, s, causal);
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * kF32Rows;
    __syncthreads();   // the previous P V is done with KV and Ps
    f32_tile<DP>(KV, k + base, k0, s, d);
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + dd]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KV[(tx + 16 * j) * LD + dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (col >= s || (causal && col > row)) x = kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the row's 16 threads are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + sum;   // this thread's part of the row sum
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();   // K read, P written
    f32_tile<DP>(KV, v + base, k0, s, d);
    __syncthreads();
#pragma unroll 2
    for (int kc = 0; kc < kF32Rows; kc += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LP + kc]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&KV[(kc + u) * LD + 64 * c + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const float denom = fmaxf(li, 1e-30f);
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < d) o[base + (long long)row * d + col] = acc[i][c][e] / denom;
      }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 / float16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;      // Q rows of a tile: 16 a warp
constexpr int kMmaThreads = 128;

struct Bf16 {
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// rows [r0, r0 + rows) of src [s, d] into dst [rows, LD], zero past s and
// past d: by cp.async in 16-byte pieces when vec (d % 8 == 0 and 16-byte
// aligned bases), else element by element
template <int DP>
__device__ __forceinline__ void mma_tile(uint16_t* dst, const uint16_t* __restrict__ src,
                                         int r0, int rows, int s, int d, int vec) {
  constexpr int LD = mma_ld<DP>();
  if (vec) {
    constexpr int CH = DP / 8;
    for (int idx = threadIdx.x; idx < rows * CH; idx += kMmaThreads) {
      const int r = idx / CH, c = (idx - r * CH) * 8, gr = r0 + r;
      const bool ok = gr < s && c < d;
      cp_async16(dst + r * LD + c, ok ? src + (long long)gr * d + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += kMmaThreads) {
      const int r = idx / DP, c = idx - r * DP, gr = r0 + r;
      dst[r * LD + c] = (gr < s && c < d) ? src[(long long)gr * d + c] : (uint16_t)0;
    }
  }
}

template <typename Tr, int DP>
__global__ void __launch_bounds__(kMmaThreads)
attn_mma_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int bh,
                int s, int d, int causal, float scale_log2, int vec) {
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

  // groups in flight, oldest first: [Q, K0] [V0], then K_{j+1}, V_{j+1}
  mma_tile<DP>(Qs, qh, q0, kMmaRows, s, d, vec);
  mma_tile<DP>(Ks, kh, 0, BK, s, d, vec);
  cp_async_commit();
  mma_tile<DP>(Vs, vh, 0, BK, s, d, vec);
  cp_async_commit();

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
    cp_async_wait<1>();   // Q and this K tile are in
    __syncthreads();
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
    if (kt + 1 < last) mma_tile<DP>(Ks, kh, k0 + BK, BK, s, d, vec);
    cp_async_commit();

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

    cp_async_wait<1>();   // this V tile is in
    __syncthreads();
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
    if (kt + 1 < last) mma_tile<DP>(Vs, vh, k0 + BK, BK, s, d, vec);
    cp_async_commit();
  }
  cp_async_wait<0>();

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
// launch
// ---------------------------------------------------------------------------

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
                       int s, int d, int causal, float scale, unsigned blocks,
                       cudaStream_t st) {
  constexpr int smem = f32_smem_bytes<DP>();
  cudaError_t rc = cudaFuncSetAttribute(
      attn_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  attn_f32_kernel<DP><<<blocks, kF32Threads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), bh, s, d, causal, scale);
  return cudaGetLastError();
}

template <typename Tr, int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int bh,
                       int s, int d, int causal, float scale, unsigned blocks,
                       cudaStream_t st) {
  constexpr int smem = mma_smem_bytes<DP>();
  cudaError_t rc = cudaFuncSetAttribute(
      attn_mma_kernel<Tr, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const int vec = d % 8 == 0 && bases % 16 == 0;
  attn_mma_kernel<Tr, DP><<<blocks, kMmaThreads, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), bh, s, d, causal,
      scale * kLog2e, vec);
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

}  // namespace

// q, k, v, o: device [bh, s, d], contiguous, all of one dtype (0 float32,
// 1 bfloat16, 2 float16); scale: d^-0.5. bh == 0 or s == 0 launches
// nothing. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or dtype the kernel does not take.
extern "C" int flash_attention_run(const void* q, const void* k, const void* v, void* o,
                                   int bh, int s, int d, int dtype, int causal,
                                   float scale, void* stream) {
  if (bh < 0 || s < 0 || d < 1 || d > kMaxD || dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (bh == 0 || s == 0) return 0;
  const int rows = dtype == 0 ? kF32Rows : kMmaRows;
  const long long blocks = (long long)bh * ((s + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks;
  cudaError_t rc;
  if (dtype == 0) {
    if (d <= 64) rc = launch_f32<64>(q, k, v, o, bh, s, d, causal, scale, nb, st);
    else if (d <= 128) rc = launch_f32<128>(q, k, v, o, bh, s, d, causal, scale, nb, st);
    else if (d <= 192) rc = launch_f32<192>(q, k, v, o, bh, s, d, causal, scale, nb, st);
    else rc = launch_f32<256>(q, k, v, o, bh, s, d, causal, scale, nb, st);
  } else if (dtype == 1) {
    rc = launch_mma_d<Bf16>(q, k, v, o, bh, s, d, causal, scale, nb, st);
  } else {
    rc = launch_mma_d<F16>(q, k, v, o, bh, s, d, causal, scale, nb, st);
  }
  return (int)rc;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
