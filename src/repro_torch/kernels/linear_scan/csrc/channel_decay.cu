// channel_decay: the linear scan's channel-decay body, the per-channel
// chunk form on the tensor cores.  The wrapper (ops.py) sends it the calls
// with bf16 q, k, v and a w that varies over K (RWKV6's data-dependent
// decay, f32 or bf16), in `inclusive` and `bonus` modes, K and V multiples
// of 16 with K ≤ 128.  Together with linear_scan.cu it replaces the TPU
// kernel linear_scan_fwd (_scan_kernel) of
// src/repro/kernels/linear_scan/linear_scan.py, and computes what it does:
//
//     h_t = exp(w_t) ⊙_K h_{t-1} + k_t ⊗ v_t            (w_t ≤ 0)
//     inclusive:  y_t = q_t · h_t
//     bonus:      y_t = q_t · (h_{t-1} + diag(u) k_t ⊗ v_t)
//
// Chunks of C = 64 steps, each cut into four sub-chunks of 16.  Cumsums of
// w are taken within a sub-chunk (bl; β = bl, or the row before in bonus
// mode); r_i, the cumsum at the end of sub-chunk i − 1, is a sum of
// sub-chunk totals.  The intra-chunk matrix A[t, s] = Σ_k q_t k_s
// e^{β_t − b_s} is built in three parts, every exponent taken ≤ 0 (a
// factor that underflows stands for a true term smaller still):
//   * s in sub-chunk j < i, t in sub-chunk i: factored at r_{j+1},
//     A = (q ⊙ e^{β − r_i} ⊙ e^{r_i − r_{j+1}}) · (k ⊙ e^{r_{j+1} − b})ᵀ,
//     a TF32 tensor-core product;
//   * the lower-left 8 × 8 quadrant of a diagonal block, factored the
//     same way at the block's middle row, a TF32 product;
//   * the two 8 × 8 diagonal quadrants: the exact sum on the CUDA cores,
//     one exponential per (t, odd s, k) and its even neighbour by one
//     multiply with e^{w} (2 of the 4 entries a lane holds per channel),
//     masked to s ≤ t (s < t in bonus mode, where t = s holds q·u·k).
// Then y = (q ⊙ e^{β}) · h + A · V and h ← e^{b_C} ⊙ h + (k ⊙ e^{b_C −
// b})ᵀ · V, both TF32 products (A, h and the exponential products rounded
// to TF32; bf16 q, k and v are exact in TF32); h stays f32 in registers.
//
// What bounds it on an H100: bytes.  At rwkv6-7b's prefill shape (batch 4,
// 64 heads, T 2048, K = V = 64; q, k, v, w and y in bf16) it reads and
// writes 5 × 67 MB, 0.100 ms at 3.35 TB/s; its products are about 13
// GFLOP, under 30 µs at the TF32 rate.  It runs at about 0.38 ms there
// (PERF.md): each block walks 32 chunks in order with 2 blocks an SM, so
// the latency of each warp's chains and of the 5 barriers a chunk sets
// the pace, with the special-function units (about 250 exponentials a
// lane a chunk) and shared-memory traffic next.
//
// Design: one block of four warps per (batch, head, V slice of 64
// columns, or 16 where 64 does not divide V) walks its chunks in order; warp w owns the rows of sub-chunk w.  Each warp
// takes its own sub-chunk's cumsum (a channel a lane, in log2 units, its
// 16 rows loaded first), its k factors (to shared memory, for the later
// warps and the carry, with channels c and c + 4 side by side so a B
// fragment is one 8-byte load) and its diagonal block; then a table of the
// 10 decays e^{r_a − r_b} between sub-chunk boundaries (a channel a
// thread) serves the off-diagonal products, q ⊙ e^{β} and the carry.  h
// sits in shared memory with a lane's B fragments side by side (16-byte
// loads); V's B fragments come by ldmatrix.trans, shared by y's A · V and
// the carry.  Every tile is single-buffered: the next chunk's q, k and w
// land by cp.async (16-byte pieces, zero-filled past T, through the
// operands' strides: RWKV6's [b, t, h, k] tensors seen as [b, h, t, k]
// are never copied) while this chunk computes y and the carry, its v
// while the next chunk computes its cumsum and A.  100,352 bytes of
// shared memory and 255 registers a thread at K = V = 64: 2 blocks an SM,
// the 256 blocks of rwkv6-7b's prefill in one wave.  Steps past T read as
// w = 0 and k = 0, so the carry is exact and nothing is padded in device
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "scan_mma.cuh"

namespace scan_cd {

using namespace scan_tc;

struct Strides {
  int64_t b, h, t, k;
};

constexpr int kC = 64;              // steps per chunk
constexpr int kSub = 16;            // steps per sub-chunk: one warp's rows
constexpr int kThreads = 128;       // four warps
constexpr int kPairs = 10;          // sub-chunk boundary pairs (a > b)
constexpr float kLog2e = 1.4426950408889634f;

// The row of e^{r_a − r_b}, 0 ≤ b < a ≤ 4, in the decay table (r_4 = b_C).
__host__ __device__ constexpr int pair(int a, int b) {
  return a * (a - 1) / 2 + b;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four bf16 at p (8-byte aligned) and four floats at p (16-byte aligned).
__device__ __forceinline__ void ld_bf16x4(const __nv_bfloat16* p,
                                          float (&f)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(r.x << 16);
  f[1] = __uint_as_float(r.x & 0xffff0000u);
  f[2] = __uint_as_float(r.y << 16);
  f[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void ld_f32x4(const float* p, float (&f)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}

// Four 8 x 8 b16 tiles, transposed: lane (g, c) gets rows 2c and 2c + 1
// of column g of each, as the low and high halves of one register.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// Where channel ch of a k-factor row sits: channels c and c + 4 of each
// group of 8 side by side, so that one 8-byte load gives a lane its pair.
__device__ __forceinline__ int kj_pos(int ch) {
  return (ch & ~7) | ((ch & 3) << 1) | ((ch >> 2) & 1);
}

// Padded rows: q and k (halves), bl and e^{w} (floats), the k factors
// (floats), v (halves), so that the fragment loads hit distinct banks.
template <int kKT>
__host__ __device__ constexpr int ld_q() { return 16 * kKT + 8; }
template <int kKT>
__host__ __device__ constexpr int ld_f() { return 16 * kKT + 4; }
template <int kKT>
__host__ __device__ constexpr int ld_j() { return 16 * kKT + 8; }
template <int kVS>
__host__ __device__ constexpr int ld_v() { return kVS + 8; }
// h is kept as K/2 rows of 2·V floats: state rows k and k + 4 of each
// group of 8 interleaved, and a lane's B fragments for every column tile
// side by side (four 16-byte loads at V = 64).
template <int kVS>
__host__ __device__ constexpr int ld_h() { return 2 * kVS + 4; }
template <int kVS>
__device__ __forceinline__ int h_pos(int k, int col) {
  return ((k >> 3) * 4 + (k & 3)) * ld_h<kVS>() + (col & 7) * (kVS / 4)
       + (col >> 3) * 2 + ((k >> 2) & 1);
}

template <int kKT, int kVS>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int K = 16 * kKT;
  return 2 * (2 * kC * ld_q<kKT>() + kC * ld_v<kVS>() + kC * K)
       + 4 * ((kC + kC / 2) * ld_f<kKT>() + kC * ld_j<kKT>()
              + K / 2 * ld_h<kVS>() + kPairs * K + 2 * K);
}

// kKT: K / 16 (K ≤ 128); kVS: the block's value columns (16 or 64).
template <int kKT, int kVS>
__global__ void __launch_bounds__(kThreads)
scan_channel_decay_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const void* __restrict__ w, int w_code,
                          const float* __restrict__ u,
                          __nv_bfloat16* __restrict__ y, int heads, int T,
                          int V, int bonus, Strides sq, Strides sk,
                          Strides sv, Strides sw) {
  constexpr int K = 16 * kKT;
  constexpr int ldq = ld_q<kKT>();
  constexpr int ldf = ld_f<kKT>();
  constexpr int ldj = ld_j<kKT>();
  constexpr int ldv = ld_v<kVS>();
  constexpr int kNT = kVS / 8;             // 8-column tiles of the slice
  constexpr int kRT = (kKT + 3) / 4;       // 16-row state tiles per warp
  constexpr int kCh = (K + 31) / 32;       // cumsum channels per lane
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [C][ldq]
  __nv_bfloat16* ks = qs + kC * ldq;                               // [C][ldq]
  __nv_bfloat16* vs = ks + kC * ldq;                               // [C][ldv]
  __nv_bfloat16* wr = vs + kC * ldv;          // [C][K] bf16 w as it lands
  float* bl = reinterpret_cast<float*>(wr + kC * K);  // [C][ldf] f32 w, bl
  float* ew = bl + kC * ldf;                  // [C/2][ldf] e^{w}, odd rows
  float* kj = ew + kC / 2 * ldf;     // [C][ldj] k ⊙ e^{r_{j+1} − b}, kj_pos
  float* hs = kj + kC * ldj;         // [K/2][ld_h] h, TF32-rounded, h_pos
  float* rt = hs + K / 2 * ld_h<kVS>();       // [kPairs][K] e^{r_a − r_b}
  float* us = rt + kPairs * K;                // [K] u (bonus mode)
  float* zr = us + K;                         // [K] zeros

  const int n_vs = V / kVS;
  const int bh = blockIdx.x / n_vs;
  const int v0 = (blockIdx.x - bh * n_vs) * kVS;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int64_t q_base = b * sq.b + h * sq.h;
  const int64_t k_base = b * sk.b + h * sk.h;
  const int64_t v_base = b * sv.b + h * sv.h + v0;
  const int64_t w_base = b * sw.b + h * sw.h;
  const int n_chunks = (T + kC - 1) / kC;

  // Start the copies of chunk ci's q, k and w (f32 w straight into bl),
  // or of its v, as one group each; past the last chunk, an empty group.
  auto load_qkw = [&](int ci) {
    if (ci < n_chunks) {
      const int t0 = ci * kC;
      for (int i = tid; i < kC * (K / 8); i += kThreads) {
        const int r = i / (K / 8), p = i - r * (K / 8);
        const bool ok = t0 + r < T;
        const int64_t t = ok ? t0 + r : 0;
        cp_async16(qs + r * ldq + 8 * p, q + q_base + t * sq.t + 8 * p, ok);
        cp_async16(ks + r * ldq + 8 * p, k + k_base + t * sk.t + 8 * p, ok);
        if (w_code)
          cp_async16(wr + r * K + 8 * p,
                     static_cast<const __nv_bfloat16*>(w) + w_base
                         + t * sw.t + 8 * p, ok);
      }
      if (!w_code)
        for (int i = tid; i < kC * (K / 4); i += kThreads) {
          const int r = i / (K / 4), p = i - r * (K / 4);
          const bool ok = t0 + r < T;
          const int64_t t = ok ? t0 + r : 0;
          cp_async16(bl + r * ldf + 4 * p,
                     static_cast<const float*>(w) + w_base + t * sw.t
                         + 4 * p, ok);
        }
    }
    cp_async_commit();
  };
  auto load_v = [&](int ci) {
    if (ci < n_chunks) {
      const int t0 = ci * kC;
      for (int i = tid; i < kC * kNT; i += kThreads) {
        const int r = i / kNT, p = i - r * kNT;
        const bool ok = t0 + r < T;
        const int64_t t = ok ? t0 + r : 0;
        cp_async16(vs + r * ldv + 8 * p, v + v_base + t * sv.t + 8 * p, ok);
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < K / 2 * ld_h<kVS>(); i += kThreads) hs[i] = 0.f;
  for (int i = tid; i < K; i += kThreads) {
    us[i] = bonus ? u[h * K + i] : 0.f;
    zr[i] = 0.f;
  }
  float hacc[kRT][kNT][4];        // state rows 16·(warp + 4r) + {g, g + 8}
#pragma unroll
  for (int r = 0; r < kRT; ++r)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[r][n][e] = 0.f;
  load_qkw(0);
  load_v(0);

  // This thread's rows ta, tb of the warp's sub-chunk, and their β rows
  // (bonus mode: the row before, zero before the sub-chunk's first row).
  const int r0 = kSub * warp;
  const int ta = r0 + g, tb = ta + 8;
  const float* beta_a = bonus ? (g ? bl + (ta - 1) * ldf : zr) : bl + ta * ldf;
  const float* beta_b = bl + (bonus ? tb - 1 : tb) * ldf;
  // The diagonal quadrants' entries this thread holds: local row g against
  // local columns 2c (even) and 2c + 1 (odd), in both quadrants.
  const bool odd_in = bonus ? 2 * c + 1 < g : 2 * c + 1 <= g;
  const bool even_in = bonus ? 2 * c < g : 2 * c <= g;
  const bool odd_u = bonus && 2 * c + 1 == g;
  const bool even_u = bonus && 2 * c == g;

  for (int ci = 0; ci < n_chunks; ++ci) {
    cp_async_wait_one();                   // q, k, w of chunk ci
    __syncthreads();                       // ... and h are in place

    // bl: cumsum of w·log2(e) within this warp's sub-chunk, a channel a
    // lane; e^{w} on the odd rows; the sub-chunk's k factors
    // k ⊙ e^{r_{i+1} − b_s}.  (f32 w is read and replaced in place.)
#pragma unroll
    for (int m = 0; m < kCh; ++m) {
      const int ch = lane + 32 * m;
      if (ch >= K) continue;
      float x[kSub], r[kSub], kv[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        x[t] = kLog2e * (w_code ? bf(wr[(r0 + t) * K + ch])
                                : bl[(r0 + t) * ldf + ch]);
        kv[t] = bf(ks[(r0 + t) * ldq + ch]);
      }
      float run = 0.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) r[t] = run += x[t];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        bl[(r0 + t) * ldf + ch] = r[t];
        if (t & 1) ew[(r0 + t) / 2 * ldf + ch] = ex2(x[t]);
        kj[(r0 + t) * ldj + kj_pos(ch)] = kv[t] * ex2(r[kSub - 1] - r[t]);
      }
    }
    __syncwarp();

    // The diagonal block, in the accumulator layout of two 8-column
    // tiles: dq[0] holds columns 0-7 (rows g: the exact top quadrant; rows
    // g + 8: the factored lower-left one), dq[1] columns 8-15 (rows g + 8:
    // the exact bottom quadrant; rows g are above the diagonal).
    float dq[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
    {
      // Lower-left quadrant at the middle row 7: (q ⊙ e^{β_t − b_7}) ·
      // (k ⊙ e^{b_7 − b_s})ᵀ for t in rows 8-15, s in rows 0-7.
      const float* mid = bl + (r0 + 7) * ldf;
      const float* b_s = bl + (r0 + g) * ldf;
      const __nv_bfloat16* k_s = ks + (r0 + g) * ldq;
#pragma unroll
      for (int kk = 0; kk < K / 8; ++kk) {
        const int c0 = 8 * kk + c, c1 = c0 + 4;
        const uint32_t a[4] = {
            0u, tf32(bf(qs[tb * ldq + c0]) * ex2(beta_b[c0] - mid[c0])),
            0u, tf32(bf(qs[tb * ldq + c1]) * ex2(beta_b[c1] - mid[c1]))};
        mma_tf32(dq[0], a, tf32(bf(k_s[c0]) * ex2(mid[c0] - b_s[c0])),
                 tf32(bf(k_s[c1]) * ex2(mid[c1] - b_s[c1])));
      }
    }
    {
      // The exact quadrants.  e^{β_t − b_s} for the odd column s, and for
      // the even one e^{β_t − b_{s+1}}·e^{w_{s+1}}; where the odd column is
      // masked the even one is the diagonal (e^0) or masked too.
      const int s_top = r0 + 2 * c + 1, s_bot = s_top + 8;
      const __nv_bfloat16* q_a = qs + ta * ldq;
      const __nv_bfloat16* q_b = qs + tb * ldq;
      const __nv_bfloat16* k_top = ks + s_top * ldq;
      const __nv_bfloat16* k_bot = ks + s_bot * ldq;
      const float* b_top = bl + s_top * ldf;
      const float* b_bot = bl + s_bot * ldf;
      const float* e_top = ew + s_top / 2 * ldf;
      const float* e_bot = ew + s_bot / 2 * ldf;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};   // (a, even), (a, odd), (b, ...)
#pragma unroll 4
      for (int kc = 0; kc < K; kc += 4) {
        float qa[4], qb[4], k0a[4], k1a[4], k0b[4], k1b[4];
        float ba[4], bb[4], sa[4], sb[4], wa[4], wb[4], uu[4];
        ld_bf16x4(q_a + kc, qa);
        ld_bf16x4(q_b + kc, qb);
        ld_bf16x4(k_top - ldq + kc, k0a);
        ld_bf16x4(k_top + kc, k1a);
        ld_bf16x4(k_bot - ldq + kc, k0b);
        ld_bf16x4(k_bot + kc, k1b);
        ld_f32x4(beta_a + kc, ba);
        ld_f32x4(beta_b + kc, bb);
        ld_f32x4(b_top + kc, sa);
        ld_f32x4(b_bot + kc, sb);
        ld_f32x4(e_top + kc, wa);
        ld_f32x4(e_bot + kc, wb);
        ld_f32x4(us + kc, uu);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xa = ex2(ba[j] - sa[j]), xb = ex2(bb[j] - sb[j]);
          const float odd_alt = odd_u ? uu[j] : 0.f;
          const float even_alt = even_in ? 1.f : (even_u ? uu[j] : 0.f);
          acc[0] = fmaf(qa[j] * k0a[j], odd_in ? xa * wa[j] : even_alt,
                        acc[0]);
          acc[1] = fmaf(qa[j] * k1a[j], odd_in ? xa : odd_alt, acc[1]);
          acc[2] = fmaf(qb[j] * k0b[j], odd_in ? xb * wb[j] : even_alt,
                        acc[2]);
          acc[3] = fmaf(qb[j] * k1b[j], odd_in ? xb : odd_alt, acc[3]);
        }
      }
      dq[0][0] += acc[0];
      dq[0][1] += acc[1];
      dq[1][2] = acc[2];
      dq[1][3] = acc[3];
    }
    __syncthreads();                       // every sub-chunk's bl and kj

    // The decay table e^{r_a − r_b}: sums of sub-chunk totals, a channel
    // a thread.
    for (int ch = tid; ch < K; ch += kThreads) {
      float tot[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) tot[m] = bl[(kSub * m + kSub - 1) * ldf + ch];
#pragma unroll
      for (int a = 1; a <= 4; ++a) {
        float sum = 0.f;
#pragma unroll
        for (int b_ = a - 1; b_ >= 0; --b_) {
          sum += tot[b_];
          rt[pair(a, b_) * K + ch] = ex2(sum);
        }
      }
    }
    __syncthreads();

    // Per 8 channels: q ⊙ e^{β_t − r_i} (rows ta, tb; channels c0, c1), the
    // off-diagonal tiles A_ij (j < i) and the inter-chunk term into y.
    float sacc[8][4];                      // tile 2j + n: columns of j < i
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    float yacc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      const int c0 = 8 * kk + c, c1 = c0 + 4;
      const float qp[4] = {bf(qs[ta * ldq + c0]) * ex2(beta_a[c0]),
                           bf(qs[tb * ldq + c0]) * ex2(beta_b[c0]),
                           bf(qs[ta * ldq + c1]) * ex2(beta_a[c1]),
                           bf(qs[tb * ldq + c1]) * ex2(beta_b[c1])};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j >= warp) continue;
        float f0 = 1.f, f1 = 1.f;          // e^{r_i − r_{j+1}}
        if (j + 1 < warp) {
          f0 = rt[pair(warp, j + 1) * K + c0];
          f1 = rt[pair(warp, j + 1) * K + c1];
        }
        const uint32_t a[4] = {tf32(qp[0] * f0), tf32(qp[1] * f0),
                               tf32(qp[2] * f1), tf32(qp[3] * f1)};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float2 k_f = *reinterpret_cast<const float2*>(
              kj + (kSub * j + 8 * n + g) * ldj + 8 * kk + 2 * c);
          mma_tf32(sacc[2 * j + n], a, tf32(k_f.x), tf32(k_f.y));
        }
      }
      float f0 = 1.f, f1 = 1.f;            // e^{r_i}
      if (warp) {
        f0 = rt[pair(warp, 0) * K + c0];
        f1 = rt[pair(warp, 0) * K + c1];
      }
      const uint32_t a[4] = {tf32(qp[0] * f0), tf32(qp[1] * f0),
                             tf32(qp[2] * f1), tf32(qp[3] * f1)};
      // h rows c0 and c1 of every column tile, side by side (h_pos).
      const float* h_f = hs + (4 * kk + c) * ld_h<kVS>() + g * (kVS / 4);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        float hf[4];
        ld_f32x4(h_f + 2 * n, hf);
        mma_tf32(yacc[n], a, __float_as_uint(hf[0]), __float_as_uint(hf[1]));
        mma_tf32(yacc[n + 1], a, __float_as_uint(hf[2]),
                 __float_as_uint(hf[3]));
      }
    }

    cp_async_wait_all();                   // v of chunk ci
    __syncthreads();                       // q, k, w and bl are free
    load_qkw(ci + 1);

    // Per 8-step s-tile st, V's B fragments by ldmatrix.trans (a lane's
    // rows 2c and 2c + 1 of column g, the TF32 fragment's k = c and
    // k = c + 4); then y += A · V on the tiles at or left of the diagonal
    // block (A's accumulator columns 2c and 2c + 1 as the same k), and the
    // carry h ← e^{b_C} ⊙ h + (k ⊙ e^{b_C − b})ᵀ · V on this warp's state
    // rows, k ⊙ e^{b_C − b} = (k ⊙ e^{r_{j+1} − b}) ⊙ e^{r_4 − r_{j+1}}.
    // Steps past T have w = 0 and k = 0, so b_C is the last real step's.
    float ec[kRT][2];                      // e^{b_C} on the state rows
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int ka = 16 * (warp + 4 * r) + g;
      if (ka >= K) continue;
      ec[r][0] = rt[pair(4, 0) * K + ka];
      ec[r][1] = rt[pair(4, 0) * K + ka + 8];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        hacc[r][n][0] *= ec[r][0];
        hacc[r][n][1] *= ec[r][0];
        hacc[r][n][2] *= ec[r][1];
        hacc[r][n][3] *= ec[r][1];
      }
    }
#pragma unroll
    for (int st = 0; st < kC / 8; ++st) {
      uint32_t vb[kNT];
      {
        const __nv_bfloat16* v_row = vs + (8 * st + lane % 8) * ldv;
        if constexpr (kNT >= 4) {
#pragma unroll
          for (int n = 0; n < kNT; n += 4) {
            uint32_t r4[4];
            ldsm_x4_t(r4, v_row + 8 * (n + lane / 8));
#pragma unroll
            for (int e = 0; e < 4; ++e) vb[n + e] = r4[e];
          }
        } else {
          uint32_t r2[2];
          ldsm_x2_t(r2, v_row + 8 * (lane / 8 % 2));
          vb[0] = r2[0];
          vb[1] = r2[1];
        }
      }
      const int j = st / 2, n2 = st % 2;   // sub-chunk, tile within it
      if (j <= warp) {
        float t4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          t4[e] = j < warp ? sacc[st][e] : dq[n2][e];
        const uint32_t a[4] = {tf32(t4[0]), tf32(t4[2]), tf32(t4[1]),
                               tf32(t4[3])};
#pragma unroll
        for (int nv = 0; nv < kNT; ++nv)
          mma_tf32(yacc[nv], a, vb[nv] << 16, vb[nv] & 0xffff0000u);
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int ka = 16 * (warp + 4 * r) + g, kb = ka + 8;
        if (ka >= K) continue;
        float fa = 1.f, fb = 1.f;
        if (j < 3) {
          fa = rt[pair(4, j + 1) * K + ka];
          fb = rt[pair(4, j + 1) * K + kb];
        }
        const float* k_a = kj + (8 * st + 2 * c) * ldj;
        const uint32_t a[4] = {tf32(k_a[kj_pos(ka)] * fa),
                               tf32(k_a[kj_pos(kb)] * fb),
                               tf32(k_a[ldj + kj_pos(ka)] * fa),
                               tf32(k_a[ldj + kj_pos(kb)] * fb)};
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mma_tf32(hacc[r][n], a, vb[n] << 16, vb[n] & 0xffff0000u);
      }
    }
    const int64_t y_row = static_cast<int64_t>(bh) * T + ci * kC;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = v0 + 8 * n + 2 * c;
      if (ci * kC + ta < T)
        *reinterpret_cast<__nv_bfloat162*>(y + (y_row + ta) * V + col) =
            __floats2bfloat162_rn(yacc[n][0], yacc[n][1]);
      if (ci * kC + tb < T)
        *reinterpret_cast<__nv_bfloat162*>(y + (y_row + tb) * V + col) =
            __floats2bfloat162_rn(yacc[n][2], yacc[n][3]);
    }
    // Every read of h this chunk came before the last barrier.
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int ka = 16 * (warp + 4 * r) + g;
      if (ka >= K) continue;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int col = 8 * n + 2 * c;
        hs[h_pos<kVS>(ka, col)] = __uint_as_float(tf32(hacc[r][n][0]));
        hs[h_pos<kVS>(ka, col + 1)] = __uint_as_float(tf32(hacc[r][n][1]));
        hs[h_pos<kVS>(ka + 8, col)] = __uint_as_float(tf32(hacc[r][n][2]));
        hs[h_pos<kVS>(ka + 8, col + 1)] =
            __uint_as_float(tf32(hacc[r][n][3]));
      }
    }
    __syncthreads();                       // every read of v, kj, rt done
    load_v(ci + 1);
  }
  cp_async_wait_all();
}

template <int kKT, int kVS>
int launch(const void* q, const void* k, const void* v, const void* w,
           int w_code, const void* u, void* y, int batch, int heads, int T,
           int V, int bonus, const int64_t* st, cudaStream_t stream) {
  constexpr int smem = smem_bytes<kKT, kVS>();
  // Raise the kernel's dynamic shared memory cap once, outside any capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_channel_decay_kernel<kKT, kVS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  scan_channel_decay_kernel<kKT, kVS>
      <<<batch * heads * (V / kVS), kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), w, w_code,
          static_cast<const float*>(u), static_cast<__nv_bfloat16*>(y),
          heads, T, V, bonus, Strides{st[0], st[1], st[2], st[3]},
          Strides{st[4], st[5], st[6], st[7]},
          Strides{st[8], st[9], st[10], st[11]},
          Strides{st[12], st[13], st[14], st[15]});
  return static_cast<int>(cudaGetLastError());
}

template <int kKT, int kVS>
int occupancy(int* smem) {
  *smem = smem_bytes<kKT, kVS>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_channel_decay_kernel<kKT, kVS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (attr != cudaSuccess) return -static_cast<int>(attr);
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, scan_channel_decay_kernel<kKT, kVS>, kThreads, *smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The value slice a block takes: 64 columns where they divide V (the
// fastest at rwkv6-7b's shape, PERF.md), else 16.
inline int pick_slice(int V) { return V % 64 == 0 ? 64 : 16; }

// Calls f.run<kKT, kVS>() for K = 16·kKT and the slice vs.
template <int kVS, class F>
int by_k(int K, const F& f) {
  switch (K / 16) {
    case 1: return f.template run<1, kVS>();
    case 2: return f.template run<2, kVS>();
    case 3: return f.template run<3, kVS>();
    case 4: return f.template run<4, kVS>();
    case 5: return f.template run<5, kVS>();
    case 6: return f.template run<6, kVS>();
    case 7: return f.template run<7, kVS>();
    case 8: return f.template run<8, kVS>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
template <class F>
int by_shape(int K, int vs, const F& f) {
  if (K % 16 || K < 16 || K > 128) return static_cast<int>(cudaErrorInvalidValue);
  switch (vs) {
    case 16: return by_k<16>(K, f);
    case 64: return by_k<64>(K, f);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  const void *q, *k, *v, *w, *u;
  void* y;
  int w_code, batch, heads, T, V, bonus;
  const int64_t* strides;
  cudaStream_t stream;
  template <int kKT, int kVS>
  int run() const {
    return launch<kKT, kVS>(q, k, v, w, w_code, u, y, batch, heads, T, V,
                            bonus, strides, stream);
  }
};

struct Occupancy {
  int* smem;
  template <int kKT, int kVS>
  int run() const { return occupancy<kKT, kVS>(smem); }
};

}  // namespace scan_cd

// The channel-decay body.  q, k: [batch, heads, T, K] and v: [batch,
// heads, T, V], bf16; w: [batch, heads, T, K] of type w_code (0 f32, 1
// bf16); each with the last dim contiguous, every other stride (in
// elements: q's four, then k's, v's and w's) spanning a multiple of 16
// bytes (0 included) and 16-byte aligned bases.  u: contiguous f32 [heads,
// K], read in bonus mode only.  K a multiple of 16 up to 128, V a multiple
// of 16.  y: contiguous bf16 [batch, heads, T, V].  Returns the launch's
// cudaGetLastError().
extern "C" int linear_scan_channel_decay_launch(
    const void* q, const void* k, const void* v, const void* w,
    const void* u, void* y, int w_code, int batch, int heads, int T, int K,
    int V, int bonus, const int64_t* strides, void* stream) {
  const scan_cd::Launch f{q, k, v, w, u, y, w_code, batch, heads, T, V,
                          bonus, strides, static_cast<cudaStream_t>(stream)};
  return scan_cd::by_shape(K, scan_cd::pick_slice(V), f);
}

// Blocks of the channel-decay body that fit on one SM at K and V (the
// instance a launch at that shape takes), and its dynamic shared memory in
// bytes through smem; a negative CUDA error on failure.
extern "C" int linear_scan_channel_decay_occupancy(int K, int V, int* smem) {
  return scan_cd::by_shape(K, scan_cd::pick_slice(V),
                           scan_cd::Occupancy{smem});
}
