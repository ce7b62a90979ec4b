// linear_scan: chunked diagonal-decay linear recurrence (the Mamba2 and
// RWKV6 engine), in `inclusive` and `bonus` modes.  Three bodies, picked
// by the wrapper (ops.py): the scalar-decay body (scan_scalar_decay_kernel,
// below) for Mamba2's decay shared by all K channels, the channel-decay
// body (channel_decay.cu) for other bf16 calls, and the per-channel body
// (scan_kernel) for every other call.
//
// Replaces the TPU kernel linear_scan_fwd (_scan_kernel) of
// src/repro/kernels/linear_scan/linear_scan.py.  Per (batch, head), with
// state h in R^{K x V}:
//
//     h_t = exp(w_t) ⊙_K h_{t-1} + k_t ⊗ v_t            (w_t ≤ 0)
//     inclusive:  y_t = q_t · h_t
//     bonus:      y_t = q_t · (h_{t-1} + diag(u) k_t ⊗ v_t)
//
// evaluated chunk by chunk as the TPU kernel does: within a chunk of C steps
// b is the inclusive cumsum of w, β = b (inclusive) or b − w (bonus),
//     y = (q ⊙ e^β) @ h  +  A @ V  (+ diag(q·u·k) v),
//     A[t,s] = Σ_k q[t,k] k[s,k] e^{β_t[k] − b_s[k]}  for s ≤ t (s < t),
//     h ← e^{b_C} ⊙ h + (k ⊙ e^{b_C − b})ᵀ V.
// Every exponent is ≤ 0 (s ≤ t ⇒ β_t ≤ b_s since w ≤ 0), so no decay
// strength overflows; there is no q·e^{b} / k·e^{−b} factorisation.
//
// What bounds it on an H100: bytes.  At the main path's shape (zamba2-7b
// prefill: batch 4, 112 heads, T 2048, K = V = 64; q, k, v, y in bf16 and
// w in f32) the function reads k and v and writes y, 117 MB each, while q
// and w are broadcast views (q shared by the heads, w by the K channels)
// worth 1 MB and 4 MB: about 360 MB, 0.11 ms at 3.35 TB/s (about 700 MB,
// 0.21 ms, if the views were dense).  The stable design spends C·(C+1)/2·K
// exponentials per chunk on the masked-in half of A, about 1.9e9 in all
// (3.8e9 with the masked half), on the special-function units (__expf).
//
// Per-channel body: one block of 256 threads per (batch, head) walks the chunks in
// order, in place of the TPU's sequential chunk grid axis, with the float32
// state h [K, V] resident in shared memory instead of VMEM scratch.  The
// [C, C, K] broadcast the TPU kernel builds in VMEM is never materialised:
// each A[t, s] is a sum over k, from q, β, k and b tiles in shared memory
// (k and b rows padded by one word, so the 32 lanes of a warp, which share
// t and take consecutive s, hit 32 banks).  Steps past T are read as zeros
// (w = 0, k = 0 leave the carry untouched), so nothing is padded in device
// memory.  Inputs are read through their strides in f32 or bf16: the
// broadcast views Mamba2 builds (q shared by all heads, w by all K
// channels) are stride-0 and never copied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "scan_mma.cuh"

namespace linear_scan {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

struct Strides {
  int64_t b, h, t, k;
};

// Element type code 0 is float32, 1 is bfloat16.
__device__ __forceinline__ float load(const void* p, int code, int64_t i) {
  return code ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, int code, int64_t i, float x) {
  if (code)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p)[i] = x;
}

// Stage steps [t0, t0 + C) of one (batch, head) slice, `dim` wide, as
// float32 rows of `ld` words; zero past T.
__device__ __forceinline__ void stage(float* dst, int ld, const void* src,
                                      int code, const Strides& st, int b,
                                      int h, int t0, int C, int T, int dim) {
  const int64_t base = b * st.b + h * st.h;
  for (int i = threadIdx.x; i < C * dim; i += kThreads) {
    const int t = i / dim, c = i - t * dim;
    const int pos = t0 + t;
    dst[t * ld + c] =
        pos < T ? load(src, code, base + pos * st.t + c * st.k) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const void* __restrict__ q, const void* __restrict__ k,
            const void* __restrict__ v, const void* __restrict__ w,
            const float* __restrict__ u, void* __restrict__ y, int q_code,
            int k_code, int v_code, int w_code, int y_code, int heads, int T,
            int K, int V, int C, int bonus, Strides sq, Strides sk,
            Strides sv, Strides sw) {
  extern __shared__ float smem[];
  const int lk = K + 1;
  float* qs = smem;             // [C][K]   q, then q ⊙ e^β
  float* es = qs + C * K;       // [C][K]   w, then β
  float* ks = es + C * K;       // [C][lk]  k, then k ⊙ e^{b_C − b}
  float* bs = ks + C * lk;      // [C][lk]  b, the inclusive cumsum of w
  float* vs = bs + C * lk;      // [C][V]
  float* as = vs + C * V;       // [C][C]   the intra-chunk matrix A
  float* hs = as + C * C;       // [K][V]   the state
  float* ds = hs + K * V;       // [C]      the bonus diagonal q·u·k

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int tid = threadIdx.x;
  const int64_t y_base = (static_cast<int64_t>(b) * heads + h) * T * V;
  for (int i = tid; i < K * V; i += kThreads) hs[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += C) {
    __syncthreads();   // the previous chunk is done with every tile
    stage(qs, K, q, q_code, sq, b, h, t0, C, T, K);
    stage(ks, lk, k, k_code, sk, b, h, t0, C, T, K);
    stage(es, K, w, w_code, sw, b, h, t0, C, T, K);
    stage(vs, V, v, v_code, sv, b, h, t0, C, T, V);
    __syncthreads();

    // b = cumsum(w) down each channel; β = b or b − w.
    for (int c = tid; c < K; c += kThreads) {
      float run = 0.f;
      for (int t = 0; t < C; ++t) {
        const float wt = es[t * K + c];
        run += wt;
        bs[t * lk + c] = run;
        es[t * K + c] = bonus ? run - wt : run;
      }
    }
    __syncthreads();

    // A[t, s] = Σ_k q[t,k] k[s,k] e^{β_t[k] − b_s[k]}, masked to s ≤ t
    // (inclusive) or s < t (bonus); every exponent taken is ≤ 0.
    for (int p = tid; p < C * C; p += kThreads) {
      const int t = p / C, s = p - t * C;
      float a = 0.f;
      if (bonus ? s < t : s <= t) {
        const float* q_t = qs + t * K;
        const float* e_t = es + t * K;
        const float* k_s = ks + s * lk;
        const float* b_s = bs + s * lk;
        for (int c = 0; c < K; ++c)
          a = fmaf(q_t[c] * k_s[c], __expf(e_t[c] - b_s[c]), a);
      }
      as[p] = a;
    }
    if (bonus) {
      for (int t = tid; t < C; t += kThreads) {
        float dsum = 0.f;
        for (int c = 0; c < K; ++c)
          dsum = fmaf(qs[t * K + c] * u[h * K + c], ks[t * lk + c], dsum);
        ds[t] = dsum;
      }
    }
    __syncthreads();

    for (int i = tid; i < C * K; i += kThreads) qs[i] *= __expf(es[i]);
    __syncthreads();

    // y[t, :] = (q ⊙ e^β)[t] @ h + A[t] @ V (+ diag[t] v[t]).
    for (int p = tid; p < C * V; p += kThreads) {
      const int t = p / V, c = p - t * V;
      float inter = 0.f;
      for (int j = 0; j < K; ++j)
        inter = fmaf(qs[t * K + j], hs[j * V + c], inter);
      float intra = 0.f;
      for (int s = 0; s <= t; ++s)
        intra = fmaf(as[t * C + s], vs[s * V + c], intra);
      float out = inter + intra;
      if (bonus) out = fmaf(ds[t], vs[t * V + c], out);
      if (t0 + t < T) store(y, y_code, y_base + (t0 + t) * V + c, out);
    }
    __syncthreads();

    // Carry: h ← e^{b_C} ⊙ h + (k ⊙ e^{b_C − b})ᵀ V.  Steps past T have
    // w = 0 and k = 0, so the chunk's last row of b is exact.
    const float* b_last = bs + (C - 1) * lk;
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, c = i - t * K;
      ks[t * lk + c] *= __expf(b_last[c] - bs[t * lk + c]);
    }
    __syncthreads();
    for (int i = tid; i < K * V; i += kThreads) {
      const int j = i / V, c = i - j * V;
      float add = 0.f;
      for (int s = 0; s < C; ++s)
        add = fmaf(ks[s * lk + j], vs[s * V + c], add);
      hs[i] = fmaf(__expf(b_last[j]), hs[i], add);
    }
  }
}

}  // namespace linear_scan

// q, k, w: [batch, heads, T, K]; v: [batch, heads, T, V]; each of element
// type code 0 (f32), 1 (bf16) or 2 (f16), read through its strides (in
// elements: q's four, then k's, v's and w's).  u: contiguous f32
// [heads, K], read in bonus mode only.  y: contiguous [batch, heads, T, V]
// of type y_code.  Returns the launch's cudaGetLastError().
extern "C" int linear_scan_launch(const void* q, const void* k,
                                  const void* v, const void* w,
                                  const void* u, void* y, int q_code,
                                  int k_code, int v_code, int w_code,
                                  int y_code, int batch, int heads, int T,
                                  int K, int V, int chunk, int bonus,
                                  const int64_t* st, void* stream) {
  using namespace linear_scan;
  // Raise the kernel's dynamic shared memory cap once, outside any capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int C = chunk;
  const size_t smem = 4 * (2 * C * K + 2 * C * (K + 1) + C * V + C * C +
                           K * V + C);
  scan_kernel<<<batch * heads, kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      q, k, v, w, static_cast<const float*>(u), y, q_code, k_code, v_code,
      w_code, y_code, heads, T, K, V, C, bonus,
      Strides{st[0], st[1], st[2], st[3]}, Strides{st[4], st[5], st[6], st[7]},
      Strides{st[8], st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14], st[15]});
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The scalar-decay body
// ---------------------------------------------------------------------------
//
// When w is one value per step shared by all K channels (Mamba2's decay, a
// stride-0 view over K), e^{β_t[k] − b_s[k]} is the same float for every k
// and the chunk form collapses, exactly, to
//
//     L[t, s] = e^{b_t − b_s} (s ≤ t, else 0),   b = cumsum(w) in the chunk
//     y = e^{b_t}·(Q·h) + ((Q·Kᵀ) ⊙ L)·V
//     h ← e^{b_C}·h + (K ⊙ e^{b_C − b_s})ᵀ·V
//
// with C² exponentials per chunk instead of C²·K, every exponent ≤ 0 (no
// e^{b} / e^{−b} factorisation).  Only `inclusive` mode.
//
// Design: one block of four warps per (batch, head, V slice of 64 columns,
// or 32 or 16 where 64 does not divide V), so B·H·V/64 blocks (448 at
// zamba2's prefill) walk their chunks of C = 64 steps in order, each
// recomputing S and L for its slice.  Warp w owns rows
// t ∈ [16w, 16w + 16) of the chunk:
//   * S = Q·Kᵀ with mma.sync m16n8k16 bf16 (ldmatrix from shared memory,
//     f32 accumulators: the products are exact), only the s-tiles at or
//     below the diagonal;
//   * A = S ⊙ L in the accumulators, then y = e^{b_t}·(Q·h) + A·V with
//     mma.sync m16n8k8 TF32 (A and h rounded to TF32; bf16 q and v are
//     exact in TF32);
//   * the carry (K ⊙ e^{b_C − b})ᵀ·V in TF32 into the f32 state h [K, 16],
//     kept in the registers of the warps that own its rows and mirrored in
//     shared memory for the next chunk's Q·h.
// The next chunk's q, k and v land by cp.async (16-byte pieces, zero-filled
// past T) in a second buffer while this chunk computes; q is read through
// its strides, so Mamba2's q shared by all heads (stride 0) is never copied.
// What bounds it: bytes (k, v and y; q and w are small), about 0.11 ms at
// zamba2's prefill shape.

namespace scan_tc {

using linear_scan::Strides;
using linear_scan::load;

constexpr int kC = 64;              // steps per chunk
constexpr int kThreads = 128;       // four warps of 16 rows

// Rows of the q, k (halves), v (halves) and h (floats) tiles, padded so
// that ldmatrix and the fragment loads hit distinct banks.
template <int kKT>
__host__ __device__ constexpr int ld_k() { return 16 * kKT + 8; }
template <int kVS>
__host__ __device__ constexpr int ld_v() { return kVS + 8; }
template <int kVS>
__host__ __device__ constexpr int ld_h() { return kVS + 8; }

template <int kKT, int kVS>
constexpr int smem_bytes() {
  return 2 * (2 * kC * ld_k<kKT>() * 2 + kC * ld_v<kVS>() * 2 + kC * 4)
       + 16 * kKT * ld_h<kVS>() * 4 + 4 * kC * 4;   // two buffers; h, b
}

// kKT: K / 16 (K ≤ 128); kVS: the block's value columns (16, 32 or 64).
template <int kKT, int kVS>
__global__ void __launch_bounds__(kThreads)
scan_scalar_decay_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const void* __restrict__ w, int w_code,
                         __nv_bfloat16* __restrict__ y, int heads, int T,
                         int V, Strides sq, Strides sk, Strides sv,
                         Strides sw) {
  constexpr int K = 16 * kKT;
  constexpr int ldk = ld_k<kKT>();
  constexpr int kLdv = ld_v<kVS>();
  constexpr int kLdh = ld_h<kVS>();
  constexpr int kNT = kVS / 8;             // 8-column tiles of the slice
  constexpr int kRT = (kKT + 3) / 4;       // 16-row state tiles per warp
  constexpr int kPieces = K / 8;           // 16-byte pieces of a q/k row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [2][C][ldk]
  __nv_bfloat16* ks = qs + 2 * kC * ldk;                            // [2][C][ldk]
  __nv_bfloat16* vs = ks + 2 * kC * ldk;                            // [2][C][kLdv]
  float* ws = reinterpret_cast<float*>(vs + 2 * kC * kLdv);         // [2][C]
  float* hs = ws + 2 * kC;                                          // [K][kLdh]
  float* bw = hs + K * kLdh;                                        // [4][C]

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

  // Start the copies of chunk `ci` into buffer `buf`; returns this thread's
  // w value of it (threads < C), stored to shared memory by the caller.
  auto load_chunk = [&](int ci, int buf) -> float {
    const int t0 = ci * kC;
    for (int i = tid; i < kC * kPieces; i += kThreads) {
      const int r = i / kPieces, p = i - r * kPieces;
      const int pos = t0 + r;
      const bool ok = pos < T;
      const int64_t t = ok ? pos : 0;
      cp_async16(qs + (buf * kC + r) * ldk + 8 * p,
                 q + q_base + t * sq.t + 8 * p, ok);
      cp_async16(ks + (buf * kC + r) * ldk + 8 * p,
                 k + k_base + t * sk.t + 8 * p, ok);
    }
    for (int i = tid; i < kC * (kVS / 8); i += kThreads) {
      const int r = i / (kVS / 8), p = i - r * (kVS / 8);
      const int pos = t0 + r;
      const bool ok = pos < T;
      cp_async16(vs + (buf * kC + r) * kLdv + 8 * p,
                 v + v_base + (ok ? pos : 0) * sv.t + 8 * p, ok);
    }
    cp_async_commit();
    const int pos = t0 + tid;
    return tid < kC && pos < T ? load(w, w_code, w_base + pos * sw.t) : 0.f;
  };

  for (int i = tid; i < K * kLdh; i += kThreads) hs[i] = 0.f;
  float hacc[kRT][kNT][4];        // state rows 16·(warp + 4r) + {g, g + 8}
#pragma unroll
  for (int r = 0; r < kRT; ++r)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[r][n][e] = 0.f;
  float w_next = load_chunk(0, 0);
  if (tid < kC) ws[tid] = w_next;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    w_next = 0.f;
    if (ci + 1 < n_chunks)
      w_next = load_chunk(ci + 1, buf ^ 1);
    else
      cp_async_commit();                   // keep the group count even
    cp_async_wait_one();
    __syncthreads();                       // chunk ci and h are in place

    const __nv_bfloat16* qc = qs + buf * kC * ldk;
    const __nv_bfloat16* kc = ks + buf * kC * ldk;
    const __nv_bfloat16* vc = vs + buf * kC * kLdv;
    float* bs = bw + warp * kC;

    // b = inclusive cumsum of w over the chunk (each warp its own copy).
    {
      const float w0 = ws[buf * kC + 2 * lane];
      const float w1 = ws[buf * kC + 2 * lane + 1];
      float run = w0 + w1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, run, 1);
      if (lane == 0) excl = 0.f;
      bs[2 * lane] = excl + w0;
      bs[2 * lane + 1] = excl + w0 + w1;
      __syncwarp();
    }
    const int t_a = 16 * warp + g, t_b = t_a + 8;   // this thread's rows
    const float bt_a = bs[t_a], bt_b = bs[t_b];
    const float b_last = bs[kC - 1];

    // S = Q·Kᵀ on the s-tiles at or below the diagonal: tiles j ≤ 2w + 1.
    float sacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    uint32_t qa[kKT][4];
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt)
      ldsm_x4(qa[kt], qc + (16 * warp + lane % 8 + 8 * ((lane / 8) % 2)) * ldk
                          + 16 * kt + 8 * (lane / 16));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp > warp) continue;
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        uint32_t kb[4];
        ldsm_x4(kb, kc + (16 * jp + lane % 8 + 8 * (lane / 16)) * ldk
                        + 16 * kt + 8 * ((lane / 8) % 2));
        mma_bf16(sacc[2 * jp], qa[kt], kb[0], kb[1]);
        mma_bf16(sacc[2 * jp + 1], qa[kt], kb[2], kb[3]);
      }
    }

    // A = S ⊙ L, L[t, s] = e^{b_t − b_s} for s ≤ t (every exponent ≤ 0).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j > 2 * warp + 1) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s_ = 8 * j + 2 * c + e;
        const float b_s = bs[s_];
        sacc[j][e] = s_ <= t_a ? sacc[j][e] * __expf(fminf(bt_a - b_s, 0.f))
                               : 0.f;
        sacc[j][2 + e] =
            s_ <= t_b ? sacc[j][2 + e] * __expf(fminf(bt_b - b_s, 0.f)) : 0.f;
      }
    }

    // y = e^{b_t}·(Q·h) + A·V, in TF32 (h is stored TF32-rounded).
    float yacc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      const uint32_t a[4] = {bf16_bits(qc[t_a * ldk + 8 * kk + c]),
                             bf16_bits(qc[t_b * ldk + 8 * kk + c]),
                             bf16_bits(qc[t_a * ldk + 8 * kk + c + 4]),
                             bf16_bits(qc[t_b * ldk + 8 * kk + c + 4])};
      const uint32_t* h_a =
          reinterpret_cast<const uint32_t*>(hs) + (8 * kk + c) * kLdh + g;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mma_tf32(yacc[n], a, h_a[8 * n], h_a[4 * kLdh + 8 * n]);
    }
    const float eb_a = __expf(bt_a), eb_b = __expf(bt_b);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      yacc[n][0] *= eb_a;
      yacc[n][1] *= eb_a;
      yacc[n][2] *= eb_b;
      yacc[n][3] *= eb_b;
    }
    // A's accumulator columns 8j + 2c and 8j + 2c + 1 serve as the TF32
    // fragment's k = c and k = c + 4; V's rows are read in the same order.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j > 2 * warp + 1) continue;
      const uint32_t a[4] = {tf32(sacc[j][0]), tf32(sacc[j][2]),
                             tf32(sacc[j][1]), tf32(sacc[j][3])};
      const __nv_bfloat16* v_a = vc + (8 * j + 2 * c) * kLdv;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mma_tf32(yacc[n], a, bf16_bits(v_a[8 * n + g]),
                 bf16_bits(v_a[kLdv + 8 * n + g]));
    }
    const int64_t y_row = static_cast<int64_t>(bh) * T + ci * kC;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = v0 + 8 * n + 2 * c;
      if (ci * kC + t_a < T)
        *reinterpret_cast<__nv_bfloat162*>(y + (y_row + t_a) * V + col) =
            __floats2bfloat162_rn(yacc[n][0], yacc[n][1]);
      if (ci * kC + t_b < T)
        *reinterpret_cast<__nv_bfloat162*>(y + (y_row + t_b) * V + col) =
            __floats2bfloat162_rn(yacc[n][2], yacc[n][3]);
    }

    // Carry: h ← e^{b_C}·h + (K ⊙ e^{b_C − b})ᵀ·V on this warp's state rows.
    // Steps past T have w = 0 and k = 0, so b_C is the last real step's.
    const float eb_last = __expf(b_last);
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int rt = warp + 4 * r;
      if (rt >= kKT) continue;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[r][n][e] *= eb_last;
#pragma unroll
      for (int kk = 0; kk < kC / 8; ++kk) {
        const int s_a = 8 * kk + c, s_b = s_a + 4;
        const float f_a = __expf(b_last - bs[s_a]);
        const float f_b = __expf(b_last - bs[s_b]);
        const __nv_bfloat16* k_a = kc + s_a * ldk + 16 * rt + g;
        const __nv_bfloat16* k_b = kc + s_b * ldk + 16 * rt + g;
        const uint32_t a[4] = {tf32(__bfloat162float(k_a[0]) * f_a),
                               tf32(__bfloat162float(k_a[8]) * f_a),
                               tf32(__bfloat162float(k_b[0]) * f_b),
                               tf32(__bfloat162float(k_b[8]) * f_b)};
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mma_tf32(hacc[r][n], a, bf16_bits(vc[s_a * kLdv + 8 * n + g]),
                   bf16_bits(vc[s_b * kLdv + 8 * n + g]));
      }
    }
    if (tid < kC) ws[(buf ^ 1) * kC + tid] = w_next;
    __syncthreads();                       // every read of h and chunk ci done
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int rt = warp + 4 * r;
      if (rt >= kKT) continue;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t* row_a = reinterpret_cast<uint32_t*>(hs)
                        + (16 * rt + g) * kLdh + 8 * n + 2 * c;
        row_a[0] = tf32(hacc[r][n][0]);
        row_a[1] = tf32(hacc[r][n][1]);
        row_a[8 * kLdh] = tf32(hacc[r][n][2]);
        row_a[8 * kLdh + 1] = tf32(hacc[r][n][3]);
      }
    }
  }
}

template <int kKT, int kVS>
int launch(const void* q, const void* k, const void* v, const void* w,
           int w_code, void* y, int batch, int heads, int T, int V,
           const int64_t* st, cudaStream_t stream) {
  constexpr int smem = smem_bytes<kKT, kVS>();
  // Raise the kernel's dynamic shared memory cap once, outside any capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_scalar_decay_kernel<kKT, kVS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  scan_scalar_decay_kernel<kKT, kVS>
      <<<batch * heads * (V / kVS), kThreads, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), w, w_code,
          static_cast<__nv_bfloat16*>(y), heads, T, V,
          Strides{st[0], st[1], st[2], st[3]},
          Strides{st[4], st[5], st[6], st[7]},
          Strides{st[8], st[9], st[10], st[11]},
          Strides{st[12], st[13], st[14], st[15]});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scan_tc

// The scalar-decay body, `inclusive` mode.  q, k: [batch, heads, T, K] and
// v: [batch, heads, T, V], bf16 with the last dim contiguous, every other
// stride (in elements: q's four, then k's, v's and w's) spanning a multiple
// of 16 bytes (0 included) and 16-byte aligned bases; w: [batch, heads, T,
// K] of type w_code (0 f32, 1 bf16), read at channel 0.  K a multiple of 16
// up to 128, V a multiple of 16.  y: contiguous bf16 [batch, heads, T, V].
// Returns the launch's cudaGetLastError().
template <int kVS>
int launch_vs(const void* q, const void* k, const void* v, const void* w,
              void* y, int w_code, int batch, int heads, int T, int K, int V,
              const int64_t* strides, cudaStream_t s) {
  switch (K / 16) {
#define SCAN_TC(kt)                                                          \
  case kt:                                                                   \
    return scan_tc::launch<kt, kVS>(q, k, v, w, w_code, y, batch, heads, T,  \
                                    V, strides, s)
    SCAN_TC(1); SCAN_TC(2); SCAN_TC(3); SCAN_TC(4);
    SCAN_TC(5); SCAN_TC(6); SCAN_TC(7); SCAN_TC(8);
#undef SCAN_TC
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int linear_scan_scalar_decay_launch(
    const void* q, const void* k, const void* v, const void* w, void* y,
    int w_code, int batch, int heads, int T, int K, int V,
    const int64_t* strides, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  // The widest value slice that divides V: fewer blocks recompute S and L
  // and copy q and k (on an H100, 64 columns ran faster at zamba2's
  // prefill shape than 32 or 16).
  if (V % 64 == 0)
    return launch_vs<64>(q, k, v, w, y, w_code, batch, heads, T, K, V,
                         strides, s);
  if (V % 32 == 0)
    return launch_vs<32>(q, k, v, w, y, w_code, batch, heads, T, K, V,
                         strides, s);
  return launch_vs<16>(q, k, v, w, y, w_code, batch, heads, T, K, V, strides,
                       s);
}
