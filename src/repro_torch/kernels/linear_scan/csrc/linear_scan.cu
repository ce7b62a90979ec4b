// linear_scan: chunked diagonal-decay linear recurrence (the Mamba2 and
// RWKV6 engine), in `inclusive` and `bonus` modes.
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
// Design: one block of 256 threads per (batch, head) walks the chunks in
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
