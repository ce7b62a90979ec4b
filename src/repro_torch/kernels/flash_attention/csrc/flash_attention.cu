// flash_attention: tiled online-softmax attention, causal and KV-length
// masks, grouped-query heads by index.
//
// Replaces the TPU kernel flash_attention_fwd (_attn_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py.  Per query row it
// computes, in float32, the scores q·k times sm_scale, masks keys at or past
// seq_kv and, if causal, keys after the query (a masked score is -1e30, the
// TPU kernel's NEG_INF, not -inf), and keeps the running max m, the
// normalizer l and the accumulator with the TPU kernel's guards for rows
// that are still fully masked.  The output is acc / (l == 0 ? 1 : l) in the
// output's type.
//
// What bounds it on an H100: operations.  At the main path's shape (zamba2-7b
// prefill: batch 4, 32 heads, 2048 positions, head dim 112, bf16, causal)
// it does 2·B·H·S²·d ≈ 1.2e11 flops (the causal half of the two products),
// 0.12 ms at the 989 TFLOP/s bf16 tensor-core peak, and moves about 235 MB,
// 70 µs at 3.35 TB/s.
//
// Design (a simple kernel first; wgmma and TMA are later work): one block of
// 256 threads owns one (batch, q-head, 64-row q tile) cell and loops over
// the 64-row KV tiles itself, in place of the TPU's sequential KV grid axis
// and its VMEM carry.  Q, K and V tiles are staged in dynamic shared memory
// as float32 with rows padded by one word (bank-conflict free), so any
// head dim up to 256 that is a multiple of 8 fits (214 KB at d = 256).
// Four threads share a query row: each holds 16 of the tile's 64 scores and
// d/4 accumulator columns in registers, and the row's max and sum go
// through two shuffles.  The products run on the CUDA cores in float32.
// A causal block stops at its last row's diagonal tile, and the heaviest
// causal tiles are scheduled first.  The KV head of q-head h is h / group:
// K and V are never repeated.  Ragged Q and KV edges are masked in the
// kernel; inputs are read through their strides, in f32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 256;   // 4 threads per query row
constexpr int kScores = kBlockKV / 4;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;

struct Strides {
  int64_t b, h, s, d;
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

// Stage rows [row0, row0 + kRows) of one (batch, head) slice as float32,
// zero past `seq`.
template <int kRows>
__device__ __forceinline__ void stage(float* dst, int ld, const void* src,
                                      int code, int64_t base,
                                      const Strides& st, int row0, int seq,
                                      int d) {
  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int pos = row0 + r;
    dst[r * ld + c] =
        pos < seq ? load(src, code, base + pos * st.s + c * st.d) : 0.f;
  }
}

template <int kDMax>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const void* __restrict__ q, const void* __restrict__ k,
            const void* __restrict__ v, void* __restrict__ out, int q_code,
            int k_code, int v_code, int o_code, int q_heads, int group,
            int seq_q, int seq_kv, int d, Strides sq, Strides sk, Strides sv,
            float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int kCols = kDMax / 4;
  const int ld = d + 1;
  const int lp = kBlockKV + 1;
  float* qs = smem;                  // [kBlockQ][ld]
  float* ks = qs + kBlockQ * ld;     // [kBlockKV][ld]
  float* vs = ks + kBlockKV * ld;    // [kBlockKV][ld]
  float* ps = vs + kBlockKV * ld;    // [kBlockQ][lp]

  const int q_tile = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = q_tile * kBlockQ;
  const int row = threadIdx.x >> 2;
  const int quad = threadIdx.x & 3;
  const int q_pos = q0 + row;

  stage<kBlockQ>(qs, ld, q, q_code, b * sq.b + h * sq.h, sq, q0, seq_q, d);

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  // Keys past the tile's last query row are masked for every row of it.
  const int kv_end = causal ? min(seq_kv, q0 + kBlockQ) : seq_kv;
  const int64_t k_base = b * sk.b + hk * sk.h;
  const int64_t v_base = b * sv.b + hk * sv.h;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();   // the previous tile's K, V and P reads are done
    stage<kBlockKV>(ks, ld, k, k_code, k_base, sk, kv0, seq_kv, d);
    stage<kBlockKV>(vs, ld, v, v_code, v_base, sv, kv0, seq_kv, d);
    __syncthreads();

    // This thread's scores: row `row`, key columns quad + 4j.
    float s[kScores];
#pragma unroll
    for (int j = 0; j < kScores; ++j) s[j] = 0.f;
    const float* q_row = qs + row * ld;
    for (int c = 0; c < d; ++c) {
      const float qv = q_row[c];
#pragma unroll
      for (int j = 0; j < kScores; ++j)
        s[j] = fmaf(qv, ks[(quad + 4 * j) * ld + c], s[j]);
    }
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const int kv_pos = kv0 + quad + 4 * j;
      const bool ok = kv_pos < seq_kv && (!causal || kv_pos <= q_pos);
      s[j] = ok ? s[j] * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);
    // Guard fully-masked rows so that exp() stays finite.
    const float m_sub = m_new <= kNegInf / 2 ? 0.f : m_new;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kScores; ++j) {
      const int kv_pos = kv0 + quad + 4 * j;
      const bool ok = kv_pos < seq_kv && (!causal || kv_pos <= q_pos);
      const float p = ok ? expf(s[j] - m_sub) : 0.f;
      ps[row * lp + quad + 4 * j] = p;
      p_sum += p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    const float alpha = m <= kNegInf / 2 ? 0.f : expf(m - m_new);
    l = alpha * l + p_sum;
    m = m_new;
    __syncwarp();      // the row's four threads (one warp) wrote its P row

#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= alpha;
    const float* p_row = ps + row * lp;
    for (int t = 0; t < kBlockKV; ++t) {
      const float p = p_row[t];
      const float* v_row = vs + t * ld;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = quad + 4 * j;
        if (c < d) acc[j] = fmaf(p, v_row[c], acc[j]);
      }
    }
  }

  if (q_pos < seq_q) {
    const float l_safe = l == 0.f ? 1.f : l;
    const int64_t o = ((static_cast<int64_t>(b) * q_heads + h) * seq_q +
                       q_pos) * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = quad + 4 * j;
      if (c < d) store(out, o_code, o + c, acc[j] / l_safe);
    }
  }
}

template <int kDMax>
int launch(const void* q, const void* k, const void* v, void* out,
           const int* codes, int batch, int q_heads, int kv_heads, int seq_q,
           int seq_kv, int d, const int64_t* st, float scale, int causal,
           cudaStream_t stream) {
  // Raise the kernel's dynamic shared memory cap once, outside any capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_kernel<kDMax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem =
      4 * (3 * kBlockQ * (d + 1) + kBlockQ * (kBlockKV + 1));
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, q_heads, batch);
  attn_kernel<kDMax><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, codes[0], codes[1], codes[2], codes[3], q_heads,
      q_heads / kv_heads, seq_q, seq_kv, d,
      Strides{st[0], st[1], st[2], st[3]}, Strides{st[4], st[5], st[6], st[7]},
      Strides{st[8], st[9], st[10], st[11]}, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

// q: [batch, q_heads, seq_q, d], k and v: [batch, kv_heads, seq_kv, d], each
// of element type code 0 (f32) or 1 (bf16) and read through its
// strides (in elements: q's four, then k's, then v's); out: contiguous
// [batch, q_heads, seq_q, d] of type o_code.  d is a multiple of 8 up to
// 256.  Returns the launch's cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int q_code,
                                      int k_code, int v_code, int o_code,
                                      int batch, int q_heads, int kv_heads,
                                      int seq_q, int seq_kv, int d,
                                      const int64_t* strides, float scale,
                                      int causal, void* stream) {
  const int codes[4] = {q_code, k_code, v_code, o_code};
  const auto s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return flash::launch<64>(q, k, v, out, codes, batch, q_heads, kv_heads,
                             seq_q, seq_kv, d, strides, scale, causal, s);
  if (d <= 128)
    return flash::launch<128>(q, k, v, out, codes, batch, q_heads, kv_heads,
                              seq_q, seq_kv, d, strides, scale, causal, s);
  return flash::launch<256>(q, k, v, out, codes, batch, q_heads, kv_heads,
                            seq_q, seq_kv, d, strides, scale, causal, s);
}
