// flash_attention: tiled online-softmax attention, causal and KV-length
// masks, grouped-query heads by index.  Two bodies, picked by the wrapper
// (ops.py) from the operands' element type.
//
// Replaces the TPU kernel flash_attention_fwd (_attn_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py.  Per query row it
// computes the scores q·k times sm_scale in float32, masks keys at or past
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
// The wgmma body (q, k and v all bf16; attn_wgmma_kernel): one CTA of two
// consumer warpgroups and one producer warp owns 128 query rows of one
// (batch, q-head), 64 rows per warpgroup.  The producer's one lane loads
// the Q tile once and keeps TMA loads of 128-key K and V tiles (the Pallas
// kernel's DEFAULT_BLOCK_KV, so P rounds at the same block boundaries; 64
// keys for d > 128, to fit shared memory) in flight into a two-stage ring,
// signalled by mbarriers.  Tiles sit in shared memory as 64-column,
// 128-byte-swizzled atoms; a head dim that is not a multiple of 64 reads as
// zero columns past d (TMA's out-of-bounds fill), which add nothing to
// Q·Kᵀ.  Each warpgroup computes S = Q·Kᵀ with wgmma (both operands in
// shared memory, f32 accumulators), runs the online softmax in registers
// (masks only on diagonal and ragged tiles), rounds P to bf16 in registers
// as the Pallas body's p.astype(v.dtype)·v does on the TPU's MXU, and
// accumulates P·V with a second wgmma, P the register operand and V
// N-major in shared memory (N = 112 at zamba2's head dim).  Heaviest causal
// tiles are scheduled first; the KV head of q-head h is h / group.  Tensor
// maps are built per call on the host (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so no -lcuda) and passed as
// __grid_constant__ parameters.  TMA needs the head dim contiguous, every
// other stride a multiple of 16 bytes and a 16-byte aligned base: the
// wrapper checks that and raises otherwise.
//
// The f32 body (any other operand types; attn_kernel): one block of 256
// threads owns one (batch, q-head, 64-row q tile) cell and loops over the
// 64-row KV tiles itself.  Q, K and V tiles are staged in dynamic shared
// memory as float32 with rows padded by one word, so any head dim up to 256
// that is a multiple of 8 fits (214 KB at d = 256).  Four threads share a
// query row: each holds 16 of the tile's 64 scores and d/4 accumulator
// columns in registers, and the row's max and sum go through two shuffles.
// The products run on the CUDA cores in float32, P included.  A causal block
// stops at its last row's diagonal tile, and the heaviest causal tiles are
// scheduled first.  Ragged Q and KV edges are masked in the kernel; inputs
// are read through their strides, in f32 or bf16.

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
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

// ---------------------------------------------------------------------------
// The wgmma body
// ---------------------------------------------------------------------------

namespace flash_tc {

constexpr int kBlockQ = 128;             // two consumer warpgroups of 64 rows
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kStages = 2;               // the K/V ring
constexpr int kAtomBytes = 128;          // one swizzled row: 64 bf16 columns
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One box {64 columns, rows, 1, 1} of a [batch, heads, seq, d] tensor.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(row), "r"(head), "r"(batch), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at `p` (1024-byte aligned
// swizzle atoms): 8-row groups 1024 bytes apart (SBO); `lbo` is the stride
// between 64-column atoms, read for N-major operands only.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(lbo >> 4) << 16)
       | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] · B[16 x 64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] · B[16 x 64]: A in registers (bf16 pairs), B
// N-major in shared memory (transposed, imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 48] += A[64 x 16] · B[16 x 48]: A in registers (bf16 pairs), B
// N-major in shared memory (transposed, imm-trans-b = 1).  Only d[0, 24)
// are written: the chunk is an n64 chunk's registers.
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int kAtoms, int kBlockKV>
constexpr int smem_bytes() {
  // 1024 bytes of alignment slack, the Q tile, the K and V rings, barriers.
  return 1024 + kAtoms * kBlockQ * kAtomBytes
       + 2 * kStages * kAtoms * kBlockKV * kAtomBytes + 64;
}

// kAtoms: 64-column atoms of a Q/K/V row (ceil(d / 64)); kDV: the width of
// the P·V product and of the Q·Kᵀ reduction (d rounded up to 16, or to 64).
template <int kAtoms, int kBlockKV, int kDV>
__global__ void __launch_bounds__(kThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  __nv_bfloat16* __restrict__ out, int q_heads, int group,
                  int seq_q, int seq_kv, int d, float scale, int causal) {
  static_assert(kDV % 16 == 0 && kDV <= 64 * kAtoms, "bad head-dim tiling");
  static_assert(kDV % 64 == 0 || kDV % 64 == 48, "P·V chunks are n64, n48");
  constexpr int kQAtom = kBlockQ * kAtomBytes;
  constexpr int kKVAtom = kBlockKV * kAtomBytes;
  constexpr int kChunks = kBlockKV / 64;       // n64 chunks of S
  constexpr int kOChunks = (kDV + 63) / 64;    // n64 (and one n48) of O
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;
  uint8_t* ks = qs + kAtoms * kQAtom;                // [stage][atom]
  uint8_t* vs = ks + kStages * kAtoms * kKVAtom;     // [stage][atom]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * kAtoms * kKVAtom);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / q_heads;
  const int h = bh - b * q_heads;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;   // heaviest first
  const int kv_end = causal ? min(seq_kv, q0 + kBlockQ) : seq_kv;
  const int n_tiles = (kv_end + kBlockKV - 1) / kBlockKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one lane starts every TMA load.
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, kAtoms * kQAtom);
      for (int a = 0; a < kAtoms; ++a)
        tma_load(qs + a * kQAtom, &q_map, q_full, 64 * a, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + s, (i / kStages - 1) & 1);
        mbar_expect_tx(k_full + s, kAtoms * kKVAtom);
        for (int a = 0; a < kAtoms; ++a)
          tma_load(ks + (s * kAtoms + a) * kKVAtom, &k_map, k_full + s,
                   64 * a, i * kBlockKV, hk, b);
        mbar_expect_tx(v_full + s, kAtoms * kKVAtom);
        for (int a = 0; a < kAtoms; ++a)
          tma_load(vs + (s * kAtoms + a) * kKVAtom, &v_map, v_full + s,
                   64 * a, i * kBlockKV, hk, b);
      }
    }
    return;
  }

  // Consumers.  Accumulator fragment of warpgroup `wg`: thread t holds rows
  // r0 = 16·warp + g and r0 + 8 (g = lane / 4) of the warpgroup's 64, at
  // columns 8j + 2c + {0, 1} (c = lane % 4): registers 4j + {0, 1} and
  // 4j + {2, 3}.
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, c = lane % 4;
  const int wg_row = q0 + 64 * wg;
  const int row0 = wg_row + 16 * warp + g;
  const int row1 = row0 + 8;

  float o[kOChunks][32];
#pragma unroll
  for (int n = 0; n < kOChunks; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int kv0 = i * kBlockKV;
    const uint8_t* k_tile = ks + s * kAtoms * kKVAtom;
    const uint8_t* v_tile = vs + s * kAtoms * kKVAtom;

    // S = Q·Kᵀ over the head dim in k-steps of 16 columns (32 bytes of a
    // swizzled row); zero columns past d add nothing.
    float sc[kChunks][32];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[ch][r] = 0.f;
    mbar_wait(k_full + s, parity);
    wgmma_fence();
#pragma unroll
    for (int kstep = 0; kstep < kDV / 16; ++kstep) {
      const int a = kstep / 4, off = 32 * (kstep % 4);
      const uint64_t da =
          sw128_desc(qs + a * kQAtom + 64 * wg * kAtomBytes + off, 16);
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
        wgmma_ss_n64(sc[ch],
                     da, sw128_desc(k_tile + a * kKVAtom
                                    + 64 * ch * kAtomBytes + off, 16),
                     kstep > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) fence_regs(sc[ch]);

    // Online softmax, the TPU kernel's arithmetic and guards.
    const bool masked = kv0 + kBlockKV > seq_kv
                     || (causal && kv0 + kBlockKV - 1 > wg_row);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = sc[ch][4 * j + e] * scale;
          float x1 = sc[ch][4 * j + 2 + e] * scale;
          if (masked) {
            const int key = kv0 + 64 * ch + 8 * j + 2 * c + e;
            if (key >= seq_kv || (causal && key > row0)) x0 = kNegInf;
            if (key >= seq_kv || (causal && key > row1)) x1 = kNegInf;
          }
          sc[ch][4 * j + e] = x0;
          sc[ch][4 * j + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // Guard fully-masked rows so that exp() stays finite; a masked score
    // (-1e30) gives exactly 0.
    const float sub0 = mn0 <= kNegInf / 2 ? 0.f : mn0;
    const float sub1 = mn1 <= kNegInf / 2 ? 0.f : mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = __expf(sc[ch][4 * j + e] - sub0);
          const float p1 = __expf(sc[ch][4 * j + 2 + e] - sub1);
          sc[ch][4 * j + e] = p0;
          sc[ch][4 * j + 2 + e] = p1;
          sum0 += p0;
          sum1 += p1;
        }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float alpha0 = m0 <= kNegInf / 2 ? 0.f : __expf(m0 - mn0);
    const float alpha1 = m1 <= kNegInf / 2 ? 0.f : __expf(m1 - mn1);
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kOChunks; ++n)
#pragma unroll
      for (int r = 0; r < 32; r += 4) {
        o[n][r] *= alpha0;
        o[n][r + 1] *= alpha0;
        o[n][r + 2] *= alpha1;
        o[n][r + 3] *= alpha1;
      }

    // O += bf16(P)·V, in k-steps of 16 keys.  The f32 accumulator layout of
    // two neighbouring 8-column blocks is the bf16 register layout of one
    // 16-column A fragment.
    uint32_t pa[kBlockKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      const float* p = sc[kk / 4] + 8 * (kk % 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(p[2 * r], p[2 * r + 1]);
    }
#pragma unroll
    for (int n = 0; n < kOChunks; ++n) fence_regs(o[n]);
    mbar_wait(v_full + s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      const uint8_t* v_rows = v_tile + 16 * kk * kAtomBytes;
#pragma unroll
      for (int n = 0; n < kOChunks; ++n) {
        const uint64_t db = sw128_desc(v_rows + n * kKVAtom, kKVAtom);
        if (kDV % 64 == 48 && n == kOChunks - 1)
          wgmma_rs_n48(o[n], pa[kk], db);
        else
          wgmma_rs_n64(o[n], pa[kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < kOChunks; ++n) fence_regs(o[n]);
    mbar_arrive(empty + s);
  }

  const float ls0 = l0 == 0.f ? 1.f : l0;
  const float ls1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* o_rows =
      out + (static_cast<int64_t>(b) * q_heads + h) * seq_q * d;
#pragma unroll
  for (int j = 0; j < kDV / 8; ++j) {
    const float* r = o[j / 8] + 4 * (j % 8);
    const int col = 8 * j + 2 * c;
    if (col >= d) continue;
    if (row0 < seq_q)
      *reinterpret_cast<__nv_bfloat162*>(o_rows + static_cast<int64_t>(row0)
                                         * d + col) =
          __floats2bfloat162_rn(r[0] / ls0, r[1] / ls0);
    if (row1 < seq_q)
      *reinterpret_cast<__nv_bfloat162*>(o_rows + static_cast<int64_t>(row1)
                                         * d + col) =
          __floats2bfloat162_rn(r[2] / ls1, r[3] / ls1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Error codes past the CUDA runtime's: no entry point, and a refused map
// (kEncodeFailed + the CUresult).
constexpr int kNoEncoder = 9000;
constexpr int kEncodeFailed = 9100;

// Tensor map of a bf16 [batch, heads, seq, d] tensor with element strides
// st = (batch, heads, seq) and a contiguous head dim, read in boxes of
// {64 columns, rows}.
int make_map(CUtensorMap* map, const void* ptr, int batch, int heads,
             int seq, int d, const int64_t* st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * st[2]),
                                 static_cast<cuuint64_t>(2 * st[1]),
                                 static_cast<cuuint64_t>(2 * st[0])};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int kAtoms, int kBlockKV, int kDV>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int q_heads, int kv_heads, int seq_q, int seq_kv, int d,
           const int64_t* st, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes<kAtoms, kBlockKV>();
  // Raise the kernel's dynamic shared memory cap once, outside any capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_wgmma_kernel<kAtoms, kBlockKV, kDV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap maps[3];
  int err = make_map(&maps[0], q, batch, q_heads, seq_q, d, st, kBlockQ);
  if (!err) err = make_map(&maps[1], k, batch, kv_heads, seq_kv, d, st + 4,
                           kBlockKV);
  if (!err) err = make_map(&maps[2], v, batch, kv_heads, seq_kv, d, st + 8,
                           kBlockKV);
  if (err) return err;
  const dim3 grid(batch * q_heads, (seq_q + kBlockQ - 1) / kBlockQ);
  attn_wgmma_kernel<kAtoms, kBlockKV, kDV><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), q_heads,
      q_heads / kv_heads, seq_q, seq_kv, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_tc

// The wgmma body.  q: [batch, q_heads, seq_q, d], k and v: [batch, kv_heads,
// seq_kv, d], all bf16 with a contiguous head dim, read through their
// strides (in elements: q's four, then k's, then v's; each a multiple of 8
// but the last, and the bases 16-byte aligned); out: contiguous bf16
// [batch, q_heads, seq_q, d].  d is a multiple of 8 up to 256, seq_kv > 0.
// Returns the launch's cudaGetLastError(), or 9000 + n if no tensor map
// could be built.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* out, int batch,
    int q_heads, int kv_heads, int seq_q, int seq_kv, int d,
    const int64_t* strides, float scale, int causal, void* stream) {
  using namespace flash_tc;
  const auto s = static_cast<cudaStream_t>(stream);
#define FLASH_TC(atoms, bkv, dv)                                             \
  return launch<atoms, bkv, dv>(q, k, v, out, batch, q_heads, kv_heads,      \
                                seq_q, seq_kv, d, strides, scale, causal, s)
  if (d <= 64) FLASH_TC(1, 128, 64);
  if (d <= 112) FLASH_TC(2, 128, 112);
  if (d <= 128) FLASH_TC(2, 128, 128);
  if (d <= 192) FLASH_TC(3, 64, 192);
  FLASH_TC(4, 64, 256);
#undef FLASH_TC
}
