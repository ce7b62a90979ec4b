// flash_attention: tiled online-softmax attention, causal and KV-length
// masks, grouped-query heads by index.  Three bodies, picked by the wrapper
// (ops.py) from the operands' element type and the number of query rows.
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
// What bounds it on an H100: operations for a prefill, bytes for a decode
// step.  At zamba2-7b's prefill (batch 4, 32 heads, 2048 positions, head
// dim 112, bf16, causal) it does 2·B·H·S²·d ≈ 1.2e11 flops (the causal half
// of the two products), 0.12 ms at the 989 TFLOP/s bf16 tensor-core peak,
// and moves about 235 MB, 70 µs at 3.35 TB/s.  At whisper-medium's decode
// cross-attention (one query row against 1500 frames) it reads 24.6 MB of
// K and V for 2.5e7 flops: 7.3 µs.
//
// The wgmma body (q, k and v all bf16, more than 16 query rows;
// attn_wgmma_kernel) is warp-specialised: see its section below.  The
// decode body (bf16, at most 16 query rows; attn_decode_kernel) splits the
// keys over many blocks: see its section.
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
// The wgmma body: warp-specialised
// ---------------------------------------------------------------------------
//
// One CTA of three warpgroups owns 128 query rows of one (batch, q-head).
// Warpgroup 2, the producer, gives its registers away (setmaxnreg.dec to
// 24) and one of its lanes keeps TMA loads of K and V in flight through two
// rings of two stages each, K and V released apart: K as soon as a tile's
// Q·Kᵀ is done, V after its P·V.  Warpgroups 0 and 1, the consumers, take
// 240 registers each (setmaxnreg.inc), which holds the 64 × d float32
// accumulator, the scores and bf16 P of a 64-row slice without spilling up
// to d = 256.  Tiles sit in shared memory as 64-column, 128-byte-swizzled
// atoms; a head dim that is not a multiple of 64 reads as zero columns
// past d (TMA's out-of-bounds fill), which add nothing to Q·Kᵀ.  The KV
// tile is 128 keys (the Pallas kernel's DEFAULT_BLOCK_KV, so P rounds at
// the same block boundaries) up to d = 128; above, the largest that fits
// two stages of K and V beside the 128-row Q tile (block_kv_for in ops.py):
// 112 keys at d = 192 (Q 48 KB + 2 × (K + V) 168 KB), 80 at d = 256 (64 KB
// + 160 KB).  S = Q·Kᵀ is one wgmma of N = 128, 112 or 80 per 16 columns
// of d, both operands in shared memory; the online softmax runs in
// registers (masks only on diagonal and ragged tiles) and rounds P to bf16
// there, as the Pallas body's p.astype(v.dtype)·v does on the TPU's MXU;
// P·V is one wgmma of N = d per 16 keys, P the register operand and V
// N-major in shared memory.
//
// Overlap, inside a consumer: the products of tile i are issued together,
// S_i = Q·K_iᵀ and then O += P_{i-1}·V_{i-1}; wgmma.wait_group 1 waits for
// S_i only, so the softmax of tile i runs on the CUDA cores while the
// tensor cores still accumulate tile i-1's P·V.  Then the rescale of O and
// the rounding of P_i to bf16 wait for that product (wait_group 0).
// Between the consumers: named barriers make them issue their products in
// turns (ping-pong), so that one warpgroup's softmax runs under the other's
// products.  Launch order: the (batch, q-head)s go in groups whose K and V
// fill half the L2, the heaviest causal q tiles of a group first.  Tensor
// maps are built per call on the host (cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so no -lcuda) and passed as
// __grid_constant__ parameters.  TMA needs the head dim contiguous, every
// other stride a multiple of 16 bytes and a 16-byte aligned base: the
// wrapper checks that and raises otherwise.

namespace flash_tc {

constexpr int kBlockQ = 128;             // two consumer warpgroups of 64 rows
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;   // and one producer warpgroup
constexpr int kStages = 2;               // the K and V rings
constexpr int kAtomBytes = 128;          // one swizzled row: 64 bf16 columns
// setmaxnreg: 128 · 24 + 256 · 240 = 64512, the 384 · 168 registers the
// launch holds (__launch_bounds__(384, 1)).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBarTurn = 1;   // named barriers 1 and 2: warpgroup w's turn
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

// D[64 x 80] (+)= A[64 x 16] · B[16 x 80]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 112] (+)= A[64 x 16] · B[16 x 112]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n112(float (&d)[56], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "%56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(accumulate));
}

// exp(x - m) as 2^(x·log2 e - m·log2 e): one FFMA and ex2.approx (what
// __expf(x - m) computes with an FADD and an FMUL before the ex2).  A
// masked score (-1e30) gives exactly 0.
__device__ __forceinline__ float exp_minus(float x, float m_log2e) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y) : "f"(fmaf(x, 1.4426950408889634f, -m_log2e)));
  return y;
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(kBarTurn + wg), "n"(kConsumers)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(kBarTurn + wg), "n"(kConsumers)
               : "memory");
}

// D[64 x 128] (+)= A[64 x 16] · B[16 x 128]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 112] += A[64 x 16] · B[16 x 112]: A in registers (bf16 pairs), B
// N-major in shared memory: 64-column atoms LBO bytes apart.
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] · B[16 x 128]: A in registers (bf16 pairs), B
// N-major in shared memory: 64-column atoms LBO bytes apart.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 192] += A[64 x 16] · B[16 x 192]: A in registers (bf16 pairs), B
// N-major in shared memory: 64-column atoms LBO bytes apart.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] · B[16 x 256]: A in registers (bf16 pairs), B
// N-major in shared memory: 64-column atoms LBO bytes apart.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int kAtoms, int kBlockKV>
constexpr int smem_bytes() {
  // 1024 bytes of alignment slack, the Q tile, the K and V rings, barriers.
  return 1024 + kAtoms * kBlockQ * kAtomBytes
       + 2 * kStages * kAtoms * kBlockKV * kAtomBytes + 128;
}

// S (+)= one 16-column step of Q·Kᵀ over all kBlockKV keys.
template <int kBlockKV>
__device__ __forceinline__ void qk_step(float (&sc)[kBlockKV / 2],
                                        uint64_t da, const uint8_t* k_col,
                                        int accumulate) {
  if constexpr (kBlockKV == 80) {
    wgmma_ss_n80(sc, da, sw128_desc(k_col, 16), accumulate);
  } else if constexpr (kBlockKV == 112) {
    wgmma_ss_n112(sc, da, sw128_desc(k_col, 16), accumulate);
  } else {
    static_assert(kBlockKV == 128, "S tiles are 80, 112 or 128 keys");
    wgmma_ss_n128(sc, da, sw128_desc(k_col, 16), accumulate);
  }
}

// O += one 16-key step of bf16(P)·V over all kDV columns in one wgmma.
template <int kDV>
__device__ __forceinline__ void pv_step(float (&o)[kDV / 2],
                                        const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kDV == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (kDV == 112) wgmma_rs_n112(o, a, db);
  else if constexpr (kDV == 128) wgmma_rs_n128(o, a, db);
  else if constexpr (kDV == 192) wgmma_rs_n192(o, a, db);
  else {
    static_assert(kDV == 256, "P·V widths are 64, 112, 128, 192, 256");
    wgmma_rs_n256(o, a, db);
  }
}

template <int kAtoms, int kBlockKV, int kDV>
__global__ void __launch_bounds__(kThreads, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               __nv_bfloat16* __restrict__ out, int q_heads, int group,
               int seq_q, int seq_kv, int d, float scale, int causal,
               int heads_per_wave) {
  static_assert(kDV % 16 == 0 && kDV <= 64 * kAtoms, "bad head-dim tiling");
  static_assert(kBlockKV % 16 == 0, "bad KV tile");
  constexpr int kQAtom = kBlockQ * kAtomBytes;
  constexpr int kKVAtom = kBlockKV * kAtomBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;
  uint8_t* ks = qs + kAtoms * kQAtom;                // [stage][atom]
  uint8_t* vs = ks + kStages * kAtoms * kKVAtom;     // [stage][atom]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * kAtoms * kKVAtom);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // Launch order: (batch, q-head)s in groups of heads_per_wave, whose K
  // and V fit in half the L2 together (a wave of 132 CTAs over 132 heads
  // would stream every head's keys from device memory); within a group,
  // the heaviest q tiles first, across its heads.
  const int n_q = (seq_q + kBlockQ - 1) / kBlockQ;
  const int n_bh = gridDim.x / n_q;
  const int grp = blockIdx.x / (heads_per_wave * n_q);
  const int in_grp = blockIdx.x - grp * heads_per_wave * n_q;
  const int grp_heads = min(heads_per_wave, n_bh - grp * heads_per_wave);
  const int bh = grp * heads_per_wave + in_grp % grp_heads;
  const int b = bh / q_heads;
  const int h = bh - b * q_heads;
  const int hk = h / group;
  const int q0 = (n_q - 1 - in_grp / grp_heads) * kBlockQ;
  const int kv_end = causal ? min(seq_kv, q0 + kBlockQ) : seq_kv;
  const int n_tiles = (kv_end + kBlockKV - 1) / kBlockKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kConsumers);
      mbar_init(v_empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: one lane starts every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, kAtoms * kQAtom);
      for (int a = 0; a < kAtoms; ++a)
        tma_load(qs + a * kQAtom, &q_map, q_full, 64 * a, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = (i / kStages - 1) & 1;
        if (i >= kStages) mbar_wait(k_empty + s, parity);
        mbar_expect_tx(k_full + s, kAtoms * kKVAtom);
        for (int a = 0; a < kAtoms; ++a)
          tma_load(ks + (s * kAtoms + a) * kKVAtom, &k_map, k_full + s,
                   64 * a, i * kBlockKV, hk, b);
        if (i >= kStages) mbar_wait(v_empty + s, parity);
        mbar_expect_tx(v_full + s, kAtoms * kKVAtom);
        for (int a = 0; a < kAtoms; ++a)
          tma_load(vs + (s * kAtoms + a) * kKVAtom, &v_map, v_full + s,
                   64 * a, i * kBlockKV, hk, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  // Accumulator fragment of warpgroup wg: thread t holds rows r0 =
  // 16·warp + g and r0 + 8 (g = lane / 4) of the warpgroup's 64, at columns
  // 8j + 2c + {0, 1} (c = lane % 4): registers 4j + {0, 1} and 4j + {2, 3}.
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, c = lane % 4;
  const int wg_row = q0 + 64 * wg;
  const int row0 = wg_row + 16 * warp + g;
  const int row1 = row0 + 8;
  const uint8_t* q_rows = qs + 64 * wg * kAtomBytes;

  float o[kDV / 2];
#pragma unroll
  for (int i = 0; i < kDV / 2; ++i) o[i] = 0.f;
  float sc[kBlockKV / 2];
  uint32_t pa[kBlockKV / 16][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // S = Q·K_iᵀ over the head dim in k-steps of 16 columns; zero columns
  // past d add nothing.
  auto issue_qk = [&](int i) {
    const uint8_t* k_tile = ks + (i % kStages) * kAtoms * kKVAtom;
#pragma unroll
    for (int kstep = 0; kstep < kDV / 16; ++kstep) {
      const int a = kstep / 4, off = 32 * (kstep % 4);
      qk_step<kBlockKV>(sc, sw128_desc(q_rows + a * kQAtom + off, 16),
                        k_tile + a * kKVAtom + off, kstep > 0);
    }
    wgmma_commit();
  };
  // O += bf16(P_i)·V_i in k-steps of 16 keys, V N-major in shared memory:
  // one wgmma of N = kDV a step, its 64-column atoms kKVAtom bytes apart.
  auto issue_pv = [&](int i) {
    const uint8_t* v_tile = vs + (i % kStages) * kAtoms * kKVAtom;
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk)
      pv_step<kDV>(o, pa[kk],
                   sw128_desc(v_tile + 16 * kk * kAtomBytes, kKVAtom));
    wgmma_commit();
  };
  // The online softmax of S_i in place (P_i in float32, the TPU kernel's
  // arithmetic and guards); returns the rows' rescale factors.
  auto softmax = [&](int i, float& alpha0, float& alpha1) {
    const int kv0 = i * kBlockKV;
    const bool masked = kv0 + kBlockKV > seq_kv
                     || (causal && kv0 + kBlockKV - 1 > wg_row);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = sc[4 * j + e] * scale;
        float x1 = sc[4 * j + 2 + e] * scale;
        if (masked) {
          const int key = kv0 + 8 * j + 2 * c + e;
          if (key >= seq_kv || (causal && key > row0)) x0 = kNegInf;
          if (key >= seq_kv || (causal && key > row1)) x1 = kNegInf;
        }
        sc[4 * j + e] = x0;
        sc[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float sub0 = (mn0 <= kNegInf / 2 ? 0.f : mn0) * 1.4426950408889634f;
    const float sub1 = (mn1 <= kNegInf / 2 ? 0.f : mn1) * 1.4426950408889634f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp_minus(sc[4 * j + e], sub0);
        const float p1 = exp_minus(sc[4 * j + 2 + e], sub1);
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    alpha0 = m0 <= kNegInf / 2 ? 0.f : __expf(m0 - mn0);
    alpha1 = m1 <= kNegInf / 2 ? 0.f : __expf(m1 - mn1);
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
  };
  // Round P_i to bf16: the accumulator layout of two neighbouring 8-key
  // blocks is the register layout of one 16-key A fragment.
  auto round_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      const float* p = sc + 8 * kk;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(p[2 * r], p[2 * r + 1]);
    }
  };

  // The consumers issue their products in turns: warpgroup 0 first; every
  // wait for a turn is matched by one pass of the other warpgroup (and
  // warpgroup 0's first by its own).  No wgmma sits under a branch: the
  // first tile's Q·Kᵀ and the last tile's P·V are peeled off the loop.
  mbar_wait(q_full, 0);
  if (wg == 0) turn_pass(0);
  float alpha0, alpha1;
  turn_wait(wg);
  mbar_wait(k_full, 0);
  wgmma_fence();
  issue_qk(0);
  turn_pass(1 - wg);
  wgmma_wait_all();
  fence_regs(sc);
  mbar_arrive(k_empty);
  softmax(0, alpha0, alpha1);        // O is still zero: no rescale
  round_p();
  for (int i = 1; i < n_tiles; ++i) {
    const int s = i % kStages, sp = (i - 1) % kStages;
    turn_wait(wg);
    mbar_wait(k_full + s, (i / kStages) & 1);
    mbar_wait(v_full + sp, ((i - 1) / kStages) & 1);
    wgmma_fence();
    issue_qk(i);                     // S_i
    issue_pv(i - 1);                 // O += P_{i-1}·V_{i-1}
    turn_pass(1 - wg);
    wgmma_wait_one();                // S_i done; P·V may still run
    fence_regs(sc);
    mbar_arrive(k_empty + s);
    softmax(i, alpha0, alpha1);      // under the P·V
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(v_empty + sp);
    // O is relative to m_{i-1}: rescale it to m_i.
#pragma unroll
    for (int r = 0; r < kDV / 2; r += 4) {
      o[r] *= alpha0;
      o[r + 1] *= alpha0;
      o[r + 2] *= alpha1;
      o[r + 3] *= alpha1;
    }
    round_p();
  }
  turn_wait(wg);
  mbar_wait(v_full + (n_tiles - 1) % kStages, ((n_tiles - 1) / kStages) & 1);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  if (wg == 0) turn_pass(1);         // warpgroup 1's last wait
  wgmma_wait_all();
  fence_regs(o);

  const float ls0 = l0 == 0.f ? 1.f : l0;
  const float ls1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* o_rows =
      out + (static_cast<int64_t>(b) * q_heads + h) * seq_q * d;
#pragma unroll
  for (int j = 0; j < kDV / 8; ++j) {
    const float* r = o + 4 * j;
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
  static_assert(smem <= 232448, "over the H100's shared memory a block");
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
  const int grid = batch * q_heads * ((seq_q + kBlockQ - 1) / kBlockQ);
  // Heads whose K and V (4·seq_kv·d bytes a KV head, shared by the group's
  // q-heads) fill half the 50 MB L2.
  const int64_t kv_bytes = 4ll * seq_kv * d;
  const int64_t per_wave = (25ll << 20) / kv_bytes * (q_heads / kv_heads);
  const int heads_per_wave = static_cast<int>(
      per_wave < 1 ? 1 : per_wave > batch * q_heads ? batch * q_heads
                                                     : per_wave);
  attn_wgmma_kernel<kAtoms, kBlockKV, kDV><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), q_heads,
      q_heads / kv_heads, seq_q, seq_kv, d, scale, causal, heads_per_wave);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_tc

// The wgmma body.  q: [batch, q_heads, seq_q, d], k and v: [batch, kv_heads,
// seq_kv, d], all bf16 with a contiguous head dim, read through their
// strides (in elements: q's four, then k's, then v's; each a multiple of 8
// but the last, and the bases 16-byte aligned); out: contiguous bf16
// [batch, q_heads, seq_q, d].  d is a multiple of 8 up to 256, seq_kv > 0.
// KV tiles of 128 keys up to d = 128, 112 up to 192, 80 up to 256.
// Returns the launch's cudaGetLastError(), or 9000 + n if no tensor map
// could be built.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* out, int batch,
    int q_heads, int kv_heads, int seq_q, int seq_kv, int d,
    const int64_t* strides, float scale, int causal, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define FLASH_TC(atoms, bkv, dv)                                             \
  return flash_tc::launch<atoms, bkv, dv>(q, k, v, out, batch, q_heads,      \
                                          kv_heads, seq_q, seq_kv, d,        \
                                          strides, scale, causal, s)
  if (d <= 64) FLASH_TC(1, 128, 64);
  if (d <= 112) FLASH_TC(2, 128, 112);
  if (d <= 128) FLASH_TC(2, 128, 128);
  if (d <= 192) FLASH_TC(3, 112, 192);
  FLASH_TC(4, 80, 256);
#undef FLASH_TC
}

// ---------------------------------------------------------------------------
// The decode body (seq_q <= 16, bf16): split-KV flash decoding
// ---------------------------------------------------------------------------
//
// What bounds it: bytes.  At whisper-medium's decode cross-attention (batch
// 4, 16 heads, one query row against 1500 frames, d = 64) it reads 24.6 MB
// of K and V for 2.5e7 flops: 7.3 µs at 3.35 TB/s.  The wgmma body runs
// such a call as 64 CTAs that each walk twelve 128-key tiles in turn with
// one live row in 128: latency-bound.  Here the keys of each (batch,
// q-head) are cut into n_splits runs of whole 128-key tiles (decode_splits
// in ops.py: 6 splits of two tiles, 384 blocks at that shape, one wave),
// so that every block has its loads in flight at once; a split of two
// tiles or more copies tile i + 1 (two stages up to d = 128) while it
// computes tile i.  A block of four warps holds the <= 16 query
// rows as one m16 tile and loads its K and V tiles with cp.async into
// shared memory (16-byte pieces, zero-filled past seq_kv; rows XOR-swizzled
// by 16-byte piece from d = 64 on, padded by one piece below, so that
// ldmatrix is free of bank conflicts).  Per 128-key tile each warp computes
// the scores of 32 keys with mma.sync m16n8k16 (bf16, f32 accumulators),
// the block exchanges row maxima through shared memory so that P is
// exp(s - m) with m the running maximum over whole 128-key blocks, as in the
// TPU kernel; each warp rounds its P to bf16 in registers and accumulates
// P·V over its keys into a partial O (ldmatrix.trans of V), and the four
// partials (same m) are summed at the end.  A block writes its rows' (acc,
// m, l) to a float32 scratch; the last block of a (batch, q-head) to finish
// (a __threadfence and an atomic counter, which it resets to 0) combines
// them: acc / l with acc = Σ w_i acc_i, l = Σ w_i l_i, w_i = exp(m_i - M),
// w_i = 0 for a split whose rows are all masked.  With one split the block
// writes acc / l itself.  Causal calls have seq_q == seq_kv <= 16: one tile.

namespace flash_dec {

constexpr int kRows = 16;          // query rows a block holds (m16n8k16)
constexpr int kTile = 128;         // keys a tile: the TPU kernel's block_kv
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplits = 64;     // ops.decode_splits' cap
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;                 // elements; the head dim is contiguous
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp(x - m) as 2^(x·log2 e - m·log2 e): one FFMA and ex2.approx (what
// __expf(x - m) computes with an FADD and an FMUL before the ex2).  A
// masked score (-1e30) gives exactly 0.
__device__ __forceinline__ float exp_minus(float x, float m_log2e) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y) : "f"(fmaf(x, 1.4426950408889634f, -m_log2e)));
  return y;
}

// Shared-memory rows of kDP bf16 columns (kDP = d rounded up to 16, 32,
// 64, 128 or 256), addressed by 16-byte piece: from kDP = 64 on, piece p of
// row r sits at p ^ (r % 8); below, rows are padded by one piece.
template <int kDP>
struct Rows {
  static constexpr int kPieces = kDP / 8;
  static constexpr bool kSwizzle = kPieces >= 8;
  static constexpr int kLd = kSwizzle ? kDP : kDP + 8;   // elements a row
  __device__ static __forceinline__ int at(int row, int piece) {
    return row * kLd + 8 * (kSwizzle ? piece ^ (row & 7) : piece);
  }
};

template <int kDP>
constexpr int smem_bytes(int stages) {
  // Q, the K and V stages, and 2·kWarps·kRows floats of row maxima (l, m
  // and the last-block flag after the KV loop).
  return 2 * Rows<kDP>::kLd * (kRows + 2 * kTile * stages)
       + 4 * 2 * kWarps * kRows;
}

// Blocks an SM the registers must allow (128 registers at kDP <= 64):
// shared memory holds three two-stage blocks at kDP <= 64, 66.5 KB each
// (whisper's shape: 384 blocks in one wave), five one-stage blocks.
template <int kDP>
constexpr int min_blocks() { return kDP <= 64 ? 4 : kDP <= 128 ? 3 : 1; }

template <int kDP>
__global__ void __launch_bounds__(kThreads, min_blocks<kDP>())
attn_decode_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ counters, int q_heads, int group,
                   int seq_q, int seq_kv, int d, Strides sq, Strides sk,
                   Strides sv, float scale, int causal, int n_splits,
                   int tiles_per_split, int stages) {
  using R = Rows<kDP>;
  constexpr int kLd = R::kLd;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kvs = qs + kRows * kLd;     // [stage][K, V][kTile][kLd]
  float* red = reinterpret_cast<float*>(kvs + 2 * stages * kTile * kLd);
  // red: [2][kWarps][kRows] row maxima by tile parity; after the KV loop
  // [kWarps][kRows] partial l, then [kRows] m.

  const int split = blockIdx.x % n_splits;
  const int bh = blockIdx.x / n_splits;
  const int b = bh / q_heads;
  const int h = bh - b * q_heads;
  const int hk = h / group;
  const int tile0 = split * tiles_per_split;
  const int n_tiles = min(tiles_per_split,
                          (seq_kv + kTile - 1) / kTile - tile0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int pieces = d / 8;

  // Zero the pieces past d of Q and of every K stage (a 0·NaN of stale
  // shared memory would poison a score); cp.async writes only pieces < d.
  const int pad = R::kPieces - pieces;
  for (int i = tid; i < (kRows + stages * kTile) * pad; i += kThreads) {
    const int r = i / pad, p = pieces + i % pad;
    // Row r < kRows of Q, else row (r - kRows) % kTile of stage
    // (r - kRows) / kTile's K, at kvs + stage·2·kTile·kLd.
    __nv_bfloat16* dst =
        r < kRows ? qs + R::at(r, p)
                  : kvs + (r - kRows) / kTile * 2 * kTile * kLd
                        + R::at((r - kRows) % kTile, p);
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  const __nv_bfloat16* q_base = q + b * sq.b + h * sq.h;
  for (int i = tid; i < kRows * pieces; i += kThreads) {
    const int r = i / pieces, p = i % pieces;
    const bool ok = r < seq_q;
    cp_async16(qs + R::at(r, p), q_base + (ok ? r : 0) * sq.s + 8 * p, ok);
  }
  const __nv_bfloat16* k_base = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* v_base = v + b * sv.b + hk * sv.h;
  // Tile t into stage st: K as one copy group, then V as another, so that
  // the scores need not wait for V.
  auto load_tile = [&](int t, int st) {
    __nv_bfloat16* ks = kvs + st * 2 * kTile * kLd;
    __nv_bfloat16* vs = ks + kTile * kLd;
    const int key0 = (tile0 + t) * kTile;
    for (int i = tid; i < kTile * pieces; i += kThreads) {
      const int r = i / pieces, p = i % pieces;
      const bool ok = key0 + r < seq_kv;
      cp_async16(ks + R::at(r, p), k_base + (ok ? key0 + r : 0) * sk.s
                 + 8 * p, ok);
    }
    cp_async_commit();
    for (int i = tid; i < kTile * pieces; i += kThreads) {
      const int r = i / pieces, p = i % pieces;
      const bool ok = key0 + r < seq_kv;
      cp_async16(vs + R::at(r, p), v_base + (ok ? key0 + r : 0) * sv.s
                 + 8 * p, ok);
    }
    cp_async_commit();
  };

  float o[kDP / 8][4];
#pragma unroll
  for (int n = 0; n < kDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // rows g, g + 8

  // Copy groups pending at the top of tile i: its K and its V (Q rides
  // with tile 0's K).
  if (stages == 2) load_tile(0, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = stages == 2 ? i & 1 : 0;
    if (stages == 1) {
      if (i > 0) __syncthreads();    // every warp is done with tile i - 1
      load_tile(i, 0);
    }
    cp_async_wait<1>();              // K_i
    __syncthreads();
    const bool ahead = stages == 2 && i + 1 < n_tiles;
    if (ahead) load_tile(i + 1, (i + 1) & 1);   // two more groups
    const __nv_bfloat16* ks = kvs + st * 2 * kTile * kLd;
    const __nv_bfloat16* vs = ks + kTile * kLd;

    // This warp's scores: rows g and g + 8, keys 32·warp + 8j + 2c + {0, 1}.
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + R::at(lane % 16, 2 * kk + lane / 16));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + R::at(32 * warp + 16 * jp + lane % 8 + 8 * (lane / 16),
                               2 * kk + (lane / 8) % 2));
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }
    const int key0 = (tile0 + i) * kTile + 32 * warp;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * c + e;
        float x0 = s[j][e] * scale, x1 = s[j][2 + e] * scale;
        if (key >= seq_kv || (causal && key > g)) x0 = kNegInf;
        if (key >= seq_kv || (causal && key > g + 8)) x1 = kNegInf;
        s[j][e] = x0;
        s[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float* tile_max = red + (i & 1) * kWarps * kRows;
    if (c == 0) {
      tile_max[warp * kRows + g] = mx0;
      tile_max[warp * kRows + g + 8] = mx1;
    }
    if (ahead) cp_async_wait<2>(); else cp_async_wait<0>();   // V_i
    __syncthreads();                 // the maxima and V_i are in

#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mx0 = fmaxf(mx0, tile_max[w * kRows + g]);
      mx1 = fmaxf(mx1, tile_max[w * kRows + g + 8]);
    }
    // The online softmax over the whole 128-key block, the TPU kernel's
    // guards; l is this thread's share, summed over the block at the end.
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float sub0 = (mn0 <= kNegInf / 2 ? 0.f : mn0) * 1.4426950408889634f;
    const float sub1 = (mn1 <= kNegInf / 2 ? 0.f : mn1) * 1.4426950408889634f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp_minus(s[j][e], sub0);
        s[j][2 + e] = exp_minus(s[j][2 + e], sub1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    const float alpha0 = m0 <= kNegInf / 2 ? 0.f : __expf(m0 - mn0);
    const float alpha1 = m1 <= kNegInf / 2 ? 0.f : __expf(m1 - mn1);
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kDP / 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }
    // O += bf16(P)·V over this warp's 32 keys, two k-steps of 16: the
    // accumulator layout of two neighbouring 8-key blocks is the A fragment.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kDP / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + R::at(32 * warp + 16 * kk + lane % 8
                                         + 8 * ((lane / 8) % 2),
                                     2 * np + lane / 16));
        mma_bf16(o[2 * np], pa, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // Sum the four warps' partial O and l (their m is the block's).
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __syncthreads();                   // the K and V stages are free
  float* po = reinterpret_cast<float*>(kvs);   // [kWarps][kRows][kDP]
  float* pl = red;                             // [kWarps][kRows]
  float* pm = red + kWarps * kRows;            // [kRows]
  int* last = reinterpret_cast<int*>(pm + kRows);
#pragma unroll
  for (int n = 0; n < kDP / 8; ++n) {
    float* r0 = po + (warp * kRows + g) * kDP + 8 * n + 2 * c;
    r0[0] = o[n][0];
    r0[1] = o[n][1];
    r0[8 * kDP] = o[n][2];
    r0[8 * kDP + 1] = o[n][3];
  }
  if (c == 0) {
    pl[warp * kRows + g] = l0;
    pl[warp * kRows + g + 8] = l1;
    if (warp == 0) {
      pm[g] = m0;
      pm[g + 8] = m1;
    }
  }
  __syncthreads();
  __nv_bfloat16* o_rows =
      out + (static_cast<int64_t>(b) * q_heads + h) * seq_q * d;
  if (n_splits == 1) {
    for (int i = tid; i < seq_q * d; i += kThreads) {
      const int r = i / d, col = i % d;
      float acc = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        acc += po[(w * kRows + r) * kDP + col];
        l += pl[w * kRows + r];
      }
      o_rows[i] = __float2bfloat16(acc / (l == 0.f ? 1.f : l));
    }
    return;
  }
  // This split's rows: [seq_q][d + 2] floats (acc, then m and l).
  const int ld = d + 2;
  float* mine = part + (static_cast<int64_t>(bh) * n_splits + split)
                           * seq_q * ld;
  for (int i = tid; i < seq_q * d; i += kThreads) {
    const int r = i / d, col = i % d;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += po[(w * kRows + r) * kDP + col];
    mine[r * ld + col] = acc;
  }
  for (int r = tid; r < seq_q; r += kThreads) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += pl[w * kRows + r];
    mine[r * ld + d] = pm[r];
    mine[r * ld + d + 1] = l;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(counters + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // The last block of this (batch, q-head): combine the splits in float32.
  // The splits' m and l go to shared memory (the K and V stages), then
  // their weights w = exp(m - M); the sums over splits read the partial
  // accumulators four splits at a time.
  const float* all = part + static_cast<int64_t>(bh) * n_splits * seq_q * ld;
  float* w = reinterpret_cast<float*>(kvs);    // [n_splits][kRows]
  float* sl = w + kMaxSplits * kRows;          // [n_splits][kRows]
  float* row_l = pl;                           // [kRows]
  for (int i = tid; i < n_splits * seq_q; i += kThreads) {
    const int sp = i / seq_q, r = i % seq_q;
    w[sp * kRows + r] = __ldcg(all + (sp * seq_q + r) * ld + d);
    sl[sp * kRows + r] = __ldcg(all + (sp * seq_q + r) * ld + d + 1);
  }
  __syncthreads();
  if (tid < seq_q) {
    float mx = kNegInf;
    for (int sp = 0; sp < n_splits; ++sp) mx = fmaxf(mx, w[sp * kRows + tid]);
    float l = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float ms = w[sp * kRows + tid];
      const float ws = ms <= kNegInf / 2 ? 0.f : expf(ms - mx);
      w[sp * kRows + tid] = ws;
      l += ws * sl[sp * kRows + tid];
    }
    row_l[tid] = l == 0.f ? 1.f : l;
  }
  __syncthreads();
  for (int i = tid; i < seq_q * d; i += kThreads) {
    const int r = i / d, col = i % d;
    float acc = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_splits; ++sp)
      acc += w[sp * kRows + r] * __ldcg(all + (sp * seq_q + r) * ld + col);
    o_rows[i] = __float2bfloat16(acc / row_l[r]);
  }
  if (tid == 0) counters[bh] = 0;    // ready for the next launch
}

template <int kDP>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part, int* counters, int batch, int q_heads, int kv_heads,
           int seq_q, int seq_kv, int d, const int64_t* st, float scale,
           int causal, int n_splits, cudaStream_t stream) {
  // Two stages of K and V where a split has two tiles or more and they
  // fit (kDP <= 128); one otherwise.
  constexpr int kMaxStages = kDP <= 128 ? 2 : 1;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_decode_kernel<kDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<kDP>(kMaxStages));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = (seq_kv + kTile - 1) / kTile;
  const int per_split = (tiles + n_splits - 1) / n_splits;
  const int stages = per_split > 1 ? kMaxStages : 1;
  const int blocks = batch * q_heads * n_splits;
  attn_decode_kernel<kDP><<<blocks, kThreads, smem_bytes<kDP>(stages),
                            stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), part, counters, q_heads,
      q_heads / kv_heads, seq_q, seq_kv, d, Strides{st[0], st[1], st[2]},
      Strides{st[4], st[5], st[6]}, Strides{st[8], st[9], st[10]}, scale,
      causal, n_splits, per_split, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_dec

// The decode body.  q: [batch, q_heads, seq_q <= 16, d], k and v: [batch,
// kv_heads, seq_kv > 0, d], bf16, head dim contiguous, read through their
// strides as the wgmma body's (each a multiple of 8 but the last; 16-byte
// aligned bases); out: contiguous bf16 [batch, q_heads, seq_q, d].  d is a
// multiple of 8 up to 256.  n_splits (ops.decode_splits) leaves no split
// empty; with n_splits > 1, part holds batch·q_heads·n_splits·seq_q·(d + 2)
// floats and counters batch·q_heads zeros (left zero).  Returns the
// launch's cudaGetLastError().
extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, void* out, void* part,
    void* counters, int batch, int q_heads, int kv_heads, int seq_q,
    int seq_kv, int d, const int64_t* strides, float scale, int causal,
    int n_splits, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
#define FLASH_DEC(dp)                                                        \
  return flash_dec::launch<dp>(q, k, v, out, p, cnt, batch, q_heads,         \
                               kv_heads, seq_q, seq_kv, d, strides, scale,   \
                               causal, n_splits, s)
  if (d <= 16) FLASH_DEC(16);
  if (d <= 32) FLASH_DEC(32);
  if (d <= 64) FLASH_DEC(64);
  if (d <= 128) FLASH_DEC(128);
  FLASH_DEC(256);
#undef FLASH_DEC
}
