// stdp_slot: one per-slot STDP step over the weight array of every
// (chip, slot), traces and weights in one launch.
//
// Replaces no TPU kernel: the JAX package's stdp_slot_step
// (src/repro/snn/plasticity.py:148) is plain jnp, which XLA fuses into one
// pass.  The port's plain version (ref.py) is about 25 PyTorch passes over
// the weights, some of them in float64 to round like XLA's fused
// multiply-adds.  This kernel is that update in the reference's order, for
// chip c, slot b, synapse row r and neuron n:
//
//   tp'[r] = fma(alpha_pre, tp[r], pre[r])       (each fma rounds once, as
//   tq'[n] = fma(alpha_post, tq[n], post[n])      XLA's fused multiply-add)
//   e1     = tp'[r] * post[n]
//   e2     = pre[r] * tq'[n]
//   dw     = fma(lr_pot, e1, -(e2 * lr_dep))
//   w'     = min(max(fma(w_max, dw, w), 0), w_max)
//
// Every product and the clip round on their own (__fmul_rn, no contraction);
// the three fmas are __fmaf_rn.  The plain version sums each fma's exact
// product in float64 and rounds that to float32: it differs from one
// rounding only where the float64 sum lands on a float32 rounding midpoint
// (about one inexact sum in 2^29).  The clip is max(x, 0) then min(x,
// w_max) in PyTorch's form: a NaN passes, -0 stays -0.  A slot whose mask
// byte is 0 keeps its traces and weights: they are copied unchanged.
//
// What bounds it on an H100: bytes.  The weights are read once and written
// once, 8 bytes a synapse against 7 floating-point operations.  At the
// engine's [96 chips, 64 slots, 256, 512] that is 6.4 GB, 1.9 ms at
// 3.35 TB/s; the traces, spikes and drives add 0.9%.
//
// Design: a block owns kItems * kThreads vectors of V floats, i.e. whole
// rows of one (chip, slot) (8 rows at 512 neurons).  Its threads start
// their weight loads first (16-byte streaming loads, neighbouring threads
// on neighbouring addresses), then filter the slot's postsynaptic traces
// and their rows' presynaptic traces into shared memory while the loads
// are in flight, and write the updated weights with streaming stores.  The
// slot's first block writes tq', each block its own rows of tp', so one
// launch writes every output once.  Every block of a slot recomputes the
// same tq' from the same inputs (4 KB from L2 against 16 KB of weights).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace stdp_slot {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // vectors a thread keeps in flight

struct Consts {
  float alpha_pre, alpha_post, lr_pot, lr_dep, w_max;
};

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_stream(const float* p) {
  Vec<V> x;
  if constexpr (V == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    x.v[0] = q.x; x.v[1] = q.y; x.v[2] = q.z; x.v[3] = q.w;
  } else {
    x.v[0] = __ldcs(p);
  }
  return x;
}

template <int V>
__device__ __forceinline__ void store_stream(float* p, const Vec<V>& x) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(x.v[0], x.v[1], x.v[2], x.v[3]));
  } else {
    __stcs(p, x.v[0]);
  }
}

template <int V>
__device__ __forceinline__ Vec<V> load_shared(const float* p) {
  Vec<V> x;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x.v[0] = q.x; x.v[1] = q.y; x.v[2] = q.z; x.v[3] = q.w;
  } else {
    x.v[0] = *p;
  }
  return x;
}

__device__ __forceinline__ float new_weight(float w, float tp, float pre,
                                            float post, float tq,
                                            const Consts& k) {
  const float e1 = __fmul_rn(tp, post);
  const float e2 = __fmul_rn(pre, tq);
  const float dw = __fmaf_rn(k.lr_pot, e1, -__fmul_rn(e2, k.lr_dep));
  float x = __fmaf_rn(k.w_max, dw, w);
  x = x < 0.0f ? 0.0f : x;
  return x > k.w_max ? k.w_max : x;
}

// Grid: slots * row_groups blocks; block i covers rows
// [g * rows_per_block, min(R, (g + 1) * rows_per_block)) of slot
// i / row_groups, g = i % row_groups.  Shared memory: post[N], tq'[N],
// pre[rows_per_block], tp'[rows_per_block].
template <int V>
__global__ void __launch_bounds__(kThreads)
stdp_slot_kernel(const float* __restrict__ tp_in,
                 const float* __restrict__ tq_in,
                 const float* __restrict__ w_in,
                 const float* __restrict__ pre,
                 const float* __restrict__ post,
                 const uint8_t* __restrict__ mask, int batch, int R, int N,
                 int rows_per_block, int row_groups, Consts k,
                 float* __restrict__ tp_out, float* __restrict__ tq_out,
                 float* __restrict__ w_out) {
  extern __shared__ __align__(16) float smem[];
  float* post_s = smem;
  float* tq_s = smem + N;
  float* pre_s = smem + 2 * N;
  float* tp_s = pre_s + rows_per_block;

  const int64_t slot = blockIdx.x / row_groups;
  const int g = static_cast<int>(blockIdx.x % row_groups);
  const int r0 = g * rows_per_block;
  const int rows = min(rows_per_block, R - r0);
  const bool keep = mask == nullptr || mask[slot % batch] != 0;
  const int units = N / V;              // vectors a row
  const int total = rows * units;       // vectors of this block
  const int64_t w_base = (slot * R + r0) * static_cast<int64_t>(N);
  const float* w_at = w_in + w_base;
  float* w_out_at = w_out + w_base;

  // The first kItems weight vectors go in flight before the traces.
  Vec<V> w[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int u = threadIdx.x + i * kThreads;
    if (u < total) w[i] = load_stream<V>(w_at + int64_t{u} * V);
  }
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const int64_t at = slot * N + n;
    const float p = post[at], q = tq_in[at];
    const float q2 = keep ? __fmaf_rn(k.alpha_post, q, p) : q;
    post_s[n] = p;
    tq_s[n] = q2;
    if (g == 0) tq_out[at] = q2;
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int64_t at = slot * R + r0 + r;
    const float d = pre[at], t = tp_in[at];
    const float t2 = keep ? __fmaf_rn(k.alpha_pre, t, d) : t;
    pre_s[r] = d;
    tp_s[r] = t2;
    tp_out[at] = t2;
  }
  __syncthreads();

  for (int first = threadIdx.x; first < total;
       first += kThreads * kItems) {
    if (first != static_cast<int>(threadIdx.x)) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int u = first + i * kThreads;
        if (u < total) w[i] = load_stream<V>(w_at + int64_t{u} * V);
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int u = first + i * kThreads;
      if (u >= total) continue;
      if (keep) {
        const int r = u / units;
        const int n = (u - r * units) * V;
        const Vec<V> p = load_shared<V>(post_s + n);
        const Vec<V> q = load_shared<V>(tq_s + n);
        const float tp = tp_s[r], d = pre_s[r];
#pragma unroll
        for (int j = 0; j < V; ++j)
          w[i].v[j] = new_weight(w[i].v[j], tp, d, p.v[j], q.v[j], k);
      }
      store_stream<V>(w_out_at + int64_t{u} * V, w[i]);
    }
  }
}

template <int V>
int launch(const float* tp, const float* tq, const float* w,
           const float* pre, const float* post, const uint8_t* mask,
           int64_t slots, int batch, int R, int N, Consts k, float* tp_out,
           float* tq_out, float* w_out, cudaStream_t stream) {
  // Whole rows a block: kItems * kThreads vectors, at least one row.
  const int per_block = kItems * kThreads * V;
  const int rows_per_block =
      std::max(1, std::min(N > 0 ? per_block / N : R, R));
  const int row_groups =
      std::max(1, (R + rows_per_block - 1) / rows_per_block);
  const int64_t blocks = slots * row_groups;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * size_t(N) + 2 * rows_per_block);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stdp_slot_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stdp_slot_kernel<V><<<static_cast<unsigned>(blocks), kThreads, smem,
                        stream>>>(tp, tq, w, pre, post, mask, batch, R, N,
                                  rows_per_block, row_groups, k, tp_out,
                                  tq_out, w_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stdp_slot

// trace_pre, pre: float32 [slots, R]; trace_post, post: float32 [slots, N];
// weights: float32 [slots, R, N], all contiguous, slots = chips * batch with
// the slot index b = slot % batch; mask: uint8 [batch] (nonzero: update) or
// null (every slot updates).  Outputs of the same shapes, not aliasing the
// inputs.  The constants as the caller rounded them to float32.  The
// weights take 16-byte vectors where N is a multiple of 4 and both weight
// pointers are 16-byte aligned, single floats otherwise.  Returns
// cudaGetLastError() of the launch.
extern "C" int stdp_slot_launch(const void* trace_pre, const void* trace_post,
                                const void* weights, const void* pre,
                                const void* post, const void* mask,
                                int64_t slots, int batch, int R, int N,
                                float alpha_pre, float alpha_post,
                                float lr_pot, float lr_dep, float w_max,
                                void* trace_pre_out, void* trace_post_out,
                                void* weights_out, void* stream) {
  using namespace stdp_slot;
  if (slots == 0) return 0;
  const Consts k{alpha_pre, alpha_post, lr_pot, lr_dep, w_max};
  const auto* tp = static_cast<const float*>(trace_pre);
  const auto* tq = static_cast<const float*>(trace_post);
  const auto* w = static_cast<const float*>(weights);
  const auto* d = static_cast<const float*>(pre);
  const auto* p = static_cast<const float*>(post);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* tp_out = static_cast<float*>(trace_pre_out);
  auto* tq_out = static_cast<float*>(trace_post_out);
  auto* w_out = static_cast<float*>(weights_out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(weights) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(weights_out) % 16 == 0;
  return vec ? launch<4>(tp, tq, w, d, p, m, slots, batch, R, N, k, tp_out,
                         tq_out, w_out, s)
             : launch<1>(tp, tq, w, d, p, m, slots, batch, R, N, k, tp_out,
                         tq_out, w_out, s);
}
