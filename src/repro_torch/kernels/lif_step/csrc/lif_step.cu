// lif_step: one fused LIF membrane update, elementwise over the neurons.
//
// Replaces the TPU kernel lif_step_fwd (_lif_kernel) of
// src/repro/kernels/lif_step/lif_step.py, in its operation order:
//
//   i_syn  = alpha_syn * i_syn + drive
//   v      = (v + c_mem * (v_leak - v)) + c_mem * i_syn     c_mem = 1 - alpha_mem
//   spike  = v > v_th                                        (1.0 or 0.0)
//   v      = (1 - spike) * v + spike * v_reset
//
// Rounding: every product and sum rounds on its own (__fmul_rn, __fadd_rn,
// __fsub_rn), so nvcc contracts nothing into a fused multiply-add and the
// result is the Pallas body's expression evaluated in float32 without FMA.
//
// What bounds it on an H100: bytes.  Three float32 inputs are read once and
// three float32 outputs written once, 24 bytes per neuron against 12
// floating-point operations: at the main shape (8 x 120 chips x 512
// neurons) 11.8 MB, 3.5 us at 3.35 TB/s.
//
// Design: a flat grid over the n elements (any shape, contiguous), one
// element per thread, neighbouring threads on neighbouring addresses so
// loads and stores coalesce.  The ragged edge is masked (i < n) instead of
// padding to the TPU's (8, 128) tiles.

#include <cstdint>
#include <cuda_runtime.h>

namespace lif_step {

constexpr int kThreads = 256;

struct Params {
  float alpha_syn, c_mem, v_leak, v_th, v_reset;
};

__global__ void __launch_bounds__(kThreads)
lif_step_kernel(const float* __restrict__ v_in, const float* __restrict__ i_in,
                const float* __restrict__ drive, int64_t n, Params p,
                float* __restrict__ v_out, float* __restrict__ i_out,
                float* __restrict__ s_out) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n) return;
  const float i_syn = __fadd_rn(__fmul_rn(p.alpha_syn, i_in[k]), drive[k]);
  float v = v_in[k];
  v = __fadd_rn(__fadd_rn(v, __fmul_rn(p.c_mem, __fsub_rn(p.v_leak, v))),
                __fmul_rn(p.c_mem, i_syn));
  const float spike = v > p.v_th ? 1.0f : 0.0f;
  v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, spike), v),
                __fmul_rn(spike, p.v_reset));
  v_out[k] = v;
  i_out[k] = i_syn;
  s_out[k] = spike;
}

__global__ void lif_step_floor_kernel() {}

}  // namespace lif_step

// v, i_syn, drive: float32 [n]; outputs v_out, i_out, s_out float32 [n].
// alpha_syn and c_mem = 1 - alpha_mem as the caller rounded them to float32.
// Returns cudaGetLastError() of the launch.
extern "C" int lif_step_launch(const void* v, const void* i_syn,
                               const void* drive, int64_t n, float alpha_syn,
                               float c_mem, float v_leak, float v_th,
                               float v_reset, void* v_out, void* i_out,
                               void* s_out, void* stream) {
  using namespace lif_step;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  lif_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(i_syn),
      static_cast<const float*>(drive), n,
      Params{alpha_syn, c_mem, v_leak, v_th, v_reset},
      static_cast<float*>(v_out), static_cast<float*>(i_out),
      static_cast<float*>(s_out));
  return static_cast<int>(cudaGetLastError());
}

// The launch floor of lif_step_launch: an empty kernel with its grid and
// block at n elements (chip_smoke.py times it beside the kernel).
extern "C" int lif_step_floor_launch(int64_t n, void* stream) {
  using namespace lif_step;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  lif_step_floor_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
