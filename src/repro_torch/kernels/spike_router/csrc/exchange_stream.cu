// exchange_stream: T full exchange rounds of a one-level star in one launch,
// each destination's routing state resident while its frames stream through.
//
// Replaces the TPU kernel exchange_stream_fwd (_exchange_stream_kernel) of
// src/repro/kernels/spike_router/spike_router.py.  For every timestep t and
// destination d it computes what the exchange kernel computes for one
// frame: fwd LUT, route enable enables[s, d], source-major merge, pack to
// `capacity` with overflow counted in `dropped`, rev LUT of d.  Both kernels
// run the same device function (exchange_round in pack.cuh), so the stream
// equals T exchange rounds bit for bit.
//
// What bounds it on an H100: launch latency and the serial tile walk of each
// round.  The main path's call (FULL_BACKPLANE, T = 64, 12 sources x 64
// slots) reads 64 x 768 labels and flags plus the fwd entries of the valid
// events, and writes 64 x 12 x 256 slots: about 1.2 MB, 0.4 us of HBM
// time.
//
// Design: the TPU kernel's grid is (destination, timestep) with the
// timestep the fast axis, so the destination's rev LUT and enable column
// stay in VMEM across its T frames.  Here each 256-thread block owns one
// destination and a run of `steps_per_block` consecutive timesteps and
// loops over them: the grid is (n_dst, ceil(T / steps_per_block)).  The
// block loads d's enable column into shared memory once; the rev entries
// its rounds touch (at most steps_per_block x capacity of the 2^15) stay in
// that SM's L1 through the read-only path, so the 128 KiB table is never
// staged whole.  The wrapper picks steps_per_block so the grid still fills
// the card (about two blocks per SM).

#include "pack.cuh"

namespace spike_router {

__global__ void __launch_bounds__(kThreads)
exchange_stream_kernel(const int32_t* __restrict__ labels,
                       const uint8_t* __restrict__ valid,
                       const int32_t* __restrict__ fwd,
                       const int32_t* __restrict__ rev,
                       const uint8_t* __restrict__ enables, int n_steps,
                       int n_src, int cap_in, int n_dst, int capacity,
                       int steps_per_block, int32_t* __restrict__ out_l,
                       uint8_t* __restrict__ out_v,
                       int32_t* __restrict__ dropped) {
  extern __shared__ uint8_t en_col[];  // [n_src]: d's route enables
  __shared__ int warp_counts[kWarps];
  const int d = blockIdx.x;
  const int t0 = blockIdx.y * steps_per_block;
  const int t1 = min(t0 + steps_per_block, n_steps);
  for (int s = threadIdx.x; s < n_src; s += kThreads)
    en_col[s] = enables[s * n_dst + d];
  __syncthreads();
  const int32_t* table = rev + static_cast<int64_t>(d) * kRevTableSize;
  const int64_t frame = static_cast<int64_t>(n_src) * cap_in;
  for (int t = t0; t < t1; ++t) {
    const int64_t row = static_cast<int64_t>(t) * n_dst + d;
    exchange_round(labels + t * frame, valid + t * frame, fwd, table, en_col,
                   1, n_src, cap_in, capacity, out_l + row * capacity,
                   out_v + row * capacity, dropped + row, warp_counts);
  }
}

}  // namespace spike_router

// labels: int32 [n_steps, n_src, cap_in]; valid: bool [n_steps, n_src,
// cap_in]; fwd: int32 [n_src, 2^16]; rev: int32 [n_dst, 2^15];
// enables: bool [n_src, n_dst]; outputs: out_l int32 / out_v bool
// [n_steps, n_dst, capacity], dropped int32 [n_steps, n_dst].
// Returns cudaGetLastError() of the launch.
extern "C" int exchange_stream_launch(const void* labels, const void* valid,
                                      const void* fwd, const void* rev,
                                      const void* enables, int n_steps,
                                      int n_src, int cap_in, int n_dst,
                                      int capacity, int steps_per_block,
                                      void* out_l, void* out_v, void* dropped,
                                      void* stream) {
  using namespace spike_router;
  if (n_steps == 0 || n_dst == 0) return 0;
  if (steps_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_dst, (n_steps + steps_per_block - 1) / steps_per_block);
  exchange_stream_kernel<<<grid, kThreads, n_src,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(labels), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(fwd), static_cast<const int32_t*>(rev),
      static_cast<const uint8_t*>(enables), n_steps, n_src, cap_in, n_dst,
      capacity, steps_per_block, static_cast<int32_t*>(out_l),
      static_cast<uint8_t*>(out_v), static_cast<int32_t*>(dropped));
  return static_cast<int>(cudaGetLastError());
}
