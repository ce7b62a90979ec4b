// exchange: one full exchange round of a one-level star, per destination.
//
// Replaces the TPU kernel exchange_fwd (_exchange_kernel / _exchange_body)
// of src/repro/kernels/spike_router/spike_router.py.  For destination d of
// batch row b: every source's egress frame goes through that source's fwd
// LUT (bit 15 enables, bits 0..14 are the wire label), is gated by the
// route enable enables[s, d], merged source-major (arrival order), packed to
// `capacity` with overflow counted in `dropped`, and decoded by d's rev LUT
// (bit 16 enables; a disabled event keeps its slot, invalid, not dropped).
//
// What bounds it on an H100: launch latency.  The main path's call reads
// 8 x 12 x 256 labels and flags plus at most that many fwd entries, and
// writes 8 x 12 x 256 slots: well under a megabyte.
//
// Design: the grid is (n_dst, batch), one launch per exchange step for all
// batch rows (the reference reaches this kernel under a vmap over them).
// Each 256-thread block runs exchange_round (pack.cuh, shared with the
// exchange_stream kernel) on its (batch row, destination): it walks the
// n_src * cap_in merge stream in tiles, ranks the gated events with a warp
// ballot, carries the rank across tiles, and scatters kept events straight
// to their slot through d's rev LUT.  The 256 KiB fwd tables and the rev
// tables are read through the read-only cache, not staged: a block touches
// only the entries its events address.  The fwd lookups repeat in every
// destination's block; a two-phase design that looks each source event up
// once is later work.

#include "pack.cuh"

namespace spike_router {

__global__ void __launch_bounds__(kThreads)
exchange_kernel(const int32_t* __restrict__ labels,
                const uint8_t* __restrict__ valid,
                const int32_t* __restrict__ fwd,
                const int32_t* __restrict__ rev,
                const uint8_t* __restrict__ enables, int n_src, int cap_in,
                int n_dst, int capacity, int32_t* __restrict__ out_l,
                uint8_t* __restrict__ out_v, int32_t* __restrict__ dropped) {
  __shared__ int warp_counts[kWarps];
  const int d = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t in = b * n_src * cap_in;
  const int64_t row = b * n_dst + d;
  exchange_round(labels + in, valid + in, fwd,
                 rev + static_cast<int64_t>(d) * kRevTableSize, enables + d,
                 n_dst, n_src, cap_in, capacity, out_l + row * capacity,
                 out_v + row * capacity, dropped + row, warp_counts);
}

}  // namespace spike_router

// labels: int32 [batch, n_src, cap_in]; valid: bool [batch, n_src, cap_in];
// fwd: int32 [n_src, 2^16]; rev: int32 [n_dst, 2^15];
// enables: bool [n_src, n_dst]; outputs: out_l int32 / out_v bool
// [batch, n_dst, capacity], dropped int32 [batch, n_dst].
// Returns cudaGetLastError() of the launch.
extern "C" int exchange_launch(const void* labels, const void* valid,
                               const void* fwd, const void* rev,
                               const void* enables, int batch, int n_src,
                               int cap_in, int n_dst, int capacity,
                               void* out_l, void* out_v, void* dropped,
                               void* stream) {
  using namespace spike_router;
  if (batch == 0 || n_dst == 0) return 0;
  const dim3 grid(n_dst, batch);
  exchange_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(labels), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(fwd), static_cast<const int32_t*>(rev),
      static_cast<const uint8_t*>(enables), n_src, cap_in, n_dst, capacity,
      static_cast<int32_t*>(out_l), static_cast<uint8_t*>(out_v),
      static_cast<int32_t*>(dropped));
  return static_cast<int>(cudaGetLastError());
}
