// spike_router: the Node-FPGA's egress stage, fwd LUT + enable bit +
// capacity pack, per row of a batch of egress frames.
//
// Replaces the TPU kernel spike_router_fwd (_router_kernel) of
// src/repro/kernels/spike_router/spike_router.py.  For row r: each valid
// event's label, masked to 16 bits (labels & 0xFFFF, as the reference
// indexes), looks up the fwd LUT; bit 15 enables the event and bits 0..14
// are its wire label.  Enabled events pack to the front of the row in
// arrival order, up to `capacity`; the rest are counted in `dropped`.  An
// event whose entry is disabled is not routed and not counted as dropped.
// Empty slots are zero-filled.  No rev LUT: this is egress only.
//
// What bounds it on an H100: launch latency.  The main path's call (8 batch
// rows x 120 chips x 512 neurons into cap_in = 32) reads 2.5 MB of labels
// and flags and writes 0.15 MB: under a microsecond of HBM time.
//
// Design: one 256-thread block per row walks the row in tiles of 256
// events, ranks the enabled events of a tile with block_rank (pack.cuh) and
// carries the offset across tiles, as the merge_pack kernel does.  Kept
// wire labels scatter straight to their slot.  The 256 KiB LUT is read
// through the read-only cache (__ldg): a row touches only the entries its
// valid events address.

#include "pack.cuh"

namespace spike_router {

__global__ void __launch_bounds__(kThreads)
spike_router_kernel(const int32_t* __restrict__ labels,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ lut, int n, int capacity,
                    int32_t* __restrict__ out_l, uint8_t* __restrict__ out_v,
                    int32_t* __restrict__ dropped) {
  __shared__ int warp_counts[kWarps];
  const int64_t row = blockIdx.x;
  const int64_t in = row * n;
  const int64_t out = row * capacity;
  int offset = 0;  // events ranked in earlier tiles (same in every thread)
  for (int base = 0; base < n; base += kThreads) {
    const int e = base + threadIdx.x;
    bool ok = false;
    int wire = 0;
    if (e < n && valid[in + e]) {
      const int entry = __ldg(lut + (labels[in + e] & kChipMask));
      ok = (entry >> kFwdEnableBit) & 1;
      wire = entry & kWireMask;
    }
    int tile_total;
    const int pos = offset + block_rank(ok, warp_counts, &tile_total);
    if (ok && pos < capacity) {
      out_l[out + pos] = wire;
      out_v[out + pos] = 1;
    }
    offset += tile_total;
  }
  const int kept = min(offset, capacity);
  zero_tail<false>(kept, capacity, out_l + out, out_v + out, nullptr);
  if (threadIdx.x == 0) dropped[row] = offset - kept;
}

}  // namespace spike_router

// labels: int32 [rows, n]; valid: bool [rows, n]; lut: int32 [2^16];
// outputs: out_l int32 / out_v bool [rows, capacity], dropped int32 [rows].
// Returns cudaGetLastError() of the launch.
extern "C" int spike_router_launch(const void* labels, const void* valid,
                                   const void* lut, int rows, int n,
                                   int capacity, void* out_l, void* out_v,
                                   void* dropped, void* stream) {
  using namespace spike_router;
  if (rows == 0) return 0;
  spike_router_kernel<<<rows, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(labels), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(lut), n, capacity,
      static_cast<int32_t*>(out_l), static_cast<uint8_t*>(out_v),
      static_cast<int32_t*>(dropped));
  return static_cast<int>(cudaGetLastError());
}
