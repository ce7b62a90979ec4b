// Shared pieces of the spike-router kernels: the bit layout of the LUT
// entries and wire words (owned by repro_torch.core.routing and
// repro_torch.core.events), the block-wide rank of 0/1 flags, the scatter
// tail that applies the rev LUT and the timed lane's queue, and the body of
// one full exchange round that the exchange and exchange_stream kernels
// share.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace spike_router {

constexpr int kFwdTableSize = 1 << 16;
constexpr int kRevTableSize = 1 << 15;
constexpr int kWireMask = (1 << 15) - 1;
constexpr int kChipMask = (1 << 16) - 1;
constexpr int kFwdEnableBit = 15;
constexpr int kRevEnableBit = 16;
constexpr int kWireValidBit = 15;

constexpr int kThreads = 256;            // one tile of the stream per pass
constexpr int kWarps = kThreads / 32;

// Exclusive rank of this thread's 0/1 flag within the block's tile, and the
// tile's total in *tile_total.  One ballot per warp, then each thread sums
// the kWarps warp counts from shared memory.  Every thread of the block
// must call it (it synchronises twice; the second lets the next tile reuse
// warp_counts).
__device__ __forceinline__ int block_rank(bool flag, int* warp_counts,
                                          int* tile_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  const int within = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_counts[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();
  *tile_total = total;
  return before + within;
}

// The timed lane's destination queue of pack rank r:
// r*service + floor(r/cc)*stall (repro_torch.core.latency.queue_wait_i32).
struct Queue {
  int service, cc, stall;
  __device__ __forceinline__ int wait(int r) const {
    return r * service + (cc ? (r / cc) * stall : 0);
  }
};

// Write one kept event to output slot `pos` of its row: the rev LUT (read
// through the read-only cache; a row touches at most `capacity` entries of
// its 128 KiB table) gives the chip label and the enable bit.  A disabled
// event keeps its slot, invalid, and is not counted as dropped.
template <bool kTimed>
__device__ __forceinline__ void emit(int pos, int wire, int time,
                                     const int32_t* __restrict__ rev,
                                     Queue q, int32_t* __restrict__ out_l,
                                     uint8_t* __restrict__ out_v,
                                     int32_t* __restrict__ out_t) {
  const int entry = __ldg(rev + (wire & kWireMask));
  const bool en = (entry >> kRevEnableBit) & 1;
  out_l[pos] = en ? (entry & kChipMask) : 0;
  out_v[pos] = en;
  if (kTimed) out_t[pos] = en ? time + q.wait(pos) : 0;
}

// Zero-fill the empty slots [kept, capacity) of one output row.
template <bool kTimed>
__device__ __forceinline__ void zero_tail(int kept, int capacity,
                                          int32_t* __restrict__ out_l,
                                          uint8_t* __restrict__ out_v,
                                          int32_t* __restrict__ out_t) {
  for (int s = kept + threadIdx.x; s < capacity; s += blockDim.x) {
    out_l[s] = 0;
    out_v[s] = 0;
    if (kTimed) out_t[s] = 0;
  }
}

// One full exchange round of one frame for one destination: every source's
// egress frame goes through that source's fwd LUT (bit 15 enables, bits
// 0..14 are the wire label), is gated by the destination's route enable,
// merged source-major (arrival order), packed to `capacity` with overflow
// counted in *dropped, and decoded by the destination's rev LUT `rev`.
//
// labels, valid: the frame [n_src, cap_in]; fwd: int32 [n_src, 2^16];
// en_col: the destination's enable column, entry s at en_col[s * en_stride]
// (global memory or shared); out_l, out_v: the destination's [capacity]
// output row.  The block walks the n_src * cap_in merge stream in tiles,
// ranks the gated events with block_rank and carries the rank across
// tiles.  Every thread of the block must call it.
__device__ __forceinline__ void exchange_round(
    const int32_t* __restrict__ labels, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ fwd, const int32_t* __restrict__ rev,
    const uint8_t* en_col, int en_stride, int n_src, int cap_in, int capacity,
    int32_t* __restrict__ out_l, uint8_t* __restrict__ out_v,
    int32_t* __restrict__ dropped, int* warp_counts) {
  const int n = n_src * cap_in;
  int offset = 0;  // events ranked in earlier tiles (same in every thread)
  for (int base = 0; base < n; base += kThreads) {
    const int e = base + threadIdx.x;
    bool ok = false;
    int wire = 0;
    if (e < n) {
      const int s = e / cap_in;
      if (valid[e] && en_col[s * en_stride]) {
        const int entry = __ldg(fwd + static_cast<int64_t>(s) * kFwdTableSize +
                                (labels[e] & kChipMask));
        ok = (entry >> kFwdEnableBit) & 1;
        wire = entry & kWireMask;
      }
    }
    int tile_total;
    const int pos = offset + block_rank(ok, warp_counts, &tile_total);
    if (ok && pos < capacity)
      emit<false>(pos, wire, 0, rev, Queue{0, 0, 0}, out_l, out_v, nullptr);
    offset += tile_total;
  }
  const int kept = min(offset, capacity);
  zero_tail<false>(kept, capacity, out_l, out_v, nullptr);
  if (threadIdx.x == 0) *dropped = offset - kept;
}

}  // namespace spike_router
