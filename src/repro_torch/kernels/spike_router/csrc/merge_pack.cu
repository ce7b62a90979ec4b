// merge_pack: merge + capacity pack + rev LUT for pre-routed wire streams.
//
// Replaces the TPU kernel merge_pack_fwd (_merge_pack_kernel) of
// src/repro/kernels/spike_router/spike_router.py.  Per row of the stream
// batch: optional int16 wire-word unpack (15-bit label, valid flag in bit
// 15, ANDed with `valid`); an order-preserving exclusive-prefix-sum pack to
// `capacity`, overflow counted in `dropped`; the rev LUT (bit 16 enables; a
// disabled event keeps its slot, invalid, not dropped); on the timed
// datapath an int32 timestamp lane rides the scatter and gains the
// destination queue r*service + floor(r/cc)*stall of its slot r.
//
// What bounds it on an H100: neither bytes nor operations.  A main-path call
// moves a few MB (e.g. 768 rows x 388 events of int16 words, bool valid and
// int32 times in, 768 x 96 slots out) and does a few integer operations per
// event, so it sits at launch latency, a few microseconds.
//
// Design: one 256-thread block per row walks the row in tiles of 256
// events; each tile ranks its valid events with one warp ballot and a sum of
// the 8 warp counts, and a running offset carries the rank across tiles.
// One global scan serves every segment layout, because contiguous segments'
// base + within-segment rank is the global rank (the TPU's segmented pack is
// a scheduling choice, not a semantic one).  Kept events scatter straight to
// their final slot with the rev LUT applied; the 128 KiB rev table is read
// through the read-only cache (a row touches at most `capacity` entries, so
// staging the table in shared memory would load 32768 entries to use 256).
// Per-row tables: row r uses table r % n_tables, because callers flatten
// [batch, n_tables] streams batch-major.

#include "pack.cuh"

namespace spike_router {

template <bool kWire16, bool kTimed>
__global__ void __launch_bounds__(kThreads)
merge_pack_kernel(const void* __restrict__ labels_,
                  const uint8_t* __restrict__ valid,
                  const int32_t* __restrict__ times,
                  const int32_t* __restrict__ rev, int n_tables, int n,
                  int capacity, Queue q, int32_t* __restrict__ out_l,
                  uint8_t* __restrict__ out_v, int32_t* __restrict__ out_t,
                  int32_t* __restrict__ dropped) {
  __shared__ int warp_counts[kWarps];
  const int64_t row = blockIdx.x;
  const int64_t in = row * n;
  const int64_t out = row * capacity;
  const int32_t* table = rev + (row % n_tables) * kRevTableSize;
  int offset = 0;  // events ranked in earlier tiles (same in every thread)
  for (int base = 0; base < n; base += kThreads) {
    const int e = base + threadIdx.x;
    bool ok = false;
    int wire = 0, time = 0;
    if (e < n) {
      ok = valid[in + e] != 0;
      if (kWire16) {
        const int word =
            static_cast<int>(static_cast<const int16_t*>(labels_)[in + e]) &
            0xFFFF;
        ok = ok && ((word >> kWireValidBit) & 1);
        wire = word & kWireMask;
      } else {
        wire = static_cast<const int32_t*>(labels_)[in + e];
      }
      if (kTimed) time = times[in + e];
    }
    int tile_total;
    const int pos = offset + block_rank(ok, warp_counts, &tile_total);
    if (ok && pos < capacity)
      emit<kTimed>(pos, wire, time, table, q, out_l + out, out_v + out,
                   kTimed ? out_t + out : nullptr);
    offset += tile_total;
  }
  const int kept = min(offset, capacity);
  zero_tail<kTimed>(kept, capacity, out_l + out, out_v + out,
                    kTimed ? out_t + out : nullptr);
  if (threadIdx.x == 0) dropped[row] = offset - kept;
}

template <bool kWire16, bool kTimed>
void launch(const void* labels, const void* valid, const void* times,
            const void* rev, int n_tables, int rows, int n, int capacity,
            Queue q, void* out_l, void* out_v, void* out_t, void* dropped,
            cudaStream_t stream) {
  merge_pack_kernel<kWire16, kTimed><<<rows, kThreads, 0, stream>>>(
      labels, static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(times), static_cast<const int32_t*>(rev),
      n_tables, n, capacity, q, static_cast<int32_t*>(out_l),
      static_cast<uint8_t*>(out_v), static_cast<int32_t*>(out_t),
      static_cast<int32_t*>(dropped));
}

}  // namespace spike_router

// labels: int32 or (wire16) int16 [rows, n]; valid: bool [rows, n];
// times: int32 [rows, n] or null (untimed); rev: int32 [n_tables, 2^15];
// outputs: out_l int32 / out_v bool / out_t int32 [rows, capacity],
// dropped int32 [rows].  Returns cudaGetLastError() of the launch.
extern "C" int merge_pack_launch(const void* labels, int wire16,
                                 const void* valid, const void* times,
                                 const void* rev, int n_tables, int rows,
                                 int n, int capacity, int service, int cc,
                                 int stall, void* out_l, void* out_v,
                                 void* out_t, void* dropped, void* stream) {
  using namespace spike_router;
  if (rows == 0) return 0;
  const Queue q{service, cc, stall};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wire16) {
    if (times)
      launch<true, true>(labels, valid, times, rev, n_tables, rows, n,
                         capacity, q, out_l, out_v, out_t, dropped, s);
    else
      launch<true, false>(labels, valid, times, rev, n_tables, rows, n,
                          capacity, q, out_l, out_v, out_t, dropped, s);
  } else {
    if (times)
      launch<false, true>(labels, valid, times, rev, n_tables, rows, n,
                          capacity, q, out_l, out_v, out_t, dropped, s);
    else
      launch<false, false>(labels, valid, times, rev, n_tables, rows, n,
                           capacity, q, out_l, out_v, out_t, dropped, s);
  }
  return static_cast<int>(cudaGetLastError());
}
