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
// What bounds it on an H100: launch latency and the chain of dependent
// memory round trips.  The main path's call reads 8 x 12 x 256 labels and
// flags plus at most that many fwd entries, and writes 8 x 12 x 256 slots:
// well under a megabyte, a 0.09 us byte bound.
//
// Design (the "row" body, exchange_bodies.cuh): a batch row's frame is
// looked up once and compacted by one block scan, and warps assemble every
// destination from the compacted runs; two barriers per row, no loop over
// the merge stream.  What is left of the
// time is three dependent trips to memory (frame, fwd entries, rev
// entries) and the on-chip phases between them, which issue from one SM
// per row.
//
// How the work is spread: one CTA per batch row ("row"), up to kRowEvents
// frame items (1024 threads x 4) from up to 32 sources.  A thread-block
// cluster per row, its CTAs sharing the compacted runs through distributed
// shared memory, was built and timed at the main shape and lost to the one
// CTA (its launch, cluster barriers and remote reads cost more than the SMs
// it adds; PERF.md), so it is not kept.  "tiled": a frame from more than 32
// sources, longer than one CTA takes, or whose enables do not fit shared
// memory runs exchange_round: grid (n_dst, batch), each
// 256-thread block walks the merge stream in tiles, repeating the fwd
// lookups per destination.  Both bodies live in exchange_bodies.cuh, shared
// with exchange_stream.  The wrapper picks the body from the shape
// (ops.exchange_body_for).

#include "exchange_bodies.cuh"

// labels: int32 [batch, n_src, cap_in]; valid: bool [batch, n_src, cap_in];
// fwd: int32 [n_src, 2^16]; rev: int32 [n_dst, 2^15];
// enables: bool [n_src, n_dst]; outputs: out_l int32 / out_v bool
// [batch, n_dst, capacity], dropped int32 [batch, n_dst].  body: 0 row,
// 1 tiled (the wrapper's exchange_body_for).  Returns the launch's CUDA
// error code, or cudaErrorInvalidValue for a shape outside the body's
// range.
extern "C" int exchange_launch(const void* labels, const void* valid,
                               const void* fwd, const void* rev,
                               const void* enables, int batch, int n_src,
                               int cap_in, int n_dst, int capacity, int body,
                               void* out_l, void* out_v, void* dropped,
                               void* stream) {
  return spike_router::exchange_body_launch(
      labels, valid, fwd, rev, enables, batch, n_src, cap_in, n_dst, capacity,
      body, 1, false, out_l, out_v, dropped, stream);
}

// The launch floor of exchange_launch: an empty kernel with the grid,
// block and shared memory the body would take at this shape (chip_smoke.py
// times it beside the kernel).
extern "C" int exchange_floor_launch(int batch, int n_src, int cap_in,
                                     int n_dst, int capacity, int body,
                                     void* stream) {
  return spike_router::exchange_body_launch(
      nullptr, nullptr, nullptr, nullptr, nullptr, batch, n_src, cap_in,
      n_dst, capacity, body, 1, true, nullptr, nullptr, nullptr, stream);
}
