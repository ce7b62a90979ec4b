// exchange_stream: T full exchange rounds of a one-level star in one launch.
//
// Replaces the TPU kernel exchange_stream_fwd (_exchange_stream_kernel) of
// src/repro/kernels/spike_router/spike_router.py.  For every timestep t and
// destination d it computes what the exchange kernel computes for one
// frame: fwd LUT, route enable enables[s, d], source-major merge, pack to
// `capacity` with overflow counted in `dropped`, rev LUT of d.  The routing
// tables and enables are static over the stream, so the stream of T frames
// is the exchange kernel with batch = T: both launch the same bodies
// (exchange_bodies.cuh), so they are equal bit for bit by construction.
//
// What bounds it on an H100: launch latency and the chain of dependent
// memory trips inside a frame.  The main path's call (FULL_BACKPLANE,
// T = 64, 12 sources x 64 slots) reads 64 x 768 labels and flags plus the
// fwd entries of the valid events, and writes 64 x 12 x 256 slots: about
// 1.2 MB, 0.4 us of HBM time.
//
// Design.  The TPU kernel's grid is (destination, timestep), the timestep
// the fast axis, so the destination's rev LUT and enable column stay in
// VMEM across its T frames, and each grid step repeats the frame's fwd
// lookups for its destination.  Here each timestep's frame is looked up
// once and compacted by one block scan, and warps assemble the
// destinations from the compacted runs ("row"); the enable matrix, static
// over the stream, is staged in shared memory.  A stream has few frames
// (64 on the main path, on 132 SMs), so the wrapper splits each frame's
// destinations over `groups` CTAs (ops.row_groups): each loads and
// compacts the frame itself and assembles its share, and the grid fills
// more of the card.  Frames the row body does not take (more than 4,096
// items, more than 32 sources, enables past 48 KiB) run the exchange
// kernel's tile loop ("tiled", a CTA per (destination, timestep)).  A
// CTA per destination walking a run of timesteps, the TPU grid's order,
// was timed slower than that tile loop and is not kept (PERF.md).  The
// wrapper picks the body from the shape (ops.exchange_body_for, the
// exchange kernel's rule).

#include "exchange_bodies.cuh"

// labels: int32 [n_steps, n_src, cap_in]; valid: bool [n_steps, n_src,
// cap_in]; fwd: int32 [n_src, 2^16]; rev: int32 [n_dst, 2^15];
// enables: bool [n_src, n_dst]; outputs: out_l int32 / out_v bool
// [n_steps, n_dst, capacity], dropped int32 [n_steps, n_dst].  body: 0 row
// (`groups` CTAs a timestep), 1 tiled.  Returns the launch's CUDA error
// code, or cudaErrorInvalidValue for a shape outside the body's range.
extern "C" int exchange_stream_launch(const void* labels, const void* valid,
                                      const void* fwd, const void* rev,
                                      const void* enables, int n_steps,
                                      int n_src, int cap_in, int n_dst,
                                      int capacity, int body, int groups,
                                      void* out_l, void* out_v, void* dropped,
                                      void* stream) {
  return spike_router::exchange_body_launch(
      labels, valid, fwd, rev, enables, n_steps, n_src, cap_in, n_dst,
      capacity, body, groups, false, out_l, out_v, dropped, stream);
}

// The launch floor of exchange_stream_launch: an empty kernel with the
// grid, block and shared memory the body would take at this shape
// (chip_smoke.py times it beside the kernel).
extern "C" int exchange_stream_floor_launch(int n_steps, int n_src,
                                            int cap_in, int n_dst,
                                            int capacity, int body,
                                            int groups, void* stream) {
  return spike_router::exchange_body_launch(
      nullptr, nullptr, nullptr, nullptr, nullptr, n_steps, n_src, cap_in,
      n_dst, capacity, body, groups, true, nullptr, nullptr, nullptr, stream);
}
