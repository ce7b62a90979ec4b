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
// What bounds it on an H100: launch latency and the chain of dependent
// memory trips inside a row (labels and flags, then the LUT entries of
// the valid events, then the stores).  The main path's call (8 batch rows x
// 120 chips x 512 neurons into cap_in = 32) reads 2.5 MB of labels and
// flags and writes 0.15 MB: under a microsecond of HBM time.  With labels
// anywhere in int32 the LUT gathers land on random 32-byte sectors of the
// 256 KiB table, and their number sets the pace.
//
// Design ("row"): the rows have merge_pack's shape, and its striped
// single-scan rows carry over (pack.cuh); the two kernels differ in what
// they gather: the fwd entries before the rank here, the rev entries after
// it there.  One CTA per row, a warp per 128 * S events (S stripes of a
// run of 4 a lane; S = 1 up to 4,096 events, 2 up to 8,192): every lane
// loads its runs of labels and flags in vector words, then issues the fwd
// gathers of its valid events together (the LUT through the read-only
// cache: a row touches only the entries its valid events address), so a
// row costs one trip to memory and one to the LUT before any ranking.  One
// block scan ranks the row; the kept wire labels are staged in shared
// memory at their slots and emitted with contiguous stores, empty slots
// zeroed in the same pass.  A warp per row (16 events a lane, merge_pack's
// warp body) was timed slower: its lane's longer chain of loads, gathers
// and staging stores is not hidden by the few warps an SM then holds
// (PERF.md).  "tiled" (longer rows): one 256-thread CTA walks the row in
// tiles of 256 (block_rank), carrying the rank across tiles.  The wrapper
// picks the body from the row length (ops.route_and_pack_body_for).
//
// Labels and flags are read in place: row r of a [outer, inner] grid of
// rows starts at (r / inner) * outer_stride + (r % inner) * inner_stride
// elements (Rows), so a label grid broadcast over the batch (stride 0) or
// a transposed spike raster needs no copy.

#include "pack.cuh"

namespace spike_router {

enum Body { kRowBody = 0, kTiledBody = 1 };
constexpr int kRowThreadsMax = 1024;
constexpr int kStripeEvents = 32 * kRun;                  // 128
constexpr int kRowMax = 2 * kStripeEvents * (kRowThreadsMax / 32);   // 8192

// Where row r of a tensor read in place starts, in elements.  One 32-bit
// division, none for a tensor whose rows fold into one stride (r < inner).
struct Rows {
  int inner;
  int64_t outer_stride, inner_stride;
  __device__ __forceinline__ int64_t at(int r) const {
    const int q = r < inner ? 0 : r / inner;
    return q * outer_stride + static_cast<int64_t>(r - q * inner) *
                                  inner_stride;
  }
};

// The stripes a lane takes in rows of n events.
__host__ __device__ inline int row_stripes(int n) {
  return n <= kRowMax / 2 ? 1 : 2;
}

template <int S>
__global__ void __launch_bounds__(kRowThreadsMax)
spike_router_row_kernel(const int32_t* __restrict__ labels,
                        const uint8_t* __restrict__ valid,
                        const int32_t* __restrict__ lut, int n, int capacity,
                        Rows lab_rows, Rows val_rows,
                        int32_t* __restrict__ out_l,
                        uint8_t* __restrict__ out_v,
                        int32_t* __restrict__ dropped) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[32];
  uint16_t* st_wire = reinterpret_cast<uint16_t*>(smem);
  const int row = blockIdx.x;
  const int seg = (threadIdx.x >> 5) * S * kStripeEvents;
  const int32_t* lab_row = labels + lab_rows.at(row);
  const uint8_t* val_row = valid + val_rows.at(row);

  // This lane's runs of the row, then the fwd entries of its valid events:
  // every load issued before any ranking.
  Run<kRun, int32_t> lab[S];
  Run<kRun, uint8_t> val[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int e = seg + stripe_event(k);
    const int avail = n - e;
    lab[k].load(lab_row + (avail > 0 ? e : 0), avail);
    val[k].load(val_row + (avail > 0 ? e : 0), avail);
  }
  int entry[S][kRun];
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      entry[k][j] = val[k][j] ? __ldg(lut + (lab[k][j] & kChipMask)) : 0;
  unsigned flags[S];                      // bit j: event j of run k routed
#pragma unroll
  for (int k = 0; k < S; ++k) {
    flags[k] = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      flags[k] |= static_cast<unsigned>((entry[k][j] >> kFwdEnableBit) & 1)
                  << j;
  }

  // Ranks: one warp scan per segment, one block scan over the segments.
  int run_base[S];
  int total;
  const int seg_base =
      segment_base<true>(stripe_ranks(flags, run_base), warp_sums, &total);

  // Stage the kept wire labels at their slots.
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int pos = seg_base + run_base[k] +
                      __popc(flags[k] & ((1u << j) - 1u));
      if (((flags[k] >> j) & 1) && pos < capacity)
        st_wire[pos] = entry[k][j] & kWireMask;
    }
  __syncthreads();

  // Emit the row's slots, contiguous across threads; slots past the kept
  // events are zeroed.
  const int64_t out = static_cast<int64_t>(row) * capacity;
  const int kept = min(total, capacity);
  for (int s = threadIdx.x; s < capacity; s += blockDim.x) {
    const bool ok = s < kept;
    out_l[out + s] = ok ? st_wire[s] : 0;
    out_v[out + s] = ok;
  }
  if (threadIdx.x == 0) dropped[row] = total - kept;
}

__global__ void __launch_bounds__(kThreads)
spike_router_tiled_kernel(const int32_t* __restrict__ labels,
                          const uint8_t* __restrict__ valid,
                          const int32_t* __restrict__ lut, int n,
                          int capacity, Rows lab_rows, Rows val_rows,
                          int32_t* __restrict__ out_l,
                          uint8_t* __restrict__ out_v,
                          int32_t* __restrict__ dropped) {
  __shared__ int warp_counts[kWarps];
  const int row = blockIdx.x;
  const int32_t* lab_row = labels + lab_rows.at(row);
  const uint8_t* val_row = valid + val_rows.at(row);
  const int64_t out = static_cast<int64_t>(row) * capacity;
  int offset = 0;  // events ranked in earlier tiles (same in every thread)
  for (int base = 0; base < n; base += kThreads) {
    const int e = base + threadIdx.x;
    bool ok = false;
    int wire = 0;
    if (e < n && val_row[e]) {
      const int entry = __ldg(lut + (lab_row[e] & kChipMask));
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

__global__ void spike_router_floor_kernel() {}

// The grid, block and dynamic shared memory of a body at rows x n; false
// if n is out of the body's range.
struct Config {
  dim3 grid, block;
  int smem = 0;
};

bool config(int body, int rows, int n, int capacity, Config* c) {
  c->grid = dim3(rows);
  switch (body) {
    case kRowBody: {
      if (n > kRowMax) return false;
      const int per_warp = row_stripes(n) * kStripeEvents;
      c->block = dim3(max(32, (n + per_warp - 1) / per_warp * 32));
      c->smem = stage_bytes(stage_len(n, capacity), false);
      return true;
    }
    case kTiledBody:
      c->block = dim3(kThreads);
      return true;
  }
  return false;
}

}  // namespace spike_router

// labels: int32, valid: bool, each [rows, n] read in place: row r starts
// at element (r / inner) * outer_stride + (r % inner) * inner_stride, the
// last dim contiguous (the wrapper's row_layout); lut: int32 [2^16];
// outputs: out_l int32 / out_v bool [rows, capacity], dropped int32
// [rows].  body: 0 row, 1 tiled (the wrapper's route_and_pack_body_for).
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for a
// body whose range excludes n.
extern "C" int spike_router_launch(
    const void* labels, int lab_inner, int64_t lab_outer_stride,
    int64_t lab_inner_stride, const void* valid, int val_inner,
    int64_t val_outer_stride, int64_t val_inner_stride, const void* lut,
    int rows, int n, int capacity, int body, void* out_l, void* out_v,
    void* dropped, void* stream) {
  using namespace spike_router;
  if (rows == 0) return 0;
  Config c;
  if (!config(body, rows, n, capacity, &c) || lab_inner < 1 || val_inner < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows lab_rows{lab_inner, lab_outer_stride, lab_inner_stride};
  const Rows val_rows{val_inner, val_outer_stride, val_inner_stride};
  auto kernel = body == kTiledBody ? spike_router_tiled_kernel
                : row_stripes(n) == 1 ? spike_router_row_kernel<1>
                                      : spike_router_row_kernel<2>;
  kernel<<<c.grid, c.block, c.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(labels), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(lut), n, capacity, lab_rows, val_rows,
      static_cast<int32_t*>(out_l), static_cast<uint8_t*>(out_v),
      static_cast<int32_t*>(dropped));
  return static_cast<int>(cudaGetLastError());
}

// The launch floor of spike_router_launch: an empty kernel with the grid,
// block and shared memory the body would take at this shape (chip_smoke.py
// times it beside the kernel).
extern "C" int spike_router_floor_launch(int rows, int n, int capacity,
                                         int body, void* stream) {
  using namespace spike_router;
  if (rows == 0) return 0;
  Config c;
  if (!config(body, rows, n, capacity, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  spike_router_floor_kernel<<<c.grid, c.block, c.smem,
                              static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
