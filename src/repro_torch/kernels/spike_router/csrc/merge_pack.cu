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
// moves a few MB (e.g. 768 rows x 388 events of int32 labels, bool valid and
// int32 times in, 768 x 96 slots out) and does a few integer operations per
// event, so it sits at launch latency and at the chain of dependent memory
// round trips inside a row: load the row, rank it, gather the rev entries,
// store.
//
// Design: every lane loads its runs of a row (labels or wire words, flags,
// times; 4 events a run, in vector words where the row's alignment allows:
// Run, pack.cuh) at once, so a row costs one round trip to memory before
// any ranking.  One prefix sum ranks the whole row: one global scan serves
// every segment layout, because contiguous segments' base +
// within-segment rank is the global rank (the TPU's segmented pack is a
// scheduling choice, not a semantic one).  The kept events are staged in
// shared memory at their slots; then the row's threads walk the slots:
// the rev entries (the 128 KiB table through the read-only cache: a row
// touches at most `capacity` entries) are gathered together and the
// stores, empty slots zeroed, are contiguous across threads.  Gathering
// the rev entries before staging, and scattering each event straight to
// its slot, both timed slower on the card (PERF.md, section 6).
// Three bodies, picked by the wrapper from the row length n:
//   warp  (n <= 512):   one warp per row, kRowsPerCta rows per CTA, one
//                       warp scan and no block barrier;
//   block (n <= 8192):  one CTA per row, a warp per 512 events, the warps'
//                       counts summed by one block scan (one barrier);
//   tiled (longer):     one 256-thread CTA walks the row in tiles of 256
//                       (block_rank), carrying the rank across tiles.
// Per-row tables: row r uses table r % n_tables, because callers flatten
// [batch, n_tables] streams batch-major.

#include <type_traits>

#include "pack.cuh"

namespace spike_router {

constexpr int kStripes = 4;               // runs a lane takes in its segment
constexpr int kItems = kRun * kStripes;   // 16 events a lane
constexpr int kWarpRowMax = 32 * kItems;  // 512: a warp's segment of a row
constexpr int kRowsPerCta = 4;            // warp body
constexpr int kBlockThreadsMax = 512;
constexpr int kBlockRowMax = kBlockThreadsMax * kItems;   // 8192
constexpr int kSmemDefault = 48 * 1024 - 128;  // beyond it: opt in (+ warp_sums)
enum Body { kWarpBody = 0, kBlockBody = 1, kTiledBody = 2 };

template <bool kWire16>
using Label = typename std::conditional<kWire16, int16_t, int32_t>::type;

// The warp and block bodies (striped rows, pack.cuh): the row's threads
// walk the staged slots kEmit at a time each, rev gathers together, stores
// contiguous across threads, empty slots zeroed.
constexpr int kEmit = 4;

template <bool kWire16, bool kTimed, bool kBlock>
__global__ void __launch_bounds__(kBlock ? kBlockThreadsMax
                                         : 32 * kRowsPerCta)
merge_pack_scan_kernel(const void* __restrict__ labels_,
                       const uint8_t* __restrict__ valid,
                       const int32_t* __restrict__ times,
                       const int32_t* __restrict__ rev, int rows,
                       int n_tables, int n, int capacity, Queue q,
                       int32_t* __restrict__ out_l,
                       uint8_t* __restrict__ out_v,
                       int32_t* __restrict__ out_t,
                       int32_t* __restrict__ dropped) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = kBlock ? blockIdx.x
                             : static_cast<int64_t>(blockIdx.x) * kRowsPerCta +
                                   warp;
  if (!kBlock && row >= rows) return;     // a whole warp: no barrier follows
  const int seg = kBlock ? warp * kWarpRowMax : 0;
  const int len = stage_len(n, capacity);
  char* stage = reinterpret_cast<char*>(smem) +
                (kBlock ? 0 : warp * stage_bytes(len, kTimed));
  uint16_t* st_wire = reinterpret_cast<uint16_t*>(stage);
  int32_t* st_time =
      reinterpret_cast<int32_t*>(stage + (2 * len + 3) / 4 * 4);

  // This lane's runs of the row: every load issued before any ranking.
  Run<kRun, Label<kWire16>> lab[kStripes];
  Run<kRun, uint8_t> val[kStripes];
  Run<kRun, int32_t> tim[kStripes];
#pragma unroll
  for (int k = 0; k < kStripes; ++k) {
    const int e = seg + stripe_event(k);
    const int avail = n - e;
    const int64_t in = row * n + (avail > 0 ? e : 0);
    lab[k].load(static_cast<const Label<kWire16>*>(labels_) + in, avail);
    val[k].load(valid + in, avail);
    if (kTimed) tim[k].load(times + in, avail);
  }
  unsigned flags[kStripes];               // bit j: event j of run k is valid
#pragma unroll
  for (int k = 0; k < kStripes; ++k) {
    flags[k] = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      bool ok = val[k][j] != 0;
      if (kWire16) ok = ok && ((lab[k][j] >> kWireValidBit) & 1);
      flags[k] |= static_cast<unsigned>(ok) << j;
    }
  }

  // Ranks: one warp scan, and in the block body one block scan.
  int run_base[kStripes];
  int total;
  const int seg_base =
      segment_base<kBlock>(stripe_ranks(flags, run_base), warp_sums, &total);

  // Stage the kept events at their slots.
#pragma unroll
  for (int k = 0; k < kStripes; ++k)
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int pos = seg_base + run_base[k] +
                      __popc(flags[k] & ((1u << j) - 1u));
      if (((flags[k] >> j) & 1) && pos < capacity) {
        st_wire[pos] = lab[k][j] & kWireMask;
        if (kTimed) st_time[pos] = static_cast<int>(tim[k][j]);
      }
    }
  if (kBlock) __syncthreads();
  else __syncwarp();

  // Emit the row's slots: the rev entries of kEmit slots a thread first,
  // then their stores, contiguous across threads; slots past the kept
  // events are zeroed.
  const int32_t* table = rev + (row % n_tables) * kRevTableSize;
  const int64_t out = row * capacity;
  const int kept = min(total, capacity);
  const int t = kBlock ? threadIdx.x : lane;
  const int stride = kBlock ? blockDim.x : 32;
  // floor(r / cc) is 0 for every slot r < capacity <= cc: skip the division.
  const Queue qs{q.service, capacity <= q.cc ? 0 : q.cc, q.stall};
  for (int s0 = t; s0 < capacity; s0 += kEmit * stride) {
    int entry[kEmit];
#pragma unroll
    for (int m = 0; m < kEmit; ++m) {
      const int s = s0 + m * stride;
      entry[m] = s < kept ? __ldg(table + st_wire[s]) : 0;
    }
#pragma unroll
    for (int m = 0; m < kEmit; ++m) {
      const int s = s0 + m * stride;
      if (s < capacity) {
        const bool en = (entry[m] >> kRevEnableBit) & 1;
        out_l[out + s] = en ? (entry[m] & kChipMask) : 0;
        out_v[out + s] = en;
        if (kTimed) out_t[out + s] = en ? st_time[s] + qs.wait(s) : 0;
      }
    }
  }
  if (t == 0) dropped[row] = total - kept;
}

template <bool kWire16, bool kTimed>
__global__ void __launch_bounds__(kThreads)
merge_pack_tiled_kernel(const void* __restrict__ labels_,
                        const uint8_t* __restrict__ valid,
                        const int32_t* __restrict__ times,
                        const int32_t* __restrict__ rev, int rows,
                        int n_tables, int n, int capacity, Queue q,
                        int32_t* __restrict__ out_l,
                        uint8_t* __restrict__ out_v,
                        int32_t* __restrict__ out_t,
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

__global__ void merge_pack_floor_kernel() {}

// The grid, block and dynamic shared memory of a body at rows x n; false
// if n is out of the body's range.
struct Config {
  dim3 grid;
  int threads = 0, smem = 0;
};

bool config(int body, int rows, int n, int capacity, bool timed, Config* c) {
  const int stage = stage_bytes(stage_len(n, capacity), timed);
  switch (body) {
    case kWarpBody:
      if (n > kWarpRowMax) return false;
      c->grid = dim3((rows + kRowsPerCta - 1) / kRowsPerCta);
      c->threads = 32 * kRowsPerCta;
      c->smem = kRowsPerCta * stage;
      return true;
    case kBlockBody:
      if (n > kBlockRowMax) return false;
      c->grid = dim3(rows);
      c->threads = max(32, (n + 32 * kItems - 1) / (32 * kItems) * 32);
      c->smem = stage;
      return true;
    case kTiledBody:
      c->grid = dim3(rows);
      c->threads = kThreads;
      return true;
  }
  return false;
}

template <bool kWire16, bool kTimed>
cudaError_t launch(int body, const Config& c, const void* labels,
                   const void* valid, const void* times, const void* rev,
                   int n_tables, int rows, int n, int capacity, Queue q,
                   void* out_l, void* out_v, void* out_t, void* dropped,
                   cudaStream_t stream) {
  auto kernel = body == kWarpBody    ? merge_pack_scan_kernel<kWire16, kTimed,
                                                              false>
                : body == kBlockBody ? merge_pack_scan_kernel<kWire16, kTimed,
                                                              true>
                                     : merge_pack_tiled_kernel<kWire16, kTimed>;
  if (c.smem > kSmemDefault) {          // the block body's longest stages
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<c.grid, c.threads, c.smem, stream>>>(
      labels, static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(times), static_cast<const int32_t*>(rev),
      rows, n_tables, n, capacity, q, static_cast<int32_t*>(out_l),
      static_cast<uint8_t*>(out_v), static_cast<int32_t*>(out_t),
      static_cast<int32_t*>(dropped));
  return cudaGetLastError();
}

}  // namespace spike_router

// labels: int32 or (wire16) int16 [rows, n]; valid: bool [rows, n];
// times: int32 [rows, n] or null (untimed); rev: int32 [n_tables, 2^15];
// outputs: out_l int32 / out_v bool / out_t int32 [rows, capacity],
// dropped int32 [rows].  body: 0 warp, 1 block, 2 tiled (the wrapper's
// merge_pack_body_for).  Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a body whose range excludes n.
extern "C" int merge_pack_launch(const void* labels, int wire16,
                                 const void* valid, const void* times,
                                 const void* rev, int n_tables, int rows,
                                 int n, int capacity, int service, int cc,
                                 int stall, int body, void* out_l,
                                 void* out_v, void* out_t, void* dropped,
                                 void* stream) {
  using namespace spike_router;
  if (rows == 0) return 0;
  Config c;
  if (!config(body, rows, n, capacity, times != nullptr, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const Queue q{service, cc, stall};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (wire16) {
    if (times)
      err = launch<true, true>(body, c, labels, valid, times, rev, n_tables,
                               rows, n, capacity, q, out_l, out_v, out_t,
                               dropped, s);
    else
      err = launch<true, false>(body, c, labels, valid, times, rev, n_tables,
                                rows, n, capacity, q, out_l, out_v, out_t,
                                dropped, s);
  } else {
    if (times)
      err = launch<false, true>(body, c, labels, valid, times, rev, n_tables,
                                rows, n, capacity, q, out_l, out_v, out_t,
                                dropped, s);
    else
      err = launch<false, false>(body, c, labels, valid, times, rev,
                                 n_tables, rows, n, capacity, q, out_l, out_v,
                                 out_t, dropped, s);
  }
  return static_cast<int>(err);
}

// The launch floor of merge_pack_launch: an empty kernel with the grid,
// block and shared memory the body would take at this shape (chip_smoke.py
// times it beside the kernel).
extern "C" int merge_pack_floor_launch(int rows, int n, int capacity,
                                       int timed, int body, void* stream) {
  using namespace spike_router;
  if (rows == 0) return 0;
  Config c;
  if (!config(body, rows, n, capacity, timed, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_pack_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        c.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_pack_floor_kernel<<<c.grid, c.threads, c.smem,
                            static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
