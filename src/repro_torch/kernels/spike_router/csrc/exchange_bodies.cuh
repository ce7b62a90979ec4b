// The bodies of the plain star's exchange round, shared by the exchange
// kernel (one round per batch row) and the exchange_stream kernel (one
// round per timestep), so that the two cannot drift: the stream of T
// frames is the exchange with batch = T, bit for bit, by construction.
//
// "row": one CTA per frame (batch row or timestep).  Event (s, i) is kept
// for d iff valid, fwd-enabled and enables[s, d]; its slot in d is the sum
// of cnt[s'] over the enabled sources s' < s plus its rank among s's
// fwd-enabled events.  So:
//   1. each thread loads its run of kRowItems frame items (labels and flags
//      in vector words, Run in pack.cuh) and gathers the fwd entries of its
//      valid items, and the block stages the enable matrix in shared
//      memory: every load is issued before the first barrier;
//   2. one block scan (block_exclusive) over the whole frame compacts the
//      fwd-enabled events in arrival order into shared memory (15-bit wire
//      labels as uint16) and marks where each source's run starts, so
//      cnt[s] = start[s + 1] - start[s];
//   3. a warp assembles 128 consecutive slots of one destination d (4 a
//      lane): one warp scan over the sources' counts gives d's bases in
//      registers (lane s: where source s's run begins in d, so up to 32
//      sources), each lane finds its slots' sources by a binary search
//      over the lanes' bases (5 shuffles), reads the wire labels from the
//      compacted runs, and issues its 4 rev gathers together and one
//      vector store; dropped[d] = total_d - min(total_d, capacity).
// No loop walks the merge stream: two barriers per frame, whatever n_src.
// The fwd tables (256 KiB each) and rev tables are read through the
// read-only cache, not staged: a frame touches only the entries its events
// address.  A frame may also be split by destination over `groups` CTAs
// (grid.x), each loading and compacting the frame itself and assembling
// ceil(n_dst / groups) destinations: more, smaller CTAs for a short run of
// frames.
//
// "tiled": frames from more than 32 sources, longer than one CTA takes, or
// whose enables do not fit shared memory run exchange_round:
// grid (n_dst, frames), each 256-thread block walks one frame's merge
// stream in tiles for one destination, repeating the fwd lookups per
// destination.
#pragma once

#include <climits>

#include "pack.cuh"

namespace spike_router {

constexpr int kRowItems = 4;                 // frame items a thread loads
constexpr int kRowThreadsMax = 1024;
constexpr int kRowEvents = kRowItems * kRowThreadsMax;   // 4096
constexpr int kMaxRowSources = 32;           // a source per lane of a warp
constexpr int kSlots = 4;                    // output slots a lane assembles
constexpr int kTaskSlots = 32 * kSlots;      // output slots of a warp task
constexpr int kRowSmemLimit = 48 * 1024;     // no opt-in needed below this

// Shared memory of the row body (ops.row_smem_bytes): start[n_src + 1],
// warp_sums[32], wires[row_events] (uint16) and the enable matrix
// [n_src, n_dst] (uint8).
__host__ __device__ inline int row_smem_bytes(int n_src, int n_dst,
                                              int row_events) {
  return 4 * (n_src + 1 + 32) + 2 * row_events + n_src * n_dst;
}

enum ExchangeBody { kRowBody = 0, kTiledBody = 1 };

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
// tiles.  Every thread of the block must call it (the tiled body).
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


// labels, valid: [frames, n_src, cap_in]; frame b = blockIdx.y, destination
// group blockIdx.x of gridDim.x; outputs [frames, n_dst, capacity] and
// dropped [frames, n_dst].
__global__ void __launch_bounds__(kRowThreadsMax)
exchange_row_kernel(const int32_t* __restrict__ labels,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ fwd,
                    const int32_t* __restrict__ rev,
                    const uint8_t* __restrict__ enables, int n_src,
                    int cap_in, int n_dst, int capacity,
                    int32_t* __restrict__ out_l, uint8_t* __restrict__ out_v,
                    int32_t* __restrict__ dropped) {
  extern __shared__ int smem[];
  int* start = smem;                                 // [n_src + 1]
  int* warp_sums = start + n_src + 1;                // [32]
  uint16_t* wires = reinterpret_cast<uint16_t*>(warp_sums + 32);
  uint8_t* en = reinterpret_cast<uint8_t*>(wires + blockDim.x * kRowItems);

  const int n = n_src * cap_in;
  const int t = threadIdx.x, T = blockDim.x;
  const int64_t b = blockIdx.y;
  const int per_group = (n_dst + gridDim.x - 1) / gridDim.x;
  const int d0 = blockIdx.x * per_group;
  const int n_mine = max(0, min(per_group, n_dst - d0));

  // 1. Loads: the enable matrix, this thread's run of the frame, and the
  //    fwd entries of its valid items.
  for (int k = t; k < n_src * n_dst; k += T) en[k] = enables[k];
  const int e0 = t * kRowItems;
  const int avail = n - e0;
  const int64_t in = b * n + (avail > 0 ? e0 : 0);
  Run<kRowItems, int32_t> lab;
  Run<kRowItems, uint8_t> val;
  lab.load(labels + in, avail);
  val.load(valid + in, avail);
  // Each item's source, and which items start a source's egress frame:
  // one division a thread.
  int src[kRowItems];
  unsigned starts = 0;                     // bit i: item e0 + i opens a frame
  {
    int s = cap_in > 0 ? e0 / cap_in : 0;
    int at = e0 - s * cap_in;
#pragma unroll
    for (int i = 0; i < kRowItems; ++i) {
      src[i] = s;
      starts |= static_cast<unsigned>(at == 0 && e0 + i < n) << i;
      if (++at == cap_in) {
        at = 0;
        ++s;
      }
    }
  }
  int entry[kRowItems];
#pragma unroll
  for (int i = 0; i < kRowItems; ++i)
    entry[i] = val[i] ? __ldg(fwd + static_cast<int64_t>(src[i]) *
                                        kFwdTableSize +
                              (lab[i] & kChipMask))
                      : 0;
  unsigned keep = 0;                       // bit i: item e0 + i is routed
#pragma unroll
  for (int i = 0; i < kRowItems; ++i)
    keep |= static_cast<unsigned>((entry[i] >> kFwdEnableBit) & 1) << i;

  // 2. One scan over the frame: compact the routed events, mark the runs.
  int count;
  int p = block_exclusive(__popc(keep), warp_sums, &count);
#pragma unroll
  for (int i = 0; i < kRowItems; ++i) {
    if ((starts >> i) & 1) start[src[i]] = p;   // source src[i] starts here
    if ((keep >> i) & 1) wires[p++] = entry[i] & kWireMask;
  }
  if (t == 0) {
    start[n_src] = count;
    if (n == 0)
      for (int s = 0; s < n_src; ++s) start[s] = 0;
  }
  __syncthreads();

  // 3. This CTA's destinations' outputs, one warp task at a time:
  //    kTaskSlots consecutive slots (kSlots a lane) of one destination.
  //    The warp builds that destination's bases in registers (lane s: the
  //    slot where source s's run begins, one warp scan over the sources'
  //    counts), and each lane finds its slots' sources by a binary search
  //    over the lanes.  Then the wire labels come from the compacted runs,
  //    the rev gathers of a lane's slots are issued together, and one
  //    vector store writes them.
  const int lane = t & 31, warp = t >> 5, nwarps = T >> 5;
  // At least one task a destination, so capacity 0 still counts its drops.
  const int chunks = max(1, (capacity + kTaskSlots - 1) / kTaskSlots);
  const int tasks = n_mine * chunks;
  const int run_start = lane < n_src ? start[lane] : 0;
  for (int task = warp; task < tasks; task += nwarps) {
    const int dl = task / chunks;
    const int d = d0 + dl;
    const int j0 = (task - dl * chunks) * kTaskSlots + lane * kSlots;
    const int c = lane < n_src && en[lane * n_dst + d]
                      ? start[lane + 1] - start[lane]
                      : 0;
    const int incl = warp_inclusive(c);
    const int total = __shfl_sync(kFullMask, incl, 31);
    // lane s: where s's run begins (nondecreasing in s; past the sources,
    // beyond every slot).
    const int run_base = lane < n_src ? incl - c : INT_MAX;
    const int kept = min(total, capacity);
    if (lane == 0 && task == dl * chunks)
      dropped[b * n_dst + d] = total - kept;
    // Each slot's source: the last lane whose run begins at or before it,
    // by a binary search over the lanes (5 shuffles a slot).
    int src_of[kSlots] = {};
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int probe = min(src_of[k] + step, 31);
        if (__shfl_sync(kFullMask, run_base, probe) <= j0 + k)
          src_of[k] = probe;
      }
    int wire[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int pos = __shfl_sync(kFullMask, run_start, src_of[k]) + j0 + k -
                      __shfl_sync(kFullMask, run_base, src_of[k]);
      wire[k] = j0 + k < kept ? wires[pos] : 0;
    }
    const int32_t* rev_d = rev + static_cast<int64_t>(d) * kRevTableSize;
    int lab_out[kSlots];
    uint32_t ok_out[kSlots / 4] = {};      // byte k % 4: slot j0 + k valid
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int rv = j0 + k < kept ? __ldg(rev_d + wire[k]) : 0;
      const bool ok = (rv >> kRevEnableBit) & 1;
      lab_out[k] = ok ? (rv & kChipMask) : 0;
      ok_out[k / 4] |= static_cast<uint32_t>(ok) << (8 * (k % 4));
    }
    const int64_t o = (b * n_dst + d) * capacity + j0;
    if (j0 + kSlots <= capacity &&
        reinterpret_cast<uintptr_t>(out_l + o) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out_v + o) % 4 == 0) {
#pragma unroll
      for (int g = 0; g < kSlots / 4; ++g) {
        *reinterpret_cast<int4*>(out_l + o + 4 * g) =
            make_int4(lab_out[4 * g], lab_out[4 * g + 1], lab_out[4 * g + 2],
                      lab_out[4 * g + 3]);
        *reinterpret_cast<uint32_t*>(out_v + o + 4 * g) = ok_out[g];
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (j0 + k < capacity) {
          out_l[o + k] = lab_out[k];
          out_v[o + k] = (ok_out[k / 4] >> (8 * (k % 4))) & 1;
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
exchange_tiled_kernel(const int32_t* __restrict__ labels,
                      const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ fwd,
                      const int32_t* __restrict__ rev,
                      const uint8_t* __restrict__ enables, int n_src,
                      int cap_in, int n_dst, int capacity,
                      int32_t* __restrict__ out_l,
                      uint8_t* __restrict__ out_v,
                      int32_t* __restrict__ dropped) {
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

__global__ void exchange_floor_kernel() {}

// The launch of one body over `frames` frames (the row body's frames split
// into `groups` CTAs by destination): grid, block and shared memory.
// False if the shape is outside the body's range.
struct ExchangeConfig {
  dim3 grid;
  int threads = 0, smem = 0;
};

inline bool exchange_config(int body, int frames, int n_src, int cap_in,
                            int n_dst, int capacity, int groups,
                            ExchangeConfig* c) {
  if (body == kTiledBody) {
    c->threads = kThreads;
    c->grid = dim3(n_dst, frames);
    return true;
  }
  const int n = n_src * cap_in;
  if (body != kRowBody || n > kRowEvents || n_src > kMaxRowSources ||
      groups < 1)
    return false;
  const int per_group = (n_dst + groups - 1) / groups;
  const int need = max((n + kRowItems - 1) / kRowItems,
                       32 * per_group *
                           max(1, (capacity + kTaskSlots - 1) / kTaskSlots));
  c->threads = min(kRowThreadsMax, max(32, (need + 31) / 32 * 32));
  c->grid = dim3(groups, frames);
  c->smem = row_smem_bytes(n_src, n_dst, c->threads * kRowItems);
  return c->smem <= kRowSmemLimit;
}

// Launches one body (floor: the empty kernel of the same launch shape).
// Returns the launch's CUDA error code, or cudaErrorInvalidValue for a
// shape outside the body's range.
inline int exchange_body_launch(const void* labels, const void* valid,
                                const void* fwd, const void* rev,
                                const void* enables, int frames, int n_src,
                                int cap_in, int n_dst, int capacity,
                                int body, int groups, bool floor,
                                void* out_l, void* out_v, void* dropped,
                                void* stream) {
  if (frames == 0 || n_dst == 0) return 0;
  ExchangeConfig c;
  if (!exchange_config(body, frames, n_src, cap_in, n_dst, capacity, groups,
                       &c))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (floor) {
    exchange_floor_kernel<<<c.grid, c.threads, c.smem, s>>>();
  } else {
    auto kernel =
        body == kRowBody ? exchange_row_kernel : exchange_tiled_kernel;
    kernel<<<c.grid, c.threads, c.smem, s>>>(
        static_cast<const int32_t*>(labels),
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(fwd),
        static_cast<const int32_t*>(rev),
        static_cast<const uint8_t*>(enables), n_src, cap_in, n_dst, capacity,
        static_cast<int32_t*>(out_l), static_cast<uint8_t*>(out_v),
        static_cast<int32_t*>(dropped));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spike_router
