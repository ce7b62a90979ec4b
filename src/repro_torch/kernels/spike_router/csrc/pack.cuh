// Shared pieces of the spike-router kernels: the bit layout of the LUT
// entries and wire words (owned by repro_torch.core.routing and
// repro_torch.core.events), the block-wide rank of 0/1 flags, the scatter
// tail that applies the rev LUT and the timed lane's queue, and the pieces
// of the single-pass bodies (a thread's run of a row loaded in vector
// words, warp and block prefix sums, the striped rows of the merge_pack
// and spike_router single-scan bodies).
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

// ---------------------------------------------------------------------------
// Single-pass bodies: each thread loads a run of N consecutive items of a
// row at once, and one prefix sum ranks the whole row.
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = 0xffffffffu;

// One thread's run of N consecutive items of type T (4-, 2- or 1-byte),
// held as the 32-bit words they occupy.  load() issues 16-, 8- or 4-byte
// vector loads as the run's address allows, and element loads where the
// row ends inside the run (avail < N items left) or the address is not
// 4-byte aligned (odd rows of odd-length int16 or bool rows).  Items past
// the row's end read as 0.
template <int N, typename T>
struct Run {
  static_assert(sizeof(T) == 1 || sizeof(T) == 2 || sizeof(T) == 4, "T");
  static_assert((N * sizeof(T)) % 4 == 0, "a run fills whole words");
  static constexpr int kPer = 4 / sizeof(T);    // items per word
  static constexpr int kWords = N / kPer;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* __restrict__ p, int avail) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if (avail >= N) {
      if constexpr (kWords % 4 == 0) {
        if (a % 16 == 0) {
          const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
          for (int k = 0; k < kWords / 4; ++k) {
            const uint4 x = q[k];
            w[4 * k] = x.x; w[4 * k + 1] = x.y;
            w[4 * k + 2] = x.z; w[4 * k + 3] = x.w;
          }
          return;
        }
      }
      if constexpr (kWords % 2 == 0) {
        if (a % 8 == 0) {
          const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
          for (int k = 0; k < kWords / 2; ++k) {
            const uint2 x = q[k];
            w[2 * k] = x.x; w[2 * k + 1] = x.y;
          }
          return;
        }
      }
      if (a % 4 == 0) {
        const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
        for (int k = 0; k < kWords; ++k) w[k] = q[k];
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < avail) {
        uint32_t v;
        if constexpr (sizeof(T) == 4) v = static_cast<uint32_t>(p[i]);
        else if constexpr (sizeof(T) == 2) v = static_cast<uint16_t>(p[i]);
        else v = static_cast<uint8_t>(p[i]);
        w[i / kPer] |= v << (8 * sizeof(T) * (i % kPer));
      }
    }
  }

  // Item i, zero-extended (i a compile-time index after unrolling).
  __device__ __forceinline__ uint32_t operator[](int i) const {
    if constexpr (sizeof(T) == 4) return w[i];
    else return (w[i / kPer] >> (8 * sizeof(T) * (i % kPer))) &
                ((1u << (8 * sizeof(T))) - 1u);
  }
};

// Inclusive sum of v over lanes 0..lane of the warp.
__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive prefix of v over the block's threads in order, and the block's
// total in *total.  blockDim.x is a multiple of 32.  One barrier: each warp
// publishes its sum, then every warp scans the (at most 32) warp sums
// itself.  warp_sums (32 ints of shared memory) must not be written again
// before the caller's next barrier.
__device__ __forceinline__ int block_exclusive(int v, int* warp_sums,
                                               int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive(v);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  const int mine = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane]
                                                            : 0;
  const int sums = warp_inclusive(mine);
  *total = __shfl_sync(kFullMask, sums, 31);
  return __shfl_sync(kFullMask, sums - mine, warp) + incl - v;
}


// ---------------------------------------------------------------------------
// Striped rows: the single-scan bodies of merge_pack and spike_router.
// A warp ranks a segment of S stripes of a row: stripe k holds events
// [128k, 128k + 128) of the segment, lane l its run of kRun at 128k + 4l,
// so each load instruction of the warp reads one contiguous stretch (16
// bytes a lane for int32).  The events before (k, l, j) are the segment's
// stripes before k, the lanes before l in stripe k, and the run's slots
// before j: one warp scan over the lanes' S run counts, packed a byte
// each, gives them all.  A row of several segments takes a warp each and
// one block scan over the segments' totals.  Kept events are staged in
// shared memory at their slots and then emitted slot by slot, stores
// contiguous across threads, empty slots zeroed.
// ---------------------------------------------------------------------------

constexpr int kRun = 4;                   // consecutive events a lane loads

// The first event of this lane's run k within its warp's segment.
__device__ __forceinline__ int stripe_event(int k) {
  return k * 32 * kRun + (threadIdx.x & 31) * kRun;
}

// Ranks within a warp's segment of S stripes from the lanes' flags
// (flags[k] bit j: event j of run k is kept): run_base[k] is the number of
// kept events of the segment before run k of this lane.  Returns the
// segment's total.
template <int S>
__device__ __forceinline__ int stripe_ranks(const unsigned (&flags)[S],
                                            int (&run_base)[S]) {
  static_assert(S >= 1 && S <= 4, "a stripe's count takes a byte");
  unsigned packed = 0;                    // a stripe holds at most 128
#pragma unroll
  for (int k = 0; k < S; ++k) packed |= __popc(flags[k]) << (8 * k);
  const unsigned incl = warp_inclusive(packed);
  const unsigned excl = incl - packed;
  const unsigned sums = __shfl_sync(kFullMask, incl, 31);
  int seg_total = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    run_base[k] = seg_total + ((excl >> (8 * k)) & 0xFF);
    seg_total += (sums >> (8 * k)) & 0xFF;
  }
  return seg_total;
}

// Where this warp's segment starts in the row's ranks, and the row's total
// in *total: 0 and the segment's total in the warp body; one block scan
// over the warps' segment totals (one barrier) in the block body.
template <bool kBlock>
__device__ __forceinline__ int segment_base(int seg_total, int* warp_sums,
                                            int* total) {
  *total = seg_total;
  if (!kBlock) return 0;
  const int lane = threadIdx.x & 31;
  return __shfl_sync(
      kFullMask, block_exclusive(lane == 0 ? seg_total : 0, warp_sums, total),
      0);
}

// Shared memory a row stages its kept events in: the wire labels (uint16)
// of slots [0, min(n, capacity)) and, timed, their times.
__host__ __device__ inline int stage_len(int n, int capacity) {
  return min(n, capacity);
}
__host__ __device__ inline int stage_bytes(int len, bool timed) {
  return (2 * len + 3) / 4 * 4 + (timed ? 4 * len : 0);
}

}  // namespace spike_router
