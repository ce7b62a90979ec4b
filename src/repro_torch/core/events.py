"""Event-frame representation of sparse spike traffic.

Port of ``src/repro/core/events.py``.  Sparse event streams travel as
fixed-capacity ``EventFrame``s — a dense buffer of labels/timestamps plus a
validity mask.  The pack unit compacts valid events to the front of the
frame in arrival order; overflow beyond ``capacity`` is dropped and counted
(the paper's lossy layer-1 semantics), and invalid slots are zero-filled.

Labels and timestamps are int32 and wire words int16 throughout; torch's
int64 defaults never reach a returned tensor.  On the layer-2 link up to
three events share one word and an 8-bit timestamp tag (``pack_words``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import resolve_device

LABEL_DTYPE = torch.int32
TIME_DTYPE = torch.int32

# Layer-2 packing factor: up to three spikes per link word (paper §III).
SPIKES_PER_WORD = 3
# Layer-2 timestamps carry the lower eight bits of the system time.
TIMESTAMP_BITS = 8
TIMESTAMP_MASK = (1 << TIMESTAMP_BITS) - 1


class EventFrame(NamedTuple):
    """A fixed-capacity batch of spike events.

    Attributes:
      labels: int32[..., capacity] spike labels (16-bit payload range).
      times:  int32[..., capacity] event timestamps.
      valid:  bool[..., capacity]  validity mask; invalid slots are padding.
    """

    labels: torch.Tensor
    times: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.labels.shape[-1]

    def count(self) -> torch.Tensor:
        """Valid events per frame, int32[...] (the reference's dtype)."""
        return self.valid.sum(-1, dtype=torch.int32)


def empty_frame(capacity: int, batch_shape: tuple[int, ...] = (), *,
                device=None) -> EventFrame:
    device = resolve_device(device)
    shape = (*batch_shape, capacity)
    return EventFrame(
        labels=torch.zeros(shape, dtype=LABEL_DTYPE, device=device),
        times=torch.zeros(shape, dtype=TIME_DTYPE, device=device),
        valid=torch.zeros(shape, dtype=torch.bool, device=device))


def _scatter_pack(payload: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """Scatter ``payload`` [b, n] to slots ``idx`` (rejected events parked in
    overflow slot ``capacity``, sliced away); empty slots stay 0."""
    out = torch.zeros((payload.shape[0], capacity + 1), dtype=payload.dtype,
                      device=payload.device)
    out.scatter_(1, idx, torch.where(keep, payload, torch.zeros_like(payload)))
    return out[:, :capacity]


def make_frame(labels: torch.Tensor, times: torch.Tensor | None,
               valid: torch.Tensor, capacity: int
               ) -> tuple[EventFrame, torch.Tensor]:
    """Compact events to the front of a capacity-bounded frame.

    An exclusive prefix sum over ``valid`` ranks every event (arrival order
    preserved); events ranked below ``capacity`` scatter to their rank, the
    rest are dropped and counted.  ``times=None`` emits zero timestamps.
    Returns (frame, dropped int32[...]).
    """
    labels = labels.to(LABEL_DTYPE)
    valid = valid.to(torch.bool)
    lead = labels.shape[:-1]
    n = labels.shape[-1]
    if n == 0:
        return (empty_frame(capacity, lead, device=labels.device),
                torch.zeros(lead, dtype=torch.int32, device=labels.device))
    labels2 = labels.reshape(-1, n)
    valid2 = valid.reshape(-1, n)
    ok = valid2.to(torch.int32)
    pos = torch.cumsum(ok, dim=-1, dtype=torch.int32) - ok
    keep = valid2 & (pos < capacity)
    idx = torch.where(keep, pos, capacity).long()
    out_l = _scatter_pack(labels2, idx, keep, capacity)
    if times is None:
        out_t = torch.zeros_like(out_l)
    else:
        out_t = _scatter_pack(times.to(TIME_DTYPE).reshape(-1, n), idx, keep,
                              capacity)
    total = ok.sum(dim=-1, dtype=torch.int32)
    kept = torch.clamp(total, max=capacity)
    slots = torch.arange(capacity, device=labels.device)
    out_v = slots[None, :] < kept[:, None]
    frame = EventFrame(labels=out_l.reshape(*lead, capacity),
                       times=out_t.reshape(*lead, capacity),
                       valid=out_v.reshape(*lead, capacity))
    return frame, (total - kept).reshape(lead)


def make_frame_segmented(labels: torch.Tensor, times: torch.Tensor | None,
                         valid: torch.Tensor, capacity: int,
                         seg_lens: tuple[int, ...], *, compact: bool = False
                         ) -> tuple[EventFrame, torch.Tensor]:
    """Segmented pack unit — bit-exact with ``make_frame``.

    The trailing axis is contiguous segments of ``seg_lens`` slots.  Because
    segments are contiguous, ``base[seg] + within-segment rank`` is the
    global arrival rank, so without ``compact`` the result is ``make_frame``
    on the whole stream.  ``compact=True`` promises every segment's valid
    events are front-compacted; the pack then gathers output slot ``i`` from
    the segment whose cumulative count first exceeds ``i``, at offset
    ``i - base[seg]`` (results are undefined if the promise is broken, as in
    the reference).
    """
    seg_lens = tuple(int(s) for s in seg_lens)
    labels = labels.to(LABEL_DTYPE)
    valid = valid.to(torch.bool)
    n = labels.shape[-1]
    if not seg_lens or min(seg_lens) <= 0 or sum(seg_lens) != n:
        raise ValueError(f"seg_lens {seg_lens} must be positive and sum to "
                         f"the stream length {n}")
    if not compact:
        return make_frame(labels, times, valid, capacity)
    lead = labels.shape[:-1]
    dev = labels.device
    lens = torch.tensor(seg_lens, device=dev)
    starts = torch.cumsum(lens, 0) - lens
    seg_id = torch.repeat_interleave(torch.arange(len(seg_lens), device=dev),
                                     lens)
    ok = valid.reshape(-1, n).to(torch.int32)
    b = ok.shape[0]
    counts = torch.zeros((b, len(seg_lens)), dtype=torch.int32, device=dev)
    counts.index_add_(1, seg_id, ok)
    cum = torch.cumsum(counts, dim=-1, dtype=torch.int32)
    base = cum - counts
    total = cum[:, -1]
    kept = torch.clamp(total, max=capacity)
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)
    seg_of = torch.searchsorted(
        cum, slots[None, :].expand(b, capacity).contiguous(), right=True)
    seg_of = torch.clamp(seg_of, max=len(seg_lens) - 1)
    out_v = slots[None, :] < kept[:, None]
    offset = slots[None, :] - torch.gather(base, 1, seg_of)
    src = torch.where(out_v, starts[seg_of] + offset, 0).long()

    def gather(x):
        g = torch.gather(x.reshape(-1, n), 1, src)
        return torch.where(out_v, g, torch.zeros_like(g))

    out_l = gather(labels)
    out_t = (torch.zeros_like(out_l) if times is None
             else gather(times.to(TIME_DTYPE)))
    frame = EventFrame(labels=out_l.reshape(*lead, capacity),
                       times=out_t.reshape(*lead, capacity),
                       valid=out_v.reshape(*lead, capacity))
    return frame, (total - kept).reshape(lead)


def make_frame_argsort(labels: torch.Tensor, times: torch.Tensor,
                       valid: torch.Tensor, capacity: int
                       ) -> tuple[EventFrame, torch.Tensor]:
    """The seed's stable-argsort compaction, kept as the baseline that pins
    ``make_frame``'s semantics.

    Equal to ``make_frame`` on (labels·valid, times·valid, valid, dropped);
    invalid slots carry the reference's sorted garbage (the invalid events
    in arrival order) rather than zeros.
    """
    labels = labels.to(LABEL_DTYPE)
    times = times.to(TIME_DTYPE)
    valid = valid.to(torch.bool)
    # Stable order on an integer key (0 = valid): valid events first, each
    # group in arrival order.
    order = torch.argsort((~valid).to(torch.int32), dim=-1, stable=True)
    labels = torch.gather(labels, -1, order)
    times = torch.gather(times, -1, order)
    valid = torch.gather(valid, -1, order)
    n = labels.shape[-1]
    total = valid.sum(dim=-1, dtype=torch.int32)
    if n >= capacity:
        frame = EventFrame(labels=labels[..., :capacity],
                           times=times[..., :capacity],
                           valid=valid[..., :capacity])
        return frame, total - frame.valid.sum(dim=-1, dtype=torch.int32)

    def pad(x):
        return torch.cat([x, x.new_zeros((*x.shape[:-1], capacity - n))], -1)

    return (EventFrame(labels=pad(labels), times=pad(times), valid=pad(valid)),
            torch.zeros_like(total))


def concatenate_frames(frames: list[EventFrame], capacity: int
                       ) -> tuple[EventFrame, torch.Tensor]:
    """Merge several frames into one capacity-bounded frame (drops
    overflow)."""
    return make_frame(torch.cat([f.labels for f in frames], dim=-1),
                      torch.cat([f.times for f in frames], dim=-1),
                      torch.cat([f.valid for f in frames], dim=-1), capacity)


# ---------------------------------------------------------------------------
# 16-bit wire format (one int16 word per on-wire event slot)
# ---------------------------------------------------------------------------

# On the MGT lane an event is one 16-bit word: 15 label bits, and the spare
# bit reused as the slot-validity flag.
WIRE_WORD_DTYPE = torch.int16
WIRE_VALID_BIT = 15
WIRE_PAYLOAD_MASK = (1 << WIRE_VALID_BIT) - 1


def pack_wire16(labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Encode (15-bit wire labels, validity) into int16 wire words; invalid
    slots encode as word 0."""
    labels = labels.to(torch.int32) & WIRE_PAYLOAD_MASK
    word = torch.where(valid.to(torch.bool), labels | (1 << WIRE_VALID_BIT),
                       torch.zeros_like(labels))
    return word.to(WIRE_WORD_DTYPE)


def unpack_wire16(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode int16 wire words into (int32 15-bit labels, bool validity)."""
    w = words.to(torch.int32) & 0xFFFF
    return w & WIRE_PAYLOAD_MASK, (w >> WIRE_VALID_BIT) == 1


# ---------------------------------------------------------------------------
# Layer-2 word packing (≤3 spikes per word + shared 8-bit timestamp tag)
# ---------------------------------------------------------------------------


class PackedWords(NamedTuple):
    """Layer-2 packed representation: groups of up to three events per
    word."""

    labels: torch.Tensor  # int32[..., n_words, SPIKES_PER_WORD]
    times: torch.Tensor   # int32[..., n_words]  (lower 8 bits of system time)
    valid: torch.Tensor   # bool[..., n_words, SPIKES_PER_WORD]


def pack_words(frame: EventFrame) -> PackedWords:
    """Pack an event frame into layer-2 words (3 spikes/word).

    The word timestamp is the tag of its first *valid* slot (frames are
    already time-ordered); a word with no valid slot carries tag 0.
    """
    cap = frame.capacity
    n_words = -(-cap // SPIKES_PER_WORD)
    pad = n_words * SPIKES_PER_WORD - cap
    shape = (*frame.labels.shape[:-1], n_words, SPIKES_PER_WORD)

    def words(x):
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)
        return x.reshape(shape)

    labels, times, valid = (words(x) for x in frame)
    # argmax returns the first maximum; it takes no bool, so cast first.
    first_valid = torch.argmax(valid.to(torch.int32), dim=-1, keepdim=True)
    first_time = torch.gather(times, -1, first_valid)[..., 0]
    word_time = torch.where(valid.any(dim=-1), first_time & TIMESTAMP_MASK,
                            torch.zeros_like(first_time))
    return PackedWords(labels=labels, times=word_time, valid=valid)


def unpack_words(words: PackedWords, base_time: int = 0,
                 capacity: int | None = None) -> EventFrame:
    """Unpack layer-2 words back into single events.

    ``base_time`` supplies the upper timestamp bits (the receiving FPGA's
    system time).  ``capacity`` restores the capacity of the frame that was
    packed (``pack_words`` pads it to whole words); ``None`` keeps every
    slot.
    """
    lead = words.labels.shape[:-2]
    cap = words.labels.shape[-2] * SPIKES_PER_WORD
    labels = words.labels.reshape(*lead, cap)
    valid = words.valid.reshape(*lead, cap)
    upper = int(base_time) & ~TIMESTAMP_MASK
    times = (words.times[..., None] + upper).to(TIME_DTYPE) \
        .expand(words.labels.shape).reshape(*lead, cap)
    if capacity is not None:
        if not cap - SPIKES_PER_WORD < capacity <= cap:
            raise ValueError(
                f"capacity {capacity} does not match "
                f"{words.labels.shape[-2]} packed words ({cap} slots)")
        labels = labels[..., :capacity]
        times = times[..., :capacity]
        valid = valid[..., :capacity]
    return EventFrame(labels=labels, times=times, valid=valid)


def words_required(n_events):
    """Number of layer-2 words needed for ``n_events`` spikes (ceil div
    3); an int or an integer tensor."""
    return -(-n_events // SPIKES_PER_WORD)


@dataclasses.dataclass(frozen=True)
class CapacityPolicy:
    """How event-frame capacity is provisioned.

    ``strict`` mirrors hardware (fixed capacity, silent drop + counter);
    ``provisioned`` sizes capacity from an expected-rate bound so gradient
    based training sees loss-free traffic.
    """

    mode: str = "strict"  # "strict" | "provisioned"
    headroom: float = 2.0

    def capacity_for(self, expected_events: int) -> int:
        if self.mode == "provisioned":
            return max(8, int(expected_events * self.headroom))
        return max(8, int(expected_events))
