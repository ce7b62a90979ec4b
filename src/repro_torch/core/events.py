"""Event-frame representation of sparse spike traffic.

Port of ``src/repro/core/events.py``.  Sparse event streams travel as
fixed-capacity ``EventFrame``s — a dense buffer of labels/timestamps plus a
validity mask.  The pack unit compacts valid events to the front of the
frame in arrival order; overflow beyond ``capacity`` is dropped and counted
(the paper's lossy layer-1 semantics), and invalid slots are zero-filled.

Labels and timestamps are int32 and wire words int16 throughout; torch's
int64 defaults never reach a returned tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LABEL_DTYPE = torch.int32
TIME_DTYPE = torch.int32


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


def empty_frame(capacity: int, batch_shape: tuple[int, ...] = (), *,
                device="cpu") -> EventFrame:
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
