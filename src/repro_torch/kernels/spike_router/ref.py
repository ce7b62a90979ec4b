"""Plain PyTorch versions of the exchange kernels.

Built on ``repro_torch.core`` (the port's semantic implementation), as the
reference's ``repro/kernels/spike_router/ref.py`` is built on
``src/repro/core/``.  The wrappers in ``ops.py`` run these on CPU tensors, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.events import (make_frame, make_frame_segmented,
                                     unpack_wire16)
from repro_torch.core.latency import queue_wait_i32
from repro_torch.core.routing import lookup_fwd, lookup_rev


def pack_indices(ok: torch.Tensor, capacity: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter index map of the global pack unit, the twin of the
    reference's ``spike_router._pack_indices``: exclusive-prefix-sum ranks
    bounded by ``capacity``, rejected events parked in overflow slot
    ``capacity``.  ``ok``: int or bool ``[..., n]``, each row one stream.
    Returns ``(idx int32[..., n], keep bool[..., n])``.  This is the
    write-set of every pack unit (``make_frame``, the kernels' scans in
    ``csrc/pack.cuh``); ``analysis.kernelcheck`` model-checks it."""
    ok = ok.to(torch.int32)
    pos = torch.cumsum(ok, dim=-1, dtype=torch.int32) - ok
    keep = (ok == 1) & (pos < capacity)
    return torch.where(keep, pos, capacity), keep


def pack_segmented_indices(ok: torch.Tensor, capacity: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter index map of the segmented pack unit, the twin of
    ``spike_router._pack_segmented_indices`` (``ok``: ``[..., n_seg,
    seg_len]``): per-segment exclusive ranks plus an exclusive scan over
    the segment totals for the base offsets, so ``base[seg] + within`` is
    the global arrival rank.  Returns ``(idx, keep)`` on the flattened
    stream ``[..., n_seg · seg_len]``, overflow parked in slot
    ``capacity`` as in ``pack_indices``."""
    ok = ok.to(torch.int32)
    counts = ok.sum(dim=-1, dtype=torch.int32)
    base = torch.cumsum(counts, dim=-1, dtype=torch.int32) - counts
    within = torch.cumsum(ok, dim=-1, dtype=torch.int32) - ok
    pos = (base[..., None] + within).flatten(-2)
    okf = ok.flatten(-2)
    keep = (okf == 1) & (pos < capacity)
    return torch.where(keep, pos, capacity), keep


def dest_queue_ns(capacity: int, queue: tuple[int, int, int],
                  device) -> torch.Tensor:
    """Destination-side queueing delay by pack rank (== output slot)."""
    return queue_wait_i32(torch.arange(capacity, dtype=torch.int32,
                                       device=device), queue)


def spike_router_ref(labels, valid, lut, *, capacity: int):
    """The egress stage, matching the ``spike_router`` kernel: fwd LUT
    (indexed by ``labels & 0xFFFF``), enable bit, capacity pack.

    labels, valid: [..., n_events]; lut: int32[2^16].
    Returns (out_labels int32[..., capacity], out_valid bool[..., capacity],
             dropped int32[...]); disabled events are neither kept nor
    counted as dropped.
    """
    wire, enabled = lookup_fwd(lut, labels)
    frame, dropped = make_frame(wire, None, valid.to(torch.bool) & enabled,
                                capacity)
    return frame.labels, frame.valid, dropped


def exchange_ref(labels, valid, fwd_luts, rev_luts, enables, *,
                 capacity: int):
    """One exchange round, matching the ``exchange`` kernel.

    labels, valid: [..., n_src, cap_in]; fwd_luts: int32[n_src, 2^16];
    rev_luts: int32[n_dst, 2^15]; enables: bool[n_src, n_dst].
    Returns (out_labels int32[..., n_dst, capacity],
             out_valid bool[..., n_dst, capacity], dropped int32[..., n_dst]).
    """
    *lead, n_src, cap_in = labels.shape
    n_dst = enables.shape[1]
    wire, fwd_en = lookup_fwd(fwd_luts, labels)
    ok = (valid.to(torch.bool) & fwd_en)[..., :, None, :] \
        & enables.to(torch.bool)[:, :, None]          # [..., src, dst, cap_in]
    ok = ok.transpose(-3, -2).reshape(*lead, n_dst, n_src * cap_in)
    stream = wire.reshape(*lead, 1, n_src * cap_in).expand(ok.shape)
    frame, dropped = make_frame_segmented(stream, None, ok, capacity,
                                          (cap_in,) * n_src)
    chip, rev_en = lookup_rev(rev_luts, frame.labels)
    out_valid = frame.valid & rev_en
    return (torch.where(out_valid, chip, torch.zeros_like(chip)), out_valid,
            dropped)


def exchange_stream_ref(labels, valid, fwd_luts, rev_luts, enables, *,
                        capacity: int):
    """T exchange rounds, matching the ``exchange_stream`` kernel:
    ``exchange_ref`` with the timestep as its leading dim.

    labels, valid: [T, n_src, cap_in].
    Returns (out_labels int32[T, n_dst, capacity],
             out_valid bool[T, n_dst, capacity], dropped int32[T, n_dst]).
    """
    return exchange_ref(labels, valid, fwd_luts, rev_luts, enables,
                        capacity=capacity)


def merge_pack_ref(labels, valid, rev_lut, *, capacity: int,
                   seg_lens: tuple[int, ...] | None = None,
                   compact: bool = False, times=None,
                   queue: tuple[int, int, int] | None = None):
    """Merge + pack + rev LUT, matching the ``merge_pack`` kernel.

    labels, valid: [..., n_events]; ``labels`` is int32 wire labels or int16
    wire words whose embedded valid bit is ANDed with ``valid``.
    rev_lut: int32[2^15] shared, or int32[n_tables, 2^15] with stream ``r``
    (leading dims flattened) reading table ``r % n_tables``.
    Returns (out_labels int32[..., capacity], out_valid bool[..., capacity],
    [out_times int32[..., capacity] when timed,] dropped int32[...]).
    """
    valid = valid.to(torch.bool)
    if labels.dtype == torch.int16:
        labels, word_valid = unpack_wire16(labels)
        valid = valid & word_valid
    if seg_lens is None:
        frame, dropped = make_frame(labels, times, valid, capacity)
    else:
        frame, dropped = make_frame_segmented(labels, times, valid, capacity,
                                              seg_lens, compact=compact)
    packed = frame.labels
    if rev_lut.dim() == 2:
        rows = frame.valid.shape[:-1].numel()
        packed = packed.reshape(rows // rev_lut.shape[0], rev_lut.shape[0],
                                capacity)
    chip, rev_en = lookup_rev(rev_lut, packed)
    chip = chip.reshape(frame.labels.shape)
    out_valid = frame.valid & rev_en.reshape(frame.valid.shape)
    out_labels = torch.where(out_valid, chip, torch.zeros_like(chip))
    if queue is None:
        return out_labels, out_valid, dropped
    arrive = frame.times + dest_queue_ns(capacity, queue, labels.device)
    out_times = torch.where(out_valid, arrive, torch.zeros_like(arrive))
    return out_labels, out_valid, out_times, dropped
