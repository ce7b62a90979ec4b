"""Public wrappers of the exchange kernels.

``fused_exchange``    one full round of a one-level star (fwd LUT → route
                      enables → merge → pack → rev LUT) for every
                      destination and batch row — the ``exchange`` kernel.
``fused_merge_pack``  merge + pack + rev LUT for streams whose fwd LUT and
                      route enables were already applied — the
                      ``merge_pack`` kernel, the merge tail of every other
                      exchange.

On CPU tensors each runs its plain version (``ref.py``); on CUDA tensors
it launches its kernel and counts the launch in its ``launches`` attribute.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.routing import FWD_TABLE_SIZE, REV_TABLE_SIZE
from repro_torch.kernels import INT, PTR, check, launcher, on_card, stream
from repro_torch.kernels.spike_router import ref as _ref


def fused_exchange(labels: torch.Tensor, valid: torch.Tensor,
                   fwd_luts: torch.Tensor, rev_luts: torch.Tensor,
                   enables: torch.Tensor, *, capacity: int):
    """One full exchange round for all destinations.

    labels, valid: [..., n_src, cap_in] per-source egress frames;
    fwd_luts: int32[n_src, 2^16]; rev_luts: int32[n_dst, 2^15];
    enables: bool[n_src, n_dst].

    Returns (out_labels int32[..., n_dst, capacity],
             out_valid bool[..., n_dst, capacity], dropped int32[..., n_dst]).
    """
    *lead, n_src, cap_in = labels.shape
    n_dst = rev_luts.shape[0]
    if valid.shape != labels.shape:
        raise ValueError(f"valid shape {tuple(valid.shape)} must match labels "
                         f"shape {tuple(labels.shape)}")
    if tuple(fwd_luts.shape) != (n_src, FWD_TABLE_SIZE):
        raise ValueError(f"fwd_luts must be [{n_src}, {FWD_TABLE_SIZE}], got "
                         f"{tuple(fwd_luts.shape)}")
    if tuple(rev_luts.shape) != (n_dst, REV_TABLE_SIZE):
        raise ValueError(f"rev_luts must be [n_dst, {REV_TABLE_SIZE}], got "
                         f"{tuple(rev_luts.shape)}")
    if tuple(enables.shape) != (n_src, n_dst):
        raise ValueError(f"enables must be [{n_src}, {n_dst}], got "
                         f"{tuple(enables.shape)}")
    if not on_card(labels, valid, fwd_luts, rev_luts, enables):
        return _ref.exchange_ref(labels, valid, fwd_luts, rev_luts, enables,
                                 capacity=capacity)
    batch = math.prod(lead)
    labels = labels.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    fwd_luts = fwd_luts.to(torch.int32).contiguous()
    rev_luts = rev_luts.to(torch.int32).contiguous()
    enables = enables.to(torch.bool).contiguous()
    dev = labels.device
    out_l = torch.empty((*lead, n_dst, capacity), dtype=torch.int32, device=dev)
    out_v = torch.empty((*lead, n_dst, capacity), dtype=torch.bool, device=dev)
    dropped = torch.empty((*lead, n_dst), dtype=torch.int32, device=dev)
    launch = launcher("exchange", "exchange_launch",
                      (PTR,) * 5 + (INT,) * 5 + (PTR,) * 4)
    check(launch(labels.data_ptr(), valid.data_ptr(), fwd_luts.data_ptr(),
                 rev_luts.data_ptr(), enables.data_ptr(), batch, n_src,
                 cap_in, n_dst, capacity, out_l.data_ptr(),
                 out_v.data_ptr(), dropped.data_ptr(), stream()),
          "exchange")
    fused_exchange.launches += 1
    return out_l, out_v, dropped


fused_exchange.launches = 0


def fused_merge_pack(labels: torch.Tensor, valid: torch.Tensor,
                     rev_lut: torch.Tensor, *, capacity: int,
                     seg_lens: tuple[int, ...] | None = None,
                     compact: bool = False, times: torch.Tensor | None = None,
                     queue: tuple[int, int, int] | None = None):
    """Merge + pack + rev LUT for pre-routed wire-label streams.

    labels, valid: [..., n_events]; ``labels`` is int32 wire labels or int16
    wire words (``events.pack_wire16``) whose embedded valid bit is ANDed
    with ``valid``.  ``valid`` must match ``labels`` slot for slot.
    rev_lut: int32[2^15] shared, or int32[n_tables, 2^15] where stream ``r``
    (leading dims flattened batch-major) reads table ``r % n_tables``.
    seg_lens / compact: the reference's segment layout and its
    front-compaction promise; the plain version honours them, the kernel's
    one global scan gives the same result for every layout.

    Timed datapath: ``times`` int32[..., n_events] rides the pack and
    ``queue`` (static (service_ns, cc_interval, stall_total_ns)) adds the
    destination queue of each output slot; the return gains
    ``out_times int32[..., capacity]`` before ``dropped``.

    Returns (out_labels int32[..., capacity], out_valid bool[..., capacity],
             [out_times,] dropped int32[...]).
    """
    if valid.shape != labels.shape:
        raise ValueError(
            f"valid shape {tuple(valid.shape)} must match labels shape "
            f"{tuple(labels.shape)} slot-for-slot; implicit broadcasting "
            "would mis-rank the merge stream in the pack unit")
    if (times is None) != (queue is None):
        raise ValueError("the timed merge needs both the timestamp lane and "
                         "the static queue constants (times XOR queue given)")
    if times is not None and times.shape != labels.shape:
        raise ValueError(
            f"times shape {tuple(times.shape)} must match labels shape "
            f"{tuple(labels.shape)} slot-for-slot (the lane rides the same "
            "pack)")
    if seg_lens is not None:
        seg_lens = tuple(int(s) for s in seg_lens)
        if sum(seg_lens) != labels.shape[-1]:
            raise ValueError(f"seg_lens {seg_lens} must sum to the stream "
                             f"length {labels.shape[-1]}")
    *lead, n = labels.shape
    rows = math.prod(lead)
    n_tables = 1 if rev_lut.dim() == 1 else rev_lut.shape[0]
    if rev_lut.shape[-1] != REV_TABLE_SIZE or rev_lut.dim() > 2:
        raise ValueError(f"rev_lut must be [{REV_TABLE_SIZE}] or "
                         f"[n_tables, {REV_TABLE_SIZE}], got "
                         f"{tuple(rev_lut.shape)}")
    if rows % n_tables:
        raise ValueError(
            f"per-stream rev LUTs: {n_tables} tables do not tile {rows} "
            f"streams (labels {tuple(labels.shape)})")
    if labels.dtype != torch.int16:       # int16 = wire words, decoded in-kernel
        labels = labels.to(torch.int32)
    if not on_card(labels, valid, rev_lut, times):
        return _ref.merge_pack_ref(labels, valid, rev_lut, capacity=capacity,
                                   seg_lens=seg_lens, compact=compact,
                                   times=times, queue=queue)
    labels = labels.contiguous()
    valid = valid.to(torch.bool).contiguous()
    rev_lut = rev_lut.to(torch.int32).contiguous()
    dev = labels.device
    out_l = torch.empty((*lead, capacity), dtype=torch.int32, device=dev)
    out_v = torch.empty((*lead, capacity), dtype=torch.bool, device=dev)
    dropped = torch.empty(lead, dtype=torch.int32, device=dev)
    out_t = None
    service = cc = stall = 0
    if times is not None:
        times = times.to(torch.int32).contiguous()
        out_t = torch.empty((*lead, capacity), dtype=torch.int32, device=dev)
        service, cc, stall = queue
    launch = launcher("merge_pack", "merge_pack_launch",
                      (PTR, INT, PTR, PTR, PTR) + (INT,) * 7 + (PTR,) * 5)
    check(launch(labels.data_ptr(), int(labels.dtype == torch.int16),
                 valid.data_ptr(), None if times is None else times.data_ptr(),
                 rev_lut.data_ptr(), n_tables, rows, n, capacity, service, cc,
                 stall, out_l.data_ptr(), out_v.data_ptr(),
                 None if out_t is None else out_t.data_ptr(),
                 dropped.data_ptr(), stream()),
          "merge_pack")
    fused_merge_pack.launches += 1
    if queue is None:
        return out_l, out_v, dropped
    return out_l, out_v, out_t, dropped


fused_merge_pack.launches = 0
