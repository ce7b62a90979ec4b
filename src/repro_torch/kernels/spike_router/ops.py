"""Public wrappers of the exchange kernels.

``route_and_pack``         the Node-FPGA's egress stage: fwd LUT, enable bit
                           and capacity pack per row — the ``spike_router``
                           kernel.
``fused_exchange``         one full round of a one-level star (fwd LUT →
                           route enables → merge → pack → rev LUT) for every
                           destination and batch row — the ``exchange``
                           kernel.
``fused_exchange_stream``  T such rounds in one launch, the routing tables
                           and enables static across the T frames — the
                           ``exchange_stream`` kernel, the streaming engine
                           of the plain star.
``fused_merge_pack``       merge + pack + rev LUT for streams whose fwd LUT
                           and route enables were already applied — the
                           ``merge_pack`` kernel, the merge tail of every
                           other exchange.

On CPU tensors each runs its plain version (``ref.py``); on CUDA tensors
it launches its kernel and counts the launch in its ``launches`` attribute.
Each kernel has several bodies, picked from the shape by
``route_and_pack_body_for``, ``exchange_body_for`` (the exchange and the
streaming exchange) and ``merge_pack_body_for``, and counted in
``launches_by_path`` too.  This is a dispatch, not a fallback: a launch
outside its body's range, or one that fails, raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.routing import FWD_TABLE_SIZE, REV_TABLE_SIZE
from repro_torch.kernels import INT, PTR, check, launcher, on_card, stream
from repro_torch.kernels.spike_router import ref as _ref


# Bodies of the exchange and exchange_stream kernels
# (csrc/exchange_bodies.cuh).
ROW_EVENTS = 4096          # frame items one CTA takes at most (1024 x 4)
MAX_ROW_SOURCES = 32       # sources of the row body (a lane each)
ROW_SMEM_LIMIT = 48 * 1024  # shared memory of the row body
EXCHANGE_BODIES = {"row": 0, "tiled": 1}
# Bodies of the merge_pack kernel (csrc/merge_pack.cu), by row length.
WARP_ROW_MAX = 512         # one warp per row, 16 events a lane
BLOCK_ROW_MAX = 8192       # one CTA of up to 512 threads per row
MERGE_PACK_BODIES = {"warp": 0, "block": 1, "tiled": 2}
# Bodies of the spike_router kernel (csrc/spike_router.cu).
ROUTE_ROW_MAX = 8192       # one CTA per row, a warp per 128 or 256 events
ROUTE_AND_PACK_BODIES = {"row": 0, "tiled": 1}


def row_smem_bytes(n_src: int, n_dst: int) -> int:
    """Shared memory of one CTA of the exchange kernel's row body at most
    (``row_smem_bytes`` in ``exchange_bodies.cuh``): the run starts, the
    warp sums, the compacted wire labels (uint16) of ``ROW_EVENTS`` items
    and the enable matrix."""
    return 4 * (n_src + 1 + 32) + 2 * ROW_EVENTS + n_src * n_dst


def exchange_body_for(n_src: int, cap_in: int, n_dst: int) -> str:
    """The body the exchange kernel runs for frames of ``n_src x cap_in``
    items into ``n_dst`` destinations, from the shape alone: ``"row"`` (one
    CTA per batch row) when the frame has at most ``ROW_EVENTS`` items from
    at most ``MAX_ROW_SOURCES`` sources and its enables fit
    ``ROW_SMEM_LIMIT``, else ``"tiled"`` (one CTA per (destination, batch
    row) walking the merge stream in tiles)."""
    if (n_src * cap_in <= ROW_EVENTS and n_src <= MAX_ROW_SOURCES
            and row_smem_bytes(n_src, n_dst) <= ROW_SMEM_LIMIT):
        return "row"
    return "tiled"


def merge_pack_body_for(n: int) -> str:
    """The body the merge_pack kernel runs for rows of ``n`` events:
    ``"warp"`` (one warp per row, a shuffle scan, no block barrier) up to
    ``WARP_ROW_MAX``, ``"block"`` (one CTA per row, one block scan) up to
    ``BLOCK_ROW_MAX``, ``"tiled"`` (one CTA walking the row in tiles of
    256) beyond."""
    if n <= WARP_ROW_MAX:
        return "warp"
    return "block" if n <= BLOCK_ROW_MAX else "tiled"


def route_and_pack_body_for(n: int) -> str:
    """The body the spike_router kernel runs for rows of ``n`` events:
    ``"row"`` (one CTA per row, a warp per 128 events, 256 past 4,096, one
    block scan) up to ``ROUTE_ROW_MAX``, ``"tiled"`` (one CTA walking the
    row in tiles of 256) beyond."""
    return "row" if n <= ROUTE_ROW_MAX else "tiled"


def row_layout(t: torch.Tensor) -> tuple[int, int, int] | None:
    """How a kernel reads the rows of ``t`` ([..., n]) in place:
    ``(inner, outer_stride, inner_stride)`` such that flattened row ``r``
    starts ``(r // inner) * outer_stride + (r % inner) * inner_stride``
    elements past ``t.data_ptr()``.  The last dim must be contiguous and
    the leading dims must fold into at most two (size-1 dims dropped,
    neighbours merged where one spans the other), as in a contiguous
    tensor, a row grid broadcast over a batch dim (stride 0) or a
    transposed pair of leading dims.  None otherwise."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        return None
    dims: list[tuple[int, int]] = []
    for size, st in zip(t.shape[:-1], t.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == st * size:
            dims[-1] = (dims[-1][0] * size, st)
        else:
            dims.append((size, st))
    if not dims:
        return 1, 0, 0
    if len(dims) == 1:
        return dims[0][0], 0, dims[0][1]
    if len(dims) == 2:
        return dims[1][0], dims[0][1], dims[1][1]
    return None


def _in_place(t: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """``t`` and its ``row_layout``; a layout the kernels cannot read in
    place is copied to a contiguous one first."""
    layout = row_layout(t)
    if layout is None:
        t = t.contiguous()
        layout = row_layout(t)
    return t, layout


def route_and_pack(labels: torch.Tensor, valid: torch.Tensor,
                   lut: torch.Tensor, *, capacity: int):
    """Egress stage: fwd LUT + enable mask + capacity pack.

    labels: int[..., n_events] chip labels (the LUT is indexed by
    ``labels & 0xFFFF``); valid: bool[..., n_events]; lut: int32[2^16].

    Returns (out_labels int32[..., capacity], out_valid bool[..., capacity],
             dropped int32[...]).  Events whose LUT entry is disabled are
    not routed and not counted as dropped.  The kernel reads ``labels``
    and ``valid`` in place where ``row_layout`` allows (a label grid
    expanded over the batch, a transposed raster); other layouts are
    copied first.
    """
    if valid.shape != labels.shape:
        raise ValueError(f"valid shape {tuple(valid.shape)} must match labels "
                         f"shape {tuple(labels.shape)}")
    if tuple(lut.shape) != (FWD_TABLE_SIZE,):
        raise ValueError(f"lut must be [{FWD_TABLE_SIZE}], got "
                         f"{tuple(lut.shape)}")
    if not on_card(labels, valid, lut):
        return _ref.spike_router_ref(labels, valid, lut, capacity=capacity)
    *lead, n = labels.shape
    rows = math.prod(lead)
    labels, lab = _in_place(labels.to(torch.int32))
    valid, val = _in_place(valid.to(torch.bool))
    lut = lut.to(torch.int32).contiguous()
    dev = labels.device
    out_l = torch.empty((*lead, capacity), dtype=torch.int32, device=dev)
    out_v = torch.empty((*lead, capacity), dtype=torch.bool, device=dev)
    dropped = torch.empty(lead, dtype=torch.int32, device=dev)
    body = route_and_pack_body_for(n)
    launch = launcher("spike_router", "spike_router_launch",
                      (PTR, INT, ctypes.c_int64, ctypes.c_int64) * 2
                      + (PTR,) + (INT,) * 4 + (PTR,) * 4)
    check(launch(labels.data_ptr(), *lab, valid.data_ptr(), *val,
                 lut.data_ptr(), rows, n, capacity,
                 ROUTE_AND_PACK_BODIES[body], out_l.data_ptr(),
                 out_v.data_ptr(), dropped.data_ptr(), stream()),
          f"spike_router ({body})")
    route_and_pack.launches += 1
    route_and_pack.launches_by_path[body] += 1
    return out_l, out_v, dropped


route_and_pack.launches = 0
route_and_pack.launches_by_path = dict.fromkeys(ROUTE_AND_PACK_BODIES, 0)


def _check_round(labels, valid, fwd_luts, rev_luts, enables):
    """Argument checks shared by the one-round and the streaming exchange."""
    n_src = labels.shape[-2]
    if valid.shape != labels.shape:
        raise ValueError(f"valid shape {tuple(valid.shape)} must match labels "
                         f"shape {tuple(labels.shape)}")
    if tuple(fwd_luts.shape) != (n_src, FWD_TABLE_SIZE):
        raise ValueError(f"fwd_luts must be [{n_src}, {FWD_TABLE_SIZE}], got "
                         f"{tuple(fwd_luts.shape)}")
    if rev_luts.dim() != 2 or rev_luts.shape[1] != REV_TABLE_SIZE:
        raise ValueError(f"rev_luts must be [n_dst, {REV_TABLE_SIZE}], got "
                         f"{tuple(rev_luts.shape)}")
    if tuple(enables.shape) != (n_src, rev_luts.shape[0]):
        raise ValueError(f"enables must be [{n_src}, {rev_luts.shape[0]}], "
                         f"got {tuple(enables.shape)}")


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
    _check_round(labels, valid, fwd_luts, rev_luts, enables)
    *lead, n_src, cap_in = labels.shape
    n_dst = rev_luts.shape[0]
    if not on_card(labels, valid, fwd_luts, rev_luts, enables):
        return _ref.exchange_ref(labels, valid, fwd_luts, rev_luts, enables,
                                 capacity=capacity)
    body = exchange_body_for(n_src, cap_in, n_dst)
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
                      (PTR,) * 5 + (INT,) * 6 + (PTR,) * 4)
    check(launch(labels.data_ptr(), valid.data_ptr(), fwd_luts.data_ptr(),
                 rev_luts.data_ptr(), enables.data_ptr(), batch, n_src,
                 cap_in, n_dst, capacity, EXCHANGE_BODIES[body],
                 out_l.data_ptr(), out_v.data_ptr(), dropped.data_ptr(),
                 stream()),
          f"exchange ({body})")
    fused_exchange.launches += 1
    fused_exchange.launches_by_path[body] += 1
    return out_l, out_v, dropped


fused_exchange.launches = 0
fused_exchange.launches_by_path = dict.fromkeys(EXCHANGE_BODIES, 0)


def row_groups(n_steps: int, n_dst: int, sms: int) -> int:
    """CTAs a timestep of the ``exchange_stream`` kernel's row body: its
    destinations split into this many groups, each CTA loading and
    compacting the frame itself, as many as keep the grid of
    ``n_steps x groups`` CTAs within one wave of the card's ``sms`` SMs (at
    least 1, at most ``n_dst``)."""
    return max(1, min(n_dst, sms // max(n_steps, 1)))


def fused_exchange_stream(labels: torch.Tensor, valid: torch.Tensor,
                          fwd_luts: torch.Tensor, rev_luts: torch.Tensor,
                          enables: torch.Tensor, *, capacity: int):
    """T full exchange rounds of the plain star in one launch.

    labels, valid: [T, n_src, cap_in] per-timestep egress frames;
    fwd_luts: int32[n_src, 2^16]; rev_luts: int32[n_dst, 2^15];
    enables: bool[n_src, n_dst], static over the stream (routing tables are
    configuration, not data).  Equal, bit for bit, to T ``fused_exchange``
    rounds, and to ``fused_exchange`` with batch = T: the kernel runs the
    exchange kernel's bodies, picked by ``exchange_body_for``, the row body
    with ``row_groups`` CTAs a timestep.

    Returns (out_labels int32[T, n_dst, capacity],
             out_valid bool[T, n_dst, capacity], dropped int32[T, n_dst]).
    """
    if labels.dim() != 3:
        raise ValueError(f"labels must be [T, n_src, cap_in], got "
                         f"{tuple(labels.shape)}")
    _check_round(labels, valid, fwd_luts, rev_luts, enables)
    n_steps, n_src, cap_in = labels.shape
    n_dst = rev_luts.shape[0]
    if not on_card(labels, valid, fwd_luts, rev_luts, enables):
        return _ref.exchange_stream_ref(labels, valid, fwd_luts, rev_luts,
                                        enables, capacity=capacity)
    labels = labels.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    fwd_luts = fwd_luts.to(torch.int32).contiguous()
    rev_luts = rev_luts.to(torch.int32).contiguous()
    enables = enables.to(torch.bool).contiguous()
    dev = labels.device
    out_l = torch.empty((n_steps, n_dst, capacity), dtype=torch.int32,
                        device=dev)
    out_v = torch.empty((n_steps, n_dst, capacity), dtype=torch.bool,
                        device=dev)
    dropped = torch.empty((n_steps, n_dst), dtype=torch.int32, device=dev)
    body = exchange_body_for(n_src, cap_in, n_dst)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = row_groups(n_steps, n_dst, sms) if body == "row" else 1
    launch = launcher("exchange_stream", "exchange_stream_launch",
                      (PTR,) * 5 + (INT,) * 7 + (PTR,) * 4)
    check(launch(labels.data_ptr(), valid.data_ptr(), fwd_luts.data_ptr(),
                 rev_luts.data_ptr(), enables.data_ptr(), n_steps, n_src,
                 cap_in, n_dst, capacity, EXCHANGE_BODIES[body], groups,
                 out_l.data_ptr(), out_v.data_ptr(), dropped.data_ptr(),
                 stream()),
          f"exchange_stream ({body})")
    fused_exchange_stream.launches += 1
    fused_exchange_stream.launches_by_path[body] += 1
    return out_l, out_v, dropped


fused_exchange_stream.launches = 0
fused_exchange_stream.launches_by_path = dict.fromkeys(EXCHANGE_BODIES, 0)


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
    body = merge_pack_body_for(n)
    launch = launcher("merge_pack", "merge_pack_launch",
                      (PTR, INT, PTR, PTR, PTR) + (INT,) * 8 + (PTR,) * 5)
    check(launch(labels.data_ptr(), int(labels.dtype == torch.int16),
                 valid.data_ptr(), None if times is None else times.data_ptr(),
                 rev_lut.data_ptr(), n_tables, rows, n, capacity, service, cc,
                 stall, MERGE_PACK_BODIES[body], out_l.data_ptr(),
                 out_v.data_ptr(), None if out_t is None else out_t.data_ptr(),
                 dropped.data_ptr(), stream()),
          f"merge_pack ({body})")
    fused_merge_pack.launches += 1
    fused_merge_pack.launches_by_path[body] += 1
    if queue is None:
        return out_l, out_v, dropped
    return out_l, out_v, out_t, dropped


fused_merge_pack.launches = 0
fused_merge_pack.launches_by_path = dict.fromkeys(MERGE_PACK_BODIES, 0)
