"""Label-LUT spike routing — the paper's §III datapath.

Port of ``src/repro/core/routing.py``.  Forward path (Node-FPGA → Aggregator): a
full 16 bit → 16 bit lookup whose bit 15 is the routing enable and bits
0..14 the on-wire label.  Reverse path (Aggregator → Node-FPGA): a 15 bit →
17 bit lookup whose bit 16 is the enable and bits 0..15 the chip label.
Tables and labels are int32.  Inside the Aggregator spikes are broadcast
all-to-all with static per-route enables (``aggregate``).

The table and enable builders take ``device=`` and build on the card unless
the caller asks for ``"cpu"``, like every entry point of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core.events import (LABEL_DTYPE, EventFrame, make_frame,
                                     make_frame_argsort)

FWD_LABEL_BITS = 16          # chip spike labels entering the fwd LUT
WIRE_LABEL_BITS = 15         # on-wire label (1 MGT bit reserved for commands)
FWD_TABLE_SIZE = 1 << FWD_LABEL_BITS
REV_TABLE_SIZE = 1 << WIRE_LABEL_BITS

FWD_ENABLE_BIT = 15          # fwd LUT output: bit 15 = enable, bits 0..14 = wire label
REV_ENABLE_BIT = 16          # rev LUT output: bit 16 = enable, bits 0..15 = chip label

FWD_ENABLE_MASK = 1 << FWD_ENABLE_BIT
REV_ENABLE_MASK = 1 << REV_ENABLE_BIT
WIRE_LABEL_MASK = (1 << WIRE_LABEL_BITS) - 1
CHIP_LABEL_MASK = (1 << FWD_LABEL_BITS) - 1


class RoutingTables(NamedTuple):
    """Per-node forward + reverse LUTs (one pair per Node-FPGA)."""

    fwd: torch.Tensor  # int32[FWD_TABLE_SIZE]   enable<<15 | wire_label
    rev: torch.Tensor  # int32[REV_TABLE_SIZE]   enable<<16 | chip_label


def _as_labels(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(LABEL_DTYPE)


def build_fwd_table(chip_labels, wire_labels, enabled=None, *,
                    device=None) -> torch.Tensor:
    """Build the 16→16 forward LUT; entries not mentioned are disabled."""
    device = resolve_device(device)
    chip_labels = _as_labels(chip_labels, device)
    wire_labels = _as_labels(wire_labels, device) & WIRE_LABEL_MASK
    if enabled is None:
        enabled = torch.ones_like(chip_labels, dtype=torch.bool)
    values = torch.where(torch.as_tensor(enabled, device=device),
                         wire_labels | FWD_ENABLE_MASK, wire_labels)
    table = torch.zeros(FWD_TABLE_SIZE, dtype=LABEL_DTYPE, device=device)
    table[chip_labels.long()] = values
    return table


def build_rev_table(wire_labels, chip_labels, enabled=None, *,
                    device=None) -> torch.Tensor:
    """Build the 15→17 reverse LUT."""
    device = resolve_device(device)
    wire_labels = _as_labels(wire_labels, device) & WIRE_LABEL_MASK
    chip_labels = _as_labels(chip_labels, device) & CHIP_LABEL_MASK
    if enabled is None:
        enabled = torch.ones_like(wire_labels, dtype=torch.bool)
    values = torch.where(torch.as_tensor(enabled, device=device),
                         chip_labels | REV_ENABLE_MASK, chip_labels)
    table = torch.zeros(REV_TABLE_SIZE, dtype=LABEL_DTYPE, device=device)
    table[wire_labels.long()] = values
    return table


def identity_tables(n_labels: int | None = None, *, device=None
                    ) -> RoutingTables:
    """Identity (fwd, rev) mapping with all routes enabled, n_labels ≤ 2^15."""
    device = resolve_device(device)
    n = REV_TABLE_SIZE if n_labels is None else n_labels
    if n > REV_TABLE_SIZE:
        raise ValueError(f"identity mapping needs labels < 2^15, got {n}")
    ids = torch.arange(n, dtype=LABEL_DTYPE, device=device)
    return RoutingTables(fwd=build_fwd_table(ids, ids, device=device),
                         rev=build_rev_table(ids, ids, device=device))


def lookup_fwd(table: torch.Tensor, labels: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """16-bit chip labels → (15-bit wire labels, routing enable).

    ``table`` is one LUT ``[2^16]`` or one per node ``[n, 2^16]``; in the
    latter case ``labels`` is ``[..., n, k]`` and node ``i`` reads table
    ``i``."""
    entry = _lookup(table, labels.to(LABEL_DTYPE) & CHIP_LABEL_MASK)
    return entry & WIRE_LABEL_MASK, (entry & FWD_ENABLE_MASK) != 0


def lookup_rev(table: torch.Tensor, labels: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """15-bit wire labels → (16-bit chip labels, routing enable); per-node
    tables as in ``lookup_fwd``."""
    entry = _lookup(table, labels.to(LABEL_DTYPE) & WIRE_LABEL_MASK)
    return entry & CHIP_LABEL_MASK, (entry & REV_ENABLE_MASK) != 0


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.dim() == 1:
        return table[idx.long()]
    node = torch.arange(table.shape[0], device=idx.device)[:, None]
    return table[node, idx.long()]


def route_outbound(tables: RoutingTables, frame: EventFrame) -> EventFrame:
    """Node-FPGA egress: fwd LUT + enable masking (timestamps discarded)."""
    wire, en = lookup_fwd(tables.fwd, frame.labels)
    return EventFrame(labels=wire, times=torch.zeros_like(frame.times),
                      valid=frame.valid & en)


def route_inbound(tables: RoutingTables, frame: EventFrame,
                  system_time: int = 0) -> EventFrame:
    """Node-FPGA ingress: rev LUT + enable masking + timestamp re-attach."""
    chip, en = lookup_rev(tables.rev, frame.labels)
    return EventFrame(labels=chip,
                      times=torch.full_like(frame.times, system_time),
                      valid=frame.valid & en)


def full_route_enables(n_nodes: int, self_loops: bool = False, *,
                       device=None) -> torch.Tensor:
    """All-to-all connectivity with optional self-loop suppression."""
    device = resolve_device(device)
    m = torch.ones((n_nodes, n_nodes), dtype=torch.bool, device=device)
    if not self_loops:
        m &= ~torch.eye(n_nodes, dtype=torch.bool, device=device)
    return m


def feedforward_route_enables(n_nodes: int, *, device=None) -> torch.Tensor:
    """Chain topology: node i feeds node i+1 (layer-per-chip networks)."""
    device = resolve_device(device)
    m = torch.zeros((n_nodes, n_nodes), dtype=torch.bool, device=device)
    idx = torch.arange(n_nodes - 1, device=device)
    m[idx, idx + 1] = True
    return m


def fan_in_route_enables(n_nodes: int, receiver: int, *, device=None
                         ) -> torch.Tensor:
    """N:1 fan-in, as in the paper's Fig 5 measurement (3 senders, 1
    receiver)."""
    device = resolve_device(device)
    m = torch.zeros((n_nodes, n_nodes), dtype=torch.bool, device=device)
    m[:, receiver] = True
    m[receiver, receiver] = False
    return m


def aggregate(frames: EventFrame, route_enables: torch.Tensor,
              capacity: int) -> tuple[EventFrame, torch.Tensor]:
    """The Aggregator broadcast: all-to-all with static per-route enables.

    frames: stacked per-source frames ``[..., n_src, cap_in]`` (leading dims
    are independent rows); route_enables: bool[n_src, n_dst].  Only the
    validity mask is built per destination: the source-major label and time
    streams are one view shared by every destination.  Returns
    (frames ``[..., n_dst, capacity]``, dropped int32[..., n_dst]); events
    past a destination's capacity are dropped and counted.
    """
    *lead, n_src, cap_in = frames.labels.shape
    n_dst = route_enables.shape[1]
    n = n_src * cap_in
    valid = frames.valid[..., :, None, :] \
        & route_enables.to(torch.bool)[:, :, None]   # [..., src, dst, cap_in]
    valid = valid.transpose(-3, -2).reshape(*lead, n_dst, n)

    def shared(x):
        return x.reshape(*lead, 1, n).expand(*lead, n_dst, n)

    return make_frame(shared(frames.labels), shared(frames.times), valid,
                      capacity)


def aggregate_baseline(frames: EventFrame, route_enables: torch.Tensor,
                       capacity: int) -> tuple[EventFrame, torch.Tensor]:
    """The seed's Aggregator, kept as the baseline that pins ``aggregate``'s
    semantics: materialize the full broadcast, then compact with a stable
    argsort (invalid slots carry sorted garbage, not zeros).

    frames: ``[n_src, cap_in]``; returns (frames ``[n_dst, capacity]``,
    dropped ``[n_dst]``).
    """
    n_src, cap_in = frames.labels.shape
    n_dst = route_enables.shape[1]

    def broadcast(x):
        return x[:, None, :].expand(n_src, n_dst, cap_in).transpose(0, 1) \
            .reshape(n_dst, n_src * cap_in)

    valid = frames.valid[:, None, :] & route_enables.to(torch.bool)[:, :, None]
    valid = valid.transpose(0, 1).reshape(n_dst, n_src * cap_in)
    return make_frame_argsort(broadcast(frames.labels),
                              broadcast(frames.times), valid, capacity)
