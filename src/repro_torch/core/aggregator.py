"""The Aggregator: star-topology spike exchange (paper §III).

Port of the single-device part of ``src/repro/core/aggregator.py``:
``RouterState`` and ``identity_router``, the stacked per-node LUTs the
hop-graph executor (``repro_torch.core.fabric``) reads, and the legacy
entry points ``route_step`` (one star round), ``route_step_hierarchical``
(the §V two-layer round) and ``route_step_baseline`` (the seed's
materializing datapath).  The first two are thin wrappers over a 1- or
2-level fabric plan and ``fabric_route_step``; which kernel runs is the
dispatch rule's choice (the plain star on CUDA tensors is one ``exchange``
launch).  The sharded star exchange is queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import fabric as fablib
from repro_torch.core import routing
from repro_torch.core.events import EventFrame
from repro_torch.core.fabric import ExchangeDrops
from repro_torch.core.latency import TimedWire


class RouterState(NamedTuple):
    """Static routing state (stacked per-node tables)."""

    fwd_tables: torch.Tensor      # int32[n_nodes, 2^16]
    rev_tables: torch.Tensor      # int32[n_nodes, 2^15]
    route_enables: torch.Tensor   # bool[n_nodes, n_nodes]


def identity_router(n_nodes: int, route_enables: torch.Tensor | None = None,
                    n_labels: int | None = None, *, device=None
                    ) -> RouterState:
    """Identity LUTs for every node, all-to-all enables without self-loops
    unless ``route_enables`` is given; built on the card unless ``device``
    says otherwise."""
    device = resolve_device(device)
    fwd, rev = routing.identity_tables(n_labels, device=device)
    if route_enables is None:
        route_enables = routing.full_route_enables(n_nodes, device=device)
    return RouterState(
        fwd_tables=fwd.expand(n_nodes, -1).contiguous(),
        rev_tables=rev.expand(n_nodes, -1).contiguous(),
        route_enables=route_enables.to(device))


def route_step(state: RouterState, frames: EventFrame, capacity: int, *,
               use_fused: bool | None = None,
               timing: TimedWire | None = None
               ) -> tuple[EventFrame, torch.Tensor]:
    """One exchange round of a one-backplane star: the 1-level fabric plan
    (``fabric.star_spec`` with ``state.route_enables``) through
    ``fabric_route_step``.

    frames: per-node egress frames ``[..., n_nodes, cap_in]``;
    ``use_fused`` and ``timing`` as in ``fabric_route_step``.  Returns
    (ingress frames
    ``[..., n_nodes, capacity]``, congestion drops int32[..., n_nodes]).
    """
    plan = fablib.compile_fabric(fablib.star_spec(
        state.route_enables.shape[0], capacity, enables=state.route_enables))
    ingress, drops = fablib.fabric_route_step(state, frames, plan,
                                              use_fused=use_fused,
                                              timing=timing)
    return ingress, drops.congestion


def route_step_hierarchical(state: RouterState, frames: EventFrame,
                            capacity: int, *, n_pods: int,
                            intra_enables, inter_enables,
                            use_fused: bool | None = None,
                            link_capacity: int | None = None,
                            pod_capacity: int | None = None,
                            timing: TimedWire | None = None
                            ) -> tuple[EventFrame, ExchangeDrops]:
    """One two-layer (§V) exchange round, all nodes stacked on one device:
    the 2-level fabric plan (``fabric.hierarchical_spec``) through
    ``fabric_route_step``.

    frames: per-node egress frames ``[..., n_nodes, cap_in]``, pod-major
    (node ``k`` lives in pod ``k // (n_nodes // n_pods)``);
    intra_enables: bool[per_pod, per_pod]; inter_enables: bool[n_pods,
    n_pods]; ``link_capacity`` / ``pod_capacity``: the compact-before-gather
    packs of each node's and each backplane's egress (``None`` = dense);
    ``use_fused`` as in ``fabric_route_step``.
    Returns (ingress frames ``[..., n_nodes, capacity]``, ExchangeDrops).
    """
    n_nodes = frames.labels.shape[-2]
    if n_nodes % n_pods:
        raise ValueError(f"{n_nodes} nodes do not fill {n_pods} pods evenly")
    plan = fablib.compile_fabric(fablib.hierarchical_spec(
        n_pods=n_pods, per_pod=n_nodes // n_pods, capacity=capacity,
        intra_enables=intra_enables, inter_enables=inter_enables,
        link_capacity=link_capacity, pod_capacity=pod_capacity))
    return fablib.fabric_route_step(state, frames, plan, use_fused=use_fused,
                                    timing=timing)


def route_step_baseline(state: RouterState, frames: EventFrame,
                        capacity: int) -> tuple[EventFrame, torch.Tensor]:
    """The seed's datapath, kept as the baseline that pins ``route_step``'s
    drop counts and order: broadcast materialization + stable argsort.

    frames: ``[n_nodes, cap_in]``.  Returns (ingress frames
    ``[n_nodes, capacity]``, dropped int32[n_nodes]).
    """
    wire, fwd_en = routing.lookup_fwd(state.fwd_tables, frames.labels)
    egress = EventFrame(labels=wire, times=torch.zeros_like(frames.times),
                        valid=frames.valid & fwd_en)
    mixed, dropped = routing.aggregate_baseline(egress, state.route_enables,
                                                capacity)
    chip, rev_en = routing.lookup_rev(state.rev_tables, mixed.labels)
    valid = mixed.valid & rev_en
    return (EventFrame(labels=torch.where(valid, chip, torch.zeros_like(chip)),
                       times=mixed.times, valid=valid),
            dropped)
