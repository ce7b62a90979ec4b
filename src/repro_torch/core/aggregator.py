"""The Aggregator: star-topology spike exchange (paper §III).

Port of ``src/repro/core/aggregator.py``: ``RouterState`` and
``identity_router``, the stacked per-node LUTs the hop-graph executor
(``repro_torch.core.fabric``) reads, and the legacy entry points
``route_step`` (one star round), ``route_step_hierarchical`` (the §V
two-layer round) and ``route_step_baseline`` (the seed's materializing
datapath).  The first two are thin wrappers over a 1- or 2-level fabric
plan and ``fabric_route_step``; which kernel runs is the dispatch rule's
choice (the plain star on CUDA tensors is one ``exchange`` launch).

The sharded legacy entry points, one node per rank of a
``torch.distributed`` mesh: ``star_exchange``, ``hierarchical_exchange``
and ``StarInterconnect`` compile the 1- or 2-level plan from the runtime
enables and run ``fabric.fabric_exchange``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import fabric as fablib
from repro_torch.core import routing
from repro_torch.core.events import EventFrame
from repro_torch.core.fabric import ExchangeDrops
from repro_torch.core.latency import TimedWire
from repro_torch.core.link import LinkConfig


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


# ---------------------------------------------------------------------------
# Sharded datapath: one node per rank of a torch.distributed mesh
# ---------------------------------------------------------------------------


def star_exchange(frame: EventFrame, axis_name: str, fwd_table: torch.Tensor,
                  rev_table: torch.Tensor, route_enables, capacity: int,
                  use_fused: bool | None = None,
                  link_capacity: int | None = None,
                  timing: TimedWire | None = None, *, mesh
                  ) -> tuple[EventFrame, ExchangeDrops]:
    """One star round seen from this rank's node: the 1-level fabric plan
    (``fabric.star_spec`` with ``route_enables``, bool[n, n]) through
    ``fabric.fabric_exchange`` over ``mesh``'s dimension ``axis_name``.

    ``frame``: this node's egress ``[..., cap_in]``; ``fwd_table`` /
    ``rev_table``: its own LUTs.  The all-gather is the star's uplink and
    broadcast; route enables, the merge, the capacity pack and the reverse
    LUT apply at the destination.  ``link_capacity`` packs the egress
    before the gather (overflow is an uplink drop); ``timing`` adds the
    int32 timestamp lane.  Returns (ingress ``[..., capacity]``,
    ExchangeDrops).
    """
    plan = fablib.compile_fabric(fablib.star_spec(
        route_enables.shape[0], capacity, enables=route_enables,
        link_capacity=link_capacity))
    return fablib.fabric_exchange(frame, mesh, fwd_table, rev_table, plan,
                                  axis_names=(axis_name,),
                                  use_fused=use_fused, timing=timing)


def hierarchical_exchange(frame: EventFrame, node_axis: str, pod_axis: str,
                          fwd_table: torch.Tensor, rev_table: torch.Tensor,
                          intra_enables, inter_enables, capacity: int,
                          use_fused: bool | None = None,
                          link_capacity: int | None = None,
                          pod_capacity: int | None = None,
                          timing: TimedWire | None = None, *, mesh
                          ) -> tuple[EventFrame, ExchangeDrops]:
    """Two-layer star (§V) seen from this rank's node: the 2-level fabric
    plan (``fabric.hierarchical_spec``) through ``fabric.fabric_exchange``
    over ``mesh``'s dimensions ``node_axis`` (the backplane) and
    ``pod_axis`` (the second layer).

    ``intra_enables``: bool[per_pod, per_pod] routes within a backplane;
    ``inter_enables``: bool[n_pods, n_pods] routes between backplanes.
    ``link_capacity`` packs this node's egress before the layer-1 gather,
    ``pod_capacity`` the backplane's aggregated egress before the layer-2
    gather; overflow at either is an uplink drop.  ``timing`` as in
    ``star_exchange``.
    """
    plan = fablib.compile_fabric(fablib.hierarchical_spec(
        n_pods=inter_enables.shape[0], per_pod=intra_enables.shape[0],
        capacity=capacity, intra_enables=intra_enables,
        inter_enables=inter_enables, link_capacity=link_capacity,
        pod_capacity=pod_capacity))
    return fablib.fabric_exchange(frame, mesh, fwd_table, rev_table, plan,
                                  axis_names=(node_axis, pod_axis),
                                  use_fused=use_fused, timing=timing)


@dataclasses.dataclass(frozen=True)
class StarInterconnect:
    """Binds the legacy star (``pod_axis=None``) or two-layer hierarchy to
    a ``torch.distributed`` mesh, with the route enables as runtime
    arguments: ``exchange_fn()(frame, fwd_table, rev_table, enables)`` for
    the star, ``(..., intra_enables, inter_enables)`` for the hierarchy.
    Each rank passes its own ``[cap_in]`` frame (``stream_fn``: ``[T,
    cap_in]``) and its own tables.

    ``link_capacity`` / ``pod_capacity`` switch on the compact-before-
    gather uplink packs; ``link_capacity`` may also come from a
    ``link.LinkConfig`` whose ``link_capacity`` is set (an explicit
    ``link_capacity`` wins).  ``timing`` adds the timed lane.
    """

    mesh: object
    node_axis: str
    pod_axis: str | None = None
    capacity: int = 256
    use_fused: bool | None = None
    link_capacity: int | None = None
    pod_capacity: int | None = None
    link: LinkConfig | None = None
    timing: TimedWire | None = None

    def _link_capacity(self) -> int | None:
        if self.link_capacity is not None:
            return self.link_capacity
        return self.link.link_capacity if self.link is not None else None

    def _round(self, frame_dims: int, what: str):
        kw = dict(use_fused=self.use_fused,
                  link_capacity=self._link_capacity(), timing=self.timing,
                  mesh=self.mesh)
        if self.pod_axis is None:
            if self.pod_capacity is not None:
                raise ValueError("pod_capacity requires a pod_axis (the "
                                 "layer-2 uplink only exists on the "
                                 "hierarchical topology)")

            def exchange(frame, fwd, rev, enables):
                return star_exchange(frame, self.node_axis, fwd, rev,
                                     enables, self.capacity, **kw)
        else:
            def exchange(frame, fwd, rev, intra, inter):
                return hierarchical_exchange(
                    frame, self.node_axis, self.pod_axis, fwd, rev, intra,
                    inter, self.capacity, pod_capacity=self.pod_capacity,
                    **kw)

        def fn(frame: EventFrame, *args):
            if frame.labels.dim() != frame_dims:
                raise ValueError(f"{what} takes this rank's "
                                 f"{frame_dims}-d frames, got labels "
                                 f"{tuple(frame.labels.shape)}")
            return exchange(frame, *args)

        return fn

    def exchange_fn(self):
        """One round over this rank's ``[cap_in]`` frame."""
        return self._round(1, "exchange_fn")

    def stream_fn(self):
        """T rounds over ``[T, cap_in]`` frames, equal to T ``exchange_fn``
        calls bit for bit; one collective per level and one merge a call
        (the rounds do not depend on each other)."""
        return self._round(2, "stream_fn")
