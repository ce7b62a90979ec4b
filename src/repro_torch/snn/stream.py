"""Streaming multi-chip emulation — the closed loop, one step at a time.

Port of ``src/repro/snn/stream.py::run_stream``.  Every step of event mode:

    chip step (synapse product + neuron update, all chips at once)
      → egress tap (label grid + capacity frame)
      → one exchange round through the compiled hop graph
      → ingress decode into synapse-row drives, written to the delay line

Dense mode, the differentiable surrogate, replaces the three exchange
stages by one product of the spikes with ``network.routing_matrices``
(compiled from the same LUTs), so gradients flow from the spikes back to
the chip weights.

The reference scans this body with ``lax.scan``; the port runs a Python
loop over steps, each step covering all batch rows.  The delay line is a
ring buffer on the port's own copy of ``state.inflight``, written in place
(slot ``t % delay``), and rolled back to shift order on exit, so outputs
and final state match the reference's.  A fault schedule degrades the
exchange step by step (a health overlay per step, ``fault_mode="mask"``)
or segment by segment (a degraded plan per constant-health segment,
``"reroute"``), as the reference's segmented scans do.  ``overlap=True``
defers each exchange one iteration (the reference's double-buffered
window); the topology flag compiles a 1- or 2-level plan.  Online
plasticity rewrites the weights the chips integrate after every step,
shared per chip or per batch row, and a slot mask silences batch rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs, resolve_device
from repro_torch.core import fabric as fablib
from repro_torch.core import latency as latlib
from repro_torch.core.events import make_frame
from repro_torch.snn import chip as chiplib
from repro_torch.snn import network as netlib
from repro_torch.snn import plasticity as plaslib


class StreamOut(NamedTuple):
    """Result of a streamed emulation run."""

    state: netlib.NetworkState
    spikes: torch.Tensor          # f32[T, n_chips, batch, n_neurons]
    dropped: torch.Tensor         # i32[T, n_chips, batch] egress + congestion
    uplink_dropped: torch.Tensor  # i32[T, n_chips, batch] uplink-pack drops
    # Timed mode only (zero-width otherwise): the chip-to-chip wire latency
    # of every delivered ingress event, in ns; ``latency_valid`` masks the
    # filled slots.
    latency_ns: torch.Tensor      # i32[T, n_chips, batch, capacity | 0]
    latency_valid: torch.Tensor   # bool[T, n_chips, batch, capacity | 0]
    # Degraded-plan accounting (zeros on a healthy fabric).
    unroutable: torch.Tensor      # i32[T, n_chips, batch]
    rerouted: torch.Tensor        # i32[T, n_chips, batch]
    # Plastic runs only (``plasticity=STDPConfig(...)``): the final traces
    # and evolved weights, per chip (``StreamPlasticityState``) or per slot
    # (``SlotPlasticityState``, when the run started from one); ``None``
    # when the run is not plastic.
    plasticity: (plaslib.StreamPlasticityState | plaslib.SlotPlasticityState
                 | None) = None


_LATENCY_STAT_KEYS = ("median_ns", "p01_ns", "p99_ns", "jitter_ns",
                      "jitter_frac")


def masked_latency_stats(latency_ns, latency_valid, *,
                         strict: bool = True) -> dict[str, float]:
    """Percentile summary of the valid latency samples plus a ``count``.
    Zero delivered events raises under ``strict``; ``strict=False`` returns
    NaN stats with ``count == 0``."""
    lats = latency_ns[latency_valid]
    count = int(lats.numel())
    if count == 0:
        if strict:
            raise ValueError("no delivered events (or run_stream ran "
                             "untimed — pass timed=True)")
        return {**{k: float("nan") for k in _LATENCY_STAT_KEYS}, "count": 0}
    stats = latlib.latency_statistics(lats)
    stats["count"] = count
    return stats


def stream_latency_stats(out: StreamOut, *,
                         strict: bool = True) -> dict[str, float]:
    """``masked_latency_stats`` of a timed stream's wire latencies."""
    return masked_latency_stats(out.latency_ns, out.latency_valid,
                                strict=strict)


def egress_label_grid(cfg: netlib.NetworkConfig, device) -> torch.Tensor:
    """int32[n_chips, n_neurons]: chip << 9 | neuron, the egress labels."""
    neurons = torch.arange(cfg.chip.n_neurons, dtype=torch.int32,
                           device=device)
    chips = torch.arange(cfg.n_chips, dtype=torch.int32,
                         device=device) << netlib.NEURON_BITS
    return chips[:, None] + neurons[None, :]


def exchange_spikes(params: netlib.NetworkParams, spikes: torch.Tensor,
                    cfg: netlib.NetworkConfig, plan: fablib.FabricPlan,
                    timing: latlib.TimedWire | None = None,
                    health: fablib.FabricHealth | None = None,
                    use_fused: bool | None = None):
    """The exchange stage of one step for every batch row at once: egress
    tap → ``fabric_route_step`` → ingress decode.

    ``spikes``: f32[n_chips, batch, n_neurons] (any leading layout with the
    chips first and the neurons last works: extra middle dims are more
    independent rows).  Every spike of the window departs at its open (time
    0 on the timed lane), so ingress times are the wire latencies.
    ``health``: the step's dynamic overlay, shared by every row;
    ``use_fused`` as in ``fabric_route_step``.

    Returns (row drives f32[n_chips, ..., n_rows], dropped, uplink,
    latency_ns, latency_valid, unroutable, rerouted), each with the chips
    first; the latency planes are zero-width when untimed.
    """
    n, *mid, n_neurons = spikes.shape
    with obs.span("exchange.egress"):
        valid = spikes.reshape(n, -1, n_neurons).transpose(0, 1) > 0.5
        labels = egress_label_grid(cfg, spikes.device).expand(valid.shape)
        times = None if timing is None else torch.zeros_like(labels)
        frames, egress_drop = make_frame(labels, times, valid, cfg.capacity)
    ingress, drops = fablib.fabric_route_step(params.router, frames, plan,
                                              use_fused=use_fused,
                                              timing=timing, health=health)
    with obs.span("exchange.ingress"):
        drives = chiplib.labels_to_rows(ingress.labels, ingress.valid,
                                        params.row_of_label, cfg.chip.n_rows)
    if timing is None:
        lat = ingress.labels[..., :0]
        lat_valid = ingress.valid[..., :0]
    else:
        lat, lat_valid = ingress.times, ingress.valid

    def chips_first(x):
        return x.transpose(0, 1).reshape(n, *mid, *x.shape[2:])

    return tuple(chips_first(x) for x in (
        drives, egress_drop + drops.congestion, drops.uplink, lat, lat_valid,
        drops.unroutable, drops.rerouted))


def fault_segments(plan: fablib.FabricPlan, faults, fault_mode: str,
                   n_steps: int, device):
    """The fault schedule as the plan of every step and, in mask mode, the
    per-step overlays: ``(plans, schedule or None)``.

    Mask mode keeps ``plan`` and expands the schedule with
    ``health_schedule``.  Reroute mode compiles one statically degraded
    plan per constant-health segment (``fault_boundaries``), or keeps
    ``plan`` where no edge is dead, so a healthy segment takes the exchange
    fast path.  No faults, or an empty schedule, is the healthy run.
    """
    if not faults:
        return [plan] * n_steps, None
    if fault_mode == "mask":
        return [plan] * n_steps, fablib.health_schedule(plan, faults, n_steps,
                                                        device=device)
    starts = fablib.fault_boundaries(faults, n_steps)
    plans = []
    for k, start in enumerate(starts):
        end = starts[k + 1] if k + 1 < len(starts) else n_steps
        dead = fablib.dead_edges_at(faults, start)
        seg = (fablib.compile_fabric(fablib.degrade_spec(plan.spec, dead))
               if dead else plan)
        plans += [seg] * (end - start)
    return plans, None


def health_at(sched: fablib.FabricHealth, t: int) -> fablib.FabricHealth:
    """Step ``t``'s overlay of a ``health_schedule`` (views, no copy)."""
    def pick(side):
        return tuple(None if m is None else m[t] for m in side)

    return fablib.FabricHealth(uplink=pick(sched.uplink),
                               downlink=pick(sched.downlink))


def dense_layout(route_mats: torch.Tensor) -> torch.Tensor:
    """``route_mats`` f32[n_src, n_dst, n_neurons, n_rows] laid out once
    for ``route_dense``: f32[n_src · n_neurons, n_dst, n_rows] (a copy)."""
    s, d, k, r = route_mats.shape
    return route_mats.permute(0, 2, 1, 3).reshape(s * k, d, r)


def route_dense(spikes: torch.Tensor, layout: torch.Tensor) -> torch.Tensor:
    """One step of dense routing, ``einsum("sbn,sdnr->dbr", spikes,
    route_mats)``, as one ``[batch, s·n] × [s·n, d·r]`` product over
    ``dense_layout(route_mats)``.  Spikes and matrices are 0/1, so the sums
    are integer counts, the same bits in any order.  Returns f32[n_dst,
    batch, n_rows]."""
    s, b, k = spikes.shape
    _, d, r = layout.shape
    routed = spikes.transpose(0, 1).reshape(b, s * k) @ layout.reshape(
        s * k, d * r)
    return routed.reshape(b, d, r).transpose(0, 1)


def run_stream(params: netlib.NetworkParams, state: netlib.NetworkState,
               ext_drives: torch.Tensor, cfg: netlib.NetworkConfig, *,
               mode: str = "event", topology: str = "star",
               route_mats: torch.Tensor | None = None, n_pods: int = 1,
               intra_enables=None, inter_enables=None,
               use_fused: bool | None = None,
               link_capacity: int | None = None,
               pod_capacity: int | None = None,
               fabric: fablib.FabricPlan | None = None, timed: bool = False,
               overlap: bool = False, faults=None, fault_mode: str = "mask",
               plasticity: plaslib.STDPConfig | None = None,
               plasticity_state: (plaslib.StreamPlasticityState
                                  | plaslib.SlotPlasticityState
                                  | None) = None,
               slot_mask=None, device=None) -> StreamOut:
    """Run the closed-loop emulation over ``ext_drives``.

    Args:
      ext_drives: f32[T, n_chips, batch, n_rows] external input per step.
      mode: ``"event"``, the faithful datapath, or ``"dense"``, the
        differentiable surrogate: each step routes its spikes as one
        product with ``route_mats`` (laid out once a run,
        ``dense_layout``), compiles no plan and launches no exchange
        kernel; its statistics are zeros of the event mode's shapes.
        Gradients flow from ``StreamOut.spikes`` to the parameters.
      route_mats: dense mode's f32[n_src, n_dst, n_neurons, n_rows]
        (``network.routing_matrices``); required there.
      topology: without ``fabric``, ``"star"`` compiles a 1-level plan
        whose enables are ``params.router.route_enables``;
        ``"hierarchical"`` compiles the §V two-layer plan
        (``fabric.hierarchical_spec``) of ``n_pods`` backplanes of
        ``cfg.n_chips // n_pods`` chips, whose enables are
        ``intra_enables`` (bool[per_pod, per_pod]) and ``inter_enables``
        (bool[n_pods, n_pods]), both required.
      use_fused: forwarded to every exchange (``fabric_route_step``):
        ``False`` runs the unfused plain-PyTorch composition and launches
        no kernel; ``None`` means ``True``.
      link_capacity, pod_capacity: hierarchical only, the compact-before-
        gather packs of each chip's and each backplane's uplink; their
        overflow lands in ``StreamOut.uplink_dropped``.
      fabric: a compiled ``FabricPlan`` (leaf count and ingress capacity
        must match ``cfg``); its levels own the route enables, and only the
        router's LUTs are read.  Either exchange mode.  It replaces the
        topology flag, which must stay ``"star"``.
      timed: thread the int32 timestamp lane through the exchange
        (``latency.timed_wire(cfg.latency)``) and report per-event wire
        latencies; the functional outputs equal the untimed run's.
      overlap: needs ``delay_steps >= 2`` and no ``faults``.  Iteration
        ``t`` runs chip step ``t``, then the exchange of step ``t - 1``'s
        spikes, written to ring slot ``(t - 1) % delay``, which is read
        ``delay - 1`` iterations later; a last exchange flushes the final
        window, and the statistics are realigned to their steps.  Every
        output equals the ``overlap=False`` run's, except at zero steps,
        where the reference's quirk is kept: the statistics have one row
        (the flushed zero window) and slot ``delay - 1`` of the delay line
        is overwritten with that window's zero drives.  One CUDA stream
        runs both phases.
      faults: a schedule of ``fabric.FaultEvent`` link faults injected into
        the stream; the per-step lost and detoured counts land in
        ``StreamOut.unroutable`` / ``StreamOut.rerouted``.  An empty
        schedule is the healthy run.
      fault_mode: ``"mask"`` passes each step's ``health_schedule`` overlay
        to the exchange on the one plan (dead edges lose their traffic as
        unroutable, nothing detours; every step runs the merge engine).
        ``"reroute"`` splits the run at ``fabric.fault_boundaries`` and
        compiles one statically degraded plan per constant-health segment,
        so dead uplinks detour over a sibling's spare extension lanes; the
        chip state, delay line and step count cross the segments untouched.
      plasticity: an ``STDPConfig`` switches on online plasticity: after
        each chip step, the step's row drive and output spikes update the
        per-chip, per-batch-row traces and rewrite the weights
        (``plasticity.stdp_stream_step``), which the chips integrate from
        the next step on.  The final state is ``StreamOut.plasticity``;
        passed back as ``plasticity_state``, two windows equal one long
        run bit for bit.  Composes with ``timed``, ``overlap`` and
        ``faults`` (the state crosses reroute segments untouched).
      plasticity_state: the initial state (needs ``plasticity``; default
        zero traces over ``params.chips.weights``).  A
        ``SlotPlasticityState`` switches to per-slot plasticity: every
        batch row integrates and rewrites its own weight copy
        (``chip.chip_step_slots``, ``plasticity.stdp_slot_step``), so the
        rows are independent sessions, each equal to a batch-1 run.  The
        caller's tensors are never written.
      slot_mask: bool[T, batch]: a False ``(t, b)`` zeroes slot ``b``'s
        spikes at step ``t`` before they are recorded, sent and seen by
        plasticity (the neurons still integrate), and under per-slot
        plasticity freezes the slot's traces and weights.
      device: where the run happens (default CUDA; raises if absent).
        Inputs are moved there.

    Returns:
      ``StreamOut`` with the chips-first per-step outputs and the final
      state (delay line in shift order).

    The argument checks raise the reference's ``ValueError``s in its
    order.
    """
    if mode not in ("event", "dense"):
        raise ValueError(f"unknown mode: {mode!r}")
    if topology not in ("star", "hierarchical"):
        raise ValueError(f"unknown topology: {topology!r}")
    if mode == "dense" and route_mats is None:
        raise ValueError("dense mode requires route_mats")
    if mode == "dense" and topology == "hierarchical":
        raise ValueError("hierarchical topology is event-mode only; dense "
                         "routing encodes the topology in route_mats")
    if topology == "hierarchical" and (intra_enables is None
                                       or inter_enables is None):
        raise ValueError("hierarchical topology requires intra_enables and "
                         "inter_enables")
    if topology != "hierarchical" and (link_capacity is not None
                                       or pod_capacity is not None):
        raise ValueError("link_capacity/pod_capacity are uplink stages of "
                         "the hierarchical topology (the stacked star round "
                         "has none)")
    if timed and mode != "event":
        raise ValueError("timed streams require the event datapath (the "
                         "dense surrogate has no wire to time)")
    if fault_mode not in ("mask", "reroute"):
        raise ValueError(f"unknown fault_mode: {fault_mode!r}")
    if plasticity_state is not None and plasticity is None:
        raise ValueError("plasticity_state without plasticity — pass the "
                         "STDPConfig that should drive the update")
    if slot_mask is not None and tuple(slot_mask.shape) != (
            ext_drives.shape[0], ext_drives.shape[2]):
        raise ValueError(f"slot_mask must be bool[T, batch] = "
                         f"{(ext_drives.shape[0], ext_drives.shape[2])}, "
                         f"got {tuple(slot_mask.shape)}")
    if faults is not None and mode != "event":
        raise ValueError("fault injection requires the event datapath (the "
                         "dense surrogate has no links to kill)")
    if overlap:
        if mode != "event":
            raise ValueError("overlap double-buffers the exchange window — "
                             "event mode only (dense routing is a matmul, "
                             "there is no wire phase to overlap)")
        if state.inflight.shape[0] < 2:
            raise ValueError("overlap needs delay_steps >= 2: with a "
                             "single-slot delay line the deferred write "
                             "would land after its own read")
        if faults is not None:
            raise ValueError("overlap defers each exchange one iteration, "
                             "which would skew the per-step fault/health "
                             "schedule — run faults without overlap")
    if fabric is not None:
        if mode != "event":
            raise ValueError("fabric plans run the event datapath only")
        if topology != "star":
            raise ValueError("fabric replaces the topology flag — pass the "
                             "plan alone (leave topology at its default)")
        if fabric.n_nodes != cfg.n_chips:
            raise ValueError(f"fabric plan wires {fabric.n_nodes} leaves "
                             f"but the network has {cfg.n_chips} chips")
        if fabric.capacity != cfg.capacity:
            raise ValueError(f"fabric plan ingress capacity "
                             f"{fabric.capacity} != cfg.capacity "
                             f"{cfg.capacity}")
    device = resolve_device(device)
    plan = layout = None
    if mode == "dense":
        layout = dense_layout(route_mats.to(device=device,
                                            dtype=torch.float32))
    elif fabric is not None:
        plan = fabric
    elif topology == "star":
        plan = fablib.compile_fabric(fablib.star_spec(
            cfg.n_chips, cfg.capacity, enables=params.router.route_enables))
    else:
        plan = fablib.compile_fabric(fablib.hierarchical_spec(
            n_pods=n_pods, per_pod=cfg.n_chips // n_pods,
            capacity=cfg.capacity, intra_enables=intra_enables,
            inter_enables=inter_enables, link_capacity=link_capacity,
            pod_capacity=pod_capacity))

    # Not detached: in dense mode gradients flow back to the caller's
    # parameters and state.
    params = netlib.to_device(params, device)
    chips = netlib.to_device(state.chips, device)
    # The ring buffer is written in place on this copy, never on the caller's.
    inflight = state.inflight.to(device, copy=True)
    ext_drives = ext_drives.to(device)
    n_steps = ext_drives.shape[0]
    delay = inflight.shape[0]
    rows = ext_drives.shape[1:-1]
    timing = latlib.timed_wire(cfg.latency) if timed else None
    plans, sched = fault_segments(plan, faults, fault_mode, n_steps, device)
    # Per-slot plasticity is chosen by the type of the initial state.
    per_slot = isinstance(plasticity_state, plaslib.SlotPlasticityState)
    plast = None
    if plasticity is not None:
        plast = (netlib.to_device(plasticity_state, device)
                 if plasticity_state is not None
                 else plaslib.init_stream_stdp(params.chips.weights,
                                               ext_drives.shape[2]))
    if slot_mask is not None:
        slot_mask = torch.as_tensor(slot_mask).to(device=device,
                                                  dtype=torch.bool)

    rasters, stats = [], []

    @obs.span("stream.route")
    def route(spikes, t):
        """Step ``t``'s exchange (its plan and overlay), written to ring
        slot ``t % delay``; the overlap epilogue of a zero-step run has no
        step and takes ``plan``."""
        health = None if sched is None else health_at(sched, t)
        routed, *st = exchange_spikes(params, spikes, cfg,
                                      plans[t] if plans else plan, timing,
                                      health, use_fused)
        inflight[t % delay] = routed
        stats.append(st)

    for t in range(n_steps):
        slot = t % delay
        with obs.span("stream.chip_step"):
            # Ingress: the slot written `delay` steps ago.
            drive = ext_drives[t] + inflight[slot]
            if per_slot:
                chips, spikes = chiplib.chip_step_slots(
                    params.chips, chips, drive, plast.weights, cfg.chip)
            else:
                # A plastic run integrates the evolving weights.
                chip_params = (params.chips if plast is None else
                               params.chips._replace(weights=plast.weights))
                chips, spikes = chiplib.chip_step(chip_params, chips, drive,
                                                  cfg.chip)
            mask_t = None if slot_mask is None else slot_mask[t]
            if mask_t is not None:
                # Before recording, egress and plasticity: an idle slot
                # emits nothing.
                spikes = torch.where(mask_t[None, :, None], spikes, 0.0)
        if plast is not None:
            with obs.span("stream.plasticity"):
                if per_slot:
                    plast = plaslib.stdp_slot_step(plast, drive, spikes,
                                                   plasticity, mask=mask_t)
                else:
                    plast = plaslib.stdp_stream_step(plast, drive, spikes,
                                                     plasticity)
        if layout is not None:
            with obs.span("stream.route"):
                inflight[slot] = route_dense(spikes, layout)
        elif not overlap:
            # Egress: the consumed slot is the one due `delay` steps out.
            route(spikes, t)
        elif t:
            # The exchange of step t - 1, one iteration late: its slot is
            # read at step t - 1 + delay, never this iteration (delay >= 2).
            route(rasters[-1], t - 1)
        rasters.append(spikes)
    spikes = (torch.stack(rasters) if rasters else
              torch.zeros((0, *rows, cfg.chip.n_neurons),
                          dtype=chips.neurons.v.dtype, device=device))
    if overlap:
        # Epilogue: flush the last window (at zero steps the reference's
        # zero window, whose drives land in slot delay - 1).  Deferred
        # spikes were masked when they were produced.
        last = (rasters[-1] if rasters else
                spikes.new_zeros((*rows, cfg.chip.n_neurons)))
        route(last, n_steps - 1)
    if stats:
        dropped, uplink, lat, lat_valid, unroutable, rerouted = (
            torch.stack(x) for x in zip(*stats))
    else:
        # Dense mode has no wire: every statistic is zero.  Event mode
        # gets here only at zero steps, where the reference's scan returns
        # zero-length outputs of the per-step shapes and the state it was
        # given.
        width = plan.capacity if timing is not None else 0
        dropped, uplink, unroutable, rerouted = (
            torch.zeros((n_steps, *rows), dtype=torch.int32, device=device)
            for _ in range(4))
        lat = torch.zeros((n_steps, *rows, width), dtype=torch.int32,
                          device=device)
        lat_valid = torch.zeros((n_steps, *rows, width), dtype=torch.bool,
                                device=device)
    # Shift-register order: slot `n_steps % delay` holds the oldest frame.
    if delay > 1 and n_steps % delay:
        inflight = torch.roll(inflight, -(n_steps % delay), dims=0)
    return StreamOut(state=netlib.NetworkState(chips=chips, inflight=inflight),
                     spikes=spikes, dropped=dropped, uplink_dropped=uplink,
                     latency_ns=lat, latency_valid=lat_valid,
                     unroutable=unroutable, rerouted=rerouted,
                     plasticity=plast)
