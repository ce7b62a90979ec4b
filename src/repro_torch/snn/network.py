"""Multi-chip SNN: chips joined by the interconnect.

Port of ``src/repro/snn/network.py``: configuration, parameters and state
of a network of stacked chips, and its two execution modes, which share
one routing configuration:

* event mode, the faithful datapath: ``step_event`` (one shift-register
  step through ``aggregator.route_step``), ``run_event`` (the streamed run)
  and ``run_event_steps`` (the per-step loop, the stream's oracle);
* dense mode, the differentiable surrogate: ``routing_matrices`` compiles
  the same LUTs and route enables into per-(source, destination) 0/1
  matrices, so inter-chip traffic is a product and surrogate gradients
  flow end to end (``step_dense``, ``run_dense``).  Without drops the two
  modes give the same spike trains.

Inter-chip spikes arrive after ``delay_steps`` whole steps, derived from
the chip-to-chip latency and the step ``dt``.  ``init_stream_plasticity``
and ``init_slot_plasticity`` start ``run_stream``'s online plasticity.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import aggregator as agg
from repro_torch.core import routing as rt
from repro_torch.core.events import make_frame
from repro_torch.core.latency import DEFAULT_PARAMS, LatencyParams
from repro_torch.snn import chip as chiplib
from repro_torch.snn import plasticity as plaslib

NEURON_BITS = 9  # 512 neurons per chip


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    n_chips: int = 4
    chip: chiplib.ChipConfig = chiplib.ChipConfig()
    # Per-destination ingress frame capacity per step (layer-2 bandwidth).
    capacity: int = 256
    # Simulation step in hardware µs; chip-to-chip latency rounds up to steps.
    dt_us: float = 1.0
    latency: LatencyParams = DEFAULT_PARAMS

    @property
    def delay_steps(self) -> int:
        return max(1, int(-(-self.latency.chip_to_chip_ns() //
                            (self.dt_us * 1000.0))))


class NetworkParams(NamedTuple):
    chips: chiplib.ChipParams              # stacked [n_chips, ...]
    # How each destination chip maps ingress labels to synapse rows.
    row_of_label: torch.Tensor             # i32[n_chips, 2^16]
    router: agg.RouterState


class NetworkState(NamedTuple):
    chips: chiplib.ChipState               # arrays [n_chips, batch, ...]
    # Delay line of in-flight inter-chip row drives, in shift order.
    inflight: torch.Tensor                 # f32[delay, n_chips, batch, n_rows]


def _feedforward_row_map(n_chips: int, n_rows: int) -> torch.Tensor:
    """Destination row map: neuron j of the previous chip drives row
    j % n_rows (labels past 2^16 fall off the table, as in the
    reference)."""
    table = torch.full((n_chips, 1 << 16), -1, dtype=torch.int32)
    neurons = torch.arange(chiplib.N_NEURONS)
    for dst in range(1, n_chips):
        labels = ((dst - 1) << NEURON_BITS) + neurons
        keep = labels < (1 << 16)
        table[dst, labels[keep]] = (neurons % n_rows).to(torch.int32)[keep]
    return table


def init_feedforward(cfg: NetworkConfig, *, seed: int = 0,
                     device=None) -> NetworkParams:
    """A feed-forward network: chip i feeds chip i+1.  Weights are drawn
    from a CPU ``torch.Generator`` seeded with ``seed``, so a seed gives the
    same network on every device."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    chips = chiplib.init_params(cfg.n_chips, cfg.chip, gen)
    router = agg.identity_router(
        cfg.n_chips, rt.feedforward_route_enables(cfg.n_chips, device=device),
        device=device)
    params = NetworkParams(chips=chips,
                           row_of_label=_feedforward_row_map(cfg.n_chips,
                                                             cfg.chip.n_rows),
                           router=router)
    return to_device(params, device)


def init_state(cfg: NetworkConfig, batch: int, *, device=None
               ) -> NetworkState:
    device = resolve_device(device)
    return NetworkState(
        chips=chiplib.init_state(cfg.chip, cfg.n_chips, batch, device=device),
        inflight=torch.zeros((cfg.delay_steps, cfg.n_chips, batch,
                              cfg.chip.n_rows), dtype=torch.float32,
                             device=device))


def init_stream_plasticity(params: NetworkParams, batch: int):
    """Zero STDP traces over the network's stacked chip weights, for
    ``run_stream(plasticity=...)`` (a ``StreamPlasticityState`` on the
    weights' device)."""
    return plaslib.init_stream_stdp(params.chips.weights, batch)


def init_slot_plasticity(params: NetworkParams, batch: int):
    """Per-slot plasticity state: zero traces and every batch row's own
    copy of the network's stacked chip weights (``SlotPlasticityState``),
    the multi-tenant engine's mode, where batch rows are independent
    sessions."""
    return plaslib.init_slot_stdp(params.chips.weights, batch)


def to_device(tree, device):
    """Copy a NamedTuple tree of tensors to ``device`` (differentiable:
    nothing is detached)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(to_device(x, device) for x in tree))


# ---------------------------------------------------------------------------
# Dense (differentiable) routing derived from the LUT configuration
# ---------------------------------------------------------------------------


def routing_matrices(params: NetworkParams, cfg: NetworkConfig
                     ) -> torch.Tensor:
    """Compile the LUTs and route enables into dense connectivity:
    f32[n_src, n_dst, n_neurons, n_rows], where ``[s, d]`` maps source
    chip ``s``'s output spikes onto destination chip ``d``'s synapse-row
    drive (0/1, one row at most per neuron).  Neuron ``k`` of chip ``s``
    reaches row ``row_of_label[d, chip_label & 0xFFFF]`` where both LUT
    enables, the row (>= 0) and ``route_enables[s, d]`` allow it; built
    for all pairs at once on the parameters' device."""
    n, rows, neurons = cfg.n_chips, cfg.chip.n_rows, cfg.chip.n_neurons
    router = params.router
    device = router.fwd_tables.device
    chips = torch.arange(n, device=device)
    labels = ((chips[:, None].to(torch.int32) << NEURON_BITS)
              + torch.arange(neurons, dtype=torch.int32, device=device))
    wire, en_f = rt.lookup_fwd(router.fwd_tables, labels)       # [s, k]
    # Every destination's reverse LUT over every source's wire labels.
    chipl, en_r = rt.lookup_rev(router.rev_tables,
                                wire.reshape(1, -1).expand(n, -1))
    dst_rows = params.row_of_label[chips[:, None],
                                   (chipl & 0xFFFF).long()]     # [d, s·k]
    ok = (en_r & (dst_rows >= 0)).reshape(n, n, neurons)
    ok = (ok.transpose(0, 1) & en_f[:, None, :]
          & router.route_enables[:, :, None])                   # [s, d, k]
    s_i, d_i, k_i = ok.nonzero(as_tuple=True)
    out = torch.zeros((n, n, neurons, rows), dtype=torch.float32,
                      device=device)
    out[s_i, d_i, k_i,
        dst_rows.reshape(n, n, neurons)[d_i, s_i, k_i].long()] = 1.0
    return out


def step_dense(params: NetworkParams, state: NetworkState,
               ext_drive: torch.Tensor, route_mats: torch.Tensor,
               cfg: NetworkConfig, *, device=None
               ) -> tuple[NetworkState, torch.Tensor]:
    """One network step with differentiable routing: the chip step on
    ``ext_drive + inflight[0]``, then ``routed[d] = Σ_s spikes[s] @
    route_mats[s, d]`` appended to the delay line as ``inflight[0]``
    leaves.

    ext_drive: f32[n_chips, batch, n_rows]; route_mats: the output of
    ``routing_matrices``.  Returns (new state, spikes f32[n_chips, batch,
    n_neurons]).  Runs on ``device`` (default CUDA)."""
    # Imported here: the stream module imports this one.
    from repro_torch.snn.stream import dense_layout, route_dense

    device = resolve_device(device)
    params = to_device(params, device)
    state = to_device(state, device)
    drive = ext_drive.to(device) + state.inflight[0]
    chips, spikes = chiplib.chip_step(params.chips, state.chips, drive,
                                      cfg.chip)
    routed = route_dense(spikes, dense_layout(route_mats.to(device)))
    inflight = torch.cat([state.inflight[1:], routed[None]], dim=0)
    return NetworkState(chips=chips, inflight=inflight), spikes


def run_dense(params: NetworkParams, state: NetworkState,
              ext_drives: torch.Tensor, route_mats: torch.Tensor,
              cfg: NetworkConfig, *, device=None
              ) -> tuple[NetworkState, torch.Tensor]:
    """Streamed dense run (``stream.run_stream(mode="dense")``).
    ext_drives: f32[T, n_chips, batch, n_rows].  Returns (final state,
    spikes)."""
    from repro_torch.snn import stream  # imported here, as above

    out = stream.run_stream(params, state, ext_drives, cfg, mode="dense",
                            route_mats=route_mats, device=device)
    return out.state, out.spikes


# ---------------------------------------------------------------------------
# Event-mode steps
# ---------------------------------------------------------------------------


def step_event(params: NetworkParams, state: NetworkState,
               ext_drive: torch.Tensor, cfg: NetworkConfig, *, device=None
               ) -> tuple[NetworkState, torch.Tensor, torch.Tensor]:
    """One network step through the event datapath: the chip step on
    ``ext_drive + inflight[0]``, then the star round
    (``aggregator.route_step`` over ``params.router``) of its spikes, whose
    row drives are appended to the delay line as ``inflight[0]`` leaves.

    ext_drive: f32[n_chips, batch, n_rows].  Returns (new state, spikes
    f32[n_chips, batch, n_neurons], dropped int32[n_chips, batch], egress
    and congestion drops).  Runs on ``device`` (default CUDA).
    """
    # Imported here: the stream module imports this one.
    from repro_torch.snn.stream import egress_label_grid

    device = resolve_device(device)
    params = to_device(params, device)
    state = to_device(state, device)
    drive = ext_drive.to(device) + state.inflight[0]
    chips, spikes = chiplib.chip_step(params.chips, state.chips, drive,
                                      cfg.chip)
    valid = spikes.transpose(0, 1) > 0.5              # [batch, chips, neurons]
    labels = egress_label_grid(cfg, device).expand(valid.shape)
    frames, egress_drop = make_frame(labels, torch.zeros_like(labels), valid,
                                     cfg.capacity)
    ingress, agg_drop = agg.route_step(params.router, frames, cfg.capacity)
    routed = chiplib.labels_to_rows(ingress.labels, ingress.valid,
                                    params.row_of_label, cfg.chip.n_rows)
    inflight = torch.cat([state.inflight[1:],
                          routed.transpose(0, 1)[None]], dim=0)
    return (NetworkState(chips=chips, inflight=inflight), spikes,
            (egress_drop + agg_drop).transpose(0, 1))


def run_event(params: NetworkParams, state: NetworkState,
              ext_drives: torch.Tensor, cfg: NetworkConfig, *, device=None
              ) -> tuple[NetworkState, torch.Tensor, torch.Tensor]:
    """Streamed event-mode run on the star (``stream.run_stream``).
    ext_drives: f32[T, n_chips, batch, n_rows].  Returns (final state,
    spikes, dropped)."""
    from repro_torch.snn import stream  # imported here, as above

    out = stream.run_stream(params, state, ext_drives, cfg, mode="event",
                            device=device)
    return out.state, out.spikes, out.dropped


def run_event_steps(params: NetworkParams, state: NetworkState,
                    ext_drives: torch.Tensor, cfg: NetworkConfig, *,
                    device=None
                    ) -> tuple[NetworkState, torch.Tensor, torch.Tensor]:
    """The per-step loop: one eager ``step_event`` per timestep.  Equal to
    ``run_event``; kept as the stream's oracle and as the dispatch-bound
    baseline of the exchange-stream benchmark."""
    device = resolve_device(device)
    params = to_device(params, device)
    state = to_device(state, device)
    spikes, dropped = [], []
    for t in range(ext_drives.shape[0]):
        state, spk, drp = step_event(params, state, ext_drives[t], cfg,
                                     device=device)
        spikes.append(spk)
        dropped.append(drp)
    return state, torch.stack(spikes), torch.stack(dropped)
