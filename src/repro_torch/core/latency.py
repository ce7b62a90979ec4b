"""Deterministic latency model and congestion simulator (paper §IV, Fig 5).

Port of ``src/repro/core/latency.py``: ``LatencyParams`` (fixed per-stage
latencies), the per-hop queueing terms (``queue_wait_ns``, ``hop_delays``
and their integer twin ``queue_wait_i32``), ``timed_wire`` (the integer-ns
constants of the int32 timestamp lane), the Fig 5A congestion simulator
``simulate_fan_in`` (a Lindley recursion over merged arrivals) and the
Fig 5B conversion to biological time.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.link import LINK_LATENCY_OPTIMIZED, LinkConfig, cc_interval_words

SYSTEM_CLOCK_NS = 8.0    # 125 MHz FPGA system clock
MGT_CLOCK_NS = 4.0       # 250 MHz transceiver user clock


@dataclasses.dataclass(frozen=True)
class LatencyParams:
    """Fixed per-stage latencies (ns), calibrated to §IV."""

    link: LinkConfig = LINK_LATENCY_OPTIMIZED
    # ASIC ↔ Node-FPGA layer-2 link, each direction.
    l2_link_ns: float = 190.0
    # On-chip layer-1 crossbar traversal.
    on_chip_ns: float = 45.0
    # Clock-domain-crossing counter synchronizations, per FPGA traversal.
    cdc_ns_per_fpga: float = 45.0
    # Packing/unpacking logic + address-LUT pipeline stages, per endpoint FPGA.
    pack_lut_ns: float = 36.0
    # Aggregator multiplexer arbitration (uncongested).
    mux_arb_ns: float = 18.0
    # Number of FPGAs traversed node→aggregator→node.
    n_fpgas: int = 3
    # Every ``cc_interval`` events the datapath stalls for ``cc_stall_ns``.
    cc_interval: int = cc_interval_words()
    cc_stall_ns: float = 8.0

    def mgt_path_ns(self) -> float:
        """Both MGT hops (node→agg, agg→node)."""
        return 2.0 * self.link.hop_latency_ns()

    def fpga_to_fpga_ns(self) -> float:
        """Deterministic Node-FPGA → Node-FPGA latency (Fig 5A bottom)."""
        return (self.mgt_path_ns()
                + self.n_fpgas * self.cdc_ns_per_fpga
                + 2 * self.pack_lut_ns
                + self.mux_arb_ns)

    def chip_to_chip_ns(self) -> float:
        """Deterministic chip → chip latency (Fig 5A top), uncongested."""
        return self.fpga_to_fpga_ns() + 2 * self.l2_link_ns + self.on_chip_ns

    def second_layer_extra_ns(self) -> float:
        """Extra latency crossing the second-layer node (§V): two more
        transceiver hops + one more aggregator traversal."""
        return (2.0 * self.link.hop_latency_ns()
                + self.cdc_ns_per_fpga + self.mux_arb_ns + self.pack_lut_ns)

    def sender_fixed_ns(self, level: str = "chip") -> float:
        """Deterministic sender-side path up to the Aggregator multiplexer."""
        fpga = (self.pack_lut_ns + self.cdc_ns_per_fpga
                + self.link.hop_latency_ns())
        if level == "chip":
            return self.on_chip_ns + self.l2_link_ns + fpga
        return fpga

    def recv_fixed_ns(self, level: str = "chip") -> float:
        """Deterministic receiver-side path from the multiplexer output."""
        fpga = (self.mux_arb_ns + self.link.hop_latency_ns()
                + self.pack_lut_ns + self.cdc_ns_per_fpga)
        if level == "chip":
            return (fpga + self.cdc_ns_per_fpga * (self.n_fpgas - 2)
                    + self.l2_link_ns)
        return fpga


DEFAULT_PARAMS = LatencyParams()

# Paper §IV headline claims (Fig 5): chip-to-chip median band across all
# spike rates and worst-regime total jitter.
PAPER_BAND_NS = (850.0, 1300.0)
PAPER_JITTER_FRAC = 0.15


# ---------------------------------------------------------------------------
# Per-hop queueing terms (the timed datapath's delay model)
# ---------------------------------------------------------------------------


def queue_wait_ns(ranks, service_ns: float = MGT_CLOCK_NS, *,
                  cc_interval: int = 0,
                  cc_stall_ns: float = 0.0) -> torch.Tensor:
    """Closed form of the Lindley recursion for one exchange window: the
    wait of 0-based arrival rank ``r`` among simultaneous arrivals,
    ``r·service + ⌊r / cc_interval⌋·cc_stall`` in float32 (``_lindley_queue``
    on a window of zeros gives the same).  Any shape of integer ``ranks``;
    the result lies on their device."""
    r = torch.as_tensor(ranks).to(torch.int32)
    wait = r.to(torch.float32) * service_ns
    if cc_interval:
        wait = wait + torch.div(r, cc_interval, rounding_mode="floor").to(
            torch.float32) * cc_stall_ns
    return wait


class HopDelays(NamedTuple):
    """Per-event queueing delays (ns) at the congested hops of one window,
    for the given 0-based arrival ranks."""

    # Sender MGT lane: one word per user-clock cycle, with compensation
    # pauses.
    uplink_ns: torch.Tensor
    # Aggregator multiplexer: all enabled sources merge into one stream.
    mux_ns: torch.Tensor
    # Receiver layer-2 downlink: runs at the mux output rate, so only its
    # own compensation pauses add wait.
    l2_down_ns: torch.Tensor

    @property
    def total_ns(self) -> torch.Tensor:
        """Destination-side queueing (mux + layer-2 downlink)."""
        return self.mux_ns + self.l2_down_ns


def hop_delays(params: LatencyParams, occupancy) -> HopDelays:
    """The per-hop queueing terms of integer arrival ranks ``occupancy``;
    ``total_ns`` equals ``queue_wait_i32(r, timed_wire(params).queue)`` on
    integer ranks."""
    r = torch.as_tensor(occupancy).to(torch.int32)
    serial = queue_wait_ns(r, MGT_CLOCK_NS, cc_interval=params.cc_interval,
                           cc_stall_ns=params.cc_stall_ns)
    stalls_only = queue_wait_ns(r, 0.0, cc_interval=params.cc_interval,
                                cc_stall_ns=params.cc_stall_ns)
    return HopDelays(uplink_ns=serial, mux_ns=serial, l2_down_ns=stalls_only)


def queue_wait_i32(ranks: torch.Tensor,
                   queue: tuple[int, int, int]) -> torch.Tensor:
    """rank·service + ⌊rank/cc⌋·stall in int32 — the wait of 0-based arrival
    rank ``ranks`` at one server.  ``queue`` is the static (service_ns,
    cc_interval, stall_ns) triple (``TimedWire.queue`` /
    ``TimedWire.uplink_queue``); shared by the uplink waits and the merge
    kernels' destination queue."""
    service_ns, cc_interval, stall_ns = queue
    ranks = ranks.to(torch.int32)
    wait = ranks * service_ns
    if cc_interval:
        wait = wait + torch.div(ranks, cc_interval,
                                rounding_mode="floor") * stall_ns
    return wait.to(torch.int32)


class TimedWire(NamedTuple):
    """Integer-ns constants of the timed streaming datapath."""

    sender_fixed_ns: int        # egress → Aggregator multiplexer input
    recv_fixed_ns: int          # multiplexer output → destination
    second_layer_extra_ns: int  # extra fixed path for inter-backplane events
    service_ns: int             # MGT user-clock cycle (one event per cycle)
    cc_interval: int            # events between clock-compensation pauses
    cc_stall_ns: int            # one compensation pause
    n_stall_hops: int           # stall-paying hops after the merge (mux + L2)

    @property
    def queue(self) -> tuple[int, int, int]:
        """(service_ns, cc_interval, stall_total_ns) of the destination merge:
        the wait of pack rank r is r·service + ⌊r/cc⌋·stall_total."""
        return (self.service_ns, self.cc_interval,
                self.cc_stall_ns * self.n_stall_hops)

    @property
    def uplink_queue(self) -> tuple[int, int, int]:
        """(service_ns, cc_interval, stall_ns) of one sender-side lane."""
        return (self.service_ns, self.cc_interval, self.cc_stall_ns)


def timed_wire(params: LatencyParams = DEFAULT_PARAMS,
               level: str = "chip") -> TimedWire:
    """Integer-ns view of ``params`` for the timed exchange datapath (each
    term rounded once, with Python ``round``, as the reference does)."""
    if level not in ("chip", "fpga"):
        raise ValueError(f"unknown level: {level!r}")
    return TimedWire(
        sender_fixed_ns=int(round(params.sender_fixed_ns(level))),
        recv_fixed_ns=int(round(params.recv_fixed_ns(level))),
        second_layer_extra_ns=int(round(params.second_layer_extra_ns())),
        service_ns=int(round(MGT_CLOCK_NS)),
        cc_interval=int(params.cc_interval),
        cc_stall_ns=int(round(params.cc_stall_ns)),
        # The layer-2 downlink only exists at chip level (Fig 5A top).
        n_stall_hops=2 if level == "chip" else 1,
    )


# ---------------------------------------------------------------------------
# Congestion simulator (Fig 5A)
# ---------------------------------------------------------------------------


def _lindley_queue(arrivals: torch.Tensor, service_ns: float,
                   cc_interval: int = 0,
                   cc_stall_ns: float = 0.0) -> torch.Tensor:
    """Waiting time of each event at one FIFO server: ``w_0 = 0``,
    ``w_i = max(0, (w_{i-1} + s_{i-1}) - (a_i - a_{i-1}))``, where every
    ``cc_interval``-th event's service carries one ``cc_stall_ns`` pause.

    The gaps are taken on ``arrivals``' device; the recursion runs on the
    host over float32 scalars in the reference's order, one rounding per
    addition.  It is sequential, and a ``cumsum``/``cummin`` closed form
    rounds differently (its ulps flip 8 ns ticks downstream), so it is not
    run as one device operation per event either.  Returns float32 on
    ``arrivals``' device.
    """
    n = arrivals.shape[0]
    service = np.full((n,), service_ns, np.float32)
    if cc_interval:
        service[cc_interval - 1::cc_interval] += np.float32(cc_stall_ns)
    gaps = torch.diff(arrivals).cpu().numpy()
    waits = np.zeros((n,), np.float32)
    zero = w = np.float32(0.0)
    for i in range(n - 1):
        w = max(zero, (w + service[i]) - gaps[i])
        waits[i + 1] = w
    return torch.from_numpy(waits).to(arrivals.device)


class FanInDraws(NamedTuple):
    """The random inputs of one ``simulate_fan_in`` call."""

    offsets: torch.Tensor   # f32[fan_in], sender phases in [0, period)
    jitter: torch.Tensor    # f32[n_cross, n_spikes], CDC alignment jitter


def fan_in_draws(rate_hz: float, n_spikes: int, generator: torch.Generator,
                 fan_in: int = 3, level: str = "chip") -> FanInDraws:
    """Uniform draws from ``generator`` on its device: each sender's phase
    within one period, and one alignment jitter per clock-domain crossing
    (4 at FPGA level, 6 at chip level), uniform within the crossing's
    destination clock period (system and MGT clocks alternating)."""
    dev = generator.device
    offsets = torch.rand((fan_in,), generator=generator, device=dev) * (
        1e9 / rate_hz)
    n_cross = 4 if level == "fpga" else 6
    period = torch.tensor([SYSTEM_CLOCK_NS if i % 2 == 0 else MGT_CLOCK_NS
                           for i in range(n_cross)], device=dev)
    jitter = torch.rand((n_cross, n_spikes), generator=generator,
                        device=dev) * period[:, None]
    return FanInDraws(offsets=offsets, jitter=jitter)


def _percentile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (linear interpolation) with the roundings
    of the reference's compiled float32 program: the position
    ``q·(0.01·(n − 1))`` (XLA folds the division by 100 into the
    constant), weights ``1 − frac`` and ``frac``, and
    ``high·w_high + low·w_low`` as one fused multiply-add, rounded once
    (``torch.quantile`` interpolates with ``lerp`` and rounds otherwise).
    A 0-d float32 tensor on ``x``'s device."""
    a = torch.sort(x.reshape(-1)).values
    n = a.numel()
    pos = np.float32(q) * (np.float32(0.01) * np.float32(n - 1))
    w_high = pos - np.floor(pos)
    w_low = np.float32(1.0) - w_high
    low = a[int(np.clip(np.floor(pos), 0, n - 1))]
    high = a[int(np.clip(np.ceil(pos), 0, n - 1))]
    # The float32 product high·w_high is exact in float64, so the float64
    # sum rounded to float32 is the fused result.
    return (high.double() * float(w_high)
            + (low * float(w_low)).double()).float()


def simulate_fan_in(rate_hz: float, n_spikes: int,
                    generator: torch.Generator | None = None,
                    fan_in: int = 3, params: LatencyParams = DEFAULT_PARAMS,
                    level: str = "chip", *, draws: FanInDraws | None = None,
                    device=None) -> torch.Tensor:
    """Simulate Fig 5A: ``fan_in`` regular senders → one receiver.

    Args:
      rate_hz: per-sender regular spike rate.
      n_spikes: total number of measured spikes (paper: 2^15).
      generator: the source of the sender phases and CDC jitter
        (``fan_in_draws``), unless ``draws`` gives them.
      fan_in, params: senders (paper: 3) and stage latencies.
      level: ``"fpga"`` (Node-FPGA → Node-FPGA) or ``"chip"``.
      draws: the random inputs themselves (``FanInDraws``): sender phases
        ``f32[fan_in]`` and ``n_cross`` jitter planes ``f32[n_cross,
        n_spikes]``, added in order (``0 + u_0 + u_1 + …``).
      device: where the simulation runs (default CUDA; raises if absent).

    Returns:
      float32[n_spikes] per-spike latencies in ns, quantized to the 8 ns
      measurement clock.

    Every step keeps the reference's float32 operations and order: stable
    sorts (equal arrival times keep emission order), the Lindley
    recursions of ``_lindley_queue`` on the host, the 30th percentile as
    ``jnp.percentile`` takes it.  The one reduction, the mean wait that
    decides congestion against 8 ns, is taken in float64, so it can
    differ from the reference's float32 mean only within its rounding of
    8 ns exactly.
    """
    if draws is None:
        if generator is None:
            raise ValueError("simulate_fan_in needs a generator or draws")
        draws = fan_in_draws(rate_hz, n_spikes, generator, fan_in, level)
    device = resolve_device(device)
    offsets = draws.offsets.to(device=device, dtype=torch.float32)
    planes = draws.jitter.to(device=device, dtype=torch.float32)
    per_sender = -(-n_spikes // fan_in)

    # Regular trains with uniform phase offsets.
    period_ns = 1e9 / rate_hz
    idx = torch.arange(per_sender, dtype=torch.float32, device=device)
    emit = offsets[:, None] + idx[None, :] * period_ns
    emit = emit.reshape(-1)[:n_spikes]

    sender_fixed = params.sender_fixed_ns(level)
    jitter = torch.zeros_like(emit)
    for plane in planes:
        jitter = jitter + plane
    arrive_mux = emit + sender_fixed + jitter

    # Aggregator multiplexer: one event per MGT cycle, with stalls.
    order = torch.argsort(arrive_mux, stable=True)
    sorted_arrivals = arrive_mux[order]
    mux_wait = _lindley_queue(sorted_arrivals, MGT_CLOCK_NS,
                              params.cc_interval, params.cc_stall_ns)
    recv_fixed = params.recv_fixed_ns(level)
    if level == "chip":
        # Receiver layer-2 link: one event per MGT cycle, its own stalls.
        depart_mux = sorted_arrivals + mux_wait + params.mux_arb_ns
        l2_wait = _lindley_queue(depart_mux, MGT_CLOCK_NS,
                                 params.cc_interval, params.cc_stall_ns)
        total_sorted = mux_wait + l2_wait
    else:
        total_sorted = mux_wait
    # Undo the sort so latencies align with emission order.
    queue_wait = torch.empty_like(total_sorted)
    queue_wait[order] = total_sorted

    latency = sender_fixed + jitter + queue_wait + recv_fixed
    if level == "chip":
        # Jitter compensation: delay events whose non-deterministic delay
        # is below the 30th percentile, by at most two system clocks, while
        # the link is uncongested.
        nondet = jitter + queue_wait
        boost = torch.clamp(_percentile_linear(nondet, 30.0) - nondet, 0.0,
                            2.0 * SYSTEM_CLOCK_NS)
        if not queue_wait.double().mean() > SYSTEM_CLOCK_NS:
            latency = latency + boost
    # Quantize to the 8 ns measurement clock (half to even, as jnp.round).
    return torch.round(latency / SYSTEM_CLOCK_NS) * SYSTEM_CLOCK_NS


def latency_statistics(latencies_ns: torch.Tensor) -> dict[str, float]:
    """Median, 1st/99th percentile and jitter of latency samples (host-side
    summary, in float64)."""
    x = latencies_ns.detach().cpu().to(torch.float64).numpy()
    med = float(np.median(x))
    p01, p99 = (float(v) for v in np.percentile(x, [1.0, 99.0]))
    return {"median_ns": med, "p01_ns": p01, "p99_ns": p99,
            "jitter_ns": p99 - p01, "jitter_frac": (p99 - p01) / med}


# ---------------------------------------------------------------------------
# Fig 5B: speed-up factor against routing latency in biological time
# ---------------------------------------------------------------------------


def biological_latency_ms(speedup, hw_latency_ns: float | None = None
                          ) -> torch.Tensor:
    """Routing latency in biological time (ms) at a given speed-up, in
    float32 on ``speedup``'s device."""
    if hw_latency_ns is None:
        hw_latency_ns = DEFAULT_PARAMS.chip_to_chip_ns()
    return torch.as_tensor(speedup, dtype=torch.float32) * hw_latency_ns * 1e-6


# Typical biological membrane time constants (Allen atlas / NeuroElectro).
TAU_MEM_BIO_MS = (10.0, 30.0)
DEFAULT_SPEEDUP = 1000.0
