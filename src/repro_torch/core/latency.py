"""Deterministic latency model of the timed datapath (paper §IV, Fig 5).

Port of the parts of ``src/repro/core/latency.py`` the timed exchange runs:
``LatencyParams`` (fixed per-stage latencies), ``queue_wait_i32`` (the
integer Lindley closed form of one exchange window) and ``timed_wire`` (the
integer-ns constants of the int32 timestamp lane).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

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


def latency_statistics(latencies_ns: torch.Tensor) -> dict[str, float]:
    """Median, 1st/99th percentile and jitter of latency samples (host-side
    summary, in float64)."""
    x = latencies_ns.detach().cpu().to(torch.float64).numpy()
    med = float(np.median(x))
    p01, p99 = (float(v) for v in np.percentile(x, [1.0, 99.0]))
    return {"median_ns": med, "p01_ns": p01, "p99_ns": p99,
            "jitter_ns": p99 - p01, "jitter_frac": (p99 - p01) / med}
