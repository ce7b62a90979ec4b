"""MGT link model: encoding, line rate, serialization latency, throughput.

Port of ``src/repro/core/link.py`` (a cost model, no tensors): the paper runs the
multi-gigabit transceivers at 5 Gbit/s with 8b10b encoding because its
short code groups minimise serialization latency.  The latency model and
the fabric's derived uplink capacities consume these numbers.
"""

from __future__ import annotations

import dataclasses

MGT_USER_CLOCK_HZ = 250e6     # user clock of the transceiver datapath (§III)
SYSTEM_CLOCK_HZ = 125e6       # FPGA system clock (8 ns period, Fig 5)
WORD_BITS = 16                # MGT datapath accepts 16 bit per user-clock cycle
EVENT_LABEL_BITS = 15         # 1 bit reserved for command messages


@dataclasses.dataclass(frozen=True)
class Encoding:
    name: str
    data_bits: int            # payload bits per code group
    code_bits: int            # line bits per code group
    max_line_rate_gbps: float # highest rate allowed for this encoding

    @property
    def overhead(self) -> float:
        return self.code_bits / self.data_bits

    def payload_rate_gbps(self, line_rate_gbps: float) -> float:
        return line_rate_gbps * self.data_bits / self.code_bits

    def group_latency_ns(self, line_rate_gbps: float) -> float:
        """Serialization latency of one code group at the given line rate."""
        return self.code_bits / line_rate_gbps  # bits / (Gbit/s) = ns


ENC_8B10B = Encoding("8b10b", data_bits=8, code_bits=10, max_line_rate_gbps=5.0)
ENC_64B66B = Encoding("64b66b", data_bits=64, code_bits=66, max_line_rate_gbps=8.0)


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """One Node-FPGA ↔ Aggregator transceiver lane."""

    encoding: Encoding = ENC_8B10B
    line_rate_gbps: float = 5.0
    # Fixed transceiver latency (PCS/PMA pipelines) besides serialization;
    # calibrated so one MGT hop ≈ 150 ns (two hops = 0.3 µs, §IV).
    fixed_latency_ns: float = 146.0
    # Events one lane admits per exchange round (compact-before-gather frame
    # size); overflow is an uplink drop.  ``None`` disables the uplink stage.
    link_capacity: int | None = None

    def __post_init__(self):
        if self.line_rate_gbps > self.encoding.max_line_rate_gbps:
            raise ValueError(
                f"{self.encoding.name} supports at most "
                f"{self.encoding.max_line_rate_gbps} Gbit/s, got {self.line_rate_gbps}")

    def word_serialization_ns(self) -> float:
        """Time to serialize one 16-bit event word onto the wire."""
        groups = WORD_BITS / self.encoding.data_bits
        # 64b66b must fill a whole 64-bit block before it can transmit:
        groups = max(groups, 1.0)
        return groups * self.encoding.group_latency_ns(self.line_rate_gbps)

    def hop_latency_ns(self) -> float:
        """One MGT hop: fixed PCS/PMA pipeline + word serialization."""
        return self.fixed_latency_ns + self.word_serialization_ns()

    def payload_rate_gbps(self) -> float:
        return self.encoding.payload_rate_gbps(self.line_rate_gbps)

    def max_event_rate_hz(self) -> float:
        """Sustained single-event throughput of the lane: min(user clock,
        payload rate / 16 bit)."""
        wire_limit = self.payload_rate_gbps() * 1e9 / WORD_BITS
        return min(MGT_USER_CLOCK_HZ, wire_limit)

    def events_per_window(self, window_us: float) -> int:
        """Events the lane can carry in one exchange window (event rate minus
        the clock-compensation stall share)."""
        rate = self.max_event_rate_hz() * (
            1.0 - clock_compensation_stall_fraction())
        return max(1, int(rate * window_us * 1e-6))


LINK_LATENCY_OPTIMIZED = LinkConfig(encoding=ENC_8B10B, line_rate_gbps=5.0)
LINK_BANDWIDTH_OPTIMIZED = LinkConfig(encoding=ENC_64B66B, line_rate_gbps=8.0)

# Reference-clock tolerance of the transceiver endpoints (±ppm each side).
CLOCK_TOLERANCE_PPM = 100.0
# Compensation sequences are scheduled this many times more often than the
# theoretical minimum, since they cannot preempt queued event words.
CC_SCHEDULING_MARGIN = 5


def cc_interval_words(ppm: float = CLOCK_TOLERANCE_PPM,
                      margin: int = CC_SCHEDULING_MARGIN) -> int:
    """Words between clock-compensation pauses, derived from the ppm budget
    (the single source of truth for ``LatencyParams.cc_interval``)."""
    return max(1, int(1.0 / (2.0 * ppm * 1e-6 * margin)))


def clock_compensation_stall_fraction(ppm: float = CLOCK_TOLERANCE_PPM,
                                      interval_words: int | None = None
                                      ) -> float:
    """Fraction of cycles lost to clock-compensation pauses."""
    if interval_words is None:
        interval_words = cc_interval_words(ppm)
    return 1.0 / interval_words
