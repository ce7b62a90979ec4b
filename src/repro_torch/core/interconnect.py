"""Topology of the multi-chip system (paper §II/§V).

Port of ``src/repro/core/interconnect.py``: one backplane hosts up to 12
chips behind Node-FPGAs, joined in a star by one Aggregator with 12 lanes
plus 4 extension lanes; two backplanes share a 4U case; a second layer
joins up to 10 Aggregators, at the cost of two more transceiver hops.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.latency import DEFAULT_PARAMS, LatencyParams

CHIPS_PER_BACKPLANE = 12
AGGREGATOR_LANES = 12
EXTENSION_LANES = 4
BACKPLANES_PER_RACK = 2
SECOND_LAYER_FANOUT = 10        # aggregators per second-layer node (§V)

NEURONS_PER_CHIP = 512
SYNAPSES_PER_CHIP = 131_072


@dataclasses.dataclass(frozen=True)
class Topology:
    """A deployed multi-chip configuration."""

    n_chips: int
    chips_per_backplane: int = CHIPS_PER_BACKPLANE
    second_layer: bool = False

    def __post_init__(self):
        if not self.second_layer and self.n_chips > self.chips_per_backplane:
            raise ValueError(
                "more than one backplane of chips requires the second-layer "
                f"interconnect: {self.n_chips} > {self.chips_per_backplane}")
        if self.second_layer:
            max_chips = self.chips_per_backplane * SECOND_LAYER_FANOUT
            if self.n_chips > max_chips:
                raise ValueError(f"second layer supports ≤{max_chips} chips")

    def backplane_of(self, chip: int) -> int:
        return chip // self.chips_per_backplane

    @property
    def n_backplanes(self) -> int:
        return -(-self.n_chips // self.chips_per_backplane)

    @property
    def n_neurons(self) -> int:
        return self.n_chips * NEURONS_PER_CHIP

    @property
    def n_synapses(self) -> int:
        return self.n_chips * SYNAPSES_PER_CHIP

    def transceiver_hops(self, src_chip: int, dst_chip: int) -> int:
        """MGT hops between two chips (0 if same chip)."""
        if src_chip == dst_chip:
            return 0
        if self.backplane_of(src_chip) == self.backplane_of(dst_chip):
            return 2                       # node → aggregator → node
        return 4                           # node → agg → 2nd layer → agg → node

    def fpgas_traversed(self, src_chip: int, dst_chip: int) -> int:
        if src_chip == dst_chip:
            return 1
        if self.backplane_of(src_chip) == self.backplane_of(dst_chip):
            return 3                       # sender node, aggregator, receiver
        return 5

    def chip_to_chip_latency_ns(self, src_chip: int, dst_chip: int,
                                params: LatencyParams = DEFAULT_PARAMS
                                ) -> float:
        """Deterministic (uncongested) latency along the star path."""
        if src_chip == dst_chip:
            return params.on_chip_ns
        base = params.chip_to_chip_ns()
        if self.backplane_of(src_chip) == self.backplane_of(dst_chip):
            return base
        return base + params.second_layer_extra_ns()


# The paper's deployed and projected systems.
PROTOTYPE_4CHIP = Topology(n_chips=4)
FULL_BACKPLANE = Topology(n_chips=12)
FULL_RACK = Topology(n_chips=24, second_layer=True)
PROJECTED_120CHIP = Topology(n_chips=120, second_layer=True)
