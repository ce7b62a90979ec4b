"""Topology constants of the multi-chip system (paper §II/§V).

Port of the constants of ``src/repro/core/interconnect.py``: one backplane hosts
up to 12 chips behind Node-FPGAs, joined in a star by one Aggregator with
12 lanes plus 4 extension lanes; two backplanes share a 4U case; a second
layer joins up to 10 Aggregators.
"""

CHIPS_PER_BACKPLANE = 12
AGGREGATOR_LANES = 12
EXTENSION_LANES = 4
BACKPLANES_PER_RACK = 2
SECOND_LAYER_FANOUT = 10        # aggregators per second-layer node (§V)

NEURONS_PER_CHIP = 512
SYNAPSES_PER_CHIP = 131_072
