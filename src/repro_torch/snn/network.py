"""Multi-chip SNN: chips joined by the interconnect.

Port of the event-mode parts of ``src/repro/snn/network.py``: configuration,
parameters and state of a network of stacked chips.  Inter-chip spikes
arrive after ``delay_steps`` whole steps, derived from the chip-to-chip
latency and the step ``dt``.  The dense (differentiable) routing path is
queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import aggregator as agg
from repro_torch.core import routing as rt
from repro_torch.core.latency import DEFAULT_PARAMS, LatencyParams
from repro_torch.snn import chip as chiplib

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


def to_device(tree, device):
    """Copy a NamedTuple tree of tensors to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(to_device(x, device) for x in tree))
