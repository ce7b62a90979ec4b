"""One chip: 512 neurons, 256 synapse rows × 512 columns of 6-bit weights.

Port of ``src/repro/snn/chip.py``.  Every function here takes the stacked chips of
a network at once: parameters ``[n_chips, ...]`` and state
``[n_chips, batch, ...]``, so the synapse product is one ``torch.bmm``
over chips (the reference leaves this product to XLA outside any Pallas
kernel).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.snn import neuron as nrn

N_NEURONS = 512
N_SYNAPSE_ROWS = 256
WEIGHT_BITS = 6
WEIGHT_MAX = (1 << WEIGHT_BITS) - 1   # 63


@dataclasses.dataclass(frozen=True)
class ChipConfig:
    n_neurons: int = N_NEURONS
    n_rows: int = N_SYNAPSE_ROWS
    neuron: nrn.NeuronParams = nrn.LIF
    quantize_weights: bool = True
    # Fraction of crossbar outputs routed back on-chip (layer-1 recurrence).
    recurrent: bool = False


class ChipParams(NamedTuple):
    """Per-chip parameters, stacked over chips."""

    weights: torch.Tensor    # f32[n_chips, n_rows, n_neurons], range [0, 63]
    row_sign: torch.Tensor   # f32[n_chips, n_rows] in {+1, -1}
    w_scale: torch.Tensor    # f32[n_chips] digital→analog weight scale


class ChipState(NamedTuple):
    neurons: nrn.NeuronState   # arrays [n_chips, batch, n_neurons]


def init_params(n_chips: int, cfg: ChipConfig, generator: torch.Generator
                ) -> ChipParams:
    """Random chip parameters from ``generator`` (a CPU generator, so a seed
    gives the same weights on every device)."""
    weights = torch.rand((n_chips, cfg.n_rows, cfg.n_neurons),
                         generator=generator) * (WEIGHT_MAX / 4)
    # 20 % inhibitory rows (typical cortical ratio).
    sign = torch.where(torch.rand((n_chips, cfg.n_rows), generator=generator)
                       < 0.8, 1.0, -1.0)
    # Normalize total drive by fan-in so a chip with a few dozen active rows
    # sits near threshold.
    scale = torch.full((n_chips,), 4.0 / (WEIGHT_MAX * math.sqrt(cfg.n_rows)),
                       dtype=torch.float32)
    return ChipParams(weights=weights, row_sign=sign, w_scale=scale)


def init_state(cfg: ChipConfig, n_chips: int, batch: int, *,
               device=None) -> ChipState:
    """Resting state of ``n_chips`` chips, on the card unless ``device``
    says otherwise."""
    return ChipState(neurons=nrn.init_state((n_chips, batch, cfg.n_neurons),
                                            cfg.neuron, device=device))


def quantize_ste(w: torch.Tensor) -> torch.Tensor:
    """6-bit straight-through quantization: the forward value is exactly
    ``round(w)`` (half to even), the gradient passes straight through
    (halved on the clip bounds 0 and 63, as the reference's)."""
    w = nrn.clip(w, 0.0, WEIGHT_MAX)
    return w + (torch.round(w) - w).detach()


def effective_weights(params: ChipParams, cfg: ChipConfig,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """``(w · w_scale) · row_sign`` in the reference's order: of
    ``params.weights`` [c, rows, n], or of ``weights``, shared [c, rows, n]
    or per slot [c, batch, rows, n]."""
    w = params.weights if weights is None else weights
    w = quantize_ste(w) if cfg.quantize_weights else w
    if w.dim() == 4:
        return ((w * params.w_scale[:, None, None, None])
                * params.row_sign[:, None, :, None])
    return (w * params.w_scale[:, None, None]) * params.row_sign[:, :, None]


def synapse_current(params: ChipParams, in_spikes: torch.Tensor,
                    cfg: ChipConfig,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """The row contraction of one step, [c, batch, n]: ``in_spikes``
    [c, batch, rows] against the shared weights (``params.weights``, or
    ``weights`` [c, rows, n]) in one ``bmm`` over chips, or against
    per-slot weights [c, batch, rows, n] in one ``bmm`` of ``[1, rows] ×
    [rows, n]`` products, one a slot: the per-problem shape of the shared
    product at batch 1, so a slot equals a batch-1 ``chip_step``."""
    w_eff = effective_weights(params, cfg, weights)
    if w_eff.dim() == 3:
        return torch.bmm(in_spikes, w_eff)
    c, b, r, n = w_eff.shape
    return torch.bmm(in_spikes.reshape(c * b, 1, r),
                     w_eff.reshape(c * b, r, n)).reshape(c, b, n)


def chip_step(params: ChipParams, state: ChipState, in_spikes: torch.Tensor,
              cfg: ChipConfig = ChipConfig()
              ) -> tuple[ChipState, torch.Tensor]:
    """One hardware time step of every chip.

    Args:
      in_spikes: f32[n_chips, batch, n_rows] row drive this step.

    Returns:
      (new_state, out_spikes f32[n_chips, batch, n_neurons]).
    """
    current = synapse_current(params, in_spikes, cfg)
    new_neurons, spikes = nrn.neuron_step(state.neurons, current, cfg.neuron)
    return ChipState(neurons=new_neurons), spikes


def chip_step_slots(params: ChipParams, state: ChipState,
                    in_spikes: torch.Tensor, weights: torch.Tensor,
                    cfg: ChipConfig = ChipConfig()
                    ) -> tuple[ChipState, torch.Tensor]:
    """One step of every chip with per-slot weight arrays (the
    multi-tenant engine): ``chip_step``'s order (quantize, scale, row
    sign, contraction, neuron step), but batch row ``b`` of chip ``c``
    integrates ``weights[c, b]`` (f32[n_chips, batch, n_rows, n_neurons]).
    Each slot's contraction is a batch-1 ``chip_step``'s, bit for bit
    (``synapse_current``)."""
    current = synapse_current(params, in_spikes, cfg, weights)
    new_neurons, spikes = nrn.neuron_step(state.neurons, current, cfg.neuron)
    return ChipState(neurons=new_neurons), spikes


def crossbar_to_rows(out_spikes: torch.Tensor,
                     select: torch.Tensor) -> torch.Tensor:
    """Layer-1 crossbar: neuron outputs [..., n_neurons] onto synapse-row
    drivers through the 0/1 matrix ``select`` [n_neurons, n_rows]."""
    return out_spikes @ select


def spikes_to_labels(out_spikes: torch.Tensor, chip_id: int,
                     neuron_bits: int = 9
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode dense output spikes as (labels, valid) for the layer-2 tap:
    ``chip_id << neuron_bits | neuron_idx``."""
    n = out_spikes.shape[-1]
    ids = (torch.arange(n, dtype=torch.int32, device=out_spikes.device)
           + (chip_id << neuron_bits))
    return ids.expand(out_spikes.shape).contiguous(), out_spikes > 0.5


def labels_to_rows(labels: torch.Tensor, valid: torch.Tensor,
                   row_of_label: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Decode routed ingress labels into a dense synapse-row drive.

    ``row_of_label`` maps a 16-bit label to a row (or -1 = no row): one
    table ``[2^16]``, or one per node ``[n, 2^16]`` with ``labels``
    ``[..., n, k]``.  Events onto one row accumulate (sums of ones, exact in
    any order)."""
    idx = (labels & 0xFFFF).long()
    if row_of_label.dim() == 1:
        rows = row_of_label[idx]
    else:
        node = torch.arange(row_of_label.shape[0], device=labels.device)
        rows = row_of_label[node[:, None], idx]
    ok = valid & (rows >= 0)
    rows = torch.where(ok, rows, n_rows).long()     # park invalid in slot n
    drive = torch.zeros((*labels.shape[:-1], n_rows + 1), dtype=torch.float32,
                        device=labels.device)
    drive.scatter_add_(-1, rows, ok.to(torch.float32))
    return drive[..., :n_rows]
