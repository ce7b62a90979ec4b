"""On-chip plasticity (hybrid plasticity, Pehle et al. 2022).

Port of ``src/repro/snn/plasticity.py``: each chip's embedded processors
observe correlation sensors in the synapse array and rewrite the 6-bit
weights while the network runs.  Here that is an STDP update on
exponentially filtered pre- and post-synaptic traces over the whole
256 × 512 array, for one chip (``stdp_step``), for every chip of a streamed
network with one weight array per chip (``stdp_stream_step``), and with one
weight array per batch row (``stdp_slot_step``).

Rounding.  The reference's update runs compiled by XLA, which fuses each
multiply feeding an add into one fused multiply-add, rounded once: the
trace filters ``alpha·trace + spikes``, the batch contraction of the
shared update (a chain of fused multiply-adds over the batch rows, in
order), ``lr_pot·E1 - (lr_dep·E2)`` and ``w + dw·WEIGHT_MAX``.  The port
rounds each of these once too (``_fma``): float32 operands multiply
exactly in float64, and the float64 sum rounded to float32 is the fused
result, except where that float64 sum itself rounds onto a float32
rounding midpoint (about one inexact sum in 2^29).  Every other operation
is one float32 operation in the reference's order.  No BLAS call sums
anything, so the update is the same elementwise computation on the CPU
and on the card, bit for bit, and the weights the chips quantize do not
drift between devices.  On the card the per-slot step runs the kernel
``kernels/stdp_slot``, whose ``__fmaf_rn`` rounds each fused multiply-add
once as XLA does: it equals this emulation except at those midpoints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.snn.chip import WEIGHT_MAX
from repro_torch.snn.neuron import clip


@dataclasses.dataclass(frozen=True)
class STDPConfig:
    tau_pre_us: float = 20.0
    tau_post_us: float = 20.0
    lr_pot: float = 0.05        # potentiation rate (pre-before-post)
    lr_dep: float = 0.06        # depression rate  (post-before-pre)
    dt_us: float = 1.0

    @property
    def alpha_pre(self) -> float:
        return math.exp((-self.dt_us / self.tau_pre_us))

    @property
    def alpha_post(self) -> float:
        return math.exp((-self.dt_us / self.tau_post_us))


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (exact in float64)."""
    return float(torch.tensor(x, dtype=torch.float32))


def _fma(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once to float32, for float32 tensors ``b`` and
    ``c`` and a scalar ``a`` rounded to float32 first."""
    return torch.add(c.to(torch.float64), b.to(torch.float64),
                     alpha=_f32(a)).to(torch.float32)


def _traces(trace_pre, trace_post, pre, post, cfg: STDPConfig):
    return (_fma(cfg.alpha_pre, trace_pre, pre),
            _fma(cfg.alpha_post, trace_post, post))


def _new_weights(weights, e1, e2, cfg: STDPConfig, batch: int = 1):
    """``clip(w + ((lr_pot·E1 − lr_dep·E2) / batch)·WEIGHT_MAX, 0,
    WEIGHT_MAX)`` with the reference's roundings; ``neuron.clip`` gives a
    weight on a bound ``jnp.clip``'s half gradient."""
    dw = _fma(cfg.lr_pot, e1, -(e2 * _f32(cfg.lr_dep))) / batch
    return clip(_fma(float(WEIGHT_MAX), dw, weights), 0.0, WEIGHT_MAX)


class STDPState(NamedTuple):
    trace_pre: torch.Tensor    # f32[n_rows]
    trace_post: torch.Tensor   # f32[n_neurons]


def init_stdp(n_rows: int, n_neurons: int, *, device=None) -> STDPState:
    """Zero traces, on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    return STDPState(trace_pre=torch.zeros((n_rows,), device=device),
                     trace_post=torch.zeros((n_neurons,), device=device))


def stdp_step(state: STDPState, weights: torch.Tensor, pre: torch.Tensor,
              post: torch.Tensor, cfg: STDPConfig = STDPConfig()
              ) -> tuple[STDPState, torch.Tensor]:
    """One plasticity step of one chip: ``weights`` f32[n_rows, n_neurons],
    ``pre`` f32[n_rows] presynaptic and ``post`` f32[n_neurons]
    postsynaptic spikes this step.  Pre-before-post potentiates,
    post-before-pre depresses."""
    trace_pre, trace_post = _traces(state.trace_pre, state.trace_post, pre,
                                    post, cfg)
    new_w = _new_weights(weights, trace_pre[:, None] * post[None, :],
                         pre[:, None] * trace_post[None, :], cfg)
    return STDPState(trace_pre=trace_pre, trace_post=trace_post), new_w


# ---------------------------------------------------------------------------
# Network-wide online plasticity for the streaming engine
# ---------------------------------------------------------------------------


class StreamPlasticityState(NamedTuple):
    """The plasticity state of a streamed multi-chip run: per-chip,
    per-batch trace filters and the evolving weight arrays."""

    trace_pre: torch.Tensor    # f32[n_chips, batch, n_rows]
    trace_post: torch.Tensor   # f32[n_chips, batch, n_neurons]
    weights: torch.Tensor      # f32[n_chips, n_rows, n_neurons]


def init_stream_stdp(weights: torch.Tensor, batch: int
                     ) -> StreamPlasticityState:
    """Zero traces over the given stacked weights (f32[n_chips, n_rows,
    n_neurons], e.g. ``params.chips.weights``), on their device."""
    n_chips, n_rows, n_neurons = weights.shape
    dev = weights.device
    return StreamPlasticityState(
        trace_pre=torch.zeros((n_chips, batch, n_rows), device=dev),
        trace_post=torch.zeros((n_chips, batch, n_neurons), device=dev),
        weights=weights.to(torch.float32))


def _batch_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum("cbr,cbn->crn", a, b)`` as the reference computes it: a
    chain of fused multiply-adds over the batch rows, in order, each
    rounded once as in ``_fma`` (the float64 sum of an exact product,
    rounded to float32), in place on two buffers."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    acc = torch.zeros((a.shape[0], a.shape[2], b.shape[2]),
                      dtype=torch.float32, device=a.device)
    wide = torch.empty(acc.shape, dtype=torch.float64, device=a.device)
    for k in range(a.shape[1]):
        wide.copy_(acc).addcmul_(a64[:, k, :, None], b64[:, k, None, :])
        acc.copy_(wide)
    return acc


def stdp_stream_step(state: StreamPlasticityState, pre: torch.Tensor,
                     post: torch.Tensor, cfg: STDPConfig = STDPConfig()
                     ) -> StreamPlasticityState:
    """One plasticity walk over every chip of a streamed network.

    ``pre`` is this step's synapse-row drive (f32[n_chips, batch,
    n_rows]), ``post`` the output spikes (f32[n_chips, batch,
    n_neurons]).  Traces filter per batch row; each chip's weight array is
    shared by the batch, so its update is the batch mean of the rows'
    outer products.  At batch 1 on one chip this is ``stdp_step``, bit for
    bit.
    """
    trace_pre, trace_post = _traces(state.trace_pre, state.trace_post, pre,
                                    post, cfg)
    weights = _new_weights(state.weights, _batch_sum(trace_pre, post),
                           _batch_sum(pre, trace_post), cfg, pre.shape[1])
    return StreamPlasticityState(trace_pre=trace_pre, trace_post=trace_post,
                                 weights=weights)


# ---------------------------------------------------------------------------
# Per-slot online plasticity for the multi-tenant emulation engine
# ---------------------------------------------------------------------------


class SlotPlasticityState(NamedTuple):
    """Per-slot plasticity: every batch row evolves its own weight copy,
    so S concurrent sessions equal S independent batch-1 runs.  At batch 1
    this is the shared path, bit for bit."""

    trace_pre: torch.Tensor    # f32[n_chips, batch, n_rows]
    trace_post: torch.Tensor   # f32[n_chips, batch, n_neurons]
    weights: torch.Tensor      # f32[n_chips, batch, n_rows, n_neurons]


def init_slot_stdp(weights: torch.Tensor, batch: int) -> SlotPlasticityState:
    """Zero traces, every slot's weights a copy of the given shared ones
    (f32[n_chips, n_rows, n_neurons]), on their device."""
    n_chips, n_rows, n_neurons = weights.shape
    dev = weights.device
    return SlotPlasticityState(
        trace_pre=torch.zeros((n_chips, batch, n_rows), device=dev),
        trace_post=torch.zeros((n_chips, batch, n_neurons), device=dev),
        weights=weights.to(torch.float32)[:, None].expand(
            n_chips, batch, n_rows, n_neurons).clone())


def stdp_slot_step(state: SlotPlasticityState, pre: torch.Tensor,
                   post: torch.Tensor, cfg: STDPConfig = STDPConfig(),
                   mask: torch.Tensor | None = None) -> SlotPlasticityState:
    """One plasticity walk with per-slot weights: each slot's outer
    products rewrite only that slot's array.  ``mask`` (bool[batch])
    freezes the masked-out slots: their traces and weights pass through
    unchanged.

    The hand-written kernel ``kernels/stdp_slot`` computes it on CUDA
    tensors in one launch and refuses a gradient there; CPU tensors take
    its plain version, which differentiates (``kernels.stdp_slot.ops.
    stdp_slot`` states the rule)."""
    # Imported here: the kernel's plain version imports this module.
    from repro_torch.kernels.stdp_slot.ops import stdp_slot
    return stdp_slot(state, pre, post, cfg, mask)
