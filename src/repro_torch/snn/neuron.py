"""Neuron dynamics of the analog substrate, discretized in PyTorch.

Port of ``src/repro/snn/neuron.py``: AdEx (adaptive exponential integrate-and-fire)
neurons, LIF in the limit of zero exponential slope and zero adaptation,
stepped by exponential Euler.  ``neuron_step`` keeps the reference's exact
operation order; thresholding uses the SuperSpike surrogate gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class NeuronParams:
    """AdEx parameters (LIF when delta_t == 0 and a == b == 0), in hardware
    microseconds."""

    tau_mem_us: float = 10.0       # membrane time constant
    tau_syn_us: float = 5.0        # synaptic current time constant
    tau_adapt_us: float = 100.0    # adaptation time constant (AdEx w)
    v_leak: float = 0.0            # leak / rest potential (normalized units)
    v_th: float = 1.0              # spike threshold
    v_reset: float = 0.0           # reset potential
    v_exp: float = 0.8             # exponential threshold (AdEx)
    delta_t: float = 0.0           # exponential slope; 0 → pure LIF
    adapt_a: float = 0.0           # sub-threshold adaptation coupling
    adapt_b: float = 0.0           # spike-triggered adaptation increment
    refrac_us: float = 0.0         # refractory period
    dt_us: float = 1.0             # integration step

    @property
    def alpha_mem(self) -> float:
        return math.exp((-self.dt_us / self.tau_mem_us))

    @property
    def alpha_syn(self) -> float:
        return math.exp((-self.dt_us / self.tau_syn_us))

    @property
    def alpha_adapt(self) -> float:
        return math.exp((-self.dt_us / self.tau_adapt_us))

    @property
    def refrac_steps(self) -> int:
        return int(round(self.refrac_us / self.dt_us))


LIF = NeuronParams()
ADEX = NeuronParams(delta_t=0.06, adapt_a=0.02, adapt_b=0.1)


class NeuronState(NamedTuple):
    v: torch.Tensor          # membrane potential        f32[..., n]
    i_syn: torch.Tensor      # synaptic current          f32[..., n]
    w_adapt: torch.Tensor    # adaptation current        f32[..., n]
    refrac: torch.Tensor     # refractory countdown      i32[..., n]


def init_state(shape: tuple[int, ...], params: NeuronParams = LIF, *,
               device=None) -> NeuronState:
    """Resting state, on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    return NeuronState(
        v=torch.full(shape, params.v_leak, dtype=torch.float32, device=device),
        i_syn=torch.zeros(shape, dtype=torch.float32, device=device),
        w_adapt=torch.zeros(shape, dtype=torch.float32, device=device),
        refrac=torch.zeros(shape, dtype=torch.int32, device=device))


SURROGATE_BETA = 10.0


class SpikeFn(torch.autograd.Function):
    """Heaviside forward, SuperSpike surrogate backward (Zenke & Ganguli
    2018): d spike / dx = 1 / (β|x| + 1)²."""

    @staticmethod
    def forward(ctx, v_minus_th):
        ctx.save_for_backward(v_minus_th)
        return (v_minus_th > 0.0).to(v_minus_th.dtype)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad / (SURROGATE_BETA * x.abs() + 1.0) ** 2


spike_fn = SpikeFn.apply


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``torch.clamp``'s values with ``jnp.clip``'s gradient: a value on a
    bound gets half the gradient (``torch.clamp`` passes all of it), as
    ``minimum(maximum(x, lo), hi)`` splits a tie in both frameworks."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def membrane(state: NeuronState, input_current: torch.Tensor,
             params: NeuronParams = LIF
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first half of ``neuron_step``: (i_syn, v) after integration and
    the refractory clamp, before the threshold."""
    p = params
    # add(c, x, alpha=a) = c + a·x rounds like the reference's fused
    # multiply-add on the CPU, where plain a*x + c rounds twice.
    i_syn = torch.add(input_current, state.i_syn, alpha=p.alpha_syn)
    dv_leak = (1.0 - p.alpha_mem) * (p.v_leak - state.v)
    if p.delta_t > 0.0:
        # Exponential spike-initiation current, clipped (the analog circuit
        # saturates similarly).
        exp_arg = clip((state.v - p.v_exp) / p.delta_t, -20.0, 20.0)
        dv_exp = (1.0 - p.alpha_mem) * p.delta_t * torch.exp(exp_arg)
    else:
        dv_exp = 0.0
    dv = dv_leak + dv_exp + (1.0 - p.alpha_mem) * (i_syn - state.w_adapt)
    v = state.v + dv
    in_refrac = state.refrac > 0
    v = torch.where(in_refrac, torch.full_like(v, p.v_reset), v)
    return i_syn, v


def neuron_step(state: NeuronState, input_current: torch.Tensor,
                params: NeuronParams = LIF
                ) -> tuple[NeuronState, torch.Tensor]:
    """One exponential-Euler step of AdEx/LIF dynamics.

    Returns (new_state, spikes) with spikes in {0, 1} (float, surrogate
    differentiable)."""
    p = params
    i_syn, v = membrane(state, input_current, p)
    in_refrac = state.refrac > 0
    spikes = spike_fn(v - p.v_th)
    spikes = torch.where(in_refrac, torch.zeros_like(spikes), spikes)
    # Reset + adaptation, on the already thresholded value so the surrogate
    # gradient path through spike_fn stays intact.
    v = (1.0 - spikes) * v + spikes * p.v_reset
    w_adapt = (p.alpha_adapt * state.w_adapt
               + (1.0 - p.alpha_adapt) * p.adapt_a * (state.v - p.v_leak)
               + spikes * p.adapt_b)
    refrac = torch.where(spikes > 0,
                         torch.full_like(state.refrac, p.refrac_steps),
                         torch.clamp(state.refrac - 1, min=0))
    return NeuronState(v=v, i_syn=i_syn, w_adapt=w_adapt,
                       refrac=refrac), spikes
