"""Spike encoders: analog values → input spike trains.

Port of ``src/repro/snn/encoding.py``.  ``poisson_encode`` draws its
uniforms from a ``torch.Generator``, or takes them as ``draws`` (the
reference's own ``jax.random.uniform`` array gives its spikes bit for bit);
the other two encoders are deterministic.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device


def poisson_encode(values: torch.Tensor, n_steps: int,
                   max_rate_per_step: float = 0.5, *,
                   generator: torch.Generator | None = None,
                   draws: torch.Tensor | None = None,
                   device=None) -> torch.Tensor:
    """Rate coding: values in [0, 1] → Bernoulli spike trains, a spike
    where the uniform draw lies below ``clip(value) · max_rate_per_step``.

    ``draws``: the uniforms f32[n_steps, *values.shape]; else they come
    from ``generator`` on its device.  Returns f32[n_steps, *values.shape]
    on ``device`` (default CUDA)."""
    device = resolve_device(device)
    values = torch.as_tensor(values, dtype=torch.float32).to(device)
    p = torch.clamp(values, 0.0, 1.0) * max_rate_per_step
    shape = (n_steps, *values.shape)
    if draws is None:
        if generator is None:
            raise ValueError("poisson_encode needs a generator or draws")
        draws = torch.rand(shape, generator=generator,
                           device=generator.device)
    elif tuple(draws.shape) != shape:
        raise ValueError(f"draws must be f32{list(shape)}, got "
                         f"{list(draws.shape)}")
    u = draws.to(device=device, dtype=torch.float32)
    return (u < p).to(torch.float32)


def latency_encode(values: torch.Tensor, n_steps: int, *,
                   device=None) -> torch.Tensor:
    """Time-to-first-spike coding: larger value → earlier single spike.
    Returns f32[n_steps, *values.shape]."""
    device = resolve_device(device)
    v = torch.clamp(torch.as_tensor(values, dtype=torch.float32).to(device),
                    0.0, 1.0)
    t_spike = torch.round((1.0 - v) * (n_steps - 1)).to(torch.int32)
    steps = torch.arange(n_steps, dtype=torch.int32, device=device)
    shape = (n_steps,) + (1,) * v.dim()
    return (steps.reshape(shape) == t_spike[None]).to(torch.float32)


def regular_encode(rate_hz: float, n_steps: int, dt_us: float,
                   phase_us: float = 0.0, n_channels: int = 1, *,
                   device=None) -> torch.Tensor:
    """Regular (deterministic) spike trains, the Fig 5 stimulus.  Returns
    f32[n_steps, n_channels]."""
    device = resolve_device(device)
    period_us = 1e6 / rate_hz
    t = torch.arange(n_steps, dtype=torch.float32, device=device) * dt_us
    phase = torch.remainder(t - phase_us, period_us)
    spikes = (phase < dt_us).to(torch.float32)
    return spikes[:, None].repeat(1, n_channels)
