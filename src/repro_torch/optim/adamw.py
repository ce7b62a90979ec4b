"""AdamW with global-norm clipping and a cosine schedule (port of
``src/repro/optim/adamw.py``).

Parameters are a module (its ``named_parameters``) or a ``{name: tensor}``
mapping; the optimizer state ``m`` and ``v`` are float32 ``{name: tensor}``
dicts keyed by the same names.  The arithmetic keeps the JAX package's
order: the clip scale from the global norm, the bias corrections in
float32, then ``p - lr·(m̂/(√v̂ + eps) + wd·p)`` (``torch.optim.AdamW``
decays in another order).  ``update`` writes the parameters, ``m`` and
``v`` in place, where the JAX package returns new trees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: dict
    v: dict


def named(params) -> dict:
    """``{name: tensor}`` of a module or of a mapping."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init(params) -> AdamWState:
    params = named(params)

    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    device = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros(), v=zeros())


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``; float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
    cosine = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return cfg.lr * warm * cosine


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm over every tensor of ``tree`` (a mapping)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


@torch.no_grad()
def update(params, grads: dict, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step.  ``grads``: ``{name: tensor}`` for every parameter.
    Writes the parameters, ``state.m`` and ``state.v`` in place.

    Returns (params, new_state, {"grad_norm", "lr"}) as the JAX package's
    ``update`` does."""
    named_params = named(params)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.betas
    step_f = step.to(torch.float32)
    bc1 = 1 - b1 ** step_f
    bc2 = 1 - b2 ** step_f

    for name, p in named_params.items():
        g = grads[name].to(torch.float32) * scale
        m, v = state.m[name], state.v[name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p
        p.sub_(lr * step_)
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
