"""Surrogate-gradient training across the multi-chip fabric.

Port of ``src/repro/snn/training.py``: BPTT with SuperSpike surrogates
through the dense routing mode (derived from the same LUT configuration as
the event datapath), rate-coded readout on the last chip, momentum SGD on
the chip weights.  The gradient comes from ``torch.autograd.grad`` through
``run_stream(mode="dense")``'s step loop.  Random inputs come from a
``torch.Generator``, or as ``draws``: the reference's own ``jax.random``
arrays give its batch bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.snn import network as net
from repro_torch.snn.encoding import poisson_encode


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    network: net.NetworkConfig = net.NetworkConfig()
    n_steps: int = 64
    n_classes: int = 4
    lr: float = 5e-2
    reg_rate: float = 1e-4       # firing-rate regularizer (keeps chips sparse)


class TaskDraws(NamedTuple):
    """The random inputs of ``synthetic_task``."""

    labels: torch.Tensor     # i32[batch] class of each example
    noise: torch.Tensor      # f32[batch, n_rows] in [0, 0.05)


class BatchDraws(NamedTuple):
    """The random inputs of ``make_batch``: the task's and the encoder's
    uniforms f32[n_steps, batch, n_rows]."""

    task: TaskDraws
    encode: torch.Tensor


def task_draws(batch: int, n_rows: int, n_classes: int,
               generator: torch.Generator) -> TaskDraws:
    """``synthetic_task``'s draws from ``generator`` on its device."""
    dev = generator.device
    labels = torch.randint(0, n_classes, (batch,), generator=generator,
                           device=dev, dtype=torch.int32)
    noise = torch.rand((batch, n_rows), generator=generator,
                       device=dev) * 0.05
    return TaskDraws(labels=labels, noise=noise)


def synthetic_task(batch: int, n_rows: int, n_classes: int, *,
                   generator: torch.Generator | None = None,
                   draws: TaskDraws | None = None, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Classify which of ``n_classes`` blocks of the input rows carries the
    elevated rate (0.9 against 0.08, plus noise).  Returns (values
    f32[batch, n_rows], labels int32[batch]) on ``device`` (default
    CUDA)."""
    device = resolve_device(device)
    if draws is None:
        if generator is None:
            raise ValueError("synthetic_task needs a generator or draws")
        draws = task_draws(batch, n_rows, n_classes, generator)
    labels = draws.labels.to(device=device, dtype=torch.int32)
    base = torch.full((batch, n_rows), 0.08, dtype=torch.float32,
                      device=device)
    block = n_rows // n_classes
    row_idx = torch.arange(n_rows, device=device)
    sel = (row_idx[None, :] // block) == labels[:, None]
    values = torch.where(sel, torch.full_like(base, 0.9), base)
    return values + draws.noise.to(device=device, dtype=torch.float32), labels


def forward_rates(params: net.NetworkParams, route_mats: torch.Tensor,
                  drives: torch.Tensor, cfg: TrainConfig, batch: int, *,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the network in dense mode from rest; return (per-class readout
    rates of the last chip f32[batch, n_classes], spikes f32[T, n_chips,
    batch, n_neurons])."""
    device = resolve_device(device)
    state = net.init_state(cfg.network, batch, device=device)
    _, spikes = net.run_dense(params, state, drives, route_mats, cfg.network,
                              device=device)
    rates = spikes[:, -1].mean(dim=0)                    # [batch, n_neurons]
    n_per_class = rates.shape[-1] // cfg.n_classes
    logits = rates.reshape(batch, cfg.n_classes, n_per_class).sum(-1)
    return logits, spikes


def loss_fn(params: net.NetworkParams, route_mats: torch.Tensor,
            drives: torch.Tensor, labels: torch.Tensor, cfg: TrainConfig, *,
            device=None) -> tuple[torch.Tensor, dict]:
    """Cross-entropy of the readout (logits × 10) plus the firing-rate
    regularizer.  Returns (loss, {"nll", "acc", "rate"}), 0-dim tensors."""
    device = resolve_device(device)
    labels = labels.to(device=device, dtype=torch.long)
    batch = labels.shape[0]
    logits, spikes = forward_rates(params, route_mats, drives, cfg, batch,
                                   device=device)
    logp = F.log_softmax(logits * 10.0, dim=-1)
    nll = -logp.gather(1, labels[:, None]).mean()
    rate = spikes.mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return nll + cfg.reg_rate * rate.square(), {"nll": nll, "acc": acc,
                                                "rate": rate}


@dataclasses.dataclass
class SGDState:
    params: net.NetworkParams
    momentum: net.NetworkParams


def train_step(params: net.NetworkParams, momentum: net.NetworkParams,
               route_mats: torch.Tensor, drives: torch.Tensor,
               labels: torch.Tensor, cfg: TrainConfig, *, device=None):
    """One momentum-SGD step on the chip weights alone (the routing tables
    and maps are static configuration): ``m = 0.9·m + g``, ``w -= lr·m``.

    ``momentum``: a ``NetworkParams`` whose ``chips.weights`` holds the
    momentum.  Returns (params, momentum, loss, aux) with new
    ``chips.weights`` in both and the rest as given."""
    device = resolve_device(device)
    params = net.to_device(params, device)
    weights = params.chips.weights.detach().requires_grad_(True)
    chips = params.chips._replace(weights=weights)
    loss, aux = loss_fn(params._replace(chips=chips), route_mats, drives,
                        labels, cfg, device=device)
    (g_w,) = torch.autograd.grad(loss, weights)
    m_new = 0.9 * momentum.chips.weights.to(device) + g_w
    new_w = params.chips.weights.detach() - cfg.lr * m_new
    return (params._replace(chips=params.chips._replace(weights=new_w)),
            momentum._replace(chips=momentum.chips._replace(weights=m_new)),
            loss.detach(), {k: v.detach() for k, v in aux.items()})


def make_batch(cfg: TrainConfig, batch: int, *,
               generator: torch.Generator | None = None,
               draws: BatchDraws | None = None, device=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode a synthetic batch: (drives f32[T, n_chips, batch, n_rows],
    the stimulus on chip 0; labels int32[batch]), from ``generator`` or
    ``draws``."""
    device = resolve_device(device)
    n_rows = cfg.network.chip.n_rows
    if draws is None:
        if generator is None:
            raise ValueError("make_batch needs a generator or draws")
        task = task_draws(batch, n_rows, cfg.n_classes, generator)
        encode = torch.rand((cfg.n_steps, batch, n_rows), generator=generator,
                            device=generator.device)
        draws = BatchDraws(task=task, encode=encode)
    values, labels = synthetic_task(batch, n_rows, cfg.n_classes,
                                    draws=draws.task, device=device)
    stim = poisson_encode(values, cfg.n_steps, draws=draws.encode,
                          device=device)                 # [T, batch, n_rows]
    drives = torch.zeros((cfg.n_steps, cfg.network.n_chips, batch, n_rows),
                         dtype=torch.float32, device=device)
    drives[:, 0] = stim                                  # stimulus → chip 0
    return drives, labels
