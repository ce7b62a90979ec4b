"""The benchmark's inputs, made from ``--seed`` on the device in a few
large calls: the chips' float weights, row signs and scales, the external
drives and the tenants' stimuli.  The same seed gives the same inputs;
the program and the reference are handed the same tensors."""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def chip_params(config: dict, gen: torch.Generator, device):
    """(weights f32[n, rows, neurons] uniform in [0, max), row_sign
    f32[n, rows] in {+1, -1} with the configured inhibitory share, w_scale
    f32[n])."""
    chip = config["chip"]
    n, rows, k = config["chips"], chip["synapse_rows"], chip["neurons"]
    weights = (torch.rand((n, rows, k), generator=gen, device=device)
               * float(chip["weight_init_max"]))
    row_sign = torch.where(
        torch.rand((n, rows), generator=gen, device=device)
        < 1.0 - float(chip["inhibitory_share"]), 1.0, -1.0)
    w_scale = torch.full((n,), float(chip["w_scale"]), dtype=torch.float32,
                         device=device)
    return weights, row_sign, w_scale


def drives(config: dict, steps: int, batch: int, p: float,
           gen: torch.Generator, device) -> torch.Tensor:
    """f32[steps, n, batch, rows]: an external spike on each synapse row
    and step with probability ``p``."""
    n, rows = config["chips"], config["chip"]["synapse_rows"]
    out = torch.empty((steps, n, batch, rows), dtype=torch.float32,
                      device=device)
    for t in range(steps):
        out[t] = (torch.rand((n, batch, rows), generator=gen, device=device)
                  < p)
    return out


def sample_rows(seed: int, batch: int, count: int) -> list[int]:
    """``count`` distinct batch rows drawn from the seed, sorted."""
    rng = np.random.default_rng([int(seed), 1])
    return sorted(int(r) for r in rng.choice(batch, size=min(count, batch),
                                             replace=False))


def session_pool(config: dict, traffic: dict, seed: int):
    """The tenants' sessions: stimuli f32[L, n_stim, rows], each
    stimulated row spiking with ``stim_p`` a step.  Every seed gets the
    same lengths in another order: blocks that each hold every length of
    the range once, each block in an order drawn from the seed, repeated
    to at least ``traffic["pool"]`` sessions (so any run of consecutive
    sessions holds about the same mix)."""
    rng = np.random.default_rng([int(seed), 2])
    lo, hi = traffic["lengths"]
    span = np.arange(lo, hi + 1)
    lengths = np.concatenate([
        rng.permutation(span)
        for _ in range(math.ceil(traffic["pool"] / len(span)))])
    n_stim = len(traffic["stim_chips"])
    rows = config["chip"]["synapse_rows"]
    return [(rng.random((int(L), n_stim, rows)) < traffic["stim_p"]
             ).astype(np.float32) for L in lengths]
