"""Holding two runs of the same stream against each other.

The integer datapath (rasters, drops, latencies, validity) must be equal.
The float chip state may differ in its last bits between two backends —
one contracts a multiply-add into a fused one, another does not — so a
spike may flip where the membrane sits within such a difference of the
threshold.  ``compare_streams`` allows exactly that and nothing else: up
to the first step whose rasters differ every output must be equal; at that
step every differing spike must have a reference margin ``|v − v_th|``
below ``FLIP_MARGIN``; after it the runs are no longer comparable.  Where
the rasters agree throughout, the final float state must agree within
``STATE_ATOL``.

Used by the CPU tests (JAX reference against the port) and by
``chip_smoke.py`` (the port on the CPU against the port on the card).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.snn import chip as chiplib
from repro_torch.snn import neuron as nrn

# Largest reference margin at which a spike may flip: XLA's or the card's
# fused multiply-adds move the membrane by a few float32 ulp (~1e-7 at
# v ≈ 1) per step, and such differences accumulate over a few steps.
FLIP_MARGIN = 1e-5
# Tolerance of the final float state where the rasters agree, for the same
# reason.
STATE_ATOL = 1e-5
# Tolerance of the final plasticity traces and weights (0..63) where the
# rasters agree: the port rounds the update as the reference does
# (``snn.plasticity``), bit for bit but for a float64 sum that rounds onto
# a float32 midpoint, one ulp of a weight (3.8e-6 at 63).
PLASTICITY_ATOL = 1e-5

INT_FIELDS = ("dropped", "uplink_dropped", "latency_ns", "latency_valid",
              "unroutable", "rerouted")
FLOAT_STATE = ("v", "i_syn", "w_adapt")


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_equal(name: str, ref, got) -> None:
    """Exact equality with the first mismatch in the message."""
    a, b = as_numpy(ref), as_numpy(got)
    if a.shape != b.shape:
        raise AssertionError(f"{name}: shape {b.shape} != reference {a.shape}")
    bad = np.argwhere(a != b)
    if bad.size:
        i = tuple(int(k) for k in bad[0])
        raise AssertionError(f"{name}: {len(bad)} mismatches, first at {i}: "
                             f"{b[i]} != reference {a[i]}")


def spike_margin(params, state, ext_drive: torch.Tensor, cfg,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """|v − v_th| before the threshold of the step that starts from
    ``state`` (delay line in shift order, so slot 0 is due) with
    ``ext_drive`` — computed with the port's float32 arithmetic, which
    differs from another backend's by a few ulp.  Under plasticity pass
    that step's evolving ``weights`` (shared [c, rows, n] or per slot
    [c, batch, rows, n]) in place of ``params.chips.weights``."""
    drive = ext_drive + state.inflight[0]
    current = chiplib.synapse_current(params.chips, drive, cfg.chip, weights)
    _, v = nrn.membrane(state.chips.neurons, current, cfg.chip.neuron)
    return (v - cfg.chip.neuron.v_th).abs()


def compare_streams(ref, got, margin_at: Callable[[int], torch.Tensor]
                    ) -> dict:
    """Hold ``got`` against ``ref`` (two ``StreamOut``s of the same inputs).

    ``margin_at(t)`` returns the reference's ``spike_margin`` at step ``t``
    [n_chips, batch, n_neurons]; it is called only if the rasters diverge.
    Raises ``AssertionError`` on any mismatch the flip rule does not allow.
    Returns ``{"steps", "first_flip_step", "flips": [(t, chip, batch,
    neuron, margin)], "state_max_err"}``, and ``"plasticity_max_err"``
    where the runs were plastic and the rasters agree (final traces and
    weights within ``PLASTICITY_ATOL``).
    """
    ref_spk, got_spk = as_numpy(ref.spikes), as_numpy(got.spikes)
    if ref_spk.shape != got_spk.shape:
        raise AssertionError(f"spikes: shape {got_spk.shape} != reference "
                             f"{ref_spk.shape}")
    n_steps = ref_spk.shape[0]
    differs = [t for t in range(n_steps)
               if not np.array_equal(ref_spk[t], got_spk[t])]
    t_flip = differs[0] if differs else n_steps
    for field in INT_FIELDS:
        assert_equal(f"{field}[:{t_flip}]", as_numpy(getattr(ref, field))[:t_flip],
                     as_numpy(getattr(got, field))[:t_flip])
    report = {"steps": n_steps, "first_flip_step": None, "flips": [],
              "state_max_err": None}
    if differs:
        margin = as_numpy(margin_at(t_flip))
        for c, b, k in np.argwhere(ref_spk[t_flip] != got_spk[t_flip]):
            m = float(margin[c, b, k])
            report["flips"].append((t_flip, int(c), int(b), int(k), m))
            if not m < FLIP_MARGIN:
                raise AssertionError(
                    f"spike ({t_flip}, chip {c}, batch {b}, neuron {k}) "
                    f"differs with reference margin {m:.3g} >= "
                    f"{FLIP_MARGIN}")
        report["first_flip_step"] = t_flip
        return report
    ref_n, got_n = ref.state.chips.neurons, got.state.chips.neurons
    err = 0.0
    for field in FLOAT_STATE:
        a = as_numpy(getattr(ref_n, field))
        b = as_numpy(getattr(got_n, field))
        err = max(err, float(np.abs(a - b).max(initial=0.0)))
    if not err <= STATE_ATOL:
        raise AssertionError(f"final float state differs by {err:.3g} > "
                             f"{STATE_ATOL}")
    assert_equal("state refrac", ref_n.refrac, got_n.refrac)
    assert_equal("state inflight", ref.state.inflight, got.state.inflight)
    report["state_max_err"] = err
    if getattr(ref, "plasticity", None) is not None:
        perr = 0.0
        for field in ("trace_pre", "trace_post", "weights"):
            a = as_numpy(getattr(ref.plasticity, field))
            b = as_numpy(getattr(got.plasticity, field))
            if a.shape != b.shape:
                raise AssertionError(f"plasticity {field}: shape {b.shape} "
                                     f"!= reference {a.shape}")
            perr = max(perr, float(np.abs(a - b).max(initial=0.0)))
        if not perr <= PLASTICITY_ATOL:
            raise AssertionError(f"final plasticity state differs by "
                                 f"{perr:.3g} > {PLASTICITY_ATOL}")
        report["plasticity_max_err"] = perr
    return report
