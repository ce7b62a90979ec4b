"""Plain PyTorch version of the per-slot STDP step: the reference's
``stdp_slot_step`` with its roundings (``snn.plasticity``'s ``_fma``: the
float64 sum of an exact product, rounded to float32), one pass over the
weights for each operation; and where the kernel's single fused roundings
may differ from it (``midpoints``)."""

from __future__ import annotations

import torch

from repro_torch.snn import plasticity as plas
from repro_torch.snn.chip import WEIGHT_MAX


def stdp_slot_ref(state: plas.SlotPlasticityState, pre: torch.Tensor,
                  post: torch.Tensor, cfg: plas.STDPConfig,
                  mask: torch.Tensor | None = None
                  ) -> plas.SlotPlasticityState:
    """One plasticity walk with per-slot weights (``stdp_slot_step``)."""
    trace_pre, trace_post = plas._traces(state.trace_pre, state.trace_post,
                                         pre, post, cfg)
    weights = plas._new_weights(state.weights,
                                trace_pre[..., :, None] * post[..., None, :],
                                pre[..., :, None] * trace_post[..., None, :],
                                cfg)
    if mask is not None:
        keep = mask.to(device=pre.device, dtype=torch.bool)[None, :, None]
        trace_pre = torch.where(keep, trace_pre, state.trace_pre)
        trace_post = torch.where(keep, trace_post, state.trace_post)
        weights = torch.where(keep[..., None], weights, state.weights)
    return plas.SlotPlasticityState(trace_pre=trace_pre,
                                    trace_post=trace_post, weights=weights)


def float32_midpoint(a: float, b: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """Where ``a·b + c``, summed in float64 from the exact product as the
    plain version's ``_fma`` sums it, lands on a float32 rounding midpoint
    that the exact sum is not on: only there may that sum rounded to
    float32 differ from one fused rounding (``__fmaf_rn``)."""
    p, c = b.double() * plas._f32(a), c.double()    # p: exact
    s = p + c
    # TwoSum: p + c == s + err exactly.
    back = s - p
    err = (p - (s - back)) + (c - back)
    r = s.float()
    toward = torch.where(s > r.double(), torch.inf, -torch.inf).float()
    neighbour = torch.nextafter(r, toward).double()
    return (err != 0) & ((r.double() + neighbour) / 2 == s)


def midpoints(state: plas.SlotPlasticityState, pre: torch.Tensor,
              post: torch.Tensor, cfg: plas.STDPConfig,
              mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Where the kernel may differ from ``stdp_slot_ref`` on these inputs,
    by field of the state: where a float64 sum of the plain version behind
    the value lands on a float32 midpoint (``float32_midpoint``), and
    never in a slot that ``mask`` freezes.  Several float64 temporaries of
    the weights' size: call it on a slice of chips at full width."""
    trace_pre, trace_post = plas._traces(state.trace_pre, state.trace_post,
                                         pre, post, cfg)
    mid_tp = float32_midpoint(cfg.alpha_pre, state.trace_pre, pre)
    mid_tq = float32_midpoint(cfg.alpha_post, state.trace_post, post)
    e1 = trace_pre[..., :, None] * post[..., None, :]
    e2 = pre[..., :, None] * trace_post[..., None, :]
    c_dw = -(e2 * plas._f32(cfg.lr_dep))
    dw = plas._fma(cfg.lr_pot, e1, c_dw)
    out = {"trace_pre": mid_tp, "trace_post": mid_tq,
           "weights": (mid_tp[..., :, None] | mid_tq[..., None, :]
                       | float32_midpoint(cfg.lr_pot, e1, c_dw)
                       | float32_midpoint(float(WEIGHT_MAX), dw,
                                          state.weights))}
    if mask is not None:
        keep = mask.to(device=pre.device, dtype=torch.bool)[None, :, None]
        out = {k: v & (keep[..., None] if k == "weights" else keep)
               for k, v in out.items()}
    return out
