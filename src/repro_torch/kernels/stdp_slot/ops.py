"""Public wrapper of the per-slot STDP step.

``stdp_slot`` launches ``csrc/stdp_slot.cu`` on CUDA tensors, counting each
launch in its ``launches`` attribute, and runs the plain version
(``ref.stdp_slot_ref``) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (FLOAT, INT, PTR, check, launcher, on_card,
                                 refuse_autograd, stream)
from repro_torch.kernels.stdp_slot.ref import stdp_slot_ref
from repro_torch.snn import plasticity as plas
from repro_torch.snn.chip import WEIGHT_MAX


def _check(state: plas.SlotPlasticityState, pre: torch.Tensor,
           post: torch.Tensor, mask: torch.Tensor | None) -> None:
    weights = state.weights
    if weights.dim() != 4:
        raise ValueError(f"weights must be [n_chips, batch, n_rows, "
                         f"n_neurons], got {tuple(weights.shape)}")
    c, b, r, n = weights.shape
    operands = {"weights": (weights, (c, b, r, n)),
                "trace_pre": (state.trace_pre, (c, b, r)),
                "trace_post": (state.trace_post, (c, b, n)),
                "pre": (pre, (c, b, r)), "post": (post, (c, b, n))}
    for name, (t, shape) in operands.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} to match weights "
                             f"{tuple(weights.shape)}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"stdp_slot takes float32, got {name} of "
                            f"{t.dtype}")
    if mask is not None and tuple(mask.shape) != (b,):
        raise ValueError(f"mask must be ({b},), one flag a slot, got "
                         f"{tuple(mask.shape)}")


def _launch(state: plas.SlotPlasticityState, pre: torch.Tensor,
            post: torch.Tensor, cfg: plas.STDPConfig,
            mask: torch.Tensor | None) -> plas.SlotPlasticityState:
    tp, tq, w, pre, post = (x.contiguous() for x in (*state, pre, post))
    c, b, r, n = w.shape
    outs = [torch.empty_like(x) for x in (tp, tq, w)]
    keep = (None if mask is None else
            mask.to(device=w.device, dtype=torch.bool).contiguous())
    launch = launcher("stdp_slot", "stdp_slot_launch",
                      (PTR,) * 6 + (ctypes.c_int64, INT, INT, INT)
                      + (FLOAT,) * 5 + (PTR,) * 4)
    # ctypes rounds the Python doubles to the nearest float32, as the plain
    # version's ``_f32`` does.
    check(launch(tp.data_ptr(), tq.data_ptr(), w.data_ptr(), pre.data_ptr(),
                 post.data_ptr(), None if keep is None else keep.data_ptr(),
                 c * b, b, r, n, cfg.alpha_pre, cfg.alpha_post, cfg.lr_pot,
                 cfg.lr_dep, float(WEIGHT_MAX),
                 *(o.data_ptr() for o in outs), stream()),
          "stdp_slot")
    return plas.SlotPlasticityState(*outs)


def stdp_slot(state: plas.SlotPlasticityState, pre: torch.Tensor,
              post: torch.Tensor, cfg: plas.STDPConfig,
              mask: torch.Tensor | None = None) -> plas.SlotPlasticityState:
    """One per-slot STDP step (``snn.plasticity.stdp_slot_step``).

    state: traces f32[n_chips, batch, n_rows] and f32[n_chips, batch,
    n_neurons], weights f32[n_chips, batch, n_rows, n_neurons]; ``pre``
    and ``post`` shaped as the traces; ``mask`` (bool[batch]) freezes the
    slots it clears.  Returns a new state in fresh tensors; the inputs are
    left as they were.

    On CUDA tensors the kernel runs, in one launch, and equals the plain
    version bit for bit except where a float64 sum of the plain version
    lands on a float32 rounding midpoint (``csrc/stdp_slot.cu``).  The
    plain version runs on CPU tensors, where it differentiates as the JAX
    reference's per-slot update does.  The kernel has no backward: on
    CUDA tensors a call that needs a gradient (grad mode on and an
    operand that requires grad) raises ``TypeError``
    (``kernels.refuse_autograd``).
    """
    _check(state, pre, post, mask)
    operands = (*state, pre, post)
    if not on_card(*operands):
        return stdp_slot_ref(state, pre, post, cfg, mask)
    refuse_autograd("stdp_slot", *operands, advice=(
        "differentiate through per-slot plasticity on CPU tensors, or call "
        "it under torch.no_grad()"))
    out = _launch(state, pre, post, cfg, mask)
    stdp_slot.launches += 1
    return out


stdp_slot.launches = 0
