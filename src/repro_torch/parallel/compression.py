"""Sparse-event gradient exchange: the paper's insight applied to gradients
(port of ``src/repro/parallel/compression.py``).

BSS-2 communicates *sparse labeled events* instead of dense state; layer-2
packs them into capacity-bounded frames.  Gradient top-k sparsification with
error feedback is the same trade: each step, only the k largest-magnitude
gradient entries (events: ``(index=label, value)``) cross the interconnect,
packed into a fixed-capacity frame; everything else accumulates locally in
the error-feedback residual (the retransmit buffer).  [Deep Gradient
Compression, arXiv:1712.01887 — adapted to the event-frame machinery.]

Also provides int8 stochastic quantization for dense all-reduce (a milder
bandwidth/precision trade on the same axis).

The functions take and return tensors on any device.  ``sparsify`` picks
as ``jax.lax.top_k`` does, the lower index first among equal magnitudes
(``torch.topk`` promises no order for ties), so its indices, values and
residual equal the JAX package's bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SparseGrad(NamedTuple):
    """A capacity-bounded event frame of gradient entries."""
    indices: torch.Tensor   # int32[capacity]   (the 'labels')
    values: torch.Tensor    # float32[capacity]
    shape: tuple            # original dense shape


def _top_k_indices(mag: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries, largest first and the lower
    index first among equal values: a stable descending sort's prefix."""
    return torch.sort(mag, descending=True, stable=True).indices[:k]


def sparsify(grad: torch.Tensor, capacity: int
             ) -> tuple[SparseGrad, torch.Tensor]:
    """Top-|g| event selection.  Returns (frame, residual)."""
    flat = grad.reshape(-1).to(torch.float32)
    capacity = min(capacity, flat.shape[0])
    indices = _top_k_indices(flat.abs(), capacity)
    picked = flat[indices]
    residual = flat.clone()
    residual[indices] = 0.0
    return SparseGrad(indices=indices.to(torch.int32), values=picked,
                      shape=tuple(grad.shape)), residual.reshape(grad.shape)


def densify(frame: SparseGrad) -> torch.Tensor:
    """The dense float32 gradient of ``frame``; entries of a repeated index
    add up, as the JAX package's ``.at[].add`` does."""
    n = math.prod(frame.shape)
    out = torch.zeros((n,), dtype=torch.float32, device=frame.values.device)
    out.index_add_(0, frame.indices.long(), frame.values.to(torch.float32))
    return out.reshape(frame.shape)


class FeedbackState(NamedTuple):
    residual: torch.Tensor


def compress_with_feedback(grad: torch.Tensor, state: FeedbackState,
                           frac: float = 0.01
                           ) -> tuple[SparseGrad, FeedbackState]:
    """Error-feedback top-k: g' = g + residual; send top-k(g'); keep rest."""
    g = grad + state.residual
    capacity = max(1, int(frac * g.numel()))
    frame, residual = sparsify(g, capacity)
    return frame, FeedbackState(residual=residual)


def init_feedback(grad_like: torch.Tensor) -> FeedbackState:
    return FeedbackState(residual=torch.zeros_like(grad_like,
                                                   dtype=torch.float32))


# ---------------------------------------------------------------------------
# int8 quantized exchange
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor, generator: torch.Generator | None = None,
                  *, noise: torch.Tensor | None = None):
    """Per-tensor stochastic int8 quantization.  Returns (q, scale).

    The rounding noise is uniform on [-0.5, 0.5): ``noise`` as given (for
    example the JAX package's own draws), or drawn from ``generator``
    (which lives on ``x``'s device); with neither, the rounding is the
    nearest, ties to even, as ``jnp.round``'s."""
    if noise is not None and generator is not None:
        raise ValueError("pass noise or a generator, not both")
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    scaled = x / scale
    if generator is not None:
        noise = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                           device=x.device) - 0.5
    if noise is not None:
        scaled = scaled + noise.to(device=x.device, dtype=scaled.dtype)
    return torch.clamp(torch.round(scaled), -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
