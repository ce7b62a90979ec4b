"""Public wrapper of the chunked linear-recurrence kernel.

``linear_scan`` runs the plain chunked version (``ref.linear_scan_chunked``
at the kernel's chunk) on CPU tensors and launches ``csrc/linear_scan.cu``
on CUDA tensors, counting each launch in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (INT, PTR, check, dtype_code, launcher,
                                 on_card, stream)
from repro_torch.kernels.linear_scan.ref import linear_scan_chunked

DEFAULT_CHUNK = 64
MODES = ("inclusive", "bonus")
SMEM_LIMIT = 232448              # dynamic shared memory a block may use (H100)


def chunk_for(t: int, chunk: int = DEFAULT_CHUNK) -> int:
    """The chunk the JAX wrapper picks for T steps: ``chunk`` capped at the
    next power of two of T, and at least 8."""
    return min(chunk, max(8, 1 << (t - 1).bit_length()))


def smem_bytes(chunk: int, kdim: int, vdim: int) -> int:
    """Dynamic shared memory of one block (csrc/linear_scan.cu): q and β
    tiles, k and b tiles with rows padded by one word, the v tile, the
    intra-chunk matrix, the state and the bonus diagonal, all f32."""
    return 4 * (2 * chunk * kdim + 2 * chunk * (kdim + 1) + chunk * vdim
                + chunk * chunk + kdim * vdim + chunk)


def linear_scan(q, k, v, w, u=None, *, mode: str = "inclusive",
                chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Diagonal-decay linear recurrence over a full sequence.

    q, k, w: [batch, heads, T, K]; v: [batch, heads, T, V]; u: [heads, K]
    (bonus mode only; zeros if omitted).  Any strides: the broadcast views
    ``mamba2_forward`` builds (stride 0 over heads or over K) are read as
    they are.  T is cut into chunks of ``chunk_for(T)`` steps; the steps past
    T read as w = 0, k = 0.  Returns y [batch, heads, T, V] in q's dtype.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    batch, heads, t, kdim = q.shape
    vdim = v.shape[-1]
    if k.shape != q.shape or w.shape != q.shape \
            or tuple(v.shape[:3]) != (batch, heads, t):
        raise ValueError(f"q, k, w must be [B, H, T, K] and v [B, H, T, V], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(w.shape)}, {tuple(v.shape)}")
    if u is not None and tuple(u.shape) != (heads, kdim):
        raise ValueError(f"u must be [{heads}, {kdim}], got {tuple(u.shape)}")
    chunk = chunk_for(t, chunk)
    if not on_card(q, k, v, w, u):
        return linear_scan_chunked(q, k, v, w, u, mode=mode,
                                   chunk=chunk).to(q.dtype)
    smem = smem_bytes(chunk, kdim, vdim)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K={kdim}, V={vdim} at chunk {chunk} needs {smem} "
                         f"bytes of shared memory, over {SMEM_LIMIT}")
    y = torch.empty((batch, heads, t, vdim), dtype=q.dtype, device=q.device)
    if y.numel() == 0:
        return y
    if mode == "bonus":
        u = (torch.zeros((heads, kdim), device=q.device) if u is None
             else u.to(torch.float32).contiguous())
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                    *w.stride())
    launch = launcher("linear_scan", "linear_scan_launch",
                      (PTR,) * 6 + (INT,) * 5 + (INT,) * 7 + (PTR, PTR))
    check(launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr() if mode == "bonus" else None, y.data_ptr(),
                 dtype_code(q), dtype_code(k), dtype_code(v), dtype_code(w),
                 dtype_code(y), batch, heads, t, kdim, vdim, chunk,
                 int(mode == "bonus"), strides, stream()),
          "linear_scan")
    linear_scan.launches += 1
    return y


linear_scan.launches = 0
