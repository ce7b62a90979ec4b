"""Public wrapper of the chunked linear-recurrence kernel.

``linear_scan`` runs the plain chunked version (``ref.linear_scan_chunked``
at the kernel's chunk) on CPU tensors and launches ``csrc/linear_scan.cu``
or ``csrc/channel_decay.cu`` on CUDA tensors.  The kernel has three bodies,
picked by ``body_for``:

* ``"scalar_decay"`` when w is constant over K by construction
  (``w.stride(-1) == 0``, Mamba2's view), q, k and v are bf16, the mode is
  ``inclusive`` and K and V are multiples of 16 (K at most 128): the chunk
  form with one decay per step, its products on tensor cores (plain twin:
  ``ref.linear_scan_scalar_decay_ref``);
* ``"channel_decay"`` for the other calls with bf16 q, k and v, K and V
  multiples of 16 (K at most 128) and q, k, v and w (f32 or bf16) on
  ``check_row_layout``'s rule, in both modes (RWKV6's decay, one per
  channel): the sub-chunk form of the per-channel chunk form, its products
  on tensor cores (plain twin: ``ref.linear_scan_channel_decay_ref``);
* ``"per_channel"`` for every other call (float32 operands among them):
  the per-channel chunk form on the CUDA cores, both modes.

This is a dispatch by the operands, not a fallback: a tensor-core call
whose launch fails raises.  A call that would need a gradient raises on
either device (``kernels.refuse_autograd``).  Each launch counts in
``linear_scan.launches`` and in ``linear_scan.launches_by_path[body]``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (INT, PTR, check, check_row_layout,
                                 dtype_code, launcher, on_card,
                                 refuse_autograd, row_layout_ok, stream)
from repro_torch.kernels.linear_scan.ref import linear_scan_chunked

DEFAULT_CHUNK = 64
SCALAR_CHUNK = 64                # the tensor-core bodies' chunk
MODES = ("inclusive", "bonus")
SMEM_LIMIT = 232448              # dynamic shared memory a block may use (H100)
MAX_TC_K = 128               # the tensor-core bodies' state rows


def chunk_for(t: int, chunk: int = DEFAULT_CHUNK) -> int:
    """The chunk the JAX wrapper picks for T steps: ``chunk`` capped at the
    next power of two of T, and at least 8."""
    return min(chunk, max(8, 1 << (t - 1).bit_length()))


def smem_bytes(chunk: int, kdim: int, vdim: int) -> int:
    """Dynamic shared memory of one block of the per-channel body
    (csrc/linear_scan.cu): q and β tiles, k and b tiles with rows padded by
    one word, the v tile, the intra-chunk matrix, the state and the bonus
    diagonal, all f32."""
    return 4 * (2 * chunk * kdim + 2 * chunk * (kdim + 1) + chunk * vdim
                + chunk * chunk + kdim * vdim + chunk)


def body_for(q, k, v, w, mode: str = "inclusive") -> str:
    """The kernel body a call runs (see the module docstring)."""
    kdim, vdim = q.shape[-1], v.shape[-1]
    tensor_cores = (q.dtype == k.dtype == v.dtype == torch.bfloat16
                    and kdim % 16 == 0 and vdim % 16 == 0
                    and 0 < kdim <= MAX_TC_K)
    if tensor_cores and w.stride(-1) == 0 and mode == "inclusive":
        return "scalar_decay"
    if tensor_cores and w.dtype in (torch.float32, torch.bfloat16) \
            and all(map(row_layout_ok, (q, k, v, w))):
        return "channel_decay"
    return "per_channel"


def linear_scan(q, k, v, w, u=None, *, mode: str = "inclusive",
                chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Diagonal-decay linear recurrence over a full sequence.

    q, k, w: [batch, heads, T, K]; v: [batch, heads, T, V]; u: [heads, K]
    (bonus mode only; zeros if omitted).  The per-channel body takes any
    strides: the broadcast views ``mamba2_forward`` builds (stride 0 over
    heads or over K) are read as they are.  The tensor-core bodies read
    them through their strides too, under ``check_row_layout``'s rule.
    T is cut into chunks (``chunk_for(T)`` steps in the per-channel body,
    64 in the tensor-core bodies); the steps past T read as w = 0, k = 0.
    Returns y [batch, heads, T, V] in q's dtype.
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
    refuse_autograd("linear_scan", q, k, v, w, u)
    if not on_card(q, k, v, w, u):
        return linear_scan_chunked(q, k, v, w, u, mode=mode,
                                   chunk=chunk).to(q.dtype)
    body = body_for(q, k, v, w, mode)
    if body == "scalar_decay":
        for name, a in (("q", q), ("k", k), ("v", v)):
            check_row_layout(a, name)
    elif body == "per_channel":
        smem = smem_bytes(chunk, kdim, vdim)
        if smem > SMEM_LIMIT:
            raise ValueError(f"K={kdim}, V={vdim} at chunk {chunk} needs "
                             f"{smem} bytes of shared memory, over "
                             f"{SMEM_LIMIT}")
    y = torch.empty((batch, heads, t, vdim), dtype=q.dtype, device=q.device)
    if y.numel() == 0:
        return y
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                    *w.stride())
    bonus = int(mode == "bonus")
    if bonus:
        u = (torch.zeros((heads, kdim), device=q.device) if u is None
             else u.to(torch.float32).contiguous())
    u_ptr = u.data_ptr() if bonus else None
    if body == "scalar_decay":
        launch = launcher("linear_scan", "linear_scan_scalar_decay_launch",
                          (PTR,) * 5 + (INT,) * 6 + (PTR, PTR))
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     y.data_ptr(), dtype_code(w), batch, heads, t, kdim, vdim,
                     strides, stream())
    elif body == "channel_decay":
        launch = launcher("channel_decay", "linear_scan_channel_decay_launch",
                          (PTR,) * 6 + (INT,) * 7 + (PTR, PTR))
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u_ptr, y.data_ptr(), dtype_code(w), batch, heads, t,
                     kdim, vdim, bonus, strides, stream())
    else:
        launch = launcher("linear_scan", "linear_scan_launch",
                          (PTR,) * 6 + (INT,) * 5 + (INT,) * 7 + (PTR, PTR))
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u_ptr, y.data_ptr(), dtype_code(q), dtype_code(k),
                     dtype_code(v), dtype_code(w), dtype_code(y), batch,
                     heads, t, kdim, vdim, chunk, bonus, strides, stream())
    check(err, f"linear_scan ({body})")
    linear_scan.launches += 1
    linear_scan.launches_by_path[body] += 1
    return y


def channel_decay_occupancy(kdim: int, vdim: int) -> tuple[int, int]:
    """(blocks of the channel-decay body an SM holds, its dynamic shared
    memory in bytes) for a launch at K and V, from the CUDA occupancy
    calculator; builds the kernel, needs a card."""
    smem = ctypes.c_int(0)
    f = launcher("channel_decay", "linear_scan_channel_decay_occupancy",
                 (INT, INT, ctypes.POINTER(ctypes.c_int)))
    blocks = f(kdim, vdim, ctypes.byref(smem))
    check(max(0, -blocks), "linear_scan (channel_decay) occupancy")
    return blocks, smem.value


linear_scan.launches = 0
linear_scan.launches_by_path = {"scalar_decay": 0, "channel_decay": 0,
                                "per_channel": 0}
