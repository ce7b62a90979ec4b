"""Plain PyTorch versions of the chunked linear recurrence: the twins of the
JAX package's ``kernels/linear_scan/ref.py``.

    h_t = exp(w_t) ⊙_K h_{t-1} + k_t ⊗ v_t            (w_t ≤ 0, per-channel)
    inclusive:  y_t = q_t · h_t
    bonus:      y_t = q_t · (h_{t-1} + diag(u) k_t ⊗ v_t)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear_scan_ref(q, k, v, w, u=None, *, mode: str = "inclusive"):
    """Step-by-step recurrence (exact, slow).

    q, k, w: [batch, heads, T, K]; v: [batch, heads, T, V]; u: [heads, K].
    Returns y: float32 [batch, heads, T, V].
    """
    q, k, v, w = (a.float() for a in (q, k, v, w))
    batch, heads, t, kdim = q.shape
    vdim = v.shape[-1]
    if u is None:
        u = torch.zeros((heads, kdim), device=q.device)
    u = u.float()[None].expand(batch, heads, kdim)
    h = torch.zeros((batch, heads, kdim, vdim), device=q.device)
    ys = []
    for i in range(t):
        q_t, k_t, v_t, w_t = q[:, :, i], k[:, :, i], v[:, :, i], w[:, :, i]
        kv = k_t[..., :, None] * v_t[..., None, :]           # [B,H,K,V]
        if mode == "bonus":
            y = torch.einsum("bhk,bhkv->bhv", q_t, h + u[..., :, None] * kv)
            h = torch.exp(w_t)[..., None] * h + kv
        else:
            h = torch.exp(w_t)[..., None] * h + kv
            y = torch.einsum("bhk,bhkv->bhv", q_t, h)
        ys.append(y)
    return torch.stack(ys, dim=2)


def linear_scan_chunked(q, k, v, w, u=None, *, mode: str = "inclusive",
                        chunk: int = 16):
    """Chunked evaluation: the XLA path's implementation, and the same math
    as the kernel.

    Within a chunk the intra-chunk term is the exact per-(t, s, k) broadcast
    (every valid exponent ≤ 0, so no overflow for any decay); matmuls carry
    the inter-chunk term; a loop over chunks carries the [K, V] state.
    Returns y in v's dtype.
    """
    orig_dtype = v.dtype
    q, k, v, w = (a.float() for a in (q, k, v, w))
    batch, heads, t, kdim = q.shape
    vdim = v.shape[-1]
    pad = (-t) % chunk
    if pad:
        q, k, v, w = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v, w))
    nc = (t + pad) // chunk

    def chunks(a, d):
        return a.reshape(batch, heads, nc, chunk, d)

    qs, ks, vs, ws = (chunks(a, d) for a, d in
                      ((q, kdim), (k, kdim), (v, vdim), (w, kdim)))
    strict = mode == "bonus"
    t_idx = torch.arange(chunk, device=q.device)
    mask = (t_idx[:, None] > t_idx[None, :]) if strict \
        else (t_idx[:, None] >= t_idx[None, :])
    if u is None:
        u = torch.zeros((heads, kdim), device=q.device)
    u = u.float()

    h = torch.zeros((batch, heads, kdim, vdim), device=q.device)
    ys = []
    for c in range(nc):
        qc, kc, vc, wc = qs[:, :, c], ks[:, :, c], vs[:, :, c], ws[:, :, c]
        b = torch.cumsum(wc, dim=2)              # inclusive cumsum
        beta = b - wc if strict else b
        # inter-chunk: (q ⊙ e^β) @ h
        y = torch.einsum("bhck,bhkv->bhcv", qc * torch.exp(beta), h)
        # intra-chunk: exact broadcast.  Valid (s ≤ t) exponents are ≤ 0;
        # masked ones can overflow, so clamp before exp (exact for valid).
        expo = beta[:, :, :, None, :] - b[:, :, None, :, :]   # [B,H,C,C,K]
        a = (qc[:, :, :, None, :] * kc[:, :, None, :, :]
             * torch.exp(torch.clamp(expo, max=0.0))).sum(-1)
        a = torch.where(mask, a, 0.0)
        y = y + torch.einsum("bhts,bhsv->bhtv", a, vc)
        if strict:
            diag = (qc * u[None, :, None, :] * kc).sum(-1)
            y = y + diag[..., None] * vc
        # carry update
        b_last = b[:, :, -1:, :]
        h = torch.exp(b_last[:, :, 0])[..., None] * h \
            + torch.einsum("bhck,bhcv->bhkv", kc * torch.exp(b_last - b), vc)
        ys.append(y)
    ys = torch.stack(ys, dim=2).reshape(batch, heads, t + pad, vdim)
    return ys[:, :, :t].to(orig_dtype)


def linear_scan_decode_ref(h, q_t, k_t, v_t, w_t, u=None, *,
                           mode: str = "inclusive"):
    """Single decode step: returns (new_state, y_t).

    h: [batch, heads, K, V]; q_t/k_t/w_t: [batch, heads, K];
    v_t: [batch, heads, V].
    """
    kv = k_t[..., :, None] * v_t[..., None, :]
    if mode == "bonus":
        if u is None:
            raise ValueError("bonus mode needs u")
        y = torch.einsum("bhk,bhkv->bhv", q_t, h + u[None, :, :, None] * kv)
        h = torch.exp(w_t)[..., None] * h + kv
    else:
        h = torch.exp(w_t)[..., None] * h + kv
        y = torch.einsum("bhk,bhkv->bhv", q_t, h)
    return h, y
