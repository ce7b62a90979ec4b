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
        # ``minimum`` splits the gradient at a tie, as ``jnp.minimum``
        # does; ``torch.clamp`` would pass all of it.
        expo = beta[:, :, :, None, :] - b[:, :, None, :, :]   # [B,H,C,C,K]
        a = (qc[:, :, :, None, :] * kc[:, :, None, :, :]
             * torch.exp(torch.minimum(expo, expo.new_zeros(())))).sum(-1)
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


def linear_scan_scalar_decay_ref(q, k, v, w, *, chunk: int = 64):
    """The scalar-decay chunk form in ``inclusive`` mode: the plain twin of
    the kernel's scalar-decay body.

    w's first channel is the decay of every channel (Mamba2's w, constant
    over K).  Within a chunk of ``chunk`` steps, b is the inclusive cumsum
    of that scalar w and L[t, s] = e^{b_t − b_s} for s ≤ t (every exponent
    ≤ 0);  y = e^{b_t}·(Q·h) + ((Q·Kᵀ) ⊙ L)·V and
    h ← e^{b_C}·h + (K ⊙ e^{b_C − b_s})ᵀ·V, all in float32.  The same
    function as ``linear_scan_chunked`` when w is constant over K.  Returns
    y in v's dtype.
    """
    orig_dtype = v.dtype
    q, k, v = (a.float() for a in (q, k, v))
    w = w[..., 0].float()
    batch, heads, t, kdim = q.shape
    vdim = v.shape[-1]
    pad = (-t) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        w = F.pad(w, (0, pad))
    t_idx = torch.arange(chunk, device=q.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    h = torch.zeros((batch, heads, kdim, vdim), device=q.device)
    ys = []
    for c0 in range(0, t + pad, chunk):
        qc, kc, vc = (a[:, :, c0:c0 + chunk] for a in (q, k, v))
        b = torch.cumsum(w[:, :, c0:c0 + chunk], dim=2)       # [B, H, C]
        # Masked (s > t) exponents can overflow: clamp, exact for s ≤ t.
        decay = torch.exp(torch.clamp(b[..., :, None] - b[..., None, :],
                                      max=0.0))
        a = torch.where(causal, (qc @ kc.transpose(-1, -2)) * decay, 0.0)
        ys.append(torch.exp(b)[..., None] * (qc @ h) + a @ vc)
        b_last = b[..., -1:]
        h = torch.exp(b_last)[..., None] * h \
            + (kc * torch.exp(b_last - b)[..., None]).transpose(-1, -2) @ vc
    y = torch.cat(ys, dim=2)[:, :, :t]
    return y.to(orig_dtype)


def linear_scan_channel_decay_ref(q, k, v, w, u=None, *,
                                  mode: str = "inclusive", chunk: int = 64,
                                  sub: int = 16):
    """The sub-chunk factorisation of the per-channel chunk form, in both
    modes: the plain twin of the kernel's channel-decay body, in float32.

    Each chunk of ``chunk`` steps is cut into sub-chunks of ``sub`` steps.
    Cumsums are taken within a sub-chunk (bl, and β = bl or bl − w); r_i
    is the cumsum of w at the end of sub-chunk i − 1 (r_0 = 0), a sum of
    sub-chunk totals.  For s in sub-chunk j < i and t in sub-chunk i the
    intra-chunk matrix factors at r_{j+1}:

        A[t, s] = (q_t ⊙ e^{β_t − r_{j+1}}) · (k_s ⊙ e^{r_{j+1} − b_s}),

    both exponents ≤ 0 (a factor that underflows stands for a smaller true
    term).  A diagonal block factors its lower-left quadrant the same way
    at its midpoint and keeps the exact Σ_k q k e^{β_t − b_s} on its two
    diagonal quadrants (s ≤ t, or s < t in ``bonus`` mode, where the
    diagonal t = s holds q·u·k).  Then y = (q ⊙ e^{β}) · h + A · V and
    h ← e^{b_C} ⊙ h + (k ⊙ e^{b_C − b})ᵀ · V, with k ⊙ e^{b_C − b} taken
    as the off-diagonal k factor times e^{b_C − r_{j+1}}.  The same
    function as ``linear_scan_chunked``.  Returns y in v's dtype.
    """
    if chunk % sub or sub % 2:
        raise ValueError(f"sub ({sub}) must be even and divide chunk "
                         f"({chunk})")
    orig_dtype = v.dtype
    q, k, v, w = (a.float() for a in (q, k, v, w))
    batch, heads, t, kdim = q.shape
    vdim = v.shape[-1]
    pad = (-t) % chunk
    if pad:
        q, k, v, w = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v, w))
    strict = mode == "bonus"
    u = (torch.zeros((heads, kdim), device=q.device) if u is None
         else u.float())
    ns, half = chunk // sub, sub // 2
    idx = torch.arange(half, device=q.device)
    quad_mask = (idx[:, None] > idx[None, :]) if strict \
        else (idx[:, None] >= idx[None, :])
    eye = torch.eye(half, dtype=torch.bool, device=q.device)

    def exact(qr, betar, kr, br):
        """Σ_k q k e^{β_t − b_s} over a diagonal quadrant, masked; the
        bonus diagonal holds q·u·k."""
        expo = betar[:, :, :, None, :] - br[:, :, None, :, :]
        a = (qr[:, :, :, None, :] * kr[:, :, None, :, :]
             * torch.exp(torch.clamp(expo, max=0.0))).sum(-1)
        a = torch.where(quad_mask, a, 0.0)
        if strict:
            diag = (qr * u[None, :, None, :] * kr).sum(-1)
            a = a + torch.where(eye, diag[..., None], 0.0)
        return a

    h = torch.zeros((batch, heads, kdim, vdim), device=q.device)
    ys = []
    for c0 in range(0, t + pad, chunk):
        qc, kc, vc, wc = (a[:, :, c0:c0 + chunk] for a in (q, k, v, w))
        ws = wc.reshape(batch, heads, ns, sub, kdim)
        bl = torch.cumsum(ws, dim=3)                  # within a sub-chunk
        betal = bl - ws if strict else bl
        tot = bl[:, :, :, -1]                         # [B, H, ns, K]

        def decay(a, b):
            """e^{r_a − r_b}, a ≥ b: the decay over sub-chunks b .. a−1."""
            return torch.exp(tot[:, :, b:a].sum(2))

        sl = [slice(i * sub, (i + 1) * sub) for i in range(ns)]
        # k ⊙ e^{r_{j+1} − b_s}: sub-chunk j's k factor.
        kj = [kc[:, :, sl[j]] * torch.exp(tot[:, :, j, None] - bl[:, :, j])
              for j in range(ns)]
        a = torch.zeros((batch, heads, chunk, chunk), device=q.device)
        y = torch.empty((batch, heads, chunk, vdim), device=q.device)
        for i in range(ns):
            qi, ki = qc[:, :, sl[i]], kc[:, :, sl[i]]
            bi, betai = bl[:, :, i], betal[:, :, i]
            qprime = qi * torch.exp(betai)            # q ⊙ e^{β_t − r_i}
            y[:, :, sl[i]] = (qprime * decay(i, 0)[:, :, None]) @ h
            for j in range(i):
                a[:, :, sl[i], sl[j]] = \
                    (qprime * decay(i, j + 1)[:, :, None]) \
                    @ kj[j].transpose(-1, -2)
            top, bot = slice(0, half), slice(half, sub)
            mid = bi[:, :, half - 1:half]
            qa = qi[:, :, bot] * torch.exp(betai[:, :, bot] - mid)
            kb = ki[:, :, top] * torch.exp(mid - bi[:, :, top])
            blk = torch.zeros((batch, heads, sub, sub), device=q.device)
            blk[:, :, bot, top] = qa @ kb.transpose(-1, -2)
            for part in (top, bot):
                blk[:, :, part, part] = exact(qi[:, :, part],
                                              betai[:, :, part],
                                              ki[:, :, part], bi[:, :, part])
            a[:, :, sl[i], sl[i]] = blk
        ys.append(y + a @ vc)
        kcarry = torch.cat([kj[j] * decay(ns, j + 1)[:, :, None]
                            for j in range(ns)], dim=2)
        h = decay(ns, 0)[..., None] * h + kcarry.transpose(-1, -2) @ vc
    y = torch.cat(ys, dim=2)[:, :, :t]
    return y.to(orig_dtype)
