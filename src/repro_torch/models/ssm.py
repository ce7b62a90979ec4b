"""State-space sequence mixers: Mamba2 (SSD) and RWKV6 (Finch).

Both reduce to the diagonal-decay linear recurrence of
``repro_torch.kernels.linear_scan``:

    Mamba2:  h_t = exp(-exp(A)·dt_t) h_{t-1} + (dt_t B_t) ⊗ x_t ;  y = C_t·h_t
             (a scalar decay per head, broadcast over the state dim)
    RWKV6:   h_t = exp(w_t) ⊙ h_{t-1} + k_t ⊗ v_t ;
             y_t = r_t · (h_{t-1} + diag(u) k_t ⊗ v_t)
             (a data-dependent per-channel decay w_t from a low-rank
             projection, and the bonus term u: the kernel's ``bonus`` mode)

Decode carries (conv/shift state, recurrence state): O(1) per token.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.linear_scan.ref import (linear_scan_chunked,
                                                 linear_scan_decode_ref)
from repro_torch.models.layers import (Params, as_param, dense, new_param,
                                       rms_norm, split_heads)
from repro_torch.parallel.sharding import constrain, on_heads, splittable


W_LORA_RANK = 64


class SSMCache(NamedTuple):
    conv: torch.Tensor    # mamba2: [B, K-1, d_conv]; rwkv6: [B, 2, d] (shifts)
    state: torch.Tensor   # [B, H, state_or_hd, hd]


class Mamba2(Params):
    def __init__(self, cfg: ModelConfig, gen=None, stack=(), device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner_
        st, h = cfg.ssm_state, cfg.n_ssm_heads
        proj_out = 2 * di + 2 * st + h       # z, x, B, C, dt
        self.in_proj = dense(gen, stack, d, proj_out, device,
                             axes=("embed", "ff"))
        self.conv_w = new_param(gen, (*stack, cfg.conv_kernel, di + 2 * st),
                                device, scale=1.0 / math.sqrt(cfg.conv_kernel),
                                axes=(None, "ff"))
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=device))
        self.a_log = as_param(a_log.expand(*stack, h).clone(), (None,))
        self.d_skip = new_param(None, (*stack, h), device, fill=1.0,
                                axes=(None,))
        self.dt_bias = new_param(None, (*stack, h), device, fill=0.0,
                                 axes=(None,))
        self.norm = new_param(None, (*stack, di), device, fill=1.0,
                              axes=(None,))
        self.out_proj = dense(gen, stack, di, d, device, axes=("ff", "embed"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, conv_state=None):
    """Depthwise causal conv over time. x: [B,S,C]; w: [K,C].

    With ``conv_state`` [B, K-1, C] (decode), prepends it and returns the new
    state; otherwise zero-pads the left edge (train/prefill).
    """
    k = w.shape[0]
    if conv_state is not None:
        xx = torch.cat([conv_state.to(x.dtype), x], dim=1)
    else:
        xx = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    n = xx.shape[1] - (k - 1)
    out = torch.zeros_like(xx[:, k - 1:])
    for i in range(k):
        out = out + xx[:, i:i + n] * w[i]
    new_state = xx[:, xx.shape[1] - (k - 1):] if k > 1 else xx[:, :0]
    return out[:, -s:], new_state


def mamba2_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                   mode: str = "train", cache: SSMCache | None = None):
    """Returns (out [B,S,D], new_cache | None)."""
    b, s, _ = x.shape
    di, st, h = cfg.d_inner_, cfg.ssm_state, cfg.n_ssm_heads
    hd = cfg.ssm_head_dim
    dt_ = x.dtype

    zxbcdt = x @ params["in_proj"].to(dt_)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * st]
    dt_raw = zxbcdt[..., zxbcdt.shape[-1] - h:]

    conv_state = cache.conv if cache is not None and mode == "decode" else None
    xbc, new_conv = _causal_conv(xbc, params["conv_w"].to(dt_), conv_state)
    xbc = F.silu(xbc)
    x_ssm = xbc[..., :di]
    b_mat = xbc[..., di:di + st]
    c_mat = xbc[..., di + st:]

    dt = F.softplus(dt_raw.float() + params["dt_bias"])        # [B,S,H]
    a = -torch.exp(params["a_log"])                             # [H] (< 0)
    w = dt * a[None, None, :]                                   # log-decay

    # Heads: x_h [B,H,S,hd]; B/C shared across heads (n_groups=1).  q and w
    # stay stride-0 broadcast views, which the scan kernel reads as they are.
    # On a mesh each is redistributed to the heads' layout (``constrain``,
    # a no-op outside a sharding scope, where the views stay views).
    xh = constrain(split_heads(x_ssm, h), "bhsk")
    kh = b_mat[:, None].expand(b, h, s, st) \
        * dt.transpose(1, 2)[..., None].to(dt_)                 # dt·B
    kh = constrain(kh, "bhsk")
    qh = constrain(c_mat[:, None].expand(b, h, s, st), "bhsk")
    w_bhs = w.transpose(1, 2)                                   # [B,H,S]
    wh = constrain(w_bhs[..., None].expand(b, h, s, st), "bhsk")

    if mode == "decode" and cache is not None:
        state, y = linear_scan_decode_ref(
            cache.state.float(), qh[:, :, 0].float(), kh[:, :, 0].float(),
            xh[:, :, 0].float(), wh[:, :, 0].float(), mode="inclusive")
        y = y[:, :, None]                                       # [B,H,1,hd]
        new_cache = SSMCache(conv=new_conv.to(cache.conv.dtype),
                             state=state.to(cache.state.dtype))
    else:
        if cfg.attention_impl == "pallas":
            y = linear_scan(qh, kh, xh, wh, mode="inclusive")
        else:
            # On a mesh each rank scans its own batch rows and heads.
            y = on_heads(lambda *a: linear_scan_chunked(*a, mode="inclusive"),
                         qh, kh, xh, wh).to(dt_)
        new_cache = None
        if mode == "prefill":
            # Final recurrence state for the cache, via the closed form
            # h = Σ_s e^{Σ_{r>s} w_r} k_s ⊗ v_s.  w is the same for every
            # state channel, so the cumsum runs on [B,H,S] and broadcasts:
            # the same values as the JAX package's [B,H,S,st] cumsum.
            wcum = torch.cumsum(w_bhs, dim=2)
            factor = torch.exp(wcum[:, :, -1:] - wcum)[..., None]
            kw = kh.float() * factor
            state = torch.einsum("bhsk,bhsv->bhkv", kw, xh.float())
            new_cache = SSMCache(conv=new_conv.to(dt_), state=state)

    y = y.to(dt_)
    y = y + params["d_skip"][None, :, None, None].to(y.dtype) * xh
    y = y.transpose(1, 2).reshape(b, s, di)
    y = rms_norm(y * F.silu(z), params["norm"])
    return y @ params["out_proj"].to(dt_), new_cache


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype,
                      device=None) -> SSMCache:
    di, st, h = cfg.d_inner_, cfg.ssm_state, cfg.n_ssm_heads
    return SSMCache(
        conv=torch.zeros((batch, cfg.conv_kernel - 1, di + 2 * st),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, h, st, cfg.ssm_head_dim),
                          dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------


class RWKV6TimeMix(Params):
    def __init__(self, cfg: ModelConfig, gen=None, stack=(), device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.ssm_head_dim
        for mu in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            setattr(self, mu, new_param(None, (*stack, d), device, fill=0.5,
                                        axes=(None,)))
        proj = ("embed", "heads")
        self.wr = dense(gen, stack, d, d, device, axes=proj)
        self.wk = dense(gen, stack, d, d, device, axes=proj)
        self.wv = dense(gen, stack, d, d, device, axes=proj)
        self.wg = dense(gen, stack, d, d, device, axes=proj)
        w_base = torch.linspace(-6.0, -0.5, d, device=device)
        self.w_base = as_param(w_base.expand(*stack, d).clone(), (None,))
        self.w_lora_a = dense(gen, stack, d, W_LORA_RANK, device,
                              axes=("embed", None))
        self.w_lora_b = dense(gen, stack, W_LORA_RANK, d, device, scale=0.01,
                              axes=(None, "heads"))
        self.u = new_param(None, (*stack, d // hd, hd), device, fill=0.0,
                           axes=(None, None))
        self.ln_scale = new_param(None, (*stack, d), device, fill=1.0,
                                  axes=(None,))
        self.wo = dense(gen, stack, d, d, device, axes=("heads", "embed"))


class RWKV6ChannelMix(Params):
    def __init__(self, cfg: ModelConfig, gen=None, stack=(), device=None):
        super().__init__()
        d = cfg.d_model
        self.mu_k = new_param(None, (*stack, d), device, fill=0.5,
                              axes=(None,))
        self.mu_r = new_param(None, (*stack, d), device, fill=0.5,
                              axes=(None,))
        self.wk = dense(gen, stack, d, cfg.d_ff, device, axes=("embed", "ff"))
        self.wv = dense(gen, stack, cfg.d_ff, d, device, axes=("ff", "embed"))
        self.wr = dense(gen, stack, d, d, device, axes=("embed", "heads"))


def _token_shift(x: torch.Tensor, shift_state=None):
    """Returns (x_prev, new_shift_state). x: [B,S,D]."""
    if shift_state is not None:
        prev = torch.cat([shift_state.to(x.dtype), x[:, :-1]], dim=1)
    else:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    return prev, x[:, x.shape[1] - 1:]


def _mix(x, prev, mu):
    # The JAX package's order in the activation dtype: x + (prev - x)·mu,
    # not a lerp and not a float32 upcast.
    return x + (prev - x) * mu.to(x.dtype)


def rwkv6_time_mix(params, x: torch.Tensor, cfg: ModelConfig, *,
                   mode: str = "train", cache: SSMCache | None = None):
    """Returns (out [B,S,D], new_cache | None)."""
    b, s, d = x.shape
    hd = cfg.ssm_head_dim
    h = d // hd
    dt_ = x.dtype

    shift_state = cache.conv[:, :1] if cache is not None \
        and mode == "decode" else None
    prev, new_shift = _token_shift(x, shift_state)

    r = _mix(x, prev, params["mu_r"]) @ params["wr"].to(dt_)
    k = _mix(x, prev, params["mu_k"]) @ params["wk"].to(dt_)
    v = _mix(x, prev, params["mu_v"]) @ params["wv"].to(dt_)
    g = F.silu(_mix(x, prev, params["mu_g"]) @ params["wg"].to(dt_))

    # Data-dependent decay (Finch): w = -exp(base + tanh(x_w A) B) ≤ 0.
    xw = _mix(x, prev, params["mu_w"])
    w_dyn = torch.tanh(xw @ params["w_lora_a"].to(dt_)) \
        @ params["w_lora_b"].to(dt_)
    w_log = -torch.exp(params["w_base"].float() + w_dyn.float())

    def heads(t):
        return constrain(split_heads(t, h), "bhsk")

    rh, kh, vh = heads(r), heads(k), heads(v)
    # The decay rounds through the activation dtype, as the JAX package's
    # ``heads(w_log.astype(dt_)).astype(float32)`` does.
    wh = heads(w_log.to(dt_)).float()
    u = params["u"]

    if mode == "decode" and cache is not None:
        state, y = linear_scan_decode_ref(
            cache.state.float(), rh[:, :, 0].float(), kh[:, :, 0].float(),
            vh[:, :, 0].float(), wh[:, :, 0], u, mode="bonus")
        y = y[:, :, None]
        new_cache = SSMCache(conv=new_shift.to(cache.conv.dtype),
                             state=state.to(cache.state.dtype))
    else:
        if cfg.attention_impl == "pallas":
            y = linear_scan(rh, kh, vh, wh.to(dt_), u, mode="bonus")
        else:
            y = on_heads(lambda *a: linear_scan_chunked(*a, mode="bonus"),
                         rh, kh, vh, wh, per_head=(u,)).to(dt_)
        new_cache = None
        if mode == "prefill":
            # The closed form h = Σ_s e^{Σ_{r>s} w_r} k_s ⊗ v_s over a
            # per-channel cumsum, as the JAX package computes it.
            wcum = torch.cumsum(wh, dim=2)
            factor = torch.exp(wcum[:, :, -1:] - wcum)
            kw = kh.float() * factor
            state = torch.einsum("bhsk,bhsv->bhkv", kw, vh.float())
            new_cache = SSMCache(conv=new_shift.to(dt_), state=state)

    y = y.transpose(1, 2).reshape(b, s, d)
    # Per-head group norm (RWKV's ln_x, population variance), then the
    # output gate.
    y32 = splittable(y.float(), 2, h).reshape(b, s, h, hd)
    mean = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    y = ((y32 - mean) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    y = (y * params["ln_scale"]).to(dt_) * g
    return y @ params["wo"].to(dt_), new_cache


def rwkv6_channel_mix(params, x: torch.Tensor, cfg: ModelConfig, *,
                      shift_state=None):
    """Returns (out [B,S,D], new shift state [B,1,D])."""
    dt_ = x.dtype
    prev, new_shift = _token_shift(x, shift_state)
    xk = _mix(x, prev, params["mu_k"])
    xr = _mix(x, prev, params["mu_r"])
    k = torch.square(torch.relu(xk @ params["wk"].to(dt_)))
    v = k @ params["wv"].to(dt_)
    r = torch.sigmoid(xr @ params["wr"].to(dt_))
    return r * v, new_shift


def init_rwkv6_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> SSMCache:
    d, hd = cfg.d_model, cfg.ssm_head_dim
    # The conv slot holds both shift states, time mix then channel mix.
    return SSMCache(conv=torch.zeros((batch, 2, d), dtype=dtype,
                                     device=device),
                    state=torch.zeros((batch, d // hd, hd, hd),
                                      dtype=torch.float32, device=device))
