"""State-space sequence mixer: Mamba2 (SSD).

Mamba2 reduces to the diagonal-decay linear recurrence of
``repro_torch.kernels.linear_scan``:

    h_t = exp(-exp(A)·dt_t) h_{t-1} + (dt_t B_t) ⊗ x_t ;  y = C_t·h_t

(a scalar decay per head, broadcast over the state dim).  Decode carries
(conv state, recurrence state): O(1) per token.  RWKV6 is still to port
(ROADMAP.md queue 1 item 11).
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
from repro_torch.models.layers import Params, dense, new_param, rms_norm


class SSMCache(NamedTuple):
    conv: torch.Tensor    # [B, K-1, d_conv]
    state: torch.Tensor   # [B, H, state, hd]


class Mamba2(Params):
    def __init__(self, cfg: ModelConfig, gen=None, stack=(), device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner_
        st, h = cfg.ssm_state, cfg.n_ssm_heads
        proj_out = 2 * di + 2 * st + h       # z, x, B, C, dt
        self.in_proj = dense(gen, stack, d, proj_out, device)
        self.conv_w = new_param(gen, (*stack, cfg.conv_kernel, di + 2 * st),
                                device, scale=1.0 / math.sqrt(cfg.conv_kernel))
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device=device))
        self.a_log = torch.nn.Parameter(a_log.expand(*stack, h).clone(),
                                        requires_grad=False)
        self.d_skip = new_param(None, (*stack, h), device, fill=1.0)
        self.dt_bias = new_param(None, (*stack, h), device, fill=0.0)
        self.norm = new_param(None, (*stack, di), device, fill=1.0)
        self.out_proj = dense(gen, stack, di, d, device)


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
    xh = x_ssm.reshape(b, s, h, hd).transpose(1, 2)
    kh = b_mat[:, None].expand(b, h, s, st) \
        * dt.transpose(1, 2)[..., None].to(dt_)                 # dt·B
    qh = c_mat[:, None].expand(b, h, s, st)
    w_bhs = w.transpose(1, 2)                                   # [B,H,S]
    wh = w_bhs[..., None].expand(b, h, s, st)

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
            y = linear_scan_chunked(qh, kh, xh, wh,
                                    mode="inclusive").to(dt_)
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
