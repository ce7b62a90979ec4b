"""Mixture-of-Experts with event-frame dispatch: the paper's datapath at LM
scale.

The mapping:

  spike label        ↔ (token, expert) routing assignment
  fwd LUT + enable   ↔ router top-k (which events leave the chip)
  layer-2 packing    ↔ capacity-bounded per-expert buffers
  Aggregator star    ↔ expert-parallel all-to-all
  congestion drop    ↔ token dropping beyond expert capacity (counted)

Dispatch is sort-based (compaction by prefix sum, like the spike_router
kernel's pack unit): a stable sort of the routed events by expert, each
event's rank in its expert's segment, and a scatter of the events that fit
the capacity into ``[E, cap, D]`` buffers; memory stays O(tokens · top_k).
Shared experts (DeepSeek) bypass routing: the on-chip layer-1 path that
never leaves the chip.

On one card every dispatch is the single one.  The JAX package's
``moe_local_dispatch`` packs per data shard, and outside a sharding scope
(one shard) takes the same single dispatch; the sharded LM path is still
to port (ROADMAP.md queue 1 item 10).  The expert products are plain
``einsum``s, as in the JAX package, where they lie outside any Pallas
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.events import CapacityPolicy
from repro_torch.models.layers import (MLP, Params, apply_mlp, dense,
                                       new_param)


class MoE(Params):
    def __init__(self, cfg: ModelConfig, gen=None, stack=(), device=None):
        super().__init__()
        d = cfg.d_model
        d_ff = cfg.moe_d_ff or cfg.d_ff
        e = cfg.n_experts
        self.router = dense(gen, stack, d, e, device)
        if cfg.mlp_act in ("silu", "gelu"):
            self.w_gate = new_param(gen, (*stack, e, d, d_ff), device,
                                    scale=1.0 / d ** 0.5)
        self.w_up = new_param(gen, (*stack, e, d, d_ff), device,
                              scale=1.0 / d ** 0.5)
        self.w_down = new_param(gen, (*stack, e, d_ff, d), device,
                                scale=1.0 / d_ff ** 0.5)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, gen, stack, device,
                              d_ff=d_ff * cfg.n_shared_experts)


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Event-frame capacity per expert: the strict ``CapacityPolicy``'s
    (at least 8) of the expected events times the capacity factor, rounded
    up to a multiple of 8; in Python floats, as the JAX package's."""
    per_expert = n_tokens * cfg.top_k / max(cfg.n_experts, 1)
    cap = CapacityPolicy("strict").capacity_for(
        int(per_expert * cfg.capacity_factor))
    return -(-cap // 8) * 8


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``'s pick: the k largest along the last axis, the
    lower index first among equal values.  ``torch.topk`` promises no order
    for ties on the card, so this takes a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_combine(tokens, top_e, top_p, params, cfg: ModelConfig,
                      cap: int):
    """Sort-based event-frame dispatch → expert compute → combine.

    tokens: [N, D]; top_e/top_p: [N, k].  Returns ``(y [N, D], kept)``
    where ``kept`` is the count of routed events that fit their expert's
    capacity (the keep fraction is ``kept / (N * k)``).
    """
    n, d = tokens.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = tokens.dtype
    dev = tokens.device

    flat_e = top_e.reshape(-1)                                # [N*k]
    order = torch.argsort(flat_e, stable=True)                # sort by expert
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev),
                                   side="left")
    pos_in_e = torch.arange(n * k, device=dev) - seg_start[sorted_e]
    keep = pos_in_e < cap                                     # congestion drop
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)

    src_token = order // k                                    # token of event
    # Dropped events all land on the dump row e·cap, the only index written
    # twice; it is cut off before the experts run.
    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=dev)
    buf[slot] = tokens[src_token].to(dt)
    buf = buf[:-1].reshape(e, cap, d)                         # [E, cap, D]

    if "w_gate" in params:
        h = F.silu(torch.einsum("ecd,edf->ecf", buf,
                                params["w_gate"].to(dt)))
        h = h * torch.einsum("ecd,edf->ecf", buf, params["w_up"].to(dt))
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(torch.einsum("ecd,edf->ecf", buf, params["w_up"].to(dt)),
                   approximate="tanh")
    out_buf = torch.einsum("ecf,efd->ecd", h, params["w_down"].to(dt))
    out_flat = out_buf.reshape(e * cap, d)

    event_out = torch.where(keep[:, None],
                            out_flat[slot.clamp(0, e * cap - 1)],
                            0.0)                               # [N*k, D]
    inv = torch.argsort(order)                                 # undo the sort
    event_out = event_out[inv].reshape(n, k, d)
    # The sum over k stays in the activation dtype, as the JAX package's:
    # for k = 2 it is one addition, rounded once either way.
    y = torch.sum(event_out * top_p[..., None].to(dt), dim=1)
    return y, keep.sum()


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """x: [B, S, D] → (out [B, S, D], metrics {aux_loss, dropped_frac})."""
    b, s, d = x.shape
    dt = x.dtype
    e, k = cfg.n_experts, cfg.top_k
    tokens = x.reshape(b * s, d)
    n = b * s

    # --- Router (the forward LUT: label → destination + enable) ------------
    logits = tokens.float() @ params["router"].float()        # [N, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)                            # [N, k]
    top_p = top_p / top_p.sum(-1, keepdim=True)               # renormalize

    # Load-balancing auxiliary loss (GShard style): ``ce`` is the fraction
    # of all k routed assignments landing on each expert.
    me = probs.mean(0)                                        # [E]
    ce = F.one_hot(top_e, e).sum(1).float().mean(0) / k
    aux_loss = e * torch.sum(me * ce)

    # --- Dispatch/combine: one shard on one card (module docstring) ---------
    cap = expert_capacity(n, cfg)
    y, kept = _dispatch_combine(tokens, top_e, top_p, params, cfg, cap)

    # --- Shared experts: the on-chip (never routed) path ---------------------
    if "shared" in params:
        y = y + apply_mlp(tokens.to(dt), params["shared"], cfg)

    dropped_frac = 1.0 - kept / (n * k)
    return y.reshape(b, s, d), {"aux_loss": aux_loss,
                                "dropped_frac": dropped_frac}
