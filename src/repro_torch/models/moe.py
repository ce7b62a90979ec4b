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

With ``cfg.moe_local_dispatch`` inside a sharding scope of more than one
data shard (``parallel.sharding.data_shard_count``), each shard packs its
own tokens into frames of ``expert_capacity(n_local)``, as the JAX
package's ``vmap`` over shards does; outside a scope (one shard) every
dispatch is the single one.  The expert products are plain ``einsum``s,
as in the JAX package, where they lie outside any Pallas kernel.

On a device mesh the sort, ``searchsorted`` and the scatter and gather of
the frames have no DTensor sharding strategy: they run on replicated
copies (``parallel.sharding.on_replicas``, an all-gather of the routing
and of the tokens, which is what GSPMD does with them), and the frames
are laid out experts on ``model`` before the expert products
(``constrain(buf, "ecd")``), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.events import CapacityPolicy
from repro_torch.models.layers import (MLP, Params, apply_mlp, dense,
                                       new_param)
from repro_torch.parallel.sharding import (constrain, data_shard_count,
                                           on_replicas, splittable)


class MoE(Params):
    def __init__(self, cfg: ModelConfig, gen=None, stack=(), device=None):
        super().__init__()
        d = cfg.d_model
        d_ff = cfg.moe_d_ff or cfg.d_ff
        e = cfg.n_experts
        self.router = dense(gen, stack, d, e, device, axes=("embed", None))
        up = ("experts", "embed", "ff")
        if cfg.mlp_act in ("silu", "gelu"):
            self.w_gate = new_param(gen, (*stack, e, d, d_ff), device,
                                    scale=1.0 / d ** 0.5, axes=up)
        self.w_up = new_param(gen, (*stack, e, d, d_ff), device,
                              scale=1.0 / d ** 0.5, axes=up)
        self.w_down = new_param(gen, (*stack, e, d_ff, d), device,
                                scale=1.0 / d_ff ** 0.5,
                                axes=("experts", "ff", "embed"))
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

    def route(top_e):
        flat_e = top_e.reshape(-1)                            # [N*k]
        order = torch.argsort(flat_e, stable=True)            # sort by expert
        sorted_e = flat_e[order]
        dev = flat_e.device
        seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev),
                                       side="left")
        pos_in_e = torch.arange(n * k, device=dev) - seg_start[sorted_e]
        keep = pos_in_e < cap                                 # congestion drop
        slot = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)
        return order, keep, slot

    def pack(tokens, order, slot):
        src_token = order // k                                # token of event
        # Dropped events all land on the dump row e·cap, the only index
        # written twice; it is cut off before the experts run.
        buf = torch.zeros((e * cap + 1, d), dtype=dt, device=tokens.device)
        buf[slot] = tokens[src_token].to(dt)
        return buf[:-1].reshape(e, cap, d)                    # [E, cap, D]

    def combine(out_buf, order, keep, slot, top_p):
        out_flat = out_buf.reshape(e * cap, d)
        event_out = torch.where(keep[:, None],
                                out_flat[slot.clamp(0, e * cap - 1)],
                                0.0)                           # [N*k, D]
        inv = torch.argsort(order)                             # undo the sort
        event_out = event_out[inv].reshape(n, k, d)
        # The sum over k stays in the activation dtype, as the JAX
        # package's: for k = 2 it is one addition, rounded once either way.
        return torch.sum(event_out * top_p[..., None].to(dt), dim=1)

    order, keep, slot = on_replicas(route, top_e)
    # Expert-parallel placement: experts on the model axis, capacity slots
    # on the data axes — the scatter becomes the Aggregator's all-to-all.
    buf = constrain(on_replicas(pack, tokens, order, slot), "ecd")

    if "w_gate" in params:
        h = F.silu(torch.einsum("ecd,edf->ecf", buf,
                                params["w_gate"].to(dt)))
        h = h * torch.einsum("ecd,edf->ecf", buf, params["w_up"].to(dt))
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(torch.einsum("ecd,edf->ecf", buf, params["w_up"].to(dt)),
                   approximate="tanh")
    out_buf = constrain(torch.einsum("ecf,efd->ecd", h,
                                     params["w_down"].to(dt)), "ecd")
    y = on_replicas(combine, out_buf, order, keep, slot, top_p)
    return y, keep.sum()


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """x: [B, S, D] → (out [B, S, D], metrics {aux_loss, dropped_frac})."""
    b, s, d = x.shape
    dt = x.dtype
    e, k = cfg.n_experts, cfg.top_k
    # On a mesh the flat tokens keep x's batch layout, so that their
    # gradient comes back to it before the reshape's own (a view of
    # [B·S, D] split finer than B would not divide into rows).
    tokens = constrain(x.reshape(b * s, d), "b.")
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

    # --- Dispatch/combine ------------------------------------------------------
    shards = data_shard_count() if cfg.moe_local_dispatch else 1
    if shards > 1 and n % shards == 0:
        # Per-data-shard event frames (the paper's per-node packing): each
        # shard sorts and packs only its own tokens; only the capacity
        # buffers cross to the expert shards.  The shards run one after
        # another here, where the JAX package vmaps over them.
        n_loc = n // shards
        cap = expert_capacity(n_loc, cfg)
        tok_s = constrain(tokens.reshape(shards, n_loc, d), "b.d")
        parts = on_replicas(
            lambda t, te, tp: tuple(zip(t.unbind(0),
                                        te.reshape(shards, n_loc, k).unbind(0),
                                        tp.reshape(shards, n_loc, k).unbind(0))),
            tok_s, top_e, top_p)
        ys, kept = [], 0
        for t, te, tp in parts:
            y_s, kept_s = _dispatch_combine(t, te, tp, params, cfg, cap)
            ys.append(y_s)
            kept = kept + kept_s
        y = torch.cat(ys, 0)
    else:
        cap = expert_capacity(n, cfg)
        y, kept = _dispatch_combine(tokens, top_e, top_p, params, cfg, cap)

    # --- Shared experts: the on-chip (never routed) path ---------------------
    if "shared" in params:
        y = y + apply_mlp(tokens.to(dt), params["shared"], cfg)

    dropped_frac = 1.0 - kept / (n * k)
    return splittable(y, 0, b).reshape(b, s, d), {"aux_loss": aux_loss,
                                "dropped_frac": dropped_frac}
