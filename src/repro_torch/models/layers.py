"""Building blocks: parameter modules, norms, RoPE, MLPs, embeddings.

Parameters live in ``Params`` modules whose names are the JAX parameter
tree's paths (``layers.mamba.in_proj``, ``shared_attn.wq``, ``embed``), so
``state_dict()`` keys are those paths and ``convert`` can load a flattened
JAX tree one to one.  A module built with ``stack=(L,)`` holds L layers'
parameters with a leading layer axis, as the JAX package's scanned stacks
do; ``Params.layer(i)`` gives layer i's as a nested dict of views.  The
forward functions take any mapping of name → tensor (a module or such a
dict), like the JAX functions take a dict of ``Param``s.

Parameters are float32 and are cast to the activation dtype at use, as
``x @ w.astype(dt)`` does in JAX.  The JAX package's logical-axis
annotations are sharding hints and have no counterpart on one card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# What the port says of the LM harness's parts it does not run yet.
NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item 11)"


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


class Params(nn.Module):
    """A module of named parameters (and sub-modules) that the forward
    functions index like the JAX package's parameter dicts."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def layer(self, i: int) -> dict:
        """Layer i of a stacked module: a nested dict of views."""
        out = {name: p[i] for name, p in self._parameters.items()}
        out.update({name: m.layer(i) for name, m in self._modules.items()})
        return out


def new_param(gen: torch.Generator | None, shape, device, *,
              scale: float = 1.0, fill: float | None = None) -> nn.Parameter:
    """A float32 parameter: normal(0, 1) · scale drawn from ``gen``, or
    ``fill`` everywhere."""
    if fill is not None:
        t = torch.full(shape, fill, dtype=torch.float32, device=device)
    else:
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale
    return nn.Parameter(t, requires_grad=False)


def dense(gen, stack, in_dim: int, out_dim: int, device,
          scale: float | None = None) -> nn.Parameter:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return new_param(gen, (*stack, in_dim, out_dim), device, scale=scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class Norm(Params):
    def __init__(self, cfg: ModelConfig, stack=(), device=None):
        super().__init__()
        self.scale = new_param(None, (*stack, cfg.d_model), device, fill=1.0)
        if cfg.norm == "layernorm":
            self.bias = new_param(None, (*stack, cfg.d_model), device,
                                  fill=0.0)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x, params, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    return rms_norm(x, params["scale"])


# ---------------------------------------------------------------------------
# RoPE (split-half, float32 angles)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, head_dim]; positions: [..., seq] (int)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # [..., seq, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class MLP(Params):
    def __init__(self, cfg: ModelConfig, gen=None, stack=(), device=None,
                 d_ff: int | None = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        d = cfg.d_model
        if cfg.mlp_act in ("silu", "gelu"):
            self.w_gate = dense(gen, stack, d, d_ff, device)
        self.w_up = dense(gen, stack, d, d_ff, device)
        self.w_down = dense(gen, stack, d_ff, d, device)


_ACTS = {"silu": F.silu,
         # jax.nn.gelu defaults to the tanh approximation.
         "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "gelu_plain": lambda x: F.gelu(x, approximate="tanh")}


def apply_mlp(x: torch.Tensor, params, cfg: ModelConfig) -> torch.Tensor:
    act = _ACTS[cfg.mlp_act]
    dt = x.dtype
    if "w_gate" in params:
        h = act(x @ params["w_gate"].to(dt)) * (x @ params["w_up"].to(dt))
    else:
        h = act(x @ params["w_up"].to(dt))
    return h @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------


def init_embedding(gen, cfg: ModelConfig, device) -> nn.Parameter:
    return new_param(gen, (cfg.vocab_size, cfg.d_model), device, scale=0.02)


def embed_tokens(tokens: torch.Tensor, embedding: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    # Gather, then cast: the same values as casting the table first.
    return F.embedding(tokens, embedding).to(dtype_of(cfg.dtype))


def logits_from_hidden(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """h: [..., d] → logits [..., vocab] in f32 (stable softmax/CE)."""
    w = head
    if w.shape[0] != h.shape[-1]:          # [vocab, d]
        w = w.T
    return h.float() @ w.float()
