"""Building blocks: parameter modules, norms, RoPE, MLPs, embeddings.

Parameters live in ``Params`` modules whose names are the JAX parameter
tree's paths (``layers.mamba.in_proj``, ``shared_attn.wq``, ``embed``), so
``state_dict()`` keys are those paths and ``convert`` can load a flattened
JAX tree one to one.  A module built with ``stack=(L,)`` holds L layers'
parameters with a leading layer axis, as the JAX package's scanned stacks
do; ``Params.per_layer()`` gives each layer's as a nested dict of views.
The forward functions take any mapping of name → tensor (a module or such
a dict), like the JAX functions take a dict of ``Param``s.

Parameters are float32 and are cast to the activation dtype at use, as
``x @ w.astype(dt)`` does in JAX.  Each parameter carries the JAX
package's logical-axis annotation (``Param(value, axes)``: ``"embed"``,
``"heads"``, ``"ff"``, ``"experts"``, ``"vocab"``, ``"layers"`` or None
for each dimension; a stacked parameter's leading axis is ``"layers"``).
A ``Params`` module records them by name, apart from the tensors, so
``state_dict()`` keys stay the paths; ``param_axes`` lists them and
``repro_torch.parallel.sharding`` resolves them to mesh dimensions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import replicate_dim, splittable

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


class Params(nn.Module):
    """A module of named parameters (and sub-modules) that the forward
    functions index like the JAX package's parameter dicts.  A parameter
    made by ``as_param`` (``new_param``, ``dense``) has its logical axes
    recorded in ``_axes`` when it is assigned."""

    def __setattr__(self, name: str, value) -> None:
        axes = getattr(value, "logical_axes", None)
        if axes is not None:
            self.__dict__.setdefault("_axes", {})[name] = axes
        super().__setattr__(name, value)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def per_layer(self) -> list[dict]:
        """Every layer of a stacked module, each a nested dict of views,
        from one ``unbind(0)`` per stacked tensor.  (Under autograd a
        ``p[i]`` view's backward would write a zero gradient of the whole
        stack, L of them for L layers; ``unbind``'s stacks the L layer
        gradients once.)"""
        parts = {name: p.unbind(0) for name, p in self._parameters.items()}
        parts.update({name: m.per_layer()
                      for name, m in self._modules.items()})
        n = len(next(iter(parts.values())))
        return [{name: part[i] for name, part in parts.items()}
                for i in range(n)]


def param_axes(params: Params, prefix: str = "") -> dict:
    """``{dotted parameter name: logical axes}`` of every parameter of
    ``params``; raises if one has none."""
    recorded = params.__dict__.get("_axes", {})
    out = {}
    for name in params._parameters:
        if name not in recorded:
            raise KeyError(f"parameter {prefix}{name} has no logical axes")
        out[prefix + name] = recorded[name]
    for name, mod in params._modules.items():
        out.update(param_axes(mod, f"{prefix}{name}."))
    return out


def as_param(t: torch.Tensor, axes) -> nn.Parameter:
    """``t`` as a parameter with the logical ``axes`` of its trailing
    dimensions; leading dimensions beyond them (a layer stack) are
    ``"layers"``."""
    axes = tuple(axes)
    p = nn.Parameter(t, requires_grad=False)
    p.logical_axes = ("layers",) * (t.dim() - len(axes)) + axes
    return p


def new_param(gen: torch.Generator | None, shape, device, *, axes,
              scale: float = 1.0, fill: float | None = None) -> nn.Parameter:
    """A float32 parameter: normal(0, 1) · scale drawn from ``gen``, or
    ``fill`` everywhere; ``axes`` as ``as_param`` takes them."""
    if fill is not None:
        t = torch.full(shape, fill, dtype=torch.float32, device=device)
    else:
        # Scaled in place, so that a layer stack's tensor takes its size
        # in memory once while it is made, not twice.
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device).mul_(scale)
    return as_param(t, axes)


def dense(gen, stack, in_dim: int, out_dim: int, device,
          scale: float | None = None, *, axes) -> nn.Parameter:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return new_param(gen, (*stack, in_dim, out_dim), device, scale=scale,
                     axes=axes)


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------


class _SplitHeads(torch.autograd.Function):
    """[B, S, H·hd] → the [B, H, S, hd] view, whose gradient is copied
    contiguous before it is merged back.  (Autograd's own backward reshapes
    the transposed gradient, which DTensor, whose layout record of a
    redistributed or cast gradient can disagree with its shards', takes
    for a view of a non-contiguous tensor and refuses.)"""

    @staticmethod
    def forward(ctx, x, n_heads):
        b, s, _ = x.shape
        return x.reshape(b, s, n_heads, -1).transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        b, h, s, hd = g.shape
        g = g.transpose(1, 2).clone(memory_format=torch.contiguous_format)
        return g.reshape(b, s, h * hd), None


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x [B, S, H·hd] as [B, H, S, hd] (a view).  On a mesh the feature
    dimension is gathered first where its shards do not split into whole
    heads (``parallel.sharding.splittable``)."""
    return _SplitHeads.apply(splittable(x, 2, n_heads), n_heads)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class Norm(Params):
    def __init__(self, cfg: ModelConfig, stack=(), device=None):
        super().__init__()
        self.scale = new_param(None, (*stack, cfg.d_model), device, fill=1.0,
                               axes=("embed",))
        if cfg.norm == "layernorm":
            self.bias = new_param(None, (*stack, cfg.d_model), device,
                                  fill=0.0, axes=("embed",))


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
            self.w_gate = dense(gen, stack, d, d_ff, device,
                                axes=("embed", "ff"))
        self.w_up = dense(gen, stack, d, d_ff, device, axes=("embed", "ff"))
        self.w_down = dense(gen, stack, d_ff, d, device, axes=("ff", "embed"))


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
    return new_param(gen, (cfg.vocab_size, cfg.d_model), device, scale=0.02,
                     axes=("vocab", "embed"))


def embed_tokens(tokens: torch.Tensor, embedding: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    # Gather, then cast: the same values as casting the table first.  On a
    # mesh the lookup reads the whole table (gathered on both dimensions):
    # DTensor's lookup in a vocab-sharded table sums "masked partials",
    # whose mask breaks once the ids are sharded on the batch and which
    # torch 2.11 cannot add to the head's partial gradient of a tied table.
    table = replicate_dim(replicate_dim(embedding, 0), 1)
    return F.embedding(tokens, table).to(dtype_of(cfg.dtype))


def logits_from_hidden(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """h: [..., d] → logits [..., vocab] in f32 (stable softmax/CE)."""
    w = head
    if w.shape[0] != h.shape[-1]:          # [vocab, d]
        w = w.T
    return h.float() @ w.float()


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``log_softmax`` over the last dimension.  On a DTensor whose last
    dimension (the vocabulary) is sharded, DTensor's own op gathers it
    (12.9 GB a device for smollm-135m at train_4k on 16 x 16): the shift
    and the normaliser are taken over the shards instead, all-reductions
    of [..., 1]."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and any(p.is_shard(x.ndim - 1)
                                      for p in x.placements):
        # The max only shifts (log_softmax's own carries no gradient).
        z = x - x.detach().amax(-1, keepdim=True)
        return z - torch.log(torch.sum(torch.exp(z), -1, keepdim=True))
    return torch.log_softmax(x, dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits`` [...,
    vocab]; with ``mask`` the mean over its weight (at least 1)."""
    from torch.distributed.tensor import DTensor

    logp = _log_softmax(logits)
    if isinstance(logp, DTensor):
        # DTensor's gather backward scatters into zeros of the whole
        # logits' shape on every rank (206 GB a device for smollm-135m at
        # train_4k on 16 x 16); the label's entry picked by a mask is the
        # same value (one term, zeros elsewhere) with a sharded backward.
        vocab = torch.arange(logp.shape[-1], device=labels.device)
        nll = -torch.sum(torch.where(vocab == labels[..., None].long(),
                                     logp, 0.0), dim=-1)
    else:
        nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
