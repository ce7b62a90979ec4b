"""Assigned input-shape sets and meta-tensor stand-ins per (arch, shape)
(port of ``src/repro/launch/shapes.py``).

LM transformer shapes (assignment):
    train_4k     seq 4 096 × global batch 256   → train_step
    prefill_32k  seq 32 768 × global batch 32   → prefill
    decode_32k   seq 32 768 × global batch 128  → serve_step (1 new token,
                                                  KV cache of seq_len)
    long_500k    seq 524 288 × global batch 1   → serve_step; requires
                 sub-quadratic mixing → runs only for ssm/hybrid archs.

``input_specs`` returns tensors on the ``meta`` device, where the JAX
package returns ``ShapeDtypeStruct``s: shapes and dtypes, no storage (the
dry-run pattern), so grok-1-314b's decode caches at ``decode_32k`` cost
nothing.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.layers import dtype_of

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

SHAPE_NAMES = list(SHAPES)


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(supported, reason-if-not) for an (arch, shape) cell."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention — long_500k skipped per "
                       "assignment (see DESIGN.md §5)")
    return True, ""


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-tensor stand-ins for every model input of this cell.

    Returns {"kind", "batch": {...}} where batch mirrors the runtime batch
    dict; decode adds "caches" + "tokens" + "index".  ``shape_name`` may
    also be a shape of its own, a dict with ``SHAPES``' keys.
    """
    spec = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    b, s = spec["global_batch"], spec["seq_len"]
    kind = spec["kind"]
    i32, dt = torch.int32, dtype_of(cfg.dtype)

    def train_batch():
        if cfg.encoder_layers:
            dec = max(8, s // cfg.decoder_len_ratio)
            return {"embeds": _struct((b, s, cfg.d_model), dt),
                    "tokens": _struct((b, dec + 1), i32)}
        if cfg.input_mode == "embeddings":
            return {"embeds": _struct((b, s, cfg.d_model), dt),
                    "labels": _struct((b, s), i32)}
        return {"tokens": _struct((b, s + 1), i32)}

    def prefill_batch():
        if cfg.encoder_layers:
            dec = max(8, s // cfg.decoder_len_ratio)
            return {"embeds": _struct((b, s, cfg.d_model), dt),
                    "tokens": _struct((b, dec), i32)}
        if cfg.input_mode == "embeddings":
            return {"embeds": _struct((b, s, cfg.d_model), dt)}
        return {"tokens": _struct((b, s), i32)}

    if kind == "train":
        return {"kind": "train", "batch": train_batch()}
    if kind == "prefill":
        return {"kind": "prefill", "batch": prefill_batch()}

    # decode: one new token against a cache of seq_len.
    out = {"kind": "decode",
           "tokens": _struct((b,), i32),
           "caches": M.init_cache(cfg, b, s, device="meta"),
           "index": _struct((), i32)}
    if cfg.encoder_layers:
        out["encoder_out"] = _struct((b, s, cfg.d_model), dt)
    return out
