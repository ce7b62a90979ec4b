"""Carry network parameters and state across from the JAX package.

The arrays travel as a flat ``{path: numpy array}`` dict keyed by the JAX
pytree paths (``chips.weights``, ``router.fwd_tables``,
``chips.neurons.v``, ``layers.mamba.in_proj``, ...), so the port never sees
a JAX object: a caller flattens the reference's ``NetworkParams`` /
``NetworkState`` or LM parameter and cache trees with numpy and hands the
dict over.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.aggregator import RouterState
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import LMParams, _segments
from repro_torch.models.ssm import SSMCache
from repro_torch.snn.chip import ChipParams, ChipState
from repro_torch.snn.network import NetworkParams, NetworkState
from repro_torch.snn.neuron import NeuronState

# Key → dtype of every array the port reads.
PARAM_KEYS = {
    "chips.weights": torch.float32,
    "chips.row_sign": torch.float32,
    "chips.w_scale": torch.float32,
    "row_of_label": torch.int32,
    "router.fwd_tables": torch.int32,
    "router.rev_tables": torch.int32,
    "router.route_enables": torch.bool,
}
STATE_KEYS = {
    "chips.neurons.v": torch.float32,
    "chips.neurons.i_syn": torch.float32,
    "chips.neurons.w_adapt": torch.float32,
    "chips.neurons.refrac": torch.int32,
    "inflight": torch.float32,
}


def _tensors(arrays: dict[str, np.ndarray], keys: dict, device):
    missing = sorted(set(keys) - set(arrays))
    if missing:
        raise KeyError(f"missing arrays: {missing}")
    device = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(arrays[k])).to(device=device,
                                                         dtype=dtype)
            for k, dtype in keys.items()}


def network_params_from_numpy(arrays: dict[str, np.ndarray], device=None
                              ) -> NetworkParams:
    t = _tensors(arrays, PARAM_KEYS, device)
    return NetworkParams(
        chips=ChipParams(weights=t["chips.weights"],
                         row_sign=t["chips.row_sign"],
                         w_scale=t["chips.w_scale"]),
        row_of_label=t["row_of_label"],
        router=RouterState(fwd_tables=t["router.fwd_tables"],
                           rev_tables=t["router.rev_tables"],
                           route_enables=t["router.route_enables"]))


def network_state_from_numpy(arrays: dict[str, np.ndarray], device=None
                             ) -> NetworkState:
    t = _tensors(arrays, STATE_KEYS, device)
    return NetworkState(
        chips=ChipState(neurons=NeuronState(
            v=t["chips.neurons.v"], i_syn=t["chips.neurons.i_syn"],
            w_adapt=t["chips.neurons.w_adapt"],
            refrac=t["chips.neurons.refrac"])),
        inflight=t["inflight"])


# ---------------------------------------------------------------------------
# LM harness
# ---------------------------------------------------------------------------


def lm_params_from_numpy(arrays: dict[str, np.ndarray], cfg,
                         device=None):
    """The LM's parameters from the JAX ``init_params`` tree flattened to
    ``{path: array}`` (``embed``, ``layers.mamba.in_proj``,
    ``shared_attn.wq``, ...; each ``Param`` contributes its value under its
    own path).  Every key the port's ``LMParams`` names must be present,
    with its shape, and no other; values become float32."""
    device = resolve_device(device)
    model = LMParams(cfg, None, device="meta")
    want = dict(model.named_parameters())
    extra = sorted(set(arrays) - set(want))
    if extra:
        raise KeyError(f"arrays the port does not read: {extra}")
    t = _tensors(arrays, dict.fromkeys(want, torch.float32), device)
    model.load_state_dict(t, strict=True, assign=True)
    return model


def lm_caches_from_numpy(arrays: dict[str, np.ndarray], cfg, device=None):
    """Decode caches from the JAX ``init_cache``/``prefill`` tree flattened
    to ``{path: array}``: for zamba2 the tuple (Mamba2 cache, shared-block
    KV cache) as ``0.conv``, ``0.state``, ``1.k``, ``1.v``; otherwise one KV
    cache per segment (``layers.k``, ``layers.v``).  Conv and K/V leaves
    take the config's activation dtype, recurrent states stay float32."""
    dt = dtype_of(cfg.dtype)
    if cfg.attn_every:
        t = _tensors(arrays, {"0.conv": dt, "0.state": torch.float32,
                              "1.k": dt, "1.v": dt}, device)
        return (SSMCache(conv=t["0.conv"], state=t["0.state"]),
                KVCache(k=t["1.k"], v=t["1.v"]))
    names = [seg.name for seg in _segments(cfg)]
    t = _tensors(arrays, {f"{n}.{f}": dt for n in names for f in "kv"},
                 device)
    return {n: KVCache(k=t[f"{n}.k"], v=t[f"{n}.v"]) for n in names}
