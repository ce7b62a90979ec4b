"""Carry network parameters and state across from the JAX package.

The arrays travel as a flat ``{path: numpy array}`` dict keyed by the JAX
pytree paths (``chips.weights``, ``router.fwd_tables``,
``chips.neurons.v``, ...), so the port never sees a JAX object: a caller
flattens the reference's ``NetworkParams`` / ``NetworkState`` with numpy
and hands the dict over.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.aggregator import RouterState
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
