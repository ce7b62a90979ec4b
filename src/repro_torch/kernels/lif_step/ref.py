"""Plain PyTorch version of the fused LIF step: the port's ``neuron_step``
on a state with zero adaptation and refractory counters, as the reference's
``repro/kernels/lif_step/ref.py`` delegates to its jnp substrate."""

from __future__ import annotations

import torch

from repro_torch.snn import neuron as nrn


def lif_step_ref(v, i_syn, drive, *, params: nrn.NeuronParams = nrn.LIF):
    """Returns (v, i_syn, spikes) after one step, each f32 like ``v``."""
    state = nrn.NeuronState(v=v, i_syn=i_syn, w_adapt=torch.zeros_like(v),
                            refrac=torch.zeros(v.shape, dtype=torch.int32,
                                               device=v.device))
    new_state, spikes = nrn.neuron_step(state, drive, params)
    return new_state.v, new_state.i_syn, spikes
