"""Public wrapper of the fused LIF step.

``lif_step`` runs the plain version (``ref.lif_step_ref``) on CPU tensors
and launches ``csrc/lif_step.cu`` on CUDA tensors, counting each launch in
its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import FLOAT, PTR, check, launcher, on_card, stream
from repro_torch.kernels.lif_step.ref import lif_step_ref
from repro_torch.snn import neuron as nrn


def lif_step(v: torch.Tensor, i_syn: torch.Tensor, drive: torch.Tensor, *,
             params: nrn.NeuronParams = nrn.LIF):
    """One fused LIF update: synaptic-current decay, membrane integration,
    threshold and reset.

    v, i_syn, drive: float32, one shape (any).  Returns (v, i_syn, spikes),
    float32 of that shape, spikes in {0, 1}.

    The kernel computes plain LIF in the TPU kernel's operation order
    (``csrc/lif_step.cu``); it carries no adaptation or refractory state.
    The reference's kernel ignores the AdEx terms of ``params`` silently;
    this wrapper raises ``ValueError`` for them instead (a nonzero
    ``delta_t``, ``adapt_a``, ``adapt_b`` or refractory period), because
    ``lif_step_ref`` computes the exponential term and a trajectory built
    from this op would silently lose adaptation and refractoriness.  The
    plain version associates the membrane sum as ``neuron_step`` does, so
    the two agree within float32 rounding (1e-6 at unit-scale potentials),
    not bit for bit.
    """
    if params.delta_t or params.adapt_a or params.adapt_b \
            or params.refrac_steps:
        raise ValueError(
            "lif_step computes plain LIF: delta_t, adapt_a, adapt_b and the "
            f"refractory period must be 0, got {params}")
    if i_syn.shape != v.shape or drive.shape != v.shape:
        raise ValueError(f"v, i_syn and drive must share one shape, got "
                         f"{tuple(v.shape)}, {tuple(i_syn.shape)}, "
                         f"{tuple(drive.shape)}")
    if not (v.dtype == i_syn.dtype == drive.dtype == torch.float32):
        raise TypeError(f"lif_step takes float32, got {v.dtype}, "
                        f"{i_syn.dtype}, {drive.dtype}")
    if not on_card(v, i_syn, drive):
        return lif_step_ref(v, i_syn, drive, params=params)
    v, i_syn, drive = (x.contiguous() for x in (v, i_syn, drive))
    v_out, i_out, s_out = (torch.empty_like(v) for _ in range(3))
    launch = launcher("lif_step", "lif_step_launch",
                      (PTR,) * 3 + (ctypes.c_int64,) + (FLOAT,) * 5
                      + (PTR,) * 4)
    # ctypes rounds the Python doubles alpha_syn and 1 - alpha_mem to the
    # nearest float32, as JAX does with the constants of the TPU kernel.
    check(launch(v.data_ptr(), i_syn.data_ptr(), drive.data_ptr(), v.numel(),
                 params.alpha_syn, 1.0 - params.alpha_mem, params.v_leak,
                 params.v_th, params.v_reset, v_out.data_ptr(),
                 i_out.data_ptr(), s_out.data_ptr(), stream()),
          "lif_step")
    lif_step.launches += 1
    return v_out, i_out, s_out


lif_step.launches = 0
