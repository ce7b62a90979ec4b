"""The port's fused LIF step against the JAX package.

``lif_step`` on CPU tensors runs its plain version (``lif_step_ref``: the
port's ``neuron_step`` with zero adaptation and refractory state).  It is
held against the JAX wrapper in interpret mode (the Pallas kernel body,
padded to (8, 128) tiles) at the JAX suite's ragged shapes and against the
JAX ``lif_step_ref``, within 1e-6: the Pallas body and ``neuron_step``
associate the membrane sum differently, and XLA on the CPU may fuse
multiply-adds.  A 50-step trajectory must keep equal spikes.  Inputs are
drawn with numpy from fixed seeds.  The CUDA kernel is held against the
plain version on the card (``cuda``-marked tests, and ``chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lif_step import ops as jops
from repro.kernels.lif_step import ref as jref
from repro.snn import neuron as jnrn
from repro_torch.kernels.lif_step import ops as tops
from repro_torch.kernels.lif_step import ref as tref
from repro_torch.snn import neuron as tnrn
from torch_threads import share_cores

share_cores()

TOL = 1e-6
LIF_SHAPES = [(8, 128), (5, 300), (16, 512), (1, 64)]


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.5, 1.2, shape).astype(np.float32)
    i = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    d = (rng.uniform(0, 1, shape) * 0.5).astype(np.float32)
    return v, i, d


@pytest.mark.parametrize("shape", LIF_SHAPES)
def test_lif_step_matches_pallas_and_oracle(shape):
    v, i, d = _inputs(shape[0] * shape[1], shape)
    got = tops.lif_step(*map(torch.from_numpy, (v, i, d)))
    assert all(g.dtype == torch.float32 and g.shape == shape for g in got)
    pallas = jops.lif_step(*map(jnp.asarray, (v, i, d)), interpret=True)
    oracle = jref.lif_step_ref(*map(jnp.asarray, (v, i, d)))
    for ref in (pallas, oracle):
        for name, r, g in zip(("v", "i_syn", "spikes"), ref, got,
                              strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL,
                                       rtol=0, err_msg=name)


def test_lif_step_trajectory_keeps_spikes():
    """50 steps of the port against 50 steps of the Pallas body: equal
    spike trains, membrane within 1e-5 at the end (the JAX suite's own
    trajectory check)."""
    b, n, steps = 4, 256, 50
    rng = np.random.default_rng(99)
    v = i = np.zeros((b, n), np.float32)
    tv, ti = torch.from_numpy(v), torch.from_numpy(i)
    jv, ji = jnp.asarray(v), jnp.asarray(i)
    n_spikes = 0
    for t in range(steps):
        drive = (rng.uniform(0, 1, (b, n)) * 0.6).astype(np.float32)
        tv, ti, ts = tops.lif_step(tv, ti, torch.from_numpy(drive))
        jv, ji, js = jops.lif_step(jv, ji, jnp.asarray(drive), interpret=True)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js),
                                      err_msg=f"spike divergence at step {t}")
        n_spikes += int(ts.sum())
    assert n_spikes > 0
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5, rtol=0)


def test_lif_step_takes_the_lif_parameters():
    """Other time constants, leak, threshold and reset: the port follows
    the reference's plain LIF."""
    params = dict(tau_mem_us=20.0, tau_syn_us=2.0, v_leak=-0.1, v_th=0.8,
                  v_reset=-0.2)
    v, i, d = _inputs(5, (6, 200))
    got = tops.lif_step(*map(torch.from_numpy, (v, i, d)),
                        params=tnrn.NeuronParams(**params))
    ref = jops.lif_step(*map(jnp.asarray, (v, i, d)),
                        params=jnrn.NeuronParams(**params), interpret=True)
    for r, g in zip(ref, got, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("field,value", [("delta_t", 0.06), ("adapt_a", 0.02),
                                         ("adapt_b", 0.1),
                                         ("refrac_us", 2.0)])
def test_lif_step_refuses_adex_terms(field, value):
    params = dataclasses.replace(tnrn.LIF, **{field: value})
    v = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="plain LIF"):
        tops.lif_step(v, v, v, params=params)


def test_lif_step_argument_checks():
    v = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="one shape"):
        tops.lif_step(v, v[:, :4], v)
    with pytest.raises(TypeError, match="float32"):
        tops.lif_step(v.double(), v.double(), v.double())


def test_cpu_tensors_never_launch():
    before = tops.lif_step.launches
    v, i, d = map(torch.from_numpy, _inputs(3, (5, 300)))
    tops.lif_step(v, i, d)
    assert tops.lif_step.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py checks it on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LIF_SHAPES + [(960, 512), (3, 7, 11)])
def test_lif_step_kernel_matches_plain(cuda_device, shape):
    v, i, d = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(7, shape))
    got = tops.lif_step(v, i, d)
    ref = tref.lif_step_ref(v, i, d)
    _, v_pre = tnrn.membrane(tnrn.NeuronState(
        v, i, torch.zeros_like(v), torch.zeros_like(v, dtype=torch.int32)),
        d)
    torch.cuda.synchronize()
    agree = got[2] == ref[2]
    # A spike may flip only where the plain membrane sits at the threshold.
    assert bool(((v_pre - tnrn.LIF.v_th).abs() < TOL)[~agree].all())
    for g, r in zip(got[:2], ref[:2]):
        assert float((g - r).abs()[agree].max()) <= TOL
    assert float((got[1] - ref[1]).abs().max()) <= TOL
