"""The port's gradient compression (``repro_torch.parallel.compression``)
against the JAX package's: the reference's own three oracle tests, then
``sparsify``, ``densify``, ``compress_with_feedback`` and
``quantize_int8`` on the same numpy inputs through both packages, on
arrays whose magnitudes tie (``jax.lax.top_k`` takes the lower index
first).  Everything is held bit for bit: indices, values, residuals and
int8 codes; ``quantize_int8`` with the reference's own noise passed in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as jcomp
from repro_torch.parallel import compression as comp
from torch_threads import share_cores

share_cores()


def _eq(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


def tied(seed: int, shape) -> np.ndarray:
    """float32 values from a few magnitudes, both signs: many ties."""
    rng = np.random.default_rng(seed)
    mags = np.array([0.0, 0.25, 0.5, 1.0, 3.0], np.float32)
    x = rng.choice(mags, size=shape) * rng.choice([-1.0, 1.0], size=shape)
    return x.astype(np.float32)


# -- the reference's oracle tests (tests/test_runtime.py) ---------------------


def test_sparsify_densify_roundtrip_topk():
    g = torch.tensor([[0.1, -5.0, 0.01], [3.0, 0.0, -0.2]])
    frame, residual = comp.sparsify(g, capacity=2)
    dense = comp.densify(frame)
    # the two largest-magnitude entries survive
    assert float(dense[0, 1]) == -5.0 and float(dense[1, 0]) == 3.0
    np.testing.assert_allclose((dense + residual).numpy(), g.numpy(),
                               atol=1e-7)


def test_error_feedback_accumulates():
    state = comp.init_feedback(torch.zeros((10,)))
    g = torch.ones((10,)) * 0.1
    g[0] = 5.0
    frame, state = comp.compress_with_feedback(g, state, frac=0.1)  # k=1
    assert int(frame.indices[0]) == 0
    # the small entries live on in the residual and eventually get sent
    total = comp.densify(frame)
    for _ in range(12):
        frame, state = comp.compress_with_feedback(torch.zeros((10,)), state,
                                                   frac=0.1)
        total = total + comp.densify(frame)
    # After enough rounds every entry has been transmitted exactly once.
    np.testing.assert_allclose(total.numpy(), g.numpy(), atol=1e-6)


def test_int8_quantization_error_bounded():
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.key(0),
                                                    (1000,))))
    q, scale = comp.quantize_int8(x)
    back = comp.dequantize_int8(q, scale)
    assert float((back - x).abs().max()) <= float(scale) * 1.01


# -- against the reference, bit for bit ---------------------------------------


@pytest.mark.parametrize("shape,capacity", [((37,), 5), ((6, 9), 17),
                                            ((4, 5, 8), 160), ((3, 3), 1)])
def test_sparsify_densify_match_jax(shape, capacity):
    x = tied(len(shape) * 7 + capacity, shape)
    frame, residual = comp.sparsify(torch.from_numpy(x), capacity)
    jframe, jresidual = jcomp.sparsify(jnp.asarray(x), capacity)
    assert frame.shape == tuple(jframe.shape) == shape
    assert frame.indices.dtype == torch.int32
    _eq(frame.indices, jframe.indices, "indices")
    _eq(frame.values, jframe.values, "values")
    _eq(residual, jresidual, "residual")
    _eq(comp.densify(frame), jcomp.densify(jframe), "densify")


def test_densify_sums_repeated_indices():
    idx = np.array([3, 1, 3, 0, 3], np.int32)
    vals = np.array([0.5, -1.0, 0.25, 2.0, 1.0], np.float32)
    got = comp.densify(comp.SparseGrad(torch.from_numpy(idx),
                                       torch.from_numpy(vals), (2, 3)))
    want = jcomp.densify(jcomp.SparseGrad(jnp.asarray(idx), jnp.asarray(vals),
                                          (2, 3)))
    _eq(got, want, "densify with repeats")


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.3])
def test_compress_with_feedback_rounds_match_jax(frac):
    shape = (24, 10)
    state = comp.init_feedback(torch.zeros(shape))
    jstate = jcomp.init_feedback(jnp.zeros(shape))
    for r in range(5):
        g = tied(100 + r, shape)
        frame, state = comp.compress_with_feedback(torch.from_numpy(g),
                                                   state, frac)
        jframe, jstate = jcomp.compress_with_feedback(jnp.asarray(g), jstate,
                                                      frac)
        _eq(frame.indices, jframe.indices, f"round {r} indices")
        _eq(frame.values, jframe.values, f"round {r} values")
        _eq(state.residual, jstate.residual, f"round {r} residual")


@pytest.mark.parametrize("with_noise", [False, True])
def test_quantize_int8_matches_jax(with_noise):
    x = np.random.default_rng(3).normal(size=(33, 7)).astype(np.float32)
    key = jax.random.key(11) if with_noise else None
    jq, jscale = jcomp.quantize_int8(jnp.asarray(x), key)
    noise = None
    if with_noise:
        noise = torch.from_numpy(np.array(jax.random.uniform(
            key, x.shape, minval=-0.5, maxval=0.5)))
    q, scale = comp.quantize_int8(torch.from_numpy(x), noise=noise)
    assert q.dtype == torch.int8
    _eq(q, jq, "int8 codes")
    _eq(scale, jscale, "scale")
    _eq(comp.dequantize_int8(q, scale), jcomp.dequantize_int8(jq, jscale),
        "dequantized")


def test_quantize_int8_generator_noise():
    x = torch.linspace(-2.0, 2.0, 257)
    gen = torch.Generator().manual_seed(4)
    q1, s1 = comp.quantize_int8(x, torch.Generator().manual_seed(4))
    noise = torch.rand(x.shape, generator=gen) - 0.5
    q2, s2 = comp.quantize_int8(x, noise=noise)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    with pytest.raises(ValueError, match="not both"):
        comp.quantize_int8(x, gen, noise=noise)
