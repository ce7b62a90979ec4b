"""The port's example scripts (``examples/*_torch.py``) and the two public
methods they brought over, against the JAX package on the CPU.

Each script's body takes its inputs as arguments, so the tests feed it the
reference's parameters and draws: quickstart prints the reference script's
three lines character for character, multichip_snn's first train step
gives the reference's loss within 1e-5 relative, and serve_lm returns the
reference ``generate``'s greedy tokens.  ``main`` of each script runs on
its own random streams at a small size, and raises without a card unless
``--device cpu`` is given.
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import scenarios as jscen
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core import events as jevents
from repro.launch.serve import generate as jgenerate
from repro.models import model as JM
from repro.snn import chip as jchip
from repro.snn import encoding as jenc
from repro.snn import network as jnet
from repro.snn import training as jtr
from repro_torch import convert
from repro_torch.analysis import scenarios as tscen
from repro_torch.configs.base import ModelConfig
from repro_torch.core import events as tevents
from repro_torch.snn import chip as tchip
from repro_torch.snn import encoding as tenc
from repro_torch.snn import neuron as nrn
from test_torch_serve import flatten as flatten_lm
from test_torch_stream import flatten
from test_torch_training import reference_batch_draws
from torch_threads import share_cores

share_cores()

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "multichip_snn", "serve_lm", "train_lm")
LOSS_RTOL = 1e-5


def load(name: str):
    """``examples/<name>_torch.py`` as a module."""
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# EventFrame.count and FabricPlan.identity_tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37,), (5, 64), (2, 3, 16)])
def test_event_frame_count_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    labels = rng.integers(0, 1 << 15, shape).astype(np.int32)
    times = rng.integers(0, 256, shape).astype(np.int32)
    valid = rng.random(shape) < 0.4
    valid.reshape(-1)[0] = True
    ref = jevents.EventFrame(jnp.asarray(labels), jnp.asarray(times),
                             jnp.asarray(valid)).count()
    got = tevents.EventFrame(torch.from_numpy(labels),
                             torch.from_numpy(times),
                             torch.from_numpy(valid)).count()
    assert got.dtype == torch.int32
    assert np.asarray(ref).dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert tuple(got.shape) == shape[:-1]


def catalogue_plans(name: str):
    """The catalogue plan ``name`` compiled in both packages."""
    _, fan_ins, cap_in, cap = next(c for c in jscen.CASES if c[0] == name)
    caps = jscen.level_caps(fan_ins, cap_in, jscen.OCC_HEADLINE)
    return (jscen.plan_for(fan_ins, cap, caps),
            tscen.plan_for(fan_ins, cap, caps))


@pytest.mark.parametrize("name,n_labels", [
    ("FULL_BACKPLANE", None), ("PROJECTED_120CHIP", None),
    ("EXT_4CASE_96CHIP", None), ("PROJECTED_120CHIP", 1536)])
def test_identity_tables_matches_reference(name, n_labels):
    jplan, tplan = catalogue_plans(name)
    assert tplan.n_nodes == jplan.n_nodes
    ref = jplan.identity_tables(n_labels)
    got = tplan.identity_tables(n_labels, device="cpu")
    for what, r, g in zip(("fwd", "rev"), ref, got):
        assert g.dtype == torch.int32, what
        assert np.asarray(r).dtype == np.int32, what
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=what)
        assert g.stride(0) == 0, what        # an expand view of one table


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_quickstart() -> list[str]:
    """The lines ``examples/quickstart.py`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    return out.getvalue().splitlines()


def test_quickstart_prints_the_reference_lines(reference_quickstart,
                                               capsys):
    """Fed the reference script's chip parameters (key 0) and Poisson
    uniforms (key 1), the port prints its three lines."""
    q = load("quickstart")
    cfg = tchip.ChipConfig()
    jp = jchip.init_params(jax.random.key(0), jchip.ChipConfig())
    params = tchip.ChipParams(
        weights=torch.from_numpy(np.array(jp.weights))[None],
        row_sign=torch.from_numpy(np.array(jp.row_sign))[None],
        w_scale=torch.from_numpy(np.array(jp.w_scale)).reshape(1))
    u = np.array(jax.random.uniform(jax.random.key(1),
                                    (q.N_STEPS, 1, cfg.n_rows)))
    stimulus = tenc.poisson_encode(
        torch.full((1, 1, cfg.n_rows), q.RATE), q.N_STEPS,
        draws=torch.from_numpy(u)[:, None], device="cpu")
    spikes = spike_trains(params, stimulus, cfg)
    ref_spikes = reference_spike_trains(jp)
    flips = np.argwhere(spikes != ref_spikes)
    assert not flips.size, (
        f"spikes differ from the reference at (step, neuron) {flips[:8]}; "
        f"margins |v - v_th| there {margins(params, stimulus, cfg, flips)}")
    out = q.run(params, stimulus, cfg)
    lines = capsys.readouterr().out.splitlines()
    assert lines == reference_quickstart
    assert out["dropped"] == [0] * q.N_CHIPS
    assert out["spikes"] == int(ref_spikes.sum()) > 0
    assert out["latency_line"] == reference_quickstart[2]


def spike_trains(params, stimulus, cfg) -> np.ndarray:
    state = tchip.init_state(cfg, 1, 1, device="cpu")
    out = []
    for t in range(stimulus.shape[0]):
        state, s = tchip.chip_step(params, state, stimulus[t], cfg)
        out.append(s[0, 0].numpy())
    return np.stack(out)


def reference_spike_trains(jp) -> np.ndarray:
    """The reference script's chip loop: the same keys, its own encoder."""
    cfg = jchip.ChipConfig()
    state = jchip.init_state(cfg, batch=1)
    stim = jenc.poisson_encode(jax.random.key(1),
                               jnp.full((1, cfg.n_rows), 0.4), n_steps=50)
    out = []
    for t in range(stim.shape[0]):
        state, s = jchip.chip_step(jp, state, stim[t], cfg)
        out.append(np.array(s[0]))
    return np.stack(out)


def margins(params, stimulus, cfg, flips) -> list[float]:
    """The port's |v - v_th| before the threshold at the first flipped
    step, for the failure message: the CPU's float32 product gives the
    reference's rasters here, so no flip is expected (elsewhere
    ``repro_torch.parity`` allows one below ``parity.FLIP_MARGIN``)."""
    if not flips.size:
        return []
    t0 = int(flips[0, 0])
    state = tchip.init_state(cfg, 1, 1, device="cpu")
    for t in range(t0):
        state, _ = tchip.chip_step(params, state, stimulus[t], cfg)
    current = tchip.synapse_current(params, stimulus[t0], cfg)
    _, v = nrn.membrane(state.neurons, current, cfg.neuron)
    m = (v - cfg.neuron.v_th).abs()[0, 0]
    return [float(m[k]) for t, k in flips if t == t0]


# ---------------------------------------------------------------------------
# multichip_snn
# ---------------------------------------------------------------------------


def test_multichip_snn_main_on_cpu():
    out = load("multichip_snn").main(["--device", "cpu", "--steps", "2",
                                      "--batch", "4"])
    assert out["event_equals_dense"] is True
    assert out["stream_equals_loop"] is True
    assert out["drops"] == 0
    assert len(out["loss"]) == 2 and np.isfinite(out["loss"]).all()
    assert [f["rate_hz"] for f in out["fig5"]] == [10e6, 50e6, 83.3e6]
    for f in out["fig5"]:
        assert 800 < f["median_ns"] < 1300


def test_multichip_snn_first_step_matches_reference():
    """The script's network and first training batch (keys 0 and 100)
    from the reference, at batch 4: the first ``train_step``'s loss
    within 1e-5 relative of the reference's jitted step, the datapath
    checks true on the reference's datapath batch (key 1)."""
    m = load("multichip_snn")
    cfg = m.config()
    cfg_j = jtr.TrainConfig(network=jnet.NetworkConfig(n_chips=3,
                                                       capacity=600),
                            n_steps=32, n_classes=4, lr=0.2)
    assert (cfg.n_steps, cfg.n_classes, cfg.lr) == (cfg_j.n_steps,
                                                    cfg_j.n_classes, cfg_j.lr)
    params_j = jnet.init_feedforward(jax.random.key(0), cfg_j.network)
    mats_j = jnet.routing_matrices(params_j, cfg_j.network)
    params = convert.network_params_from_numpy(flatten(params_j),
                                               device="cpu")
    mats = m.routing_matrices(params, cfg.network)
    batch = 4
    drives, _ = m.trlib.make_batch(
        cfg, batch, draws=reference_batch_draws(jax.random.key(1), cfg_j,
                                                batch), device="cpu")
    checks = m.check_datapath(params, mats, drives, cfg, "cpu")
    assert checks["event_equals_dense"] and checks["stream_equals_loop"]

    key = jax.random.key(100)
    drives_j, labels_j = jtr.make_batch(key, cfg_j, batch)
    mom_j = jax.tree.map(
        lambda x: jnp.zeros_like(x) if x.dtype == jnp.float32 else x,
        params_j)
    _, _, loss_j, _ = jax.jit(lambda p, mo, d, la: jtr.train_step(
        p, mo, mats_j, d, la, cfg_j))(params_j, mom_j, drives_j, labels_j)
    first = m.trlib.make_batch(cfg, batch,
                               draws=reference_batch_draws(key, cfg_j, batch),
                               device="cpu")
    hist = m.train(params, mats, cfg, 1, lambda i: first, "cpu")
    ref = float(loss_j)
    assert abs(hist["loss"][0] - ref) <= LOSS_RTOL * abs(ref), (
        hist["loss"][0], ref)
    mom = m.zeros_like_floats(params)
    assert float(mom.chips.weights.abs().sum()) == 0
    assert torch.equal(mom.row_of_label, params.row_of_label)


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-7b"])
def test_serve_lm_returns_the_reference_tokens(arch):
    """The reference script's config (the smoke config, its own
    ``attention_impl``), weights from its key 0 and numpy prompts at its
    batch, prompt length and new tokens: the port (under ``"pallas"``,
    the kernels' plain versions on the CPU) returns the same greedy
    tokens.  Both run in float32: in bfloat16 the two frameworks round at
    other places (``tests/test_torch_serve.py``, ``BF16_LOGIT_TOL``), and
    over 24 greedy steps of random weights a near-tied argmax flips."""
    s = load("serve_lm")
    jcfg = dataclasses.replace(jsmoke_config(jget_config(arch)),
                               dtype="float32")
    cfg = s.config(arch, True)
    assert cfg.attention_impl == "pallas" and cfg.dtype == "bfloat16"
    assert dataclasses.replace(cfg, attention_impl=jcfg.attention_impl,
                               dtype="float32") == ModelConfig(
        **dataclasses.asdict(jcfg))
    cfg = dataclasses.replace(cfg, dtype="float32")
    jparams = JM.init_params(jax.random.key(0), jcfg)
    params = convert.lm_params_from_numpy(flatten_lm(jparams), cfg,
                                          device="cpu")
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (4, 16)).astype(np.int32)
    ref, _ = jgenerate(jcfg, jparams, jnp.asarray(prompts), 24)
    out = s.serve(cfg, params, torch.from_numpy(prompts), 24)
    np.testing.assert_array_equal(np.array(out["tokens"]), np.asarray(ref))
    assert out["launches"] == {}                   # the CPU never launches


def test_serve_lm_refuses_embeddings_archs():
    with pytest.raises(SystemExit, match="token-input arch"):
        load("serve_lm").main(["--arch", "llava-next-mistral-7b",
                               "--device", "cpu"])


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------


def test_train_lm_resumes_and_the_loss_falls(tmp_path):
    out = load("train_lm").main(["--device", "cpu", "--smoke", "--steps",
                                 "20", "--simulate-failure"],
                                ckpt_dir=tmp_path / "ckpt")
    assert out["resumed_at"] == 10
    assert len(out["losses"]) == 20
    assert out["last"] < out["first"]
    assert (tmp_path / "ckpt").is_dir()


# ---------------------------------------------------------------------------
# Every script: the card by default, no JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_raise_without_a_card(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = load(name)
    kw = {"ckpt_dir": tmp_path / "ckpt"} if name == "train_lm" else {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([], **kw)


def forbidden_imports(path: pathlib.Path) -> list[str]:
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno}: {name}")
    return bad


@pytest.mark.parametrize("target", [*EXAMPLES, "src/repro_torch"])
def test_no_jax_or_reference_imports(target):
    if target in EXAMPLES:
        files = [ROOT / "examples" / f"{target}_torch.py"]
    else:
        files = sorted((ROOT / target).rglob("*.py"))
        assert len(files) > 30
    bad = [b for f in files for b in forbidden_imports(f)]
    assert not bad, bad
