"""The port's LM training slice against the JAX package.

``synthetic_batch`` and ``Pipeline`` (bit for bit), ``cross_entropy``,
``train_loss`` with every gradient leaf for the ten archs (smoke configs,
float32, ``attention_impl="xla"``: the JAX package cannot differentiate
through its Pallas kernels, and the port's kernels refuse to), per-layer
remat, ``adamw.update``, the ``Trainer`` (steps, resume, checkpoints in
both directions) and ``launch.train``.  Weights come from the JAX
``init_params``, flattened to ``{pytree path: numpy}`` and loaded by
``repro_torch.convert``.

Tolerances: the loss within ``LOSS_TOL`` relative; each gradient leaf
within ``GRAD_TOL`` x its largest magnitude (measured: at most 4.0e-6,
zamba2-7b's), rwkv6-7b's within ``RWKV_GRAD_TOL``: float32 rounding alone
moves its gradient that far (the port's own chunked scan at chunk 4
against chunk 16, the same function, differs by up to 1.3e-5 x max|g|
over four seeds; the port against JAX by 4.4e-6 to 1.9e-5);
``adamw.update`` within ``ADAMW_TOL`` (the norm's sum over
leaves in another order: 1 ulp); four ``Trainer`` steps: losses within
``LOSS_TOL`` relative, parameters within ``TRAINER_PARAM_TOL`` (Adam's
normalised step turns gradients' float32 rounding into parameter moves
of up to a few percent of lr for the smallest gradient entries).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.runtime import trainer as jtrainer
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs.base import ModelConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.linear_scan import ops as tscan
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.runtime import trainer as ttrainer
from test_torch_serve import flatten
from torch_threads import share_cores

share_cores()

KEY = jax.random.key(5)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
RWKV_GRAD_TOL = 5e-5
ADAMW_TOL = 1e-6
TRAINER_PARAM_TOL = 1e-5      # at lr 3e-4: 3% of one step
BATCH, SEQ = 2, 16


def configs(arch, dtype="float32", impl="xla", **overrides):
    """The same smoke config of ``arch`` in both packages."""
    jcfg = dataclasses.replace(jsmoke_config(jget_config(arch)), dtype=dtype,
                               attention_impl=impl, **overrides)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _batches(jcfg, cfg, step=5, seed=1):
    jb = jpipe.synthetic_batch(jcfg, jpipe.DataConfig(BATCH, SEQ, seed), step)
    tb = tpipe.synthetic_batch(cfg, tpipe.DataConfig(BATCH, SEQ, seed), step,
                               device="cpu")
    return jb, tb


def _grads(params, loss):
    names, leaves = zip(*params.named_parameters())
    return dict(zip(names, torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_arch_lists_match():
    assert ARCH_NAMES == JARCH_NAMES


@pytest.mark.parametrize("arch", JARCH_NAMES)
def test_synthetic_batch_matches_jax(arch):
    jcfg, cfg = configs(arch)
    for step, seed in ((0, 0), (7, 3)):
        jb, tb = _batches(jcfg, cfg, step, seed)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            want = np.asarray(jb[k])
            assert tb[k].dtype == {"int32": torch.int32,
                                   "float32": torch.float32}[str(want.dtype)]
            np.testing.assert_array_equal(tb[k].numpy(), want, err_msg=k)


def test_pipeline_order_and_close():
    jcfg, cfg = configs("smollm-135m")
    dcfg = tpipe.DataConfig(BATCH, SEQ, seed=2, prefetch=2)
    pipe = tpipe.Pipeline(cfg, dcfg, start_step=3, device="cpu",
                          shard_fn=lambda b: {**b, "seen": True})
    try:
        for want in (3, 4, 5):
            step, batch = next(pipe)
            assert step == want and pipe.step == want + 1 and batch["seen"]
            ref = jpipe.synthetic_batch(jcfg, jpipe.DataConfig(BATCH, SEQ, 2),
                                        want)
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          np.asarray(ref["tokens"]))
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


# ---------------------------------------------------------------------------
# The loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", ["none", "mask", "empty_mask"])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = None
    if masked != "none":
        mask = (rng.random((3, 5)) < 0.5).astype(np.float32)
        if masked == "empty_mask":
            mask[:] = 0.0
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    t_logits = torch.from_numpy(logits).requires_grad_(True)
    got = tlayers.cross_entropy(t_logits, torch.from_numpy(labels),
                                None if mask is None else
                                torch.from_numpy(mask))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jgrad = jax.grad(lambda x: jlayers.cross_entropy(
        x, jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask)))(jnp.asarray(logits))
    (tgrad,) = torch.autograd.grad(got, t_logits)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-7)


@pytest.mark.parametrize("arch", JARCH_NAMES)
def test_train_loss_and_grads_match_jax(arch):
    jcfg, cfg = configs(arch)
    jb, tb = _batches(jcfg, cfg)
    jp = JM.init_params(KEY, jcfg)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(p, jb, jcfg), has_aux=True)(jp)
    params = convert.lm_params_from_numpy(flatten(jp), cfg, device="cpu")
    params.requires_grad_(True)
    loss, metrics = TM.train_loss(params, tb, cfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    for got, want in ((loss, jloss), (metrics["ce_loss"], jmetrics["ce_loss"]),
                      (metrics["aux_loss"], jmetrics["aux_loss"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=LOSS_TOL)
    if cfg.n_experts:
        assert float(metrics["aux_loss"].detach()) > 0
    grads = _grads(params, loss)
    jflat = flatten(jgrads)
    assert sorted(grads) == sorted(jflat)
    tol = RWKV_GRAD_TOL if cfg.ssm == "rwkv6" else GRAD_TOL
    for name, g in grads.items():
        want = jflat[name]
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("arch", JARCH_NAMES)
def test_remat_recomputes_and_matches(arch, monkeypatch):
    """``cfg.remat`` recomputes every decoder layer in the backward pass
    (zamba2: each group, its layers with it) and changes no bit."""
    _, cfg = configs(arch)
    tb = tpipe.synthetic_batch(cfg, tpipe.DataConfig(BATCH, SEQ, 1), 5,
                               device="cpu")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params.requires_grad_(True)
    calls = []
    layer = TM.decoder_layer
    monkeypatch.setattr(TM, "decoder_layer",
                        lambda *a, **k: calls.append(1) or layer(*a, **k))
    out = {}
    for remat in (False, True):
        calls.clear()
        loss, _ = TM.train_loss(params, tb,
                                dataclasses.replace(cfg, remat=remat))
        out[remat] = (loss.detach(), _grads(params, loss), len(calls))
    assert out[True][2] == 2 * out[False][2] == 2 * cfg.n_layers
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[False][1].items():
        assert torch.equal(out[True][1][name], g), name


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b", "rwkv6-7b",
                                  "deepseek-v2-236b"])
def test_pallas_refuses_gradients(arch):
    """Under ``"pallas"`` the JAX package cannot differentiate (its kernels
    have no JVP rule; its MLA path raises in the forward already) and the
    port's kernels raise: no gradient is cut off without an error.
    Without a gradient the same call runs."""
    jcfg, cfg = configs(arch, impl="pallas")
    jb, tb = _batches(jcfg, cfg)
    jp = JM.init_params(KEY, jcfg)
    with pytest.raises(Exception):
        jax.grad(lambda p: JM.train_loss(p, jb, jcfg)[0])(jp)
    params = convert.lm_params_from_numpy(flatten(jp), cfg, device="cpu")
    params.requires_grad_(True)
    launches = (tflash.flash_attention.launches, tscan.linear_scan.launches)
    with pytest.raises(TypeError, match="has no backward"):
        TM.train_loss(params, tb, cfg)
    with torch.no_grad():
        loss, _ = TM.train_loss(params, tb, cfg)
    want, _ = TM.train_loss(params, tb, dataclasses.replace(
        cfg, attention_impl="xla"))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert launches == (tflash.flash_attention.launches,
                        tscan.linear_scan.launches)


def test_kernel_wrappers_refuse_autograd():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, 16))
                                .astype(np.float32)) for _ in range(3))
    w = -torch.rand(1, 2, 8, 16)
    for grad_arg in range(3):
        args = [q.clone(), k.clone(), v.clone()]
        args[grad_arg].requires_grad_(True)
        with pytest.raises(TypeError, match="flash_attention has no backward"):
            tflash.flash_attention(*args)
        with pytest.raises(TypeError, match="linear_scan has no backward"):
            tscan.linear_scan(*args, w)
        with torch.no_grad():
            assert tflash.flash_attention(*args).grad_fn is None
            assert tscan.linear_scan(*args, w).grad_fn is None
    u = torch.zeros(2, 16, requires_grad=True)
    with pytest.raises(TypeError, match="linear_scan has no backward"):
        tscan.linear_scan(q, k, v, w, u, mode="bonus")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_adamw_matches_jax():
    """Twelve steps across the warm-up and the cosine's floor, the gradient
    norm alternating above the clip norm (clipped) and below it."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b.c": (5,), "b.d": (2, 2, 3)}

    def jtree(d):
        return {"a": jnp.asarray(d["a"]), "b": {"c": jnp.asarray(d["b.c"]),
                                                "d": jnp.asarray(d["b.d"])}}

    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=10)
    cfg = adamw.AdamWConfig(**dataclasses.asdict(jcfg))
    jp, tp = jtree(p), {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jadamw.init(jp), adamw.init(tp)
    clipped = []
    for step in range(12):
        scale = 3.0 if step % 2 == 0 else 0.05
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        jp, js, jm = jadamw.update(jp, jtree(g), js, jcfg)
        tp, ts, tm = adamw.update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, cfg)
        clipped.append(float(tm["grad_norm"]) > cfg.clip_norm)
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            jf = flatten(tree_j)
            for k in shapes:
                assert tree_t[k].dtype == torch.float32
                np.testing.assert_allclose(tree_t[k].numpy(), jf[k],
                                           rtol=ADAMW_TOL, atol=ADAMW_TOL)
    assert any(clipped) and not all(clipped)


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------


def _trainers(tmp_path, jcfg, cfg, steps=4, ckpt_every=2, seed=3,
              lr=3e-4):
    """The reference's and the port's Trainer, the port's parameters loaded
    from the reference's initial ones."""
    jt = jtrainer.Trainer(
        jcfg, jtrainer.TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                                     ckpt_dir=str(tmp_path / "jax"),
                                     log_every=1000),
        jpipe.DataConfig(BATCH, SEQ, seed),
        jadamw.AdamWConfig(lr=lr, warmup_steps=2, total_steps=steps))
    tt = ttrainer.Trainer(
        cfg, ttrainer.TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                                    ckpt_dir=str(tmp_path / "torch"),
                                    log_every=1000),
        tpipe.DataConfig(BATCH, SEQ, seed),
        adamw.AdamWConfig(lr=lr, warmup_steps=2, total_steps=steps),
        device="cpu")
    init = flatten(jt.params)
    with torch.no_grad():
        for name, p in tt.params.named_parameters():
            p.copy_(torch.from_numpy(init[name]))
    return jt, tt


def _assert_params_close(tt, jparams):
    jf = flatten(jparams)
    for name, p in tt.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jf[name],
                                   atol=TRAINER_PARAM_TOL, err_msg=name)


def test_trainer_matches_jax(tmp_path):
    jcfg, cfg = configs("smollm-135m")
    jt, tt = _trainers(tmp_path, jcfg, cfg)
    jh, th = jt.run(), tt.run()
    assert [h["step"] for h in th] == [0, 1, 2, 3]
    for a, b in zip(jh, th):
        assert set(b) == set(a)
        for key in ("loss", "ce_loss", "aux_loss", "lr"):
            np.testing.assert_allclose(b[key], a[key], rtol=LOSS_TOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"], rtol=1e-5)
    _assert_params_close(tt, jt.params)
    assert int(tt.opt_state.step) == 4
    assert ckpt.latest_step(str(tmp_path / "torch")) == 4


def test_resume_is_bit_deterministic(tmp_path):
    """As the JAX package's ``test_runtime.py``: a fresh Trainer resumes
    from the step-4 checkpoint and replays steps 4-7 with the same losses
    (the smoke config's bf16 activations)."""
    cfg = ModelConfig(**dataclasses.asdict(jsmoke_config(
        jget_config("smollm-135m"))))

    def trainer():
        return ttrainer.Trainer(
            cfg, ttrainer.TrainerConfig(steps=8, ckpt_every=4,
                                        ckpt_dir=str(tmp_path),
                                        log_every=1000),
            tpipe.DataConfig(batch_size=2, seq_len=16, seed=3), device="cpu")

    losses = {h["step"]: h["loss"] for h in trainer().run()}
    t2 = trainer()
    assert t2.try_resume() and t2.step == 8
    assert t2.try_resume(step=4) and t2.step == 4
    assert int(t2.opt_state.step) == 4
    t2.run()
    assert [h["step"] for h in t2.history] == [4, 5, 6, 7]
    for h in t2.history:
        assert abs(losses[h["step"]] - h["loss"]) < 1e-6, h["step"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A checkpoint one package's Trainer writes at step 2 restores in the
    other's, which continues steps 2-3 as the writer does."""
    jcfg, cfg = configs("smollm-135m")
    jt, tt = _trainers(tmp_path, jcfg, cfg)
    first = jt if writer == "jax" else tt
    first.run()
    src = tmp_path / writer
    shutil.rmtree(tmp_path / "other", ignore_errors=True)
    shutil.copytree(src / "step_00000002",
                    tmp_path / "other" / "step_00000002")
    jt2, tt2 = _trainers(tmp_path, jcfg, cfg)
    other = tt2 if writer == "jax" else jt2
    other.tcfg.ckpt_dir = str(tmp_path / "other")
    assert other.try_resume() and other.step == 2
    other.history = []
    other.run()
    for a, b in zip(first.history[2:], other.history):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_TOL)
    if writer == "jax":
        _assert_params_close(tt2, jt.params)
    else:
        _assert_params_close(tt, jt2.params)


def test_trainer_restarts_from_the_latest_checkpoint(tmp_path, monkeypatch):
    """A step that raises ``RuntimeError`` restores the latest checkpoint
    and replays from it; past ``max_restarts`` the error propagates."""
    _, cfg = configs("smollm-135m")
    tt = ttrainer.Trainer(
        cfg, ttrainer.TrainerConfig(steps=4, ckpt_every=2,
                                    ckpt_dir=str(tmp_path), log_every=1000,
                                    max_restarts=1),
        tpipe.DataConfig(BATCH, SEQ, 3), device="cpu")
    step = tt.train_step
    fails = {3}

    def flaky(params, opt_state, batch):
        if tt.step in fails:
            fails.discard(tt.step)
            raise RuntimeError("injected")
        return step(params, opt_state, batch)

    tt.train_step = flaky
    hist = tt.run()
    assert tt.restarts == 1
    assert [h["step"] for h in hist] == [0, 1, 2, 2, 3]
    assert hist[2]["loss"] == hist[3]["loss"]
    fails.add(4)
    with pytest.raises(RuntimeError, match="injected"):
        tt.run(5)                  # a second restart: over max_restarts


def test_mesh_rank_count_must_match_group():
    """A mesh of 8 devices with no process group (one rank) is refused
    before anything is built."""
    from repro_torch.parallel.sharding import MeshShape

    _, cfg = configs("smollm-135m")
    mesh = MeshShape(("data", "model"), (2, 4))
    with pytest.raises(ValueError, match="8 devices.*1 rank"):
        ttrainer.make_train_step(cfg, adamw.AdamWConfig(), mesh=mesh,
                                 device="cpu")
    with pytest.raises(ValueError, match="8 devices.*1 rank"):
        ttrainer.Trainer(cfg, ttrainer.TrainerConfig(), mesh=mesh,
                         device="cpu")


def test_launch_train_smoke(tmp_path, capsys):
    history = tlaunch.main(["--arch", "smollm-135m", "--smoke", "--device",
                            "cpu", "--steps", "6", "--batch-size", "2",
                            "--seq-len", "16", "--ckpt-dir",
                            str(tmp_path / "ck"), "--history-out",
                            str(tmp_path / "h.json")])
    out = capsys.readouterr().out
    assert len(history) == 6 and "loss: first-5 avg" in out
    assert (tmp_path / "h.json").exists()
    assert ckpt.latest_step(str(tmp_path / "ck")) == 6


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs("smollm-135m")
    dcfg = tpipe.DataConfig(BATCH, SEQ)
    calls = [lambda: tpipe.synthetic_batch(cfg, dcfg, 0),
             lambda: tpipe.Pipeline(cfg, dcfg),
             lambda: ttrainer.make_train_step(cfg, adamw.AdamWConfig()),
             lambda: ttrainer.Trainer(cfg, ttrainer.TrainerConfig(
                 ckpt_dir=str(tmp_path))),
             lambda: tlaunch.main(["--arch", "smollm-135m", "--smoke",
                                   "--ckpt-dir", str(tmp_path)])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
