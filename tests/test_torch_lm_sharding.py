"""The port's LM shardings against the JAX package's.

* ``launch.shapes``: the cell support matrix and every input stand-in (meta
  tensors against ``ShapeDtypeStruct``s, path for path, shape and dtype),
  decode caches of grok-1-314b at ``decode_32k`` included;
* the logical axes of every parameter of the ten archs at full width
  (``Params`` records them; meta tensors) against the reference's
  ``Param.axes``, and ``resolve_spec`` of each on the 16 x 16 and
  2 x 16 x 16 production shapes against the reference's (which reads only
  a mesh's axis names and shape, so a stand-in mesh needs no devices);
  ``cache_shardings`` of every decode cache the same way; the reference's
  own ``resolve_spec`` and ``param_shardings`` tests;
* on 8 gloo ranks (a 2 x 4 ``("data", "model")`` mesh, one spawn for the
  module) against the reference on 8 host devices in a JAX subprocess
  started at the same time (``lm_sharded_cases``): the qwen3-8b sharded
  loss within ``LOSS_TOL`` of the one-device loss (the reference's own
  bound, ``tests/test_multidevice.py``), every gradient leaf within
  ``GRAD_TOL`` x max|g| and one full step (AdamW's default schedule)
  within ``PARAM_TOL`` x max|p| of the one-device ones; the gradients of
  heads that miss the model axis (the sequence split), RWKV6, zamba2's
  Mamba2 and MLA likewise, and their sharded prefill and decode step
  (caches laid out by ``cache_shardings``) within ``SERVE_TOL``; grok-1-314b with
  ``moe_local_dispatch``: the loss within ``LOSS_TOL`` and
  ``dropped_frac`` equal to the reference's sharded run; ``Trainer(mesh=)``
  against ``Trainer()`` for 3 steps (losses within ``TRAINER_TOL``
  relative); ``resume_on_mesh`` of a checkpoint written unsharded by either
  package (every leaf equal, placements ``param_shardings``').
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_sharded_cases as lc
from repro.ckpt import checkpoint as jckpt
from repro.configs import ARCH_NAMES as JARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.launch import shapes as jshapes
from repro.models import model as JM
from repro.models.layers import is_param
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jshard
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import shapes
from repro_torch.models import model as M
from repro_torch.models.layers import param_axes
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as S
from repro_torch.parallel.spawn import run_ranks
from repro_torch.runtime import trainer as T
from test_torch_serve import flatten
from torch_threads import share_cores

share_cores()

LOSS_TOL = 1e-4
PARAM_TOL = 1e-5
GRAD_TOL = 1e-5
# RWKV6's chunked scan turns float32 rounding of its inputs into up to
# 1.3e-5 x max|g| (test_torch_lm_training.py's RWKV_GRAD_TOL, the same
# bound there); sharded against one device measured 9.9e-6.
RWKV_GRAD_TOL = 5e-5
SERVE_TOL = 1e-5             # logits and caches, absolute (measured ≤ 3.2e-6)
TRAINER_TOL = 1e-5
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def port_mesh(name):
    return S.MeshShape(*MESHES[name])


def jax_mesh(name):
    """A stand-in for the reference: its ``resolve_spec`` and
    ``cache_shardings`` read ``axis_names`` and ``devices.shape`` only."""
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def structs(tree, prefix=""):
    """``{dotted path: (shape, dtype name)}`` of a tree of arrays, tensors
    or ``ShapeDtypeStruct``s (dicts, NamedTuples, tuples)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: (tuple(tree.shape),
                              str(tree.dtype).removeprefix("torch."))}
    out = {}
    for k, v in items:
        out.update(structs(v, f"{prefix}{k}."))
    return out


def jax_params(arch):
    """The reference's full-width parameter tree, abstract."""
    return jax.eval_shape(lambda: JM.init_params(jax.random.key(0),
                                                 jget_config(arch)))


def jax_axes(tree, prefix=""):
    """``{dotted path: Param}`` of a reference parameter tree."""
    if is_param(tree):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(jax_axes(v, f"{prefix}{k}."))
    return out


# ---------------------------------------------------------------------------
# launch.shapes
# ---------------------------------------------------------------------------


def test_cell_support_matrix():
    expected_skips = {(a, "long_500k") for a in (
        "llava-next-mistral-7b", "smollm-135m", "phi3-medium-14b",
        "gemma-7b", "qwen3-8b", "deepseek-v2-236b", "grok-1-314b",
        "whisper-medium")}
    skips = set()
    for arch in ARCH_NAMES:
        for shape in shapes.SHAPES:
            ok, reason = shapes.cell_supported(get_config(arch), shape)
            assert (ok, reason) == jshapes.cell_supported(jget_config(arch),
                                                          shape)
            if not ok:
                skips.add((arch, shape))
                assert reason
    assert skips == expected_skips
    assert shapes.SHAPES == jshapes.SHAPES
    assert shapes.SHAPE_NAMES == jshapes.SHAPE_NAMES


@pytest.mark.parametrize("arch", JARCH_NAMES)
@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_input_specs_are_abstract(arch, shape):
    cfg = get_config(arch)
    ok, _ = shapes.cell_supported(cfg, shape)
    if not ok:
        assert not jshapes.cell_supported(jget_config(arch), shape)[0]
        return
    spec = shapes.input_specs(cfg, shape)
    want = jshapes.input_specs(jget_config(arch), shape)
    assert spec["kind"] == want["kind"]
    tensors = []
    S.map_tree(lambda t: tensors.append(t) or t,
               {k: v for k, v in spec.items() if k != "kind"})
    assert tensors and all(t.is_meta for t in tensors)
    got = structs({k: v for k, v in spec.items() if k != "kind"})
    ref = structs({k: v for k, v in want.items() if k != "kind"})
    assert got == ref
    if shape == "train_4k":
        b = shapes.SHAPES[shape]["global_batch"]
        assert all(t.shape[0] == b for t in spec["batch"].values())
    elif spec["kind"] == "decode":
        assert tuple(spec["tokens"].shape) == (
            shapes.SHAPES[shape]["global_batch"],)
        assert spec["caches"] is not None


# ---------------------------------------------------------------------------
# Logical axes, resolve_spec, cache_shardings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", JARCH_NAMES)
def test_param_axes_and_specs_match_jax(arch):
    params = M.init_params(None, get_config(arch), device="meta")
    axes = param_axes(params)
    ref = jax_axes(jax_params(arch))
    assert sorted(axes) == sorted(ref)
    shapes_ = {n: tuple(p.shape) for n, p in params.named_parameters()}
    for name, p in ref.items():
        assert axes[name] == p.axes, name
        assert shapes_[name] == tuple(p.value.shape), name
    for mesh in MESHES:
        got = S.param_shardings(params, port_mesh(mesh))
        for name, p in ref.items():
            want = jshard.resolve_spec(p.axes, p.value.shape, jax_mesh(mesh))
            assert tuple(got[name].spec) == tuple(want), (mesh, name)
            assert len(got[name].placements) == len(MESHES[mesh][0])


def specs_of(tree, leaf_type, prefix=""):
    """``{dotted path: spec tuple}`` of a tree of shardings (the port's
    ``NamedSharding``s or the reference's bare ``PartitionSpec``s)."""
    if isinstance(tree, leaf_type):
        return {prefix[:-1]: tuple(getattr(tree, "spec", tree))}
    items = (tree.items() if isinstance(tree, dict) else
             zip(tree._fields, tree) if hasattr(tree, "_fields")
             else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(specs_of(v, leaf_type, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_shardings_match_jax(shape, monkeypatch):
    # The reference wraps each spec in a NamedSharding, which wants a real
    # mesh: keep the spec alone.
    monkeypatch.setattr(jshard, "NamedSharding", lambda mesh, spec: spec)
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        if not shapes.cell_supported(cfg, shape)[0]:
            continue
        caches = shapes.input_specs(cfg, shape)["caches"]
        jcaches = jshapes.input_specs(jget_config(arch), shape)["caches"]
        for mesh in MESHES:
            got = specs_of(S.cache_shardings(cfg, port_mesh(mesh), caches),
                           S.NamedSharding)
            want = specs_of(jshard.cache_shardings(
                jget_config(arch), jax_mesh(mesh), jcaches),
                jax.sharding.PartitionSpec)
            assert got == want and sorted(got) == sorted(structs(caches)), \
                (arch, mesh)
            for spec in got.values():
                S.to_placements(S.P(*spec), port_mesh(mesh))


def test_resolve_spec_divisibility_fallback():
    mesh = S.MeshShape(("model",), (1,))
    # dim divisible by 1 → sharded on model
    spec = S.resolve_spec(("vocab", "embed"), (100, 64), mesh)
    assert spec[0] == "model"
    mesh = S.MeshShape(("data", "model"), (2, 16))
    # whisper's odd vocab stays replicated, its embed dim takes data
    assert tuple(S.resolve_spec(("vocab", "embed"), (51865, 1024),
                                mesh)) == (None, "data")


def test_resolve_spec_conflict_first_wins():
    mesh = S.MeshShape(("model",), (1,))
    # experts and ff both want 'model'; experts (first) wins
    spec = S.resolve_spec(("experts", "embed", "ff"), (8, 64, 128), mesh)
    assert spec[0] == "model" and spec[2] is None


def test_param_shardings_cover_tree():
    cfg = smoke_config(get_config("qwen3-8b"))
    params = M.init_params(None, cfg, device="meta")
    shardings = S.param_shardings(params, S.MeshShape(("model",), (1,)))
    assert sorted(shardings) == sorted(n for n, _ in
                                       params.named_parameters())


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = port_mesh("2x16x16")
    assert S.to_placements(S.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert S.to_placements(S.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        S.to_placements(S.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="used twice"):
        S.to_placements(S.P("model", "model"), mesh)
    with pytest.raises(ValueError, match="not in"):
        S.to_placements(S.P("chip"), mesh)


def test_constrain_spec_matches_jax(monkeypatch):
    """The constraint patterns' specs, for shapes that take and miss the
    model axis (the sequence fallback), against the reference's."""
    captured = {}
    monkeypatch.setattr(jshard, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: captured.setdefault("spec", spec))
    cases = [((8, 16, 4096, 128), "bhsk"), ((8, 9, 4096, 64), "bhsk"),
             ((8, 9, 4096, 4096), "bhss"), ((8, 4096, 1024), "bsh"),
             ((8, 4096, 49152), "bsv"), ((32, 1024, 4096), "ecd"),
             ((16, 2048, 4096), "b.d"), ((7, 4096, 576), "bsd"),
             ((8, 32000), "bv")]
    for mesh in MESHES:
        for shape, pat in cases:
            captured.clear()
            jshard._ACT_CTX.append(jax_mesh(mesh))
            try:
                jshard.constrain(types.SimpleNamespace(shape=shape,
                                                       ndim=len(shape)), pat)
            finally:
                jshard._ACT_CTX.pop()
            got = S.constrain_spec(shape, pat, port_mesh(mesh))
            assert tuple(got) == tuple(captured["spec"]), (mesh, shape, pat)


def test_constrain_and_on_replicas_outside_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert S.constrain(x, "bd") is x
    with S.activation_shardings(S.MeshShape(("data", "model"), (1, 1))):
        assert S.constrain(x, "bd") is x          # a plain tensor
        assert S.data_shard_count() == 1
    assert S.data_shard_count() == 1
    assert S.on_replicas(lambda a, b: a + b, x, 1.0).equal(x + 1.0)


# ---------------------------------------------------------------------------
# On 8 ranks, against the reference's sharded run
# ---------------------------------------------------------------------------


def _jax_cfg(arch, **kw):
    return dataclasses.replace(jsmoke_config(jget_config(arch)),
                               dtype="float32", **kw)


def _write_checkpoints(tmp_path) -> dict:
    """An unsharded step-3 checkpoint of smollm-135m (smoke) from each
    package, moments non-zero."""
    jcfg = _jax_cfg("smollm-135m")
    params = JM.init_params(jax.random.key(9), jcfg)
    jstate = {"params": params, "opt": jadamw.AdamWState(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree.map(lambda x: x * 2.0, params),
        v=jax.tree.map(lambda x: x * x, params))}
    jckpt.save(str(tmp_path / "jax"), 3, jstate)

    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tparams = M.init_params(torch.Generator().manual_seed(4), cfg, "cpu")
    named = {n: p.detach() for n, p in tparams.named_parameters()}
    ckpt.save(str(tmp_path / "torch"), 3, {
        "params": T.nested(named),
        "opt": adamw.AdamWState(
            step=torch.tensor(3, dtype=torch.int32),
            m=T.nested({n: p * 0.5 for n, p in named.items()}),
            v=T.nested({n: p * p for n, p in named.items()}))})
    return {"torch": str(tmp_path / "torch"), "jax": str(tmp_path / "jax")}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_sharded")
    inp = lc.make_inputs(0)
    ckpts = _write_checkpoints(tmp)
    qwen = flatten(JM.init_params(jax.random.key(lc.KEY),
                                  _jax_cfg("qwen3-8b")))
    grok = flatten(JM.init_params(jax.random.key(lc.KEY),
                                  _jax_cfg("grok-1-314b", **lc.GROK)))
    with lc.jax_oracle(inp) as oracle:
        ranks = run_ranks(lc.port_rank, lc.N_RANKS, inp, qwen, grok,
                          str(tmp), ckpts, timeout_s=600)
        ref = oracle()
    return ranks, ref


def test_sharded_loss_matches_single_device(sharded):
    step = sharded[0][0]["step"]
    assert abs(step["sharded_loss"] - step["base_loss"]) < LOSS_TOL
    assert abs(step["step_loss"][1] - step["step_loss"][0]) < LOSS_TOL
    assert step["placements_ok"] and step["moments_ok"]


def test_sharded_step_matches_single_device(sharded):
    step = sharded[0][0]["step"]
    worst = max(step["grad_errs"], key=step["grad_errs"].get)
    assert step["grad_errs"][worst] <= GRAD_TOL, worst
    assert step["moved"]
    assert np.isclose(*step["grad_norm"], rtol=1e-5)
    worst = max(step["param_errs"], key=step["param_errs"].get)
    assert step["param_errs"][worst] <= PARAM_TOL, worst


@pytest.mark.parametrize("case", list(lc.GRAD_CASES))
def test_sharded_gradients_match_single_device(sharded, case):
    r = sharded[0][0]["grads"][case]
    assert abs(r["loss"][1] - r["loss"][0]) < LOSS_TOL
    worst = max(r["grad_errs"], key=r["grad_errs"].get)
    tol = RWKV_GRAD_TOL if case.startswith("rwkv6") else GRAD_TOL
    assert r["grad_errs"][worst] <= tol, worst


@pytest.mark.parametrize("case", list(lc.GRAD_CASES))
def test_sharded_prefill_and_decode_match_single_device(sharded, case):
    r = sharded[0][0]["serve"][case]
    assert max(r.values()) <= SERVE_TOL, r


def test_moe_local_dispatch_matches_reference_sharded_run(sharded):
    moe, ref = sharded[0][0]["moe"], sharded[1]
    assert moe["dropped"] == ref["dropped"]
    # Frames per data shard drop other events than one frame for all.
    assert moe["dropped"] != moe["dropped_one"]
    assert abs(moe["loss"] - ref["loss"]) < LOSS_TOL
    np.testing.assert_allclose(moe["y"], ref["y"], rtol=1e-5, atol=1e-5)


def test_sharded_trainer_matches_single_device(sharded):
    tr = sharded[0][0]["trainer"]
    assert len(tr["sharded"]) == lc.TRAIN_STEPS
    np.testing.assert_allclose(tr["sharded"], tr["plain"], rtol=TRAINER_TOL)
    # The sharded Trainer's checkpoint restores on one device, equal.
    assert tr["resumed_step"] == lc.TRAIN_STEPS and tr["resumed_equal"]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_resume_on_mesh(sharded, writer):
    from torch.distributed.tensor import Replicate

    for rank in sharded[0]:
        r = rank["resume"][writer]
        assert r["step"] == 3 and r["opt_step"] == 3
        assert r["step_placements"] == (Replicate(), Replicate())
        assert r["equal"] and r["placements_ok"]
        assert r["sharded"] > 0 and r["n_leaves"] > 0
