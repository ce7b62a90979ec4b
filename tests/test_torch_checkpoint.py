"""Durable long-run streams in the port: the crash-consistent checkpoint
format (``repro_torch.ckpt.checkpoint``, the reference's format v2 on disk)
and the preemption-survival harness (``repro_torch.runtime.elastic``),
mirroring ``tests/test_checkpoint.py``, plus the checks across packages:

* the leaf names of any tree of dicts, NamedTuples, lists and tuples are
  JAX's (``_flatten_with_names`` of both packages on the same tree);
* a checkpoint written by either package restores in the other, and the
  manifests are equal entry for entry (name, shape, dtype, bytes, sha256);
  a JAX typed key survives a reference → port → reference round trip;
  a port checkpoint holding a ``torch.Generator`` restores only in the
  port (the reference refuses the impl name);
* ``stream_fingerprint`` and ``FabricPlan.describe`` agree on the
  catalogue;
* a JAX-written mid-run checkpoint resumed by the port's
  ``resume_supervised_stream`` gives the reference's uninterrupted tail.

Across packages the networks are ``test_torch_plasticity.stream_case``'s
(dyadic weights and drives, parameters carried by ``convert``) and the
runs are held by ``parity.compare_streams``: integer outputs and spikes
equal up to near-threshold flips (reported), the final float neuron state
within ``parity.STATE_ATOL`` (XLA's fused multiply-adds); where no spike
flips, the plasticity traces and weights must be equal bit for bit.
Within the port every resumed or supervised run equals one long run bit
for bit.
"""

import os
import shutil
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.runtime import elastic as jel
from repro.snn import network as jnet
from repro.snn import plasticity as jplas
from repro.snn import stream as jstream
from repro_torch import convert, parity
from repro_torch.analysis import scenarios as tsc
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import fabric as fablib
from repro_torch.core.aggregator import identity_router
from repro_torch.runtime import elastic
from repro_torch.snn import network as netlib
from repro_torch.snn import stream as stlib
from repro_torch.snn.plasticity import STDPConfig
from test_torch_plasticity import stream_case, stream_inputs
from test_torch_stream import BATCH as XBATCH
from test_torch_stream import flatten
from torch_threads import share_cores

share_cores()

CPU = "cpu"


@pytest.fixture(autouse=True)
def _disarm_crash_points():
    yield
    ckpt.set_crash_point(None)
    jck.set_crash_point(None)


def _tree(scale=1.0):
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) * scale,
            "opt": {"step": torch.tensor(3, dtype=torch.int32),
                    "m": torch.ones((3, 4), dtype=torch.float32) * scale}}


def _leaves(tree):
    return [x for _, x in ckpt._flatten_paths(tree)]


def T(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Format v2: manifest, checksums, per-leaf validation
# ---------------------------------------------------------------------------


def test_manifest_roundtrip_with_checksums(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree(), metadata={"note": "x"})
    out, manifest = ckpt.restore(d, _tree(0.0), step=1, device=CPU)
    assert manifest["format_version"] == ckpt.FORMAT_VERSION == 2
    assert manifest["step"] == 1 and manifest["metadata"]["note"] == "x"
    for entry in manifest["leaves"]:
        assert set(entry) >= {"name", "shape", "dtype", "sha256", "bytes"}
    for a, b in zip(_leaves(out), _leaves(_tree()), strict=True):
        assert isinstance(a, torch.Tensor) and torch.equal(a, b)
    assert out["opt"]["step"].dtype == torch.int32
    assert out["opt"]["step"].shape == ()


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    ckpt.save(str(tmp_path), 1, _tree())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore(str(tmp_path), _tree(), step=1)


def test_restore_validates_dtype_per_leaf(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    bad = _tree()
    bad["opt"]["step"] = torch.tensor(0.0)       # i32 slot declared as f32
    with pytest.raises(ckpt.CheckpointError) as e:
        ckpt.restore(d, bad, step=1, device=CPU)
    assert "dtype" in str(e.value) and "step" in str(e.value)


def test_restore_validates_shape_per_leaf(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    bad = _tree()
    bad["w"] = torch.zeros((4, 3))
    with pytest.raises(ckpt.CheckpointError) as e:
        ckpt.restore(d, bad, step=1, device=CPU)
    assert "shape" in str(e.value) and "'w'" in str(e.value)


def test_restore_rejects_structure_mismatch(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    with pytest.raises(ckpt.CheckpointError) as e:
        ckpt.restore(d, {"w": _tree()["w"]}, step=1, device=CPU)
    assert "unexpected leaves" in str(e.value)


def test_checksum_detects_bit_flip(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    path = os.path.join(d, "step_00000001", "w.npy")
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF                              # same size, different bits
    open(path, "wb").write(bytes(raw))
    problems = ckpt.verify(d)[1]
    assert problems and "sha256" in problems[0]
    with pytest.raises(ckpt.CheckpointError, match="checksum"):
        ckpt.restore(d, _tree(), step=1, device=CPU)


def test_quarantine_moves_corrupt_aside(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    ckpt.save(d, 2, _tree(2.0))
    os.remove(os.path.join(d, "step_00000002", "w.npy"))
    assert ckpt.latest_step(d, quarantine=True) == 1
    names = os.listdir(d)
    assert "step_00000002.corrupt" in names
    assert 2 not in ckpt.verify(d)               # never scanned again
    record = open(os.path.join(d, "step_00000002.corrupt",
                               "QUARANTINE.json")).read()
    assert "file missing" in record
    # A second corrupt copy of the same step gets the next suffix.
    ckpt.save(d, 2, _tree(2.0))
    os.remove(os.path.join(d, "step_00000002", "w.npy"))
    assert ckpt.latest_step(d, quarantine=True) == 1
    assert "step_00000002.corrupt.1" in os.listdir(d)


def test_latest_step_skips_partial_tmp_and_bounds(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    ckpt.save(d, 4, _tree())
    os.makedirs(os.path.join(d, "step_00000007.tmp"))   # crashed writer
    os.makedirs(os.path.join(d, "step_00000009"))       # no manifest at all
    assert ckpt.latest_step(d) == 4
    assert ckpt.latest_step(d, max_step=3) == 1
    assert ckpt.latest_step(d, max_step=0) is None
    assert ckpt.latest_step(d, verified=False) == 9     # name-only mode
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


def test_old_stands_in_between_the_two_renames(tmp_path):
    """A crash between an overwrite's two renames leaves only
    ``step_<N>.old``: the reader takes it as that step."""
    d = str(tmp_path)
    ckpt.save(d, 5, _tree(5.0))
    os.rename(os.path.join(d, "step_00000005"),
              os.path.join(d, "step_00000005.old"))
    assert ckpt.latest_step(d) == 5
    out, _ = ckpt.restore(d, _tree(), device=CPU)
    assert float(out["w"][0, 1]) == 5.0
    ckpt.save(d, 5, _tree(6.0))                  # the final wins again
    out, _ = ckpt.restore(d, _tree(), step=5, device=CPU)
    assert float(out["w"][0, 1]) == 6.0


def test_transient_write_errors_are_retried(tmp_path, monkeypatch):
    d = str(tmp_path)
    real_save, calls = np.save, []

    def flaky(path, arr):
        calls.append(path)
        if len(calls) == 1:
            raise OSError("transient")
        real_save(path, arr)

    monkeypatch.setattr(ckpt.np, "save", flaky)
    ckpt.save(d, 1, _tree(), backoff_s=0.001)
    assert ckpt.latest_step(d) == 1 and len(calls) == 4

    def broken(path, arr):
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt.np, "save", broken)
    with pytest.raises(ckpt.CheckpointError, match="after 2 attempts"):
        ckpt.save(d, 2, _tree(), attempts=2, backoff_s=0.001)
    assert ckpt.latest_step(d) == 1


def test_crash_point_names_and_environment(tmp_path):
    with pytest.raises(ValueError, match="unknown crash point"):
        ckpt.set_crash_point("nowhere")
    assert ckpt.CRASH_POINTS == jck.CRASH_POINTS
    env = dict(os.environ, REPRO_CKPT_CRASH="pre_rename",
               PYTHONPATH=os.pathsep.join(sys.path))
    code = ("import sys\n"
            "from repro_torch.ckpt import checkpoint as c\n"
            "import torch\n"
            "try:\n"
            f"    c.save({str(tmp_path)!r}, 3, {{'x': torch.ones(2)}})\n"
            "except c.CrashInjected as e:\n"
            "    print('crashed at', e)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert "crashed at pre_rename" in out.stdout, out.stderr
    assert ckpt.latest_step(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# Crash injection: a kill at every protocol point leaves a resumable dir
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", ["mid_leaf_write", "pre_rename"])
def test_crash_before_rename_preserves_previous(tmp_path, point):
    d = str(tmp_path)
    ckpt.save(d, 1, _tree())
    ckpt.set_crash_point(point)
    with pytest.raises(ckpt.CrashInjected):
        ckpt.save(d, 2, _tree(2.0))
    assert ckpt.latest_step(d) == 1              # torn write never counts
    out, _ = ckpt.restore(d, _tree(), device=CPU)
    assert float(out["w"][0, 1]) == 1.0
    ckpt.save(d, 2, _tree(2.0))                  # retry after "restart"
    assert ckpt.latest_step(d) == 2
    assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_crash_post_rename_checkpoint_is_complete(tmp_path):
    d = str(tmp_path)
    ckpt.set_crash_point("post_rename")
    with pytest.raises(ckpt.CrashInjected):
        ckpt.save(d, 1, _tree())
    assert ckpt.latest_step(d) == 1
    assert not ckpt.verify(d)[1]


def test_crash_while_overwriting_same_step(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, _tree())
    ckpt.set_crash_point("pre_rename")
    with pytest.raises(ckpt.CrashInjected):
        ckpt.save(d, 3, _tree(9.0))
    assert ckpt.latest_step(d) == 3
    out, _ = ckpt.restore(d, _tree(), step=3, device=CPU)
    assert float(out["w"][0, 1]) == 1.0
    ckpt.save(d, 3, _tree(9.0))                  # the overwrite completes
    out, _ = ckpt.restore(d, _tree(), step=3, device=CPU)
    assert float(out["w"][0, 1]) == 9.0
    assert sorted(os.listdir(d)) == ["step_00000003"]


def test_crash_mid_prune_keeps_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        ckpt.save(d, s, _tree(float(s)))
    ckpt.set_crash_point("mid_prune")
    with pytest.raises(ckpt.CrashInjected):
        ckpt.prune(d, keep=1)
    assert ckpt.latest_step(d) == 3
    out, _ = ckpt.restore(d, _tree(), device=CPU)
    assert float(out["w"][0, 1]) == 3.0


def test_prune_keeps_only_verified_and_clamps(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        ckpt.save(d, s, _tree(float(s)))
    path = os.path.join(d, "step_00000003", "w.npy")
    with open(path, "r+b") as f:
        f.truncate(10)
    removed = ckpt.prune(d, keep=0)              # clamps to keep >= 1
    assert ckpt.latest_step(d) == 2              # newest *verified* survives
    assert 3 in removed and 1 in removed


# ---------------------------------------------------------------------------
# Across packages: leaf names, files, typed keys, fingerprints
# ---------------------------------------------------------------------------


class Pair(NamedTuple):
    left: object
    right: object


@pytest.mark.parametrize("case", range(6))
def test_leaf_names_match_jax(case):
    a = np.arange(3, dtype=np.float32)
    tree = [
        {"zeta": a, "alpha": {"b": a, "a": a}, "mid": [a, (a, a)]},
        {"chips": Pair(Pair(a, None), a), "inflight": a, "rng": None},
        a,                                       # a bare leaf
        {"a_b": a, "a": {"b": a}, "a/b": a},     # collisions and "/"
        Pair(left=[None, a, {}], right=(Pair(a, a),)),
        {3: a, 10: a, 2: {"x": [a], "10": a, "9": a}},
    ][case]
    names_t, leaves_t = ckpt._flatten_with_names(tree)
    names_j, leaves_j, _ = jck._flatten_with_names(tree)
    assert names_t == names_j
    assert all(x is y for x, y in zip(leaves_t, leaves_j, strict=True))
    rebuilt = ckpt._unflatten(tree, iter(leaves_t))
    assert jax.tree.structure(rebuilt) == jax.tree.structure(tree)


def _manifest_leaves(directory, step, package):
    return package.read_manifest(directory, step)["leaves"]


def test_plain_tree_files_equal_and_cross_restore(tmp_path):
    jt = {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
          "opt": {"step": jnp.int32(3), "m": jnp.ones((3, 4), jnp.float32),
                  "mask": jnp.array([True, False])}}
    tt = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
          "opt": {"step": torch.tensor(3, dtype=torch.int32),
                  "m": torch.ones((3, 4)),
                  "mask": torch.tensor([True, False])}}
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jck.save(dj, 7, jt, metadata={"k": 1})
    ckpt.save(dt, 7, tt, metadata={"k": 1})
    assert (jck.read_manifest(dj, 7) == ckpt.read_manifest(dt, 7))
    got, _ = ckpt.restore(dj, tt, step=7, device=CPU)
    for a, b in zip(_leaves(got), _leaves(tt), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back, _ = jck.restore(dt, jt, step=7)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        assert a.dtype == b.dtype and jnp.array_equal(a, b)


@pytest.fixture(scope="module")
def xnet():
    """FULL_BACKPLANE at SMALL_CHIP with dyadic weights in both packages,
    and 8 steps of dyadic drives."""
    cfg_j, params_j, plan_j, cfg_t, params_t, plan_t = stream_case(
        "FULL_BACKPLANE")
    drives, _ = stream_inputs(cfg_j, 8, 77)
    state_j = jnet.init_state(cfg_j, XBATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device=CPU)
    return (cfg_j, params_j, plan_j, state_j, cfg_t, params_t, plan_t,
            state_t, drives)


XSTDP = (jplas.STDPConfig(lr_pot=0.3, lr_dep=0.2),
         STDPConfig(lr_pot=0.3, lr_dep=0.2))


@pytest.mark.parametrize("per_slot", [False, True])
def test_stream_checkpoint_crosses_packages(tmp_path, xnet, per_slot):
    """A plastic stream checkpoint with a typed key: the reference writes,
    the port restores (leaves equal, key data as ``KeyData``) and writes
    again with equal manifests and files; the reference restores the
    port's and gets its typed key back."""
    cfg_j, params_j, plan_j, state_j, cfg_t, params_t, plan_t, state_t, \
        drives = xnet
    init_j = jnet.init_slot_plasticity if per_slot \
        else jnet.init_stream_plasticity
    init_t = netlib.init_slot_plasticity if per_slot \
        else netlib.init_stream_plasticity
    out = jstream.run_stream(params_j, state_j, jnp.asarray(drives[:3]),
                             cfg_j, fabric=plan_j, plasticity=XSTDP[0],
                             plasticity_state=init_j(params_j, XBATCH))
    key = jax.random.key(11)
    fp_j = jel.stream_fingerprint(cfg_j, fabric=plan_j, plasticity=XSTDP[0])
    fp_t = elastic.stream_fingerprint(cfg_t, fabric=plan_t,
                                      plasticity=XSTDP[1])
    assert fp_j == fp_t
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    jel.save_stream_state(dj, 3, out.state, plasticity=out.plasticity,
                          rng=key, fingerprint=fp_j)
    ck = elastic.restore_stream_checkpoint(
        dj, state_t, plasticity_like=init_t(params_t, XBATCH),
        expect_fingerprint=fp_t, device=CPU)
    assert ck.step == 3 and isinstance(ck.rng, elastic.KeyData)
    assert ck.rng.impl == "threefry2x32"
    assert ck.rng.data.dtype == torch.uint32
    parity.assert_equal("key data", jax.random.key_data(key), ck.rng.data)
    assert type(ck.plasticity).__name__ == type(out.plasticity).__name__
    for name, a, b in zip(("v", "i_syn", "w_adapt", "refrac"),
                          out.state.chips.neurons, ck.state.chips.neurons):
        parity.assert_equal(name, a, b)
    parity.assert_equal("inflight", out.state.inflight, ck.state.inflight)
    for a, b in zip(out.plasticity, ck.plasticity, strict=True):
        parity.assert_equal("plasticity", a, b)
    elastic.save_stream_state(dt, 3, ck.state, plasticity=ck.plasticity,
                              rng=ck.rng, fingerprint=fp_t)
    assert jck.read_manifest(dj, 3) == ckpt.read_manifest(dt, 3)
    back = jel.restore_stream_checkpoint(
        dt, state_j, plasticity_like=init_j(params_j, XBATCH),
        expect_fingerprint=fp_j)
    assert jnp.issubdtype(back.rng.dtype, jax.dtypes.prng_key)
    assert str(jax.random.key_impl(back.rng)) == "threefry2x32"
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(back.rng)),
                                  np.asarray(jax.random.key_data(key)))
    for a, b in zip(jax.tree.leaves(back.plasticity),
                    jax.tree.leaves(out.plasticity)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_generator_rng_is_port_only(tmp_path, xnet):
    """A ``torch.Generator`` rides as its state bytes and restores as a
    Generator drawing the same numbers; the reference refuses the impl."""
    *_, state_t, _ = xnet
    state_j = xnet[3]
    gen = torch.Generator().manual_seed(1234)
    torch.rand(5, generator=gen)                 # move off the seed
    d = str(tmp_path)
    elastic.save_stream_state(d, 0, state_t, rng=gen)
    meta = ckpt.read_manifest(d, 0)["metadata"]
    assert meta["rng_impl"] == "torch.Generator:cpu"
    ck = elastic.restore_stream_checkpoint(d, state_t, device=CPU)
    assert isinstance(ck.rng, torch.Generator)
    assert torch.equal(torch.rand(8, generator=ck.rng),
                       torch.rand(8, generator=gen))
    with pytest.raises(ValueError, match="unrecognized PRNG"):
        jel.restore_stream_checkpoint(d, state_j)


def test_raw_key_data_round_trips(tmp_path, xnet):
    state_t = xnet[7]
    raw = torch.tensor([7, 2 ** 32 - 1], dtype=torch.uint32)
    d = str(tmp_path)
    elastic.save_stream_state(d, 0, state_t, rng=raw)
    assert ckpt.read_manifest(d, 0)["metadata"]["rng_impl"] is None
    ck = elastic.restore_stream_checkpoint(d, state_t, device=CPU)
    assert ck.rng.dtype == torch.uint32 and torch.equal(ck.rng, raw)


@pytest.mark.parametrize("plastic", [False, True])
def test_fingerprint_and_describe_match_on_the_catalogue(plastic):
    from repro.analysis import scenarios as jsc

    pj, pt = XSTDP if plastic else (None, None)
    for (name, plan_j, _), (name_t, plan_t, _) in zip(
            jsc.benchmark_plans(), tsc.benchmark_plans(), strict=True):
        assert name == name_t
        assert plan_t.describe() == plan_j.describe(), name
    for name, *_ in jsc.CASES:
        cfg_j, _, plan_j = jsc.engine_network(name)
        cfg_t, _, plan_t = tsc.engine_network(name, device=CPU)
        assert (elastic.stream_fingerprint(cfg_t, fabric=plan_t,
                                           plasticity=pt)
                == jel.stream_fingerprint(cfg_j, fabric=plan_j,
                                          plasticity=pj)), name
    # Different configurations hash apart; a tensor in a spec hashes as
    # its values, wherever it lies.
    cfg_t, _, plan_t = tsc.engine_network("FULL_BACKPLANE", device=CPU)
    other = netlib.NetworkConfig(n_chips=12, capacity=128)
    assert (elastic.stream_fingerprint(other, fabric=plan_t)
            != elastic.stream_fingerprint(cfg_t, fabric=plan_t))
    assert (elastic._canon(torch.tensor([[True, False]]))
            == jel._canon(np.array([[True, False]])))


# ---------------------------------------------------------------------------
# Stream-level preemption survival in the port: kill → resume is bit-exact
# ---------------------------------------------------------------------------


N_CHIPS, BATCH, STEPS, WINDOW = 4, 1, 8, 2


@pytest.fixture(scope="module")
def net():
    cfg = netlib.NetworkConfig(n_chips=N_CHIPS, capacity=256)
    params = netlib.init_feedforward(cfg, seed=7, device=CPU)._replace(
        router=identity_router(N_CHIPS, device=CPU))
    state = netlib.init_state(cfg, BATCH, device=CPU)
    rng = np.random.default_rng(3)
    drives = T((rng.random((STEPS, N_CHIPS, BATCH, cfg.chip.n_rows)) < 0.3)
               .astype(np.float32))
    plan = fablib.compile_fabric(fablib.star_spec(N_CHIPS, cfg.capacity))
    pcfg = STDPConfig(lr_pot=0.3, lr_dep=0.2)
    ref = stlib.run_stream(params, state, drives, cfg, fabric=plan,
                           plasticity=pcfg, device=CPU)
    assert float(ref.spikes.sum()) > 0
    return cfg, params, state, drives, plan, pcfg, ref


def assert_trees_equal(what, a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        parity.assert_equal(what, x, y)


def assert_tail(what, out, ref, s):
    for f in elastic._DATA_FIELDS:
        parity.assert_equal(f"{what} {f}", getattr(ref, f)[s:],
                            getattr(out, f))
    assert_trees_equal(f"{what} state", out.state, ref.state)
    assert_trees_equal(f"{what} plasticity", out.plasticity, ref.plasticity)


@pytest.mark.parametrize("point", ckpt.CRASH_POINTS)
def test_kill_resume_bit_exact(tmp_path, net, point):
    """The process dies at ``point`` while checkpointing (or pruning) after
    3 windows; a fresh process resumes from the newest valid checkpoint and
    the tail is bit-exact with the uninterrupted plastic run."""
    cfg, params, state0, drives, plan, pcfg, ref = net
    d = str(tmp_path)
    out_pre, recs = elastic.run_supervised_stream(
        params, state0, drives[:6], cfg, fabric=plan, window=WINDOW,
        ckpt_dir=d, plasticity=pcfg, async_checkpoint=False, device=CPU)
    assert recs == [] and ckpt.latest_step(d) == 4
    fp = elastic.stream_fingerprint(cfg, fabric=plan, plasticity=pcfg)
    ckpt.set_crash_point(point)
    with pytest.raises(ckpt.CrashInjected):
        if point == "mid_prune":
            ckpt.prune(d, keep=1)
        else:
            elastic.save_stream_state(d, 6, out_pre.state,
                                      plasticity=out_pre.plasticity,
                                      fingerprint=fp)
    expect_step = {"mid_leaf_write": 4, "pre_rename": 4,
                   "post_rename": 6, "mid_prune": 4}[point]
    out, info = elastic.resume_supervised_stream(
        params, state0, drives, cfg, fabric=plan, window=WINDOW,
        ckpt_dir=d, plasticity=pcfg, async_checkpoint=False, device=CPU)
    s = info["resumed_step"]
    assert s == expect_step
    assert_tail(point, out, ref, s)


def test_kill_resume_with_fault_schedule(tmp_path, net):
    cfg, params, state0, drives, plan, pcfg, _ = net
    d = str(tmp_path)
    faults = (fablib.FaultEvent(level=0, edge=1, kill_step=3,
                                restore_step=7),)
    ref = stlib.run_stream(params, state0, drives, cfg, fabric=plan,
                           plasticity=pcfg, faults=faults, device=CPU)
    assert int(ref.unroutable.sum()) > 0
    elastic.run_supervised_stream(
        params, state0, drives[:4], cfg, fabric=plan, window=WINDOW,
        ckpt_dir=d, plasticity=pcfg, faults=faults, async_checkpoint=False,
        device=CPU)
    out, info = elastic.resume_supervised_stream(
        params, state0, drives, cfg, fabric=plan, window=WINDOW,
        ckpt_dir=d, plasticity=pcfg, faults=faults, async_checkpoint=False,
        device=CPU)
    s = info["resumed_step"]
    assert s == 2
    assert_tail("faulted", out, ref, s)


def test_resume_refuses_fingerprint_mismatch(tmp_path, net):
    cfg, params, state0, drives, plan, pcfg, _ = net
    d = str(tmp_path)
    elastic.run_supervised_stream(
        params, state0, drives[:2], cfg, fabric=plan, window=WINDOW,
        ckpt_dir=d, plasticity=pcfg, async_checkpoint=False, device=CPU)
    other = netlib.NetworkConfig(n_chips=N_CHIPS, capacity=512)
    with pytest.raises(ckpt.CheckpointError, match="fingerprint"):
        elastic.resume_supervised_stream(
            params, state0, drives, other, fabric=plan, window=WINDOW,
            ckpt_dir=d, plasticity=pcfg, device=CPU)
    with pytest.raises(FileNotFoundError, match="nothing to resume"):
        elastic.resume_supervised_stream(
            params, state0, drives, cfg, fabric=plan, window=WINDOW,
            ckpt_dir=str(tmp_path / "empty"), plasticity=pcfg, device=CPU)


def test_restore_refuses_to_drop_plasticity(tmp_path, net):
    cfg, params, state0, drives, plan, pcfg, _ = net
    d = str(tmp_path)
    out = stlib.run_stream(params, state0, drives[:2], cfg, fabric=plan,
                           plasticity=pcfg, device=CPU)
    elastic.save_stream_state(d, 2, out.state, plasticity=out.plasticity)
    with pytest.raises(ckpt.CheckpointError, match="plasticity"):
        elastic.restore_stream_state(d, state0, step=2, device=CPU)
    ck = elastic.restore_stream_checkpoint(
        d, state0, step=2,
        plasticity_like=netlib.init_stream_plasticity(params, BATCH),
        device=CPU)
    assert_trees_equal("plasticity", ck.plasticity, out.plasticity)


def test_supervised_cadence_and_retention(tmp_path, net):
    """Sparse checkpoint cadence + bounded retention, the async writer: the
    windowed outputs equal the one long run bit for bit."""
    cfg, params, state0, drives, plan, pcfg, ref = net
    d = str(tmp_path)
    out, recs = elastic.run_supervised_stream(
        params, state0, drives, cfg, fabric=plan, window=WINDOW,
        ckpt_dir=d, plasticity=pcfg, ckpt_every=2, keep=1, device=CPU)
    assert recs == []
    assert_tail("supervised", out, ref, 0)
    steps = sorted(ckpt._candidates(d))
    assert steps == [4]                          # widx 0, 2 saved; keep=1
    assert not ckpt.verify(d)[4]


def test_async_writer_saves_the_boundary_not_later_state(tmp_path, net,
                                                         monkeypatch):
    """The async writer gets a host copy taken at the boundary: a writer
    that runs only after the stream moved on still saves the boundary's
    state, and writer errors surface at the next join."""
    cfg, params, state0, drives, plan, pcfg, _ = net
    d = str(tmp_path)
    ref = stlib.run_stream(params, state0, drives[:4], cfg, fabric=plan,
                           plasticity=pcfg, device=CPU)
    real_save = ckpt.save

    def late_save(directory, step, tree, metadata=None, **kw):
        # Every leaf the writer sees is host numpy, not a tensor.
        assert all(isinstance(x, np.ndarray) for x in _leaves(tree))
        return real_save(directory, step, tree, metadata, **kw)

    monkeypatch.setattr(ckpt, "save", late_save)
    elastic.run_supervised_stream(
        params, state0, drives[:6], cfg, fabric=plan, window=WINDOW,
        ckpt_dir=d, plasticity=pcfg, device=CPU)
    ck = elastic.restore_stream_checkpoint(
        d, state0, step=4,
        plasticity_like=netlib.init_stream_plasticity(params, BATCH),
        device=CPU)
    assert_trees_equal("state at step 4", ck.state, ref.state)
    assert_trees_equal("plasticity at step 4", ck.plasticity,
                       ref.plasticity)

    def failing_save(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        elastic.run_supervised_stream(
            params, state0, drives[:4], cfg, fabric=plan, window=WINDOW,
            ckpt_dir=str(tmp_path / "b"), plasticity=pcfg, device=CPU)


# ---------------------------------------------------------------------------
# A reference mid-run checkpoint resumed by the port
# ---------------------------------------------------------------------------


def reference_margins(xnet, pcfg_j, offset, **kw):
    """``margin_at(t)`` for ``parity.compare_streams``: the reference's
    margin entering step ``offset + t`` of the plastic run from step 0, on
    the weights that step integrates."""
    cfg_j, params_j, plan_j, state_j, cfg_t, params_t, _, _, drives = xnet

    def margin_at(t):
        k = offset + t
        ps0 = jnet.init_stream_plasticity(params_j, XBATCH)
        if k:
            out = jstream.run_stream(params_j, state_j,
                                     jnp.asarray(drives[:k]), cfg_j,
                                     fabric=plan_j, plasticity=pcfg_j,
                                     plasticity_state=ps0, **kw)
            before, weights = out.state, out.plasticity.weights
        else:
            before, weights = state_j, ps0.weights
        return parity.spike_margin(
            params_t, convert.network_state_from_numpy(flatten(before),
                                                       device=CPU),
            T(drives[k]), cfg_t, weights=T(weights))
    return margin_at


def hold(ref, got, margin_at, what):
    """``compare_streams``, and where no spike flipped, the plasticity
    state bit for bit."""
    report = parity.compare_streams(ref, got, margin_at)
    print(f"{what}: {report}")
    assert float(got.spikes.sum()) > 0
    if report["first_flip_step"] is None:
        for a, b in zip(ref.plasticity, got.plasticity, strict=True):
            parity.assert_equal(f"{what} plasticity", a, b)
    return report


@pytest.fixture(scope="module")
def reference_supervised(xnet, tmp_path_factory):
    """The reference's supervised timed plastic run over the first 6 steps
    (checkpoints at 0, 2, 4) and its uninterrupted 8-step run."""
    cfg_j, params_j, plan_j, state_j, *_, drives = xnet
    d = str(tmp_path_factory.mktemp("jax_supervised"))
    jel.run_supervised_stream(
        params_j, state_j, jnp.asarray(drives[:6]), cfg_j, fabric=plan_j,
        window=WINDOW, ckpt_dir=d, plasticity=XSTDP[0],
        stream_kwargs={"timed": True}, rng=jax.random.key(5),
        async_checkpoint=False)
    full = jstream.run_stream(params_j, state_j, jnp.asarray(drives), cfg_j,
                              fabric=plan_j, plasticity=XSTDP[0], timed=True)
    return d, full


def test_port_resumes_a_reference_checkpoint(tmp_path, xnet,
                                             reference_supervised):
    cfg_j, params_j, plan_j, state_j, cfg_t, params_t, plan_t, state_t, \
        drives = xnet
    src, full = reference_supervised
    d = str(tmp_path / "ck")
    shutil.copytree(src, d)
    out, info = elastic.resume_supervised_stream(
        params_t, state_t, T(drives), cfg_t, fabric=plan_t, window=WINDOW,
        ckpt_dir=d, plasticity=XSTDP[1], stream_kwargs={"timed": True},
        async_checkpoint=False, device=CPU)
    s = info["resumed_step"]
    assert s == 4
    assert isinstance(info["rng"], elastic.KeyData)
    tail = full._replace(**{f: getattr(full, f)[s:]
                            for f in elastic._DATA_FIELDS})
    hold(tail, out, lambda t: reference_margins(
        xnet, XSTDP[0], s, timed=True)(t), "reference checkpoint → port")
    # The port's own boundary checkpoint at step 6 restores in the
    # reference, its typed key intact.
    back = jel.restore_stream_checkpoint(
        d, state_j, step=6,
        plasticity_like=jnet.init_stream_plasticity(params_j, XBATCH),
        expect_fingerprint=jel.stream_fingerprint(
            cfg_j, fabric=plan_j, plasticity=XSTDP[0]))
    assert back.step == 6
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(back.rng)),
                                  np.asarray(jax.random.key_data(
                                      jax.random.key(5))))
