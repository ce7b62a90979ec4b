"""Watchdog-supervised streams in the port
(``repro_torch.runtime.elastic.run_supervised_stream``), mirroring the
supervised tests of ``tests/test_degraded.py``: a stalled window fires the
watchdog, the supervisor restores the newest valid checkpoint at or before
the window and reruns the span on the plan ``on_recover`` supplies.

Within the port the recovered stream equals a healthy run up to the
restored step and a direct degraded run from the restored checkpoint after
it, bit for bit.  Against the reference (``test_torch_plasticity``'s
dyadic EXT_4CASE_96CHIP case, timed) the same composition of the
reference's healthy and degraded runs holds the port's recovered output
under ``parity.compare_streams``.

The watchdog (``ArmedOn``) has a real timer with a 0.2 s deadline on the
windows that stall (they sleep 0.4 s) and a minute on the others, so a
loaded machine cannot fire it on a window that does not stall.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fabric as jfab
from repro.snn import network as jnet
from repro.snn import stream as jstream
from repro_torch import convert, parity
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import fabric as fablib
from repro_torch.core.aggregator import identity_router
from repro_torch.runtime import elastic
from repro_torch.runtime.watchdog import StepWatchdog, WatchdogConfig
from repro_torch.snn import network as netlib
from repro_torch.snn import stream as stlib
from repro_torch.snn.plasticity import STDPConfig
from test_torch_checkpoint import assert_trees_equal
from test_torch_plasticity import stream_case, stream_inputs
from test_torch_stream import BATCH, flatten
from torch_threads import share_cores

share_cores()

CPU = "cpu"
DEADLINE_S, STALL_S = 0.2, 0.4


class ArmedOn(StepWatchdog):
    """A watchdog whose deadline is ``DEADLINE_S`` on the windows it arms
    for (counted from 0 as it is entered) and a minute on the others, so a
    loaded machine cannot fire it on a window that does not stall."""

    def __init__(self, *windows):
        super().__init__(WatchdogConfig(refractory_s=10.0))
        self.windows, self.entered = windows, 0

    @property
    def deadline_s(self) -> float:
        return DEADLINE_S if self.entered - 1 in self.windows else 60.0

    def __enter__(self):
        self.entered += 1
        return super().__enter__()


def stall_at(*windows):
    def probe(widx):
        if widx in windows:
            time.sleep(STALL_S)
    return probe


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ext():
    cfg_j, params_j, plan_j, cfg_t, params_t, plan_t = stream_case(
        "EXT_4CASE_96CHIP")
    drives, _ = stream_inputs(cfg_j, 8, 41)
    state_j = jnet.init_state(cfg_j, BATCH)
    state_t = convert.network_state_from_numpy(flatten(state_j), device=CPU)
    dead = [(1, 0)]
    degraded_j = jfab.compile_fabric(jfab.degrade_spec(plan_j.spec, dead))
    degraded_t = fablib.compile_fabric(fablib.degrade_spec(plan_t.spec, dead))
    return (cfg_j, params_j, plan_j, degraded_j, state_j, cfg_t, params_t,
            plan_t, degraded_t, state_t, drives)


def test_supervised_stream_recovers_bit_exactly(tmp_path, ext):
    """The watchdog fires on window 1; the supervisor restores step 2 and
    resumes on the degraded plan.  Pre-recovery windows equal the healthy
    run, the rest a direct degraded run from the restored checkpoint."""
    (cfg_j, params_j, plan_j, degraded_j, state_j, cfg_t, params_t, plan_t,
     degraded_t, state_t, drives) = ext
    d = str(tmp_path)
    wd = ArmedOn(1)
    plans = []

    def on_recover(widx, plan):
        plans.append((widx, plan))
        return degraded_t

    out, recs = elastic.run_supervised_stream(
        params_t, state_t, T(drives), cfg_t, fabric=plan_t, window=2,
        ckpt_dir=d, watchdog=wd, on_recover=on_recover,
        stall_probe=stall_at(1), stream_kwargs={"timed": True}, device=CPU)
    assert [r["window"] for r in recs] == [1] and wd.timeouts == 1
    assert recs[0]["restored_step"] == 2 and recs[0]["step"] == 2
    assert recs[0]["plan"] == degraded_t.describe()
    assert plans == [(1, plan_t)]
    assert (ckpt.read_manifest(d, 6)["metadata"]["plan"]
            == degraded_t.describe())
    healthy = stlib.run_stream(params_t, state_t, T(drives), cfg_t,
                               fabric=plan_t, timed=True, device=CPU)
    for f in elastic._DATA_FIELDS:
        parity.assert_equal(f"pre-recovery {f}", getattr(healthy, f)[:2],
                            getattr(out, f)[:2])
    st2, _ = elastic.restore_stream_state(d, state_t, step=2, device=CPU)
    direct = stlib.run_stream(params_t, st2, T(drives[2:]), cfg_t,
                              fabric=degraded_t, timed=True, device=CPU)
    for f in elastic._DATA_FIELDS:
        parity.assert_equal(f"post-recovery {f}", getattr(direct, f),
                            getattr(out, f)[2:])
    assert_trees_equal("final state", out.state, direct.state)
    assert int(out.rerouted[2:].sum()) > 0       # the detour carried traffic

    # Against the reference: its healthy run to step 2, then its degraded
    # run from there.
    ref_h = jstream.run_stream(params_j, state_j, jnp.asarray(drives[:2]),
                               cfg_j, fabric=plan_j, timed=True)
    ref_d = jstream.run_stream(params_j, ref_h.state,
                               jnp.asarray(drives[2:]), cfg_j,
                               fabric=degraded_j, timed=True)
    ref = ref_d._replace(**{f: jnp.concatenate([getattr(ref_h, f),
                                                getattr(ref_d, f)])
                            for f in elastic._DATA_FIELDS})

    def margin_at(t):
        before = state_j
        if t:
            before = jstream.run_stream(
                params_j, state_j, jnp.asarray(drives[:min(t, 2)]), cfg_j,
                fabric=plan_j, timed=True).state
        if t > 2:
            before = jstream.run_stream(
                params_j, before, jnp.asarray(drives[2:t]), cfg_j,
                fabric=degraded_j, timed=True).state
        return parity.spike_margin(
            params_t, convert.network_state_from_numpy(flatten(before),
                                                       device=CPU),
            T(drives[t]), cfg_t)

    report = parity.compare_streams(ref, out, margin_at)
    print(f"recovered stream against the reference: {report}")


def test_sparse_cadence_recovers_from_an_older_checkpoint(tmp_path, ext):
    """ckpt_every=2: window 3 stalls, the newest checkpoint at or before
    step 6 is step 4, and the whole span 4..8 reruns as one call — plastic
    state included, bit for bit with the direct runs; a stall in the
    refractory period that follows fires nothing."""
    (*_, cfg_t, params_t, plan_t, degraded_t, state_t, drives) = ext
    d = str(tmp_path)
    pcfg = STDPConfig(lr_pot=0.3, lr_dep=0.2)
    wd = ArmedOn(3)
    out, recs = elastic.run_supervised_stream(
        params_t, state_t, T(drives), cfg_t, fabric=plan_t, window=2,
        ckpt_dir=d, watchdog=wd, on_recover=lambda w, p: degraded_t,
        stall_probe=stall_at(3), plasticity=pcfg, ckpt_every=2,
        device=CPU)
    assert [(r["window"], r["restored_step"]) for r in recs] == [(3, 4)]
    assert sorted(ckpt._candidates(d)) == [0, 4]
    head = stlib.run_stream(params_t, state_t, T(drives[:4]), cfg_t,
                            fabric=plan_t, plasticity=pcfg, device=CPU)
    tail = stlib.run_stream(params_t, head.state, T(drives[4:]), cfg_t,
                            fabric=degraded_t, plasticity=pcfg,
                            plasticity_state=head.plasticity, device=CPU)
    for f in elastic._DATA_FIELDS:
        parity.assert_equal(f, torch.cat([getattr(head, f),
                                          getattr(tail, f)]),
                            getattr(out, f))
    assert_trees_equal("state", out.state, tail.state)
    assert_trees_equal("plasticity", out.plasticity, tail.plasticity)

    # Refractory: two stalls in a row recover once.
    wd = ArmedOn(1, 2)
    _, recs = elastic.run_supervised_stream(
        params_t, state_t, T(drives), cfg_t, fabric=plan_t, window=2,
        ckpt_dir=str(tmp_path / "r"), watchdog=wd,
        stall_probe=stall_at(1, 2), device=CPU)
    assert [r["window"] for r in recs] == [1] and wd.timeouts == 1
    assert recs[0]["plan"] == plan_t.describe()   # no on_recover: same plan


def test_recovery_without_a_valid_checkpoint_raises(tmp_path, ext):
    (*_, cfg_t, params_t, plan_t, _, state_t, drives) = ext
    d = str(tmp_path)

    def corrupt_then_stall(widx):
        os.remove(os.path.join(d, "step_00000000", "inflight.npy"))
        time.sleep(STALL_S)

    with pytest.raises(ckpt.CheckpointError, match="no valid checkpoint"):
        elastic.run_supervised_stream(
            params_t, state_t, T(drives[:2]), cfg_t, fabric=plan_t,
            window=2, ckpt_dir=d, watchdog=ArmedOn(0),
            stall_probe=corrupt_then_stall, async_checkpoint=False,
            device=CPU)
    assert "step_00000000.corrupt" in os.listdir(d)


def test_supervised_generator_rng_and_per_slot_plasticity(tmp_path, ext):
    """A ``torch.Generator`` rides through every boundary checkpoint and
    comes back from a resume with its state; per-slot plasticity threads
    through the windows bit for bit with one long run."""
    (*_, cfg_t, params_t, plan_t, _, state_t, drives) = ext
    d = str(tmp_path)
    pcfg = STDPConfig()
    ps0 = netlib.init_slot_plasticity(params_t, BATCH)
    gen = torch.Generator().manual_seed(99)
    out, _ = elastic.run_supervised_stream(
        params_t, state_t, T(drives), cfg_t, fabric=plan_t, window=3,
        ckpt_dir=d, plasticity=pcfg, plasticity_state=ps0, rng=gen,
        device=CPU)
    ref = stlib.run_stream(params_t, state_t, T(drives), cfg_t,
                           fabric=plan_t, plasticity=pcfg,
                           plasticity_state=ps0, device=CPU)
    for f in elastic._DATA_FIELDS:
        parity.assert_equal(f, getattr(ref, f), getattr(out, f))
    assert_trees_equal("per-slot plasticity", out.plasticity,
                       ref.plasticity)
    assert sorted(ckpt._candidates(d)) == [0, 3, 6]
    ck = elastic.restore_stream_checkpoint(
        d, state_t, plasticity_like=netlib.init_slot_plasticity(params_t,
                                                                BATCH),
        device=CPU)
    assert ck.step == 6 and isinstance(ck.rng, torch.Generator)
    assert torch.equal(ck.rng.get_state(), gen.get_state())
    assert type(ck.plasticity).__name__ == "SlotPlasticityState"


def test_stream_state_checkpoint_roundtrip(tmp_path):
    cfg = netlib.NetworkConfig(n_chips=2)
    state = netlib.init_state(cfg, 1, device=CPU)
    bumped = state._replace(inflight=state.inflight + 1.0)
    elastic.save_stream_state(str(tmp_path), 4, bumped, metadata={"k": "v"})
    got, manifest = elastic.restore_stream_state(str(tmp_path), state, step=4,
                                                 device=CPU)
    assert type(got) is type(state)
    assert torch.equal(got.inflight, bumped.inflight)
    assert_trees_equal("chips", got.chips, bumped.chips)
    assert manifest["metadata"]["k"] == "v"
    assert manifest["metadata"]["stream_step"] == 4
    assert manifest["metadata"]["has_plasticity"] is False


def test_argument_checks(tmp_path):
    cfg = netlib.NetworkConfig(n_chips=2, capacity=64)
    params = netlib.init_feedforward(cfg, device=CPU)._replace(
        router=identity_router(2, device=CPU))
    state = netlib.init_state(cfg, 1, device=CPU)
    plan = fablib.compile_fabric(fablib.star_spec(2, 64))
    drives = torch.zeros((2, 2, 1, cfg.chip.n_rows))
    for kw, msg in (({"window": 0}, "window"),
                    ({"window": 2, "ckpt_every": 0}, "ckpt_every")):
        with pytest.raises(ValueError, match=msg):
            elastic.run_supervised_stream(params, state, drives, cfg,
                                          fabric=plan, ckpt_dir=str(tmp_path),
                                          device=CPU, **kw)
