"""The port's multi-tenant emulation engine (``repro_torch.runtime.engine``)
and its CLI, mirroring ``tests/test_engine.py``, and against the
reference's engine.

Within the port, S concurrent sessions batched through one window program
equal S independent batch-1 ``run_stream`` runs bit for bit: spikes, all
four drop fields, the latency statistics and the final per-slot plasticity
row, with unequal session lengths (so tail masking is in the gate); evict
→ checkpoint → resubmit resumes bit-exactly; one slot serves a FIFO queue;
idle slots cost nothing.

Against the reference, on ``test_engine.py``'s 3-chip 24 × 12 network with
its ``w_scale`` set to 2^-6 in both packages (dyadic products; parameters
carried by ``convert``): the two engines, timed and plastic, agree session
for session — spikes, drop counts and plasticity rows bit for bit, latency
counts exactly and their percentiles within a relative 1e-6 (the reference
takes them in float32, the port in float64, as
``test_torch_stream.py::test_latency_stats_match_reference`` states) — and
a session the reference evicts, the port restores and finishes, equal to
the reference's uninterrupted session.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregator import identity_router as j_identity_router
from repro.runtime.engine import EmulationEngine as JEngine
from repro.snn import chip as jchip
from repro.snn import network as jnet
from repro.snn.plasticity import STDPConfig as JSTDP
from repro_torch import convert, parity
from repro_torch.analysis import scenarios as tsc
from repro_torch.ckpt.checkpoint import CheckpointError
from repro_torch.core.aggregator import identity_router
from repro_torch.launch import serve_emulation
from repro_torch.runtime.engine import EmulationEngine
from repro_torch.snn import chip as chiplib
from repro_torch.snn import network as netlib
from repro_torch.snn import stream as stlib
from repro_torch.snn.plasticity import STDPConfig
from test_torch_stream import flatten
from torch_threads import share_cores

share_cores()

CPU = "cpu"
CHIP = dict(n_neurons=24, n_rows=12)
LENGTHS = (10, 7, 4, 12, 9)
LAT_KEYS = ("median_ns", "p01_ns", "p99_ns", "jitter_ns", "jitter_frac")
DROPS = ("dropped", "uplink_dropped", "unroutable", "rerouted")


def _small_network():
    chip = chiplib.ChipConfig(**CHIP)
    cfg = netlib.NetworkConfig(n_chips=3, capacity=16, chip=chip)
    params = netlib.init_feedforward(cfg, seed=3, device=CPU)._replace(
        router=identity_router(cfg.n_chips, device=CPU))
    return cfg, params


def _stims(cfg, lengths, rate=0.35, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(size=(L, cfg.chip.n_rows)) < rate)
            .astype(np.float32) for L in lengths]


def _independent_run(cfg, params, stim, *, timed=False, plasticity=None):
    drives = torch.zeros((stim.shape[0], cfg.n_chips, 1, cfg.chip.n_rows))
    drives[:, 0, 0] = torch.from_numpy(stim)
    pstate = (netlib.init_slot_plasticity(params, 1)
              if plasticity is not None else None)
    return stlib.run_stream(params, netlib.init_state(cfg, 1, device=CPU),
                            drives, cfg, timed=timed, plasticity=plasticity,
                            plasticity_state=pstate, device=CPU)


def assert_session(r, out, what=""):
    """A ``SessionResult`` against a batch-1 ``StreamOut``, bit for bit."""
    parity.assert_equal(f"{what} spikes", out.spikes[:, :, 0], r.spikes)
    for field in DROPS:
        assert getattr(r, field) == int(getattr(out, field).sum()), field
    if r.latency is not None:
        ref = stlib.masked_latency_stats(out.latency_ns, out.latency_valid,
                                         strict=False)
        assert r.latency["count"] == ref["count"]
        if ref["count"]:
            assert all(r.latency[k] == ref[k] for k in LAT_KEYS)
    if r.plasticity is not None:
        for name, got, want in zip(r.plasticity._fields, r.plasticity,
                                   out.plasticity, strict=True):
            parity.assert_equal(f"{what} {name}", want[:, 0], got)


# ---------------------------------------------------------------------------
# The port's engine against its own batch-1 runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plastic", [False, True])
def test_engine_sessions_match_independent_runs(plastic):
    cfg, params = _small_network()
    pcfg = STDPConfig() if plastic else None
    stims = _stims(cfg, LENGTHS)
    eng = EmulationEngine(params, cfg, slots=3, max_steps=max(LENGTHS),
                          window=4, timed=True, plasticity=pcfg, device=CPU)
    sids = [eng.submit(s) for s in stims]
    assert eng.active == 3 and eng.queued == 2
    eng.drain()
    assert set(eng.done) == set(sids)
    total_events = 0
    for sid, stim, L in zip(sids, stims, LENGTHS):
        out = _independent_run(cfg, params, stim, timed=True,
                               plasticity=pcfg)
        r = eng.collect(sid)
        assert r.steps == L and r.time_to_result_s >= 0
        assert_session(r, out, f"session {sid}")
        total_events += r.latency["count"]
    assert total_events > 0, "gate must see real routed traffic"
    with pytest.raises(KeyError):
        eng.collect(sids[0])


def test_engine_evict_restore_is_bit_exact(tmp_path):
    cfg, params = _small_network()
    pcfg = STDPConfig()
    stim = _stims(cfg, (12,))[0]
    eng = EmulationEngine(params, cfg, slots=2, max_steps=12, window=4,
                          plasticity=pcfg, device=CPU)
    sid = eng.submit(stim)
    other = eng.submit(_stims(cfg, (8,), seed=9)[0])
    eng.step()                                      # both at cursor 4
    ck = str(tmp_path / "evicted")
    partial = eng.evict(sid, ck)
    assert partial.evicted_to == ck and partial.steps == 4
    eng.drain()
    eng.collect(other)
    resumed = eng.submit(stim, restore_from=ck)
    eng.drain()
    r = eng.collect(resumed)
    assert r.steps == 8                             # post-restore windows

    ref_eng = EmulationEngine(params, cfg, slots=1, max_steps=12, window=4,
                              plasticity=pcfg, device=CPU)
    ref_sid = ref_eng.submit(stim)
    ref_eng.drain()
    ref = ref_eng.collect(ref_sid)
    np.testing.assert_array_equal(
        np.concatenate([partial.spikes, r.spikes]), ref.spikes)
    for a, b in zip(r.plasticity, ref.plasticity, strict=True):
        np.testing.assert_array_equal(a, b)


def test_engine_evict_before_first_step_and_restore_rejects_fingerprint(
        tmp_path):
    """A session admitted but never stepped evicts its init row; a
    checkpoint from a differently-configured engine is refused."""
    cfg, params = _small_network()
    stim = _stims(cfg, (8,))[0]
    eng = EmulationEngine(params, cfg, slots=1, max_steps=8, window=4,
                          plasticity=STDPConfig(), device=CPU)
    sid = eng.submit(stim)
    ck0 = str(tmp_path / "ck0")
    partial = eng.evict(sid, ck0)
    assert partial.steps == 0 and partial.spikes.shape[0] == 0
    init = netlib.init_slot_plasticity(params, 1)
    for a, b in zip(partial.plasticity, init, strict=True):
        np.testing.assert_array_equal(a, b[:, 0].numpy())
    resumed = eng.submit(stim, restore_from=ck0)    # from cursor 0
    eng.drain()
    alone = _independent_run(cfg, params, stim, plasticity=STDPConfig())
    assert_session(eng.collect(resumed), alone)

    sid = eng.submit(stim)
    eng.step()
    ck = str(tmp_path / "ck")
    eng.evict(sid, ck)
    other = EmulationEngine(params, cfg, slots=1, max_steps=8, window=4,
                            plasticity=STDPConfig(lr_pot=0.5), device=CPU)
    with pytest.raises(CheckpointError, match="fingerprint"):
        other.submit(stim, restore_from=ck)


def test_engine_slot_reuse_serves_fifo_queue():
    """A 1-slot engine drains a FIFO of 3 sessions through the same slot;
    accounting-only mode matches the independent runs' counts."""
    cfg, params = _small_network()
    lengths = (10, 7, 4)
    stims = _stims(cfg, lengths)
    eng = EmulationEngine(params, cfg, slots=1, max_steps=max(lengths),
                          window=4, keep_spikes=False, timed=True,
                          device=CPU)
    sids = [eng.submit(s) for s in stims]
    assert eng.active == 1 and eng.queued == 2
    eng.warm()                                      # advances nothing
    assert eng.active == 1 and eng.queued == 2
    eng.drain()
    got = [eng.collect(sid) for sid in sids]
    assert [r.steps for r in got] == list(lengths)
    for r, stim in zip(got, stims):
        out = _independent_run(cfg, params, stim, timed=True)
        assert r.spikes is None                     # accounting-only mode
        assert r.spike_count == int(out.spikes.sum())
        for field in DROPS:
            assert getattr(r, field) == int(getattr(out, field).sum())
        assert r.latency["count"] == int(out.latency_valid.sum())


def test_engine_idle_slots_cost_nothing():
    cfg, params = _small_network()
    pcfg = STDPConfig()
    stim = _stims(cfg, (8,))[0]
    eng = EmulationEngine(params, cfg, slots=3, max_steps=8, window=4,
                          timed=True, plasticity=pcfg, device=CPU)
    init_w = eng._plast.weights.clone()
    sid = eng.submit(stim)
    eng.drain()
    r = eng.collect(sid)
    out = _independent_run(cfg, params, stim, timed=True, plasticity=pcfg)
    assert_session(r, out)
    final = eng._plast
    assert torch.equal(final.weights[:, 1:], init_w[:, 1:])
    assert not final.trace_pre[:, 1:].any()
    assert not final.trace_post[:, 1:].any()
    assert eng.step() == 0                          # nothing to run


def test_engine_rejects_bad_submissions(monkeypatch):
    cfg, params = _small_network()
    eng = EmulationEngine(params, cfg, slots=1, max_steps=8, window=4,
                          device=CPU)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(np.zeros((9, cfg.chip.n_rows), np.float32))
    with pytest.raises(ValueError, match="stimulus"):
        eng.submit(np.zeros((4, cfg.chip.n_rows + 1), np.float32))
    with pytest.raises(ValueError, match="window"):
        EmulationEngine(params, cfg, slots=1, max_steps=2, window=4,
                        device=CPU)
    with pytest.raises(KeyError, match="not running"):
        eng.evict(123, "/nonexistent")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmulationEngine(params, cfg, slots=1, max_steps=8, window=4)


def test_engine_on_a_catalogue_fabric_with_two_stim_chips():
    """A 3-level catalogue plan (compact uplinks, merge engine) with
    stimulus on two chips: each session equals its batch-1 run."""
    chip = chiplib.ChipConfig(n_neurons=16, n_rows=8)
    cfg, params, plan = tsc.engine_network("EXT_4CASE_96CHIP", chip=chip,
                                           device=CPU)
    rng = np.random.default_rng(4)
    stims = [(rng.random((L, 2, 8)) < 0.5).astype(np.float32)
             for L in (6, 3, 5)]
    eng = EmulationEngine(params, cfg, slots=2, max_steps=6, window=3,
                          plan=plan, stim_chips=(0, 12), timed=True,
                          device=CPU)
    sids = [eng.submit(s) for s in stims]
    eng.drain()
    for sid, stim in zip(sids, stims):
        drives = torch.zeros((stim.shape[0], cfg.n_chips, 1, 8))
        drives[:, 0, 0] = torch.from_numpy(stim[:, 0])
        drives[:, 12, 0] = torch.from_numpy(stim[:, 1])
        out = stlib.run_stream(params, netlib.init_state(cfg, 1, device=CPU),
                               drives, cfg, fabric=plan, timed=True,
                               device=CPU)
        assert_session(eng.collect(sid), out, f"session {sid}")


def test_serve_emulation_cli(capsys):
    serve_emulation.main(["--scenario", "FULL_BACKPLANE", "--sessions", "3",
                          "--slots", "2", "--steps", "8", "--window", "4",
                          "--small", "--timed", "--plastic", "--rate", "0.5",
                          "--device", "cpu"])
    text = capsys.readouterr().out
    assert "FULL_BACKPLANE: 12 chips, S=2 slots, window=4" in text
    assert "3 experiments in" in text and "experiments/s" in text
    rows = [line.split() for line in text.splitlines()
            if line[:4].strip().isdigit()]
    assert [int(r[0]) for r in rows] == [0, 1, 2]
    assert all(4 <= int(r[1]) <= 8 for r in rows)


# ---------------------------------------------------------------------------
# The port's engine against the reference's
# ---------------------------------------------------------------------------


def _pair_network():
    chip_j = jchip.ChipConfig(**CHIP)
    cfg_j = jnet.NetworkConfig(n_chips=3, capacity=16, chip=chip_j)
    params_j = jnet.init_feedforward(jax.random.PRNGKey(3), cfg_j)._replace(
        router=j_identity_router(3))
    params_j = params_j._replace(chips=params_j.chips._replace(
        w_scale=jnp.full_like(params_j.chips.w_scale, 2.0 ** -6)))
    cfg_t = netlib.NetworkConfig(n_chips=3, capacity=16,
                                 chip=chiplib.ChipConfig(**CHIP))
    params_t = convert.network_params_from_numpy(flatten(params_j),
                                                 device=CPU)
    return cfg_j, params_j, cfg_t, params_t


def assert_same_result(ref, got, what):
    assert got.steps == ref.steps, what
    np.testing.assert_array_equal(got.spikes, ref.spikes, err_msg=what)
    for field in DROPS:
        assert getattr(got, field) == getattr(ref, field), (what, field)
    assert got.spike_count == ref.spike_count
    assert got.latency["count"] == ref.latency["count"], what
    if ref.latency["count"]:
        for k in LAT_KEYS:
            assert got.latency[k] == pytest.approx(ref.latency[k],
                                                   rel=1e-6), (what, k)
    for name, a, b in zip(got.plasticity._fields, ref.plasticity,
                          got.plasticity, strict=True):
        np.testing.assert_array_equal(b, np.asarray(a),
                                      err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def reference_engine(tmp_path_factory):
    """The reference's timed plastic engine over LENGTHS' sessions, and a
    second run in which session 0 is evicted after one window."""
    cfg_j, params_j, cfg_t, params_t = _pair_network()
    stims = _stims(cfg_t, LENGTHS)
    kw = dict(slots=3, max_steps=max(LENGTHS), window=4, timed=True,
              plasticity=JSTDP())
    eng = JEngine(params_j, cfg_j, **kw)
    sids = [eng.submit(s) for s in stims]
    eng.drain()
    results = [eng.collect(s) for s in sids]
    ck = str(tmp_path_factory.mktemp("jax_evicted") / "ck")
    eng = JEngine(params_j, cfg_j, **kw)
    sid = eng.submit(stims[0])
    eng.submit(stims[1])
    eng.step()
    partial = eng.evict(sid, ck)
    return stims, results, ck, partial


def test_engine_matches_reference_session_for_session(reference_engine):
    stims, ref_results, _, _ = reference_engine
    _, _, cfg_t, params_t = _pair_network()
    eng = EmulationEngine(params_t, cfg_t, slots=3, max_steps=max(LENGTHS),
                          window=4, timed=True, plasticity=STDPConfig(),
                          device=CPU)
    sids = [eng.submit(s) for s in stims]
    eng.drain()
    events = 0
    for sid, ref in zip(sids, ref_results, strict=True):
        got = eng.collect(sid)
        assert_same_result(ref, got, f"session {sid}")
        events += got.latency["count"]
    assert events > 0 and sum(r.spike_count for r in ref_results) > 0


def test_port_finishes_a_session_the_reference_evicted(reference_engine,
                                                       tmp_path):
    stims, ref_results, ck, partial = reference_engine
    _, _, cfg_t, params_t = _pair_network()
    eng = EmulationEngine(params_t, cfg_t, slots=2, max_steps=max(LENGTHS),
                          window=4, timed=True, plasticity=STDPConfig(),
                          device=CPU)
    sid = eng.submit(stims[0], restore_from=ck)
    eng.drain()
    r = eng.collect(sid)
    whole = ref_results[0]
    assert partial.steps == 4 and r.steps == whole.steps - 4
    np.testing.assert_array_equal(
        np.concatenate([partial.spikes, r.spikes]), whole.spikes)
    for a, b in zip(r.plasticity, whole.plasticity, strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    # The port evicts that session again; the reference's engine resumes
    # the port's checkpoint and finishes it the same way.
    eng = EmulationEngine(params_t, cfg_t, slots=1, max_steps=max(LENGTHS),
                          window=4, timed=True, plasticity=STDPConfig(),
                          device=CPU)
    sid = eng.submit(stims[0], restore_from=ck)
    eng.step()
    ck2 = str(tmp_path / "port_evicted")
    again = eng.evict(sid, ck2)
    cfg_j, params_j, _, _ = _pair_network()
    jeng = JEngine(params_j, cfg_j, slots=1, max_steps=max(LENGTHS),
                   window=4, timed=True, plasticity=JSTDP())
    jsid = jeng.submit(stims[0], restore_from=ck2)
    jeng.drain()
    rest = jeng.collect(jsid)
    np.testing.assert_array_equal(
        np.concatenate([partial.spikes, again.spikes, rest.spikes]),
        whole.spikes)
    for a, b in zip(rest.plasticity, whole.plasticity, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
