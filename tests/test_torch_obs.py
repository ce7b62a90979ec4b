"""The port's stage spans (``repro_torch.obs``) on the CPU.

Spans and counters record only inside a ``torch.profiler`` session: a run
outside one leaves the recorder empty, a run inside one gives each stage
of ``run_stream`` and of ``EmulationEngine.step`` its count, its host and
self times, and its ``user_annotation`` in the profiler's trace, nested in
its parent stage, and the outputs do not change by a bit.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.analysis import scenarios
from repro_torch.core.aggregator import identity_router
from repro_torch.runtime.engine import EmulationEngine
from repro_torch.snn import chip as chiplib
from repro_torch.snn import network as netlib
from repro_torch.snn import stream as stlib
from repro_torch.snn.plasticity import STDPConfig
from torch_threads import share_cores

share_cores()

CPU = "cpu"
T, BATCH = 6, 3
CHIP = dict(n_neurons=24, n_rows=12)
STREAM_SPANS = ("stream.chip_step", "stream.plasticity", "stream.route",
                "exchange.egress", "fabric.uplink_pack", "fabric.merge",
                "exchange.ingress")
PARENT = {"exchange.egress": "stream.route",
          "fabric.uplink_pack": "stream.route",
          "fabric.merge": "stream.route",
          "exchange.ingress": "stream.route"}
# (fan-ins, capacity, link capacities): a 4-chip star, and an 8-chip
# 3-level fabric whose every level packs its uplink.
STAR = ((4,), 16, (None,))
THREE_LEVEL = ((2, 2, 2), 16, (4, 6, 8))


@pytest.fixture(autouse=True)
def fresh_recorder():
    obs.reset()
    yield
    obs.reset()


def _network(fan_ins, capacity, caps, device=CPU):
    n = int(np.prod(fan_ins))
    cfg = netlib.NetworkConfig(n_chips=n, capacity=capacity,
                               chip=chiplib.ChipConfig(**CHIP))
    params = netlib.init_feedforward(cfg, seed=3, device=device)._replace(
        router=identity_router(n, device=device))
    return cfg, params, scenarios.plan_for(fan_ins, capacity, caps)


def _stream(topology, *, timed=False, plastic=False, device=CPU):
    """One ``run_stream`` call (drives from a fixed seed)."""
    cfg, params, plan = _network(*topology, device=device)
    gen = torch.Generator().manual_seed(5)
    drives = (torch.rand((T, cfg.n_chips, BATCH, cfg.chip.n_rows),
                         generator=gen) < 0.4).float()
    kw = {}
    if plastic:
        kw = dict(plasticity=STDPConfig(),
                  plasticity_state=netlib.init_slot_plasticity(params, BATCH))
    return stlib.run_stream(
        params, netlib.init_state(cfg, BATCH, device=device), drives, cfg,
        fabric=plan, timed=timed, device=device, **kw)


def _profiled(fn, tmp_path):
    """``fn()`` inside a CPU profiler session; returns (result, the trace's
    user annotations as (name, start, end))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return out, notes


def _flat(out):
    fields = [out.spikes, out.dropped, out.uplink_dropped, out.latency_ns,
              out.latency_valid, out.unroutable, out.rerouted,
              out.state.inflight, *out.state.chips.neurons]
    if out.plasticity is not None:
        fields += list(out.plasticity)
    return fields


def test_no_profiler_records_nothing():
    _stream(THREE_LEVEL, timed=True, plastic=True)
    obs.count("engine.to_host_bytes", 10)
    assert obs.summary() == {"spans": {}, "counters": {}}


def test_star_call_records_chip_step_and_route_each_step(tmp_path):
    _, notes = _profiled(lambda: _stream(STAR), tmp_path)
    spans = obs.summary()["spans"]
    assert spans["stream.chip_step"]["count"] == T
    assert spans["stream.route"]["count"] == T
    assert spans["exchange.egress"]["count"] == T
    assert spans["exchange.ingress"]["count"] == T
    # The untimed 1-level star is one exchange-kernel round: no pack, no
    # merge, and no plasticity in a plain run.
    assert {"fabric.uplink_pack", "fabric.merge",
            "stream.plasticity"}.isdisjoint(spans)
    names = [n for n, *_ in notes]
    for name in ("stream.chip_step", "stream.route", "exchange.egress",
                 "exchange.ingress"):
        assert names.count(name) == T


def test_three_level_timed_plastic_call_nests_its_stages(tmp_path):
    _, notes = _profiled(
        lambda: _stream(THREE_LEVEL, timed=True, plastic=True), tmp_path)
    spans = obs.summary()["spans"]
    for name in STREAM_SPANS:
        assert name in spans, name
        assert name in {n for n, *_ in notes}, name
    for name in ("stream.chip_step", "stream.plasticity", "stream.route",
                 "exchange.egress", "fabric.merge", "exchange.ingress"):
        assert spans[name]["count"] == T, name
    # The leaf lane and the two upper levels each pack their uplink.
    assert spans["fabric.uplink_pack"]["count"] == 3 * T
    routes = [(a, b) for n, a, b in notes if n == "stream.route"]
    for name, parent in PARENT.items():
        outer = [(a, b) for n, a, b in notes if n == parent]
        for n, a, b in notes:
            if n == name:
                assert any(pa <= a and b <= pb for pa, pb in outer), name
    for n, a, b in notes:
        if n in ("stream.chip_step", "stream.plasticity"):
            assert not any(ra < b and a < rb for ra, rb in routes), n
    route = spans["stream.route"]
    children = sum(spans[n]["host_s"] for n in PARENT)
    assert route["self_host_s"] == pytest.approx(route["host_s"] - children)
    for s in spans.values():
        assert 0 <= s["self_host_s"] <= s["host_s"]
        # On the CPU the stream time is the host time.
        assert s["stream_s"] == pytest.approx(s["host_s"])
        assert s["self_stream_s"] == pytest.approx(s["self_host_s"])


@pytest.mark.parametrize("case", [
    pytest.param(dict(topology=STAR), id="star"),
    pytest.param(dict(topology=THREE_LEVEL, timed=True, plastic=True),
                 id="three_level_timed_plastic"),
])
def test_outputs_under_the_profiler_equal_outputs_without(case, tmp_path):
    plain = _stream(**case)
    traced, _ = _profiled(lambda: _stream(**case), tmp_path)
    for a, b in zip(_flat(plain), _flat(traced), strict=True):
        assert torch.equal(a, b)


def test_a_span_used_as_a_decorator_records_per_call():
    @obs.span("test.stage")
    def stage(x):
        return x + 1

    assert stage(1) == 2
    with profile(activities=[ProfilerActivity.CPU]):
        stage(1)
        stage(2)
    assert obs.summary()["spans"]["test.stage"]["count"] == 2
    obs.reset()
    assert obs.summary() == {"spans": {}, "counters": {}}


def test_a_stage_nested_in_itself_records_each_entry():
    stage = obs.span("test.nest")
    with profile(activities=[ProfilerActivity.CPU]):
        with stage:
            with stage:
                time.sleep(0.01)
            time.sleep(0.01)
    got = obs.summary()["spans"]["test.nest"]
    assert got["count"] == 2
    # The outer entry's self time excludes the inner entry's, and neither
    # closed the other's span.
    assert got["host_s"] >= 0.03
    assert 0.01 <= got["self_host_s"] < got["host_s"]


@pytest.mark.parametrize("start_inside", [True, False],
                         ids=["profiler_starts_inside", "profiler_stops_inside"])
def test_an_exit_closes_only_what_its_entry_opened(start_inside):
    """A profiler that starts or stops inside an open stage leaves the
    outer entry's span, recorded or not, to the outer exit."""
    stage = obs.span("test.toggle")
    prof = profile(activities=[ProfilerActivity.CPU])
    if not start_inside:
        prof.start()
    with stage:
        if start_inside:
            prof.start()
        else:
            prof.stop()
        with stage:
            pass
        time.sleep(0.02)
    if start_inside:
        prof.stop()
    got = obs.summary()["spans"]["test.toggle"]
    assert got["count"] == 1
    if start_inside:
        assert got["host_s"] < 0.02       # only the inner entry recorded
    else:
        assert got["host_s"] >= 0.02      # the outer span closed at its exit


def test_engine_step_counts_the_bytes_it_brings_to_the_host():
    cfg, params, plan = _network(*THREE_LEVEL)
    window, slots = 4, 3
    eng = EmulationEngine(params, cfg, slots=slots, max_steps=8, plan=plan,
                          window=window, timed=True,
                          plasticity=STDPConfig(), device=CPU)
    rng = np.random.default_rng(7)
    for length in (4, 8, 6):
        eng.submit((rng.uniform(size=(length, cfg.chip.n_rows)) < 0.4)
                   .astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]):
        finished = eng.step()
    assert finished == 1                    # the 4-step session
    n, k, rows = cfg.n_chips, cfg.chip.n_neurons, cfg.chip.n_rows
    plane = window * n * slots
    account = (plane * k * 4                 # spikes, float32
               + 4 * plane * 4               # the four drop fields, int32
               + plane * cfg.capacity * (4 + 1))  # latencies and valid
    # A finished session's plasticity row: both traces and its weights.
    finalize = n * (rows + k + rows * k) * 4
    got = obs.summary()
    assert got["counters"] == {"engine.to_host_bytes": account + finalize}
    spans = got["spans"]
    assert spans["engine.step"]["count"] == 1
    assert spans["engine.gather"]["count"] == 1
    assert spans["engine.account"]["count"] == 1
    assert spans["engine.finalize"]["count"] == finished
    assert spans["stream.plasticity"]["count"] == window
    stages = sum(spans[n]["host_s"] for n in (
        "engine.gather", "engine.account", "engine.finalize",
        "stream.chip_step", "stream.plasticity", "stream.route"))
    assert stages <= spans["engine.step"]["host_s"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's hand-written kernels); "
                    "run on the card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_spans_take_the_streams_time(cuda_device):
    """On the card a span's stream time is its CUDA events': every stage
    of a timed plastic 3-level call has some, no parent has less than its
    children, the stages fit in the call's wall time, and the outputs
    equal an untraced call's bit for bit."""
    case = dict(topology=THREE_LEVEL, timed=True, plastic=True,
                device=cuda_device)
    plain = _stream(**case)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        traced = _stream(**case)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for a, b in zip(_flat(plain), _flat(traced), strict=True):
        assert torch.equal(a, b)
    spans = obs.summary()["spans"]
    for name in STREAM_SPANS:
        assert spans[name]["stream_s"] > 0, name
    route = spans["stream.route"]
    assert route["self_stream_s"] >= 0
    assert route["self_stream_s"] < route["stream_s"]
    stages = sum(spans[n]["stream_s"] for n in (
        "stream.chip_step", "stream.plasticity", "stream.route"))
    assert stages <= wall
