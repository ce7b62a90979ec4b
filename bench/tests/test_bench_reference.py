"""The plain reference against the port at a tiny size on the CPU: each
cell's path (the star's exchange, the 3-level timed fabric, the dense
route, per-session STDP) agrees with what the port computes."""

import copy

import pytest
import torch
from torch_threads import share_cores

from bench.lib import inputs, program, spec
from bench.reference import snn as ref
from bench.tests import tiny
from repro_torch.core.latency import timed_wire
from repro_torch.snn import network as netlib
from repro_torch.snn import plasticity as plas
from repro_torch.snn import stream as stlib

share_cores()
CPU = torch.device("cpu")


def _setup(config_name: str, traffic_name: str = "sweep"):
    config, _ = tiny.shrink(spec.config(config_name),
                            spec.traffic(traffic_name))
    gen = inputs.generator(7, CPU)
    w, sign, scale = inputs.chip_params(config, gen, CPU)
    cfg, params, plan = program.build(config, w, sign, scale, device=CPU)
    return config, cfg, params, plan, ref.Net(config, w, sign, scale)


def _spikes(n: int, batch: int, p: float, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, batch, 512), generator=g) < p


@pytest.mark.parametrize("config_name,timed,p", [
    ("full_backplane", False, 0.05), ("full_backplane", False, 0.4),
    ("ext_4case_96chip", True, 0.05), ("ext_4case_96chip", True, 0.4),
    ("ext_4case_96chip", False, 0.2)])
def test_fabric_route_matches_the_port(config_name, timed, p):
    config, cfg, params, plan, net = _setup(config_name)
    spikes = _spikes(config["chips"], 6, p, seed=3)
    timing = timed_wire(cfg.latency) if timed else None
    drives, dropped, uplink, lat, lat_valid, *_ = stlib.exchange_spikes(
        params, spikes.float(), cfg, plan, timing)
    r = net.fabric.route(spikes.transpose(0, 1), timed)
    assert torch.equal(r["drive"].transpose(0, 1), drives)
    assert torch.equal(r["dropped"].transpose(0, 1), dropped.long())
    assert torch.equal(r["uplink"].transpose(0, 1), uplink.long())
    assert int(dropped.sum()) > 0 or p < 0.1
    if timed:
        assert torch.equal(r["lat_valid"].transpose(0, 1), lat_valid)
        assert torch.equal(r["lat"].transpose(0, 1), lat.long())
        assert int(lat_valid.sum()) > 0


def test_dense_route_matches_the_ports_routing_matrices():
    config, cfg, params, _, net = _setup("full_backplane")
    spikes = _spikes(config["chips"], 5, 0.3, seed=4)
    mats = netlib.routing_matrices(params, cfg)
    want = stlib.route_dense(spikes.float(), stlib.dense_layout(mats))
    got = net.fabric.dense_route(spikes.transpose(0, 1)).transpose(0, 1)
    assert torch.equal(got, want)


def test_stdp_step_equals_the_ports_slot_step_bit_for_bit():
    config, cfg, params, _, net = _setup("ext_4case_96chip", "tenants")
    traffic = spec.traffic("tenants")
    n, b = config["chips"], 3
    g = torch.Generator().manual_seed(5)
    state = netlib.init_slot_plasticity(params, b)
    mine = tuple(x.clone() for x in state)
    stdp = ref.STDP(**traffic["plasticity"])
    for _ in range(4):
        pre = (torch.rand((n, b, 256), generator=g) < 0.3).float() * 2
        post = (torch.rand((n, b, 512), generator=g) < 0.1).float()
        state = plas.stdp_slot_step(state, pre, post,
                                    program.stdp_config(traffic))
        mine = ref.stdp_step(*mine, pre, post, stdp, net.wmax)
    for a, c in zip(state, mine):
        assert torch.equal(a, c)


def test_follow_the_ports_own_stream_finds_no_disagreement():
    config, cfg, params, plan, net = _setup("ext_4case_96chip")
    gen = inputs.generator(9, CPU)
    drives = inputs.drives(config, 12, 2, 0.2, gen, CPU)
    out = stlib.run_stream(params, netlib.init_state(cfg, 2, device=CPU),
                           drives, cfg, fabric=plan, timed=True, device=CPU)
    assert int(out.spikes.sum()) > 0
    spikes = out.spikes > 0.5
    f = ref.follow(net, 12, lambda a, b: spikes[a:b],
                   lambda a, b: drives[a:b], timed=True, chunk=5)
    assert f.disagreements == 0
    assert torch.equal(f.routed["dropped"], out.dropped.long())
    lat = torch.where(out.latency_valid, out.latency_ns, 0).sum(-1)
    assert torch.equal(f.routed["lat_sum"], lat.long())
    assert float((f.state["v"] - out.state.chips.neurons.v).abs().max()) < 1e-5


def test_tf32_rounds_to_a_ten_bit_mantissa():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    assert ref.tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0,
                                    1.0 + 2 ** -9, -3.0]


def test_free_running_reference_in_float32_equals_the_port():
    config, cfg, params, plan, net = _setup("full_backplane")
    gen = inputs.generator(10, CPU)
    drives = inputs.drives(config, 10, 3, 0.2, gen, CPU)
    out = stlib.run_stream(params, netlib.init_state(cfg, 3, device=CPU),
                           drives, cfg, fabric=plan, device=CPU)
    mine, _, _ = ref.stream(net, ref.init_state(net, 3, CPU),
                            copy.deepcopy(drives), precision="float32")
    assert torch.equal(mine["spikes"], out.spikes)
    assert torch.equal(mine["dropped"].int(), out.dropped)
