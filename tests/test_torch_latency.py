"""The port's latency model (Fig 5) and topology against the JAX package.

Every comparison here is exact.  ``queue_wait_ns``, ``hop_delays`` and the
Lindley recursion round as the reference does (float32, one rounding per
operation, in its order).  ``simulate_fan_in`` runs on the reference's own
random draws: ``reference_draws`` reproduces its key splits with
``jax.random`` and hands the numbers to the port as ``FanInDraws``, so
both packages simulate the same spikes, and every latency must be the
same multiple of 8 ns.  The Fig 5 properties of the reference's battery
(``tests/test_latency_model.py``) are also held on the port's own draws
from a ``torch.Generator``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import interconnect as jic
from repro.core import latency as jlat
from repro_torch.core import interconnect as tic
from repro_torch.core import latency as tlat
from torch_threads import share_cores

share_cores()

RATES_HZ = (1e6, 5e6, 10e6, 25e6, 50e6, 70e6, 80e6, 83.3e6)
# Reduced from the paper's 2^15 (chip_smoke.py phase 11 runs 2^15 on the
# card against the CPU).
N_SPIKES = 2 ** 12
KEY = jax.random.key(21)


def reference_draws(key, rate_hz, n_spikes, fan_in=3, level="chip"):
    """The phase offsets and jitter planes ``repro.core.latency.
    simulate_fan_in`` draws from ``key``, as the port's ``FanInDraws``."""
    k_phase, k_cdc, _ = jax.random.split(key, 3)
    offsets = jax.random.uniform(k_phase, (fan_in,), minval=0.0,
                                 maxval=1e9 / rate_hz)
    n_cross = 4 if level == "fpga" else 6
    keys = jax.random.split(k_cdc, n_cross)
    planes = [jax.random.uniform(
        keys[i], (n_spikes,),
        maxval=jlat.SYSTEM_CLOCK_NS if i % 2 == 0 else jlat.MGT_CLOCK_NS)
        for i in range(n_cross)]
    return tlat.FanInDraws(offsets=torch.tensor(np.array(offsets)),
                           jitter=torch.tensor(np.stack(planes)))


def test_constants_match():
    assert tlat.PAPER_BAND_NS == jlat.PAPER_BAND_NS
    assert tlat.PAPER_JITTER_FRAC == jlat.PAPER_JITTER_FRAC
    assert tlat.TAU_MEM_BIO_MS == jlat.TAU_MEM_BIO_MS
    assert tlat.DEFAULT_SPEEDUP == jlat.DEFAULT_SPEEDUP
    assert tlat.SYSTEM_CLOCK_NS == jlat.SYSTEM_CLOCK_NS
    assert tlat.MGT_CLOCK_NS == jlat.MGT_CLOCK_NS


# ---------------------------------------------------------------------------
# Per-hop queueing terms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("service,cc,stall", [
    (jlat.MGT_CLOCK_NS, 0, 0.0), (jlat.MGT_CLOCK_NS, 1250, 8.0),
    (0.0, 1250, 8.0), (3.3, 7, 2.7)])
def test_queue_wait_ns_matches(service, cc, stall):
    rng = np.random.default_rng(cc)
    ranks = rng.integers(-20, 40_000, (6, 50)).astype(np.int32)
    ranks[0, :12] = np.arange(12) * max(cc, 1)       # multiples of cc
    ref = jlat.queue_wait_ns(jnp.asarray(ranks), service, cc_interval=cc,
                             cc_stall_ns=stall)
    got = tlat.queue_wait_ns(torch.from_numpy(ranks), service,
                             cc_interval=cc, cc_stall_ns=stall)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # Scalars and Python ints, as the reference takes them.
    assert float(tlat.queue_wait_ns(7, service, cc_interval=cc,
                                    cc_stall_ns=stall)) == float(
        jlat.queue_wait_ns(7, service, cc_interval=cc, cc_stall_ns=stall))


@pytest.mark.parametrize("params", [
    tlat.DEFAULT_PARAMS, tlat.LatencyParams(cc_interval=5, cc_stall_ns=12.0)])
def test_hop_delays_match_and_total_is_queue_wait_i32(params):
    jparams = jlat.LatencyParams(cc_interval=params.cc_interval,
                                 cc_stall_ns=params.cc_stall_ns)
    ranks = np.arange(0, 3 * params.cc_interval + 7, dtype=np.int32)
    ref = jlat.hop_delays(jparams, jnp.asarray(ranks))
    got = tlat.hop_delays(params, torch.from_numpy(ranks))
    for field in tlat.HopDelays._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(got.total_ns.numpy(),
                                  np.asarray(ref.total_ns))
    # On integer ranks the float model equals the int32 lane's destination
    # wait (reference latency.py, queue_wait_i32 and TimedWire.queue).
    lane = tlat.queue_wait_i32(torch.from_numpy(ranks),
                               tlat.timed_wire(params).queue)
    np.testing.assert_array_equal(got.total_ns.numpy(),
                                  lane.numpy().astype(np.float32))


@pytest.mark.parametrize("case", ["ties", "stalls", "zeros", "unsorted"])
def test_lindley_queue_matches(case):
    rng = np.random.default_rng(len(case))
    n, cc, stall = 3000, 0, 0.0
    if case == "ties":            # integer ns: many equal arrival times
        arrivals = np.sort(rng.integers(0, 6000, n)).astype(np.float32)
    elif case == "stalls":        # saturated: every compensation pause shows
        arrivals = np.sort(rng.uniform(0, 4.0 * n, n)).astype(np.float32)
        cc, stall = 250, 8.0
    elif case == "zeros":         # one window of simultaneous arrivals
        arrivals = np.zeros(n, np.float32)
        cc, stall = jlat.DEFAULT_PARAMS.cc_interval, 8.0
    else:                         # as depart_mux may be: not sorted
        arrivals = (np.arange(n) * 3.7 + rng.uniform(0, 40, n)).astype(
            np.float32)
        cc, stall = 300, 8.0
    ref = jlat._lindley_queue(jnp.asarray(arrivals), jlat.MGT_CLOCK_NS, cc,
                              stall)
    got = tlat._lindley_queue(torch.from_numpy(arrivals), tlat.MGT_CLOCK_NS,
                              cc, stall)
    assert got.dtype == torch.float32 and float(got.max()) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if case == "zeros":           # the closed form of one window
        np.testing.assert_array_equal(got.numpy(), tlat.hop_delays(
            tlat.DEFAULT_PARAMS, torch.arange(n)).mux_ns.numpy())


@pytest.mark.parametrize("n", [1, 2, 7, 4096, 32768])
def test_percentile_linear_matches_jnp(n):
    rng = np.random.default_rng(n)
    x = (rng.gamma(2.0, 30.0, n) * rng.choice([1.0, 0.5], n)).astype(
        np.float32)
    for q in (30.0, 1.0, 99.0, 50.0):
        ref = np.asarray(jnp.percentile(jnp.asarray(x), q))
        got = tlat._percentile_linear(torch.from_numpy(x), q)
        assert got.dtype == torch.float32
        assert got.numpy() == ref, (q, got.numpy(), ref)


# ---------------------------------------------------------------------------
# The Fig 5A simulator on the reference's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", ["fpga", "chip"])
@pytest.mark.parametrize("rate_hz", RATES_HZ)
def test_simulate_fan_in_matches_on_reference_draws(rate_hz, level):
    key = jax.random.fold_in(KEY, int(rate_hz))
    ref = np.asarray(jlat.simulate_fan_in(rate_hz, N_SPIKES, key, fan_in=3,
                                          level=level))
    got = tlat.simulate_fan_in(
        rate_hz, N_SPIKES, fan_in=3, level=level, device="cpu",
        draws=reference_draws(key, rate_hz, N_SPIKES, 3, level))
    assert got.shape == (N_SPIKES,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("fan_in,n_spikes", [(1, 1000), (4, 999), (5, 1)])
def test_simulate_fan_in_matches_other_fan_ins(fan_in, n_spikes):
    key = jax.random.fold_in(KEY, fan_in)
    params = jlat.LatencyParams(cc_interval=40)
    ref = np.asarray(jlat.simulate_fan_in(70e6, n_spikes, key, fan_in,
                                          params))
    got = tlat.simulate_fan_in(
        70e6, n_spikes, None, fan_in, tlat.LatencyParams(cc_interval=40),
        device="cpu", draws=reference_draws(key, 70e6, n_spikes, fan_in))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_simulate_fan_in_draws_from_a_generator():
    def run(seed, level="chip"):
        return tlat.simulate_fan_in(
            25e6, 1024, torch.Generator().manual_seed(seed), level=level,
            device="cpu")

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool((torch.remainder(a, tlat.SYSTEM_CLOCK_NS) == 0).all())
    draws = tlat.fan_in_draws(25e6, 1024, torch.Generator().manual_seed(0),
                              level="fpga")
    assert draws.offsets.shape == (3,) and draws.jitter.shape == (4, 1024)
    assert float(draws.offsets.max()) < 1e9 / 25e6
    assert float(draws.jitter[0].max()) < 8.0
    assert float(draws.jitter[1].max()) < 4.0
    assert torch.equal(run(0, "fpga"), tlat.simulate_fan_in(
        25e6, 1024, level="fpga", draws=draws, device="cpu"))
    with pytest.raises(ValueError, match="generator or draws"):
        tlat.simulate_fan_in(25e6, 1024, device="cpu")


def _port_chip_lats(rate_hz, n_spikes):
    return tlat.simulate_fan_in(
        rate_hz, n_spikes, torch.Generator().manual_seed(int(rate_hz)),
        fan_in=3, level="chip", device="cpu")


@pytest.mark.parametrize("rate_hz", RATES_HZ)
def test_port_chip_level_median_in_paper_band(rate_hz):
    """The reference battery's band check on the port's own draws."""
    lats = _port_chip_lats(rate_hz, N_SPIKES)
    med = tlat.latency_statistics(lats)["median_ns"]
    lo, hi = tlat.PAPER_BAND_NS
    assert lo <= med <= hi, med


def test_port_medians_monotone_and_worst_jitter():
    meds = [tlat.latency_statistics(_port_chip_lats(r, N_SPIKES))[
        "median_ns"] for r in RATES_HZ]
    for lo, hi in zip(meds, meds[1:]):
        assert hi >= lo - tlat.SYSTEM_CLOCK_NS, meds
    stats = tlat.latency_statistics(_port_chip_lats(83.3e6, 2 ** 15))
    assert (0.66 * tlat.PAPER_JITTER_FRAC <= stats["jitter_frac"]
            <= 1.66 * tlat.PAPER_JITTER_FRAC), stats


def test_simulate_fan_in_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlat.simulate_fan_in(1e6, 16, torch.Generator())


# ---------------------------------------------------------------------------
# Fig 5B and the topology
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("speedup,hw", [(1000.0, None), (1.0, 1500.0),
                                        (np.array([1.0, 10.0, 1e3, 1e4]),
                                         None), (7, 950.0)])
def test_biological_latency_ms_matches(speedup, hw):
    ref = np.asarray(jlat.biological_latency_ms(speedup, hw))
    got = tlat.biological_latency_ms(speedup, hw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


TOPOLOGIES = ("PROTOTYPE_4CHIP", "FULL_BACKPLANE", "FULL_RACK",
              "PROJECTED_120CHIP")


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_topology_matches(name):
    ref, got = getattr(jic, name), getattr(tic, name)
    assert (got.n_chips, got.chips_per_backplane, got.second_layer) == (
        ref.n_chips, ref.chips_per_backplane, ref.second_layer)
    for prop in ("n_backplanes", "n_neurons", "n_synapses"):
        assert getattr(got, prop) == getattr(ref, prop), prop
    params = tlat.LatencyParams(l2_link_ns=150.0)
    jparams = jlat.LatencyParams(l2_link_ns=150.0)
    for src, dst in itertools.product(range(ref.n_chips), repeat=2):
        assert got.backplane_of(src) == ref.backplane_of(src)
        assert (got.transceiver_hops(src, dst)
                == ref.transceiver_hops(src, dst))
        assert got.fpgas_traversed(src, dst) == ref.fpgas_traversed(src, dst)
        assert (got.chip_to_chip_latency_ns(src, dst)
                == ref.chip_to_chip_latency_ns(src, dst))
        assert (got.chip_to_chip_latency_ns(src, dst, params)
                == ref.chip_to_chip_latency_ns(src, dst, jparams))


@pytest.mark.parametrize("kwargs", [dict(n_chips=13),
                                    dict(n_chips=121, second_layer=True),
                                    dict(n_chips=9, chips_per_backplane=4)])
def test_topology_errors_match(kwargs):
    with pytest.raises(ValueError) as ref:
        jic.Topology(**kwargs)
    with pytest.raises(ValueError) as got:
        tic.Topology(**kwargs)
    assert str(got.value) == str(ref.value)
