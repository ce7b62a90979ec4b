"""The port's sharded legacy surface against the reference's, bit for bit:
``StarInterconnect`` (the star and the two-layer hierarchy, with and
without the compact-before-gather caps, untimed and timed, ``exchange_fn``
and ``stream_fn``), ``star_exchange`` and ``hierarchical_exchange``, the
in-graph ``barrier`` and ``parallel.collectives``.

The port runs in one gloo group of 8 ranks (``parallel.spawn.run_ranks``);
the reference's ``StarInterconnect`` runs on 8 host devices in one JAX
subprocess at the same time (``sharded_cases.jax_oracle``), and its
stacked ``route_step`` / ``route_step_hierarchical`` run here.  Cases
mirror ``tests/test_multidevice.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_cases as sc
from repro.core import aggregator as jagg
from repro.core.events import EventFrame as JFrame
from repro.core.latency import timed_wire as jtimed
from repro.parallel import collectives as jcoll
from repro_torch import core as tcore
from repro_torch.core import aggregator as tagg
from repro_torch.core import sync as tsync
from repro_torch.core.events import EventFrame as TFrame
from repro_torch.parallel import collectives as tcoll
from repro_torch.parallel.spawn import run_ranks
from torch_threads import share_cores

share_cores()

SEED = 31
STREAMED = [name for name, case in sc.STAR_CASES.items() if case[4]]


@pytest.fixture(scope="module")
def inputs():
    return sc.star_inputs(SEED)


@pytest.fixture(scope="module")
def runs(inputs):
    """(per-rank results of the port, the reference's shard_map results),
    the ranks running while the oracle does."""
    with sc.jax_oracle("star", inputs) as oracle:
        ranks = run_ranks(sc.star_rank, sc.N_RANKS, inputs, timeout_s=300)
        return ranks, oracle()


def stacked(ranks, name, key="exchange"):
    return [np.stack([r[name][key][k] if key else r[name][k]
                      for r in ranks])
            for k in range(len(sc.OUT_FIELDS))]


def assert_fields(what, got, want):
    """The fields of ``sc.OUT_FIELDS`` that ``want`` has, exactly."""
    for name, g, w in zip(sc.OUT_FIELDS[:len(want)], got, want,
                          strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}: {name}")


def test_star_exchange_on_8_chips(runs):
    """All-to-all minus self: each chip receives 7 x 8 events, no drops."""
    ranks, ref = runs
    got = stacked(ranks, "star8")
    assert got[2].sum(axis=1).tolist() == [56] * sc.N_RANKS
    assert all(int(d.sum()) == 0 for d in got[3:])
    assert_fields("star8", got, ref["star8"]["exchange"])


@pytest.mark.parametrize("name", list(sc.STAR_CASES))
def test_star_interconnect_matches_shard_map(runs, name):
    ranks, ref = runs
    got = stacked(ranks, name)
    assert_fields(name, got, ref[name]["exchange"])
    assert got[2].sum() > 0


@pytest.mark.parametrize("name", STREAMED)
def test_stream_fn_matches_exchange_fn_and_reference(runs, name):
    ranks, ref = runs
    stream = stacked(ranks, name, "stream")               # [rank, T, ...]
    assert_fields(f"{name} stream against shard_map", stream,
                  [np.swapaxes(x, 0, 1) for x in ref[name]["stream"]])
    for t in range(sc.ROUNDS):
        rounds = [np.stack([r[name]["rounds"][t][k] for r in ranks])
                  for k in range(len(sc.OUT_FIELDS))]
        assert_fields(f"{name} round {t}", [x[:, t] for x in stream],
                      rounds)


def jax_stacked(inputs, name):
    """The reference's single-device twin of a StarInterconnect case on
    round 0: ``route_step`` (congestion only) or
    ``route_step_hierarchical``."""
    topo, kw, timed, tables, _ = sc.STAR_CASES[name]
    fwd = jnp.asarray(inputs[f"{tables}_fwd"])
    rev = jnp.asarray(inputs[f"{tables}_rev"])
    frame = JFrame(*(jnp.asarray(inputs[k][0])
                     for k in ("labels", "times", "valid")))
    timing = jtimed() if timed else None
    if topo == "hier":
        return jagg.route_step_hierarchical(
            jagg.RouterState(fwd, rev, None), frame, kw["capacity"],
            n_pods=2, intra_enables=jnp.asarray(inputs["intra_en"]),
            inter_enables=jnp.asarray(inputs["inter_en"]), timing=timing,
            link_capacity=kw.get("link_capacity"),
            pod_capacity=kw.get("pod_capacity"))
    en = jnp.asarray(inputs[sc.ENABLES[topo][0]])
    out, dropped = jagg.route_step(jagg.RouterState(fwd, rev, en), frame,
                                   kw["capacity"], timing=timing)
    return out, (dropped,)


@pytest.mark.parametrize("name", ["star", "star_timed", "hier", "hier_caps",
                                  "hier_timed", "hier_caps_timed"])
def test_matches_stacked_route_steps(runs, inputs, name):
    ranks, _ = runs
    got = stacked(ranks, name)
    out, drops = jax_stacked(inputs, name)
    want = [np.asarray(x) for x in (*out, *drops)]
    assert_fields(name, got[:len(want)], want)


def test_direct_wrappers_match_the_interconnect(runs, inputs):
    """``star_exchange`` and ``hierarchical_exchange`` called directly
    equal ``StarInterconnect``'s round and the reference's."""
    ranks, ref = runs
    assert_fields("star_exchange", stacked(ranks, "star_exchange", None),
                  ref["star_link"]["exchange"])
    assert_fields("hierarchical_exchange",
                  stacked(ranks, "hierarchical_exchange", None),
                  ref["hier_caps_timed"]["exchange"])


def test_barrier(runs):
    """True on all ranks iff all of the axis were ready: the whole star,
    each pod on the hierarchy's chip axis, each chip column on its pod
    axis."""
    ranks, _ = runs
    for rank, r in enumerate(ranks):
        pod, chip = divmod(rank, sc.N_RANKS // 2)
        assert r["barrier"] == [True, False, pod != 0, chip != 3, True], rank


def test_hierarchical_psum_equals_flat_and_reference(runs):
    """Reduce-scatter in the pod, all-reduce across pods, all-gather in
    the pod equals a flat all-reduce, exactly on integer-valued floats (3
    rows take the non-divisible branch), and equals the reference's
    schedule under ``shard_map`` on the same blocks."""
    ranks, ref = runs
    x = sc.star_inputs(SEED)["psum_x"]
    for rank, r in enumerate(ranks):
        p = r["psum"]
        np.testing.assert_array_equal(p["hier"], p["flat"])
        np.testing.assert_array_equal(p["hier"], x.sum(axis=0))
        np.testing.assert_array_equal(p["hier_odd"], p["flat_odd"])
        np.testing.assert_array_equal(p["no_pod"], p["pod_only"])
        np.testing.assert_array_equal(p["mean"], p["flat"] / sc.N_RANKS)
        for key in ("hier", "hier_odd", "no_pod", "mean"):
            np.testing.assert_array_equal(p[key], ref["psum"][key][rank],
                                          err_msg=f"{key}, rank {rank}")


def test_cross_pod_bytes_matches_reference():
    for nbytes, data in ((4096, 4), (100, 8), (7, 2)):
        assert (tcoll.cross_pod_bytes(nbytes, data)
                == jcoll.cross_pod_bytes(nbytes, data))


def test_pod_capacity_needs_a_pod_axis():
    for mod in (jagg, tagg):
        ic = mod.StarInterconnect(None, "chip", pod_capacity=8)
        with pytest.raises(ValueError, match="pod_capacity requires a "
                                             "pod_axis"):
            ic.exchange_fn()


def test_link_config_sets_the_link_capacity():
    from repro_torch.core.link import LinkConfig

    ic = tagg.StarInterconnect(None, "chip",
                               link=LinkConfig(link_capacity=5))
    assert ic._link_capacity() == 5
    assert tagg.StarInterconnect(None, "chip", link_capacity=3,
                                 link=LinkConfig(link_capacity=5)
                                 )._link_capacity() == 3


def test_one_rank_barrier_and_frame_dims():
    from torch.distributed.device_mesh import init_device_mesh

    with sc.single_rank_group():
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("chip",))
        got = tsync.barrier(torch.tensor(True), "chip", mesh)
        assert got.dtype == torch.bool and bool(got)
        ready = torch.tensor(0, dtype=torch.int32)
        assert not bool(tsync.barrier(ready, "chip", mesh))
        assert int(ready) == 0                      # the input is untouched
        ic = tagg.StarInterconnect(mesh, "chip", capacity=4)
        fwd, rev = (torch.from_numpy(x[0]) for x in sc.identity_luts(1))
        frame = TFrame(torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32),
                       torch.ones(2, dtype=torch.bool))
        en = torch.ones((1, 1), dtype=torch.bool)
        out, drops = ic.exchange_fn()(frame, fwd, rev, en)
        assert out.valid.sum() == 2 and out.labels.shape == (4,)
        with pytest.raises(ValueError, match="stream_fn takes"):
            ic.stream_fn()(frame, fwd, rev, en)


def test_core_exports_the_sharded_legacy_surface():
    for name in ("star_exchange", "hierarchical_exchange",
                 "StarInterconnect"):
        assert getattr(tcore, name) is getattr(tagg, name)
    assert tcore.barrier is tsync.barrier


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the merge_pack kernel); run on the "
                    "card with -m cuda")
    return torch.device("cuda")


def card_rank(rank: int, world: int, inputs: dict) -> list:
    """The timed capped hierarchy's round on the card (gloo ranks sharing
    cuda:0, the wire through the host) and on the CPU, and a barrier on
    the card."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.latency import timed_wire

    hier = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("pod", "chip"))
    outs = []
    for dev in ("cpu", "cuda"):
        ic = tagg.StarInterconnect(hier, "chip", pod_axis="pod", capacity=24,
                                   link_capacity=6, pod_capacity=20,
                                   timing=timed_wire())
        out, drops = ic.exchange_fn()(
            TFrame(*(x.to(dev) for x in sc._frame(inputs, rank))),
            torch.from_numpy(inputs["fwd"][rank]).to(dev),
            torch.from_numpy(inputs["rev"][rank]).to(dev),
            torch.from_numpy(inputs["intra_en"]).to(dev),
            torch.from_numpy(inputs["inter_en"]).to(dev))
        outs.append([x.cpu().numpy() for x in (*out, *drops)])
    ready = torch.tensor(rank != 3, device="cuda")
    outs.append(bool(tsync.barrier(ready, "chip", hier).cpu()))
    return outs


@pytest.mark.cuda
def test_sharded_hierarchy_card_matches_cpu(cuda_device, inputs):
    ranks = run_ranks(card_rank, sc.N_RANKS, inputs, timeout_s=300)
    for rank, (cpu, card, released) in enumerate(ranks):
        assert_fields(f"rank {rank} card against CPU", card, cpu)
        assert released == (rank >= sc.N_RANKS // 2)
