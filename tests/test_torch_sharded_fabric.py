"""The port's sharded fabric executor (``repro_torch.core.fabric``:
``fabric_exchange`` and ``FabricInterconnect`` on ``torch.distributed``)
against the reference's ``shard_map`` executor, bit for bit.

The port runs in one gloo group of 8 ranks (``parallel.spawn.run_ranks``,
file rendezvous), each rank with its own leaf's frame and tables; the
reference runs ``FabricInterconnect`` on 8 host devices in one JAX
subprocess at the same time (``sharded_cases.jax_oracle``), and the JAX and
torch stacked ``fabric_route_step`` run here.  The cases mirror
``tests/test_multidevice.py``: 3-level (2, 2, 2) plans with and without
cascaded caps, a 2 x 4 plan whose top level prunes route-disabled pairs,
degraded plans (detour, exhausted, mixed) and health overlays, gather and
routed, untimed and timed; labels, valid, times and all four
``ExchangeDrops`` fields compared exactly on every rank.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_cases as sc
from repro.analysis import scenarios as jscen
from repro.core import fabric as jfab
from repro.core.aggregator import RouterState as JRouterState
from repro.core.events import EventFrame as JFrame
from repro.core.latency import timed_wire as jtimed
from repro.parallel import sharding as jshard
from repro_torch import core as tcore
from repro_torch.analysis import scenarios as tscen
from repro_torch.core import fabric as tfab
from repro_torch.core.aggregator import RouterState as TRouterState
from repro_torch.core.events import EventFrame as TFrame
from repro_torch.core.latency import timed_wire as ttimed
from repro_torch.parallel import sharding as tshard
from repro_torch.parallel.spawn import run_ranks
from torch_threads import share_cores

share_cores()

SEED = 24
CASES = sc.fabric_cases()
IDS = [sc.case_id(c) for c in CASES]
STREAMED_IDS = [sc.case_id(c) for c in sc.STREAMED]


@pytest.fixture(scope="module")
def inputs():
    return sc.make_inputs(SEED)


@pytest.fixture(scope="module")
def runs(inputs):
    """(per-rank results of the port, the reference's shard_map results,
    both stacked executors' results by case): the ranks and the stacked
    executors run while the oracle does."""
    with sc.jax_oracle("fabric", inputs) as oracle:
        ranks = run_ranks(sc.fabric_rank, sc.N_RANKS, inputs, timeout_s=300)
        stacked = {case: stacked_refs(inputs, case) for case in CASES}
        return ranks, oracle(), stacked


def stacked_ranks(ranks, case, key="exchange"):
    """The ranks' outputs of one case stacked leaf-major: one array per
    field of ``sc.OUT_FIELDS``."""
    return [np.stack([r[case][key][k] for r in ranks])
            for k in range(len(sc.OUT_FIELDS))]


def assert_fields(what, got, want):
    for name, g, w in zip(sc.OUT_FIELDS, got, want, strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}: {name}")


def stacked_refs(inputs, case):
    """The JAX and the torch stacked ``fabric_route_step`` on round 0."""
    base, mode, timed = case
    jplan = sc.build_plan(jfab, base, mode)
    jout = jfab.fabric_route_step(
        JRouterState(jnp.asarray(inputs["fwd"]), jnp.asarray(inputs["rev"]),
                     None),
        JFrame(*(jnp.asarray(inputs[k][0]) for k in ("labels", "times",
                                                     "valid"))),
        jplan, timing=jtimed() if timed else None,
        health=sc.build_health(jfab, jplan, base, jnp.asarray))
    tplan = sc.build_plan(tfab, base, mode)
    tout = tfab.fabric_route_step(
        TRouterState(torch.from_numpy(inputs["fwd"]),
                     torch.from_numpy(inputs["rev"]), None),
        TFrame(*(torch.from_numpy(inputs[k][0]) for k in ("labels", "times",
                                                          "valid"))),
        tplan, timing=ttimed() if timed else None,
        health=sc.build_health(tfab, tplan, base, torch.from_numpy))
    return ([np.asarray(x) for x in (*jout[0], *jout[1])],
            [x.numpy() for x in (*tout[0], *tout[1])])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_exchange_matches_shard_map(runs, case):
    ranks, ref, _ = runs
    got = stacked_ranks(ranks, case)
    assert_fields(sc.case_id(case), got, ref[case]["exchange"])
    # Every case moves events and most lose some somewhere.
    assert got[2].sum() > 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_exchange_matches_stacked_executors(runs, case):
    ranks, _, stacked = runs
    got = stacked_ranks(ranks, case)
    jax_stacked, torch_stacked = stacked[case]
    assert_fields(f"{sc.case_id(case)} against JAX stacked", got,
                  jax_stacked)
    assert_fields(f"{sc.case_id(case)} against torch stacked", got,
                  torch_stacked)


def test_cases_reach_every_drop_point(runs):
    """The battery loses events at every drop point and reroutes some."""
    ranks = runs[0]
    totals = np.zeros(4, np.int64)
    for case in CASES:
        totals += [a.sum() for a in stacked_ranks(ranks, case)[3:]]
    assert (totals > 0).all(), dict(zip(sc.DROP_FIELDS, totals))


@pytest.mark.parametrize("case", sc.STREAMED, ids=STREAMED_IDS)
def test_stream_fn_matches_exchange_fn_and_reference(runs, case):
    ranks, ref, _ = runs
    stream = stacked_ranks(ranks, case, "stream")          # [rank, T, ...]
    assert_fields(f"{sc.case_id(case)} stream against shard_map", stream,
                  [np.swapaxes(x, 0, 1) for x in ref[case]["stream"]])
    for t in range(sc.ROUNDS):
        rounds = [np.stack([r[case]["rounds"][t][k] for r in ranks])
                  for k in range(len(sc.OUT_FIELDS))]
        assert_fields(f"{sc.case_id(case)} round {t}",
                      [x[:, t] for x in stream], rounds)
    # Round 0 of the stream is exchange_fn's round.
    assert_fields(sc.case_id(case), [x[:, 0] for x in stream],
                  stacked_ranks(ranks, case))


def expected_wire(plan, rank: int, timed: bool, cap_in: int) -> dict:
    """What one round posts from ``rank``: the gathers, or the sends and
    receives of the routed schedule (pruned pairs post nothing), and the
    bytes it receives, from the plan alone."""
    planes = 2 if timed else 1
    want = dict(gathers=0, gather_bytes=0, sends=0, recvs=0, p2p_bytes=0)
    stride = 1
    for i, (lvl, seg) in enumerate(zip(plan.levels,
                                       plan.merge_layout(cap_in))):
        f = lvl.fan_in
        row = sum(seg) // f                 # one slot's stream, in events
        me = (rank // stride) % f
        stride *= f
        if plan.exchange_mode == "gather":
            want["gathers"] += planes
            want["gather_bytes"] += (f - 1) * row * (2 + 4 * timed)
            continue
        perms = tshard.edge_neighbor_permutes(
            lvl.enables, prune=i + 1 == plan.n_levels)
        for r, perm in enumerate(perms, start=1):
            want["sends"] += planes * ((me, (me + r) % f) in perm)
            recv = ((me - r) % f, me) in perm
            want["recvs"] += planes * recv
            want["p2p_bytes"] += recv * row * (2 + 4 * timed)
    return want


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wire_calls_and_bytes_follow_the_plan(runs, case):
    """Routed rounds make no gather call and post exactly the routed
    schedule's sends and receives (none for pruned pairs); gather rounds
    make one all-gather per level and plane and no send."""
    ranks = runs[0]
    base, mode, timed = case
    plan = sc.build_plan(tfab, base, mode)
    for rank, r in enumerate(ranks):
        assert r[case]["wire"] == expected_wire(plan, rank, timed,
                                                sc.CAP_IN), (case, rank)
    if mode == "routed":
        assert all(r[case]["wire"]["gathers"] == 0 for r in ranks)


def test_pruned_pairs_post_nothing(runs):
    """The 2 x 4 plan's top level enables pod j → j + 1 only: rotations 2
    and 3 are pruned, so each rank sends and receives one top-level plane
    per wire lane instead of three (level 0 keeps its one rotation)."""
    ranks = runs[0]
    for timed in (False, True):
        planes = 2 if timed else 1
        case = ("pruned", "routed", timed)
        for r in ranks:
            assert r[case]["wire"]["sends"] == 2 * planes
            assert r[case]["wire"]["recvs"] == 2 * planes
        gather = ("pruned", "gather", timed)
        assert all(r[gather]["wire"]["gathers"] == 2 * planes for r in ranks)


def test_leaf_index_is_the_rank(runs):
    ranks = runs[0]
    for rank, r in enumerate(ranks):
        leaf, coords, group_ranks = r["leaf"]
        assert leaf == rank
        assert coords == [rank % 2, rank // 2 % 2, rank // 4]
        assert group_ranks == coords
        # A mesh with level 0 outermost puts leaf a + 2b + 4c at rank
        # 4a + 2b + c: only ranks with a == c agree, the rest raise.
        agrees = rank % 2 == rank // 4
        assert (r["wrong_order"] is None) == agrees, (rank, r["wrong_order"])
        if not agrees:
            assert "innermost" in r["wrong_order"]


def catalogue_plans():
    for name, fan_ins, cap_in, cap in tscen.CASES:
        yield name, fan_ins


@pytest.mark.parametrize("name,fan_ins", list(catalogue_plans()))
def test_edge_neighbor_permutes_matches_reference(name, fan_ins):
    rng = np.random.default_rng(len(fan_ins))
    for f in fan_ins:
        for en in (np.ones((f, f), bool), ~np.eye(f, dtype=bool),
                   rng.random((f, f)) < 0.5):
            for prune in (False, True):
                assert (tshard.edge_neighbor_permutes(en, prune=prune)
                        == jshard.edge_neighbor_permutes(en, prune=prune))
    # The scenario's own plans, every level, as the executors prune them.
    jplan = jscen.plan_for(fan_ins, 8, (None,) * len(fan_ins))
    tplan = tscen.plan_for(fan_ins, 8, (None,) * len(fan_ins))
    for i, (jl, tl) in enumerate(zip(jplan.levels, tplan.levels)):
        top = i + 1 == len(fan_ins)
        assert (tshard.edge_neighbor_permutes(tl.enables, prune=top)
                == jshard.edge_neighbor_permutes(np.asarray(jl.enables),
                                                 prune=top))
    with pytest.raises(ValueError, match="square"):
        tshard.edge_neighbor_permutes(np.ones((2, 3), bool), prune=False)


@pytest.fixture
def one_rank():
    with sc.single_rank_group():
        yield


def one_leaf_plan(levels=3, mode="gather"):
    return tfab.compile_fabric(tfab.FabricSpec(
        levels=tuple(tfab.LevelSpec(1) for _ in range(levels)), capacity=4,
        exchange_mode=mode))


def test_fabric_axis_names_and_mesh(one_rank):
    plan = one_leaf_plan()
    assert tshard.fabric_axis_names(plan) == jshard.fabric_axis_names(plan)
    mesh = tshard.fabric_mesh(plan, device_type="cpu")
    assert mesh.mesh_dim_names == ("fab2", "fab1", "fab0")
    assert tuple(mesh.mesh.shape) == (1, 1, 1)
    assert tshard.fabric_leaf_index(mesh, plan.fan_ins) == 0


def test_one_leaf_round_keeps_its_own_events(one_rank):
    """A 1-leaf fabric gathers only its own stream, which level 0's
    enables (no self-loops) gate off: everything it sends is lost to no
    one and nothing arrives, in both modes and in a stream."""
    for mode in ("gather", "routed"):
        plan = one_leaf_plan(1, mode)
        mesh = tshard.fabric_mesh(plan, device_type="cpu")
        ic = tfab.FabricInterconnect(mesh, plan)
        fwd, rev = (torch.from_numpy(x[0]) for x in sc.identity_luts(1))
        frame = TFrame(torch.arange(3, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32),
                       torch.ones(3, dtype=torch.bool))
        out, drops = ic.exchange_fn()(frame, fwd, rev)
        assert out.labels.shape == (4,) and not out.valid.any()
        assert all(d.shape == () and int(d) == 0 for d in drops)
        out, drops = ic.stream_fn()(TFrame(*(x[None].expand(2, 3)
                                             for x in frame)), fwd, rev)
        assert out.labels.shape == (2, 4) and drops.congestion.shape == (2,)


def test_value_errors(one_rank):
    plan = one_leaf_plan()
    mesh = tshard.fabric_mesh(plan, device_type="cpu")
    fwd, rev = (torch.from_numpy(x[0]) for x in sc.identity_luts(1))
    frame = TFrame(torch.zeros(3, dtype=torch.int32),
                   torch.zeros(3, dtype=torch.int32),
                   torch.ones(3, dtype=torch.bool))
    # The reference's two: the axis count and an axis size against fan_in.
    with pytest.raises(ValueError, match="2 mesh axes for 3 fabric levels"):
        tfab.FabricInterconnect(mesh, plan,
                                axis_names=("fab0", "fab1")).exchange_fn()
    wide = tfab.compile_fabric(tfab.FabricSpec(
        levels=(tfab.LevelSpec(2), tfab.LevelSpec(1), tfab.LevelSpec(1)),
        capacity=4))
    with pytest.raises(ValueError, match="expects fan_in 2"):
        tfab.FabricInterconnect(mesh, wide).stream_fn()
    # A level count mismatch, and a routed plan whose enables hold no data.
    with pytest.raises(ValueError, match="1 mesh axes for 3 fabric levels"):
        tfab.fabric_exchange(frame, mesh, fwd, rev, plan,
                             axis_names=("fab0",))
    routed = tfab.with_exchange_mode(plan, "routed")
    meta = dataclasses.replace(routed, levels=(dataclasses.replace(
        routed.levels[0], enables=torch.ones((1, 1), dtype=torch.bool,
                                             device="meta")),
        *routed.levels[1:]))
    with pytest.raises(ValueError, match="hold no data"):
        tfab.fabric_exchange(frame, mesh, fwd, rev, meta)
    # Each function takes this rank's frames of its own rank of dims.
    ic = tfab.FabricInterconnect(mesh, plan)
    with pytest.raises(ValueError, match="exchange_fn takes"):
        ic.exchange_fn()(TFrame(*(x[None] for x in frame)), fwd, rev)
    with pytest.raises(ValueError, match="stream_fn takes"):
        ic.stream_fn()(frame, fwd, rev)


def test_core_exports_the_sharded_executor():
    for name in ("fabric_exchange", "FabricInterconnect"):
        assert getattr(tcore, name) is getattr(tfab, name)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the merge_pack kernel); run on the "
                    "card with -m cuda")
    return torch.device("cuda")


def card_rank(rank: int, world: int, inputs: dict, case) -> list:
    """One case's round on the card (frames and tables on cuda:0, the wire
    through the host under gloo) and on the CPU, with the merge_pack
    launches of the card's round."""
    from repro_torch.kernels.spike_router import ops

    base, mode, timed = case
    plan = sc.build_plan(tfab, base, mode)
    mesh = tshard.fabric_mesh(plan, device_type="cpu")
    outs = []
    for dev in ("cpu", "cuda"):
        ic = tfab.FabricInterconnect(
            mesh, plan, timing=ttimed() if timed else None,
            health=sc.build_health(tfab, plan, base,
                                   lambda a: torch.from_numpy(a).to(dev)))
        before = ops.fused_merge_pack.launches
        out, drops = ic.exchange_fn()(
            TFrame(*(x.to(dev) for x in sc._frame(inputs, rank))),
            torch.from_numpy(inputs["fwd"][rank]).to(dev),
            torch.from_numpy(inputs["rev"][rank]).to(dev))
        outs.append(([x.cpu().numpy() for x in (*out, *drops)],
                     ops.fused_merge_pack.launches - before))
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("mixed", "routed", True),
                                  ("overlay", "gather", False)],
                         ids=sc.case_id)
def test_sharded_exchange_card_matches_cpu(cuda_device, inputs, case):
    ranks = run_ranks(card_rank, sc.N_RANKS, inputs, case, timeout_s=300)
    for rank, ((cpu, cpu_launches), (card, card_launches)) in enumerate(
            ranks):
        assert_fields(f"rank {rank} card against CPU", card, cpu)
        assert (cpu_launches, card_launches) == (0, 1)
