"""Cases of the sharded-executor parity tests (``test_torch_sharded_*.py``).

One module holds what both sides of a comparison need, so they cannot
drift apart: the inputs (numpy, from a seed), the plans (built through
either package's ``fabric`` module), the port's rank bodies (torch only:
run by ``repro_torch.parallel.spawn.run_ranks`` in one gloo group of 8
ranks) and the reference's oracle (JAX only: ``FabricInterconnect`` and
``StarInterconnect`` under ``shard_map`` on 8 host devices, run by
``jax_oracle`` in its own interpreter, which must set ``XLA_FLAGS`` before
JAX starts).  Not a test module: pytest does not collect it.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile

import numpy as np

N_RANKS = 8
CAP_IN = 12
ROUNDS = 3
OCC = 0.6
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
DROP_FIELDS = ("congestion", "uplink", "unroutable", "rerouted")
OUT_FIELDS = ("labels", "times", "valid") + DROP_FIELDS


def lut(rng, n: int, size: int, enable_bit: int, payload_bits: int):
    """Random LUTs, about 10% of entries disabled."""
    payload = rng.integers(0, 1 << payload_bits, (n, size))
    en = rng.random((n, size)) < 0.9
    return (payload | (en.astype(np.int64) << enable_bit)).astype(np.int32)


def identity_luts(n: int):
    """Identity fwd/rev LUTs over the 2^15 wire labels, every route on."""
    ids = np.arange(1 << 15, dtype=np.int32)
    fwd = np.zeros(1 << 16, np.int32)
    fwd[ids] = ids | (1 << 15)
    rev = ids | (1 << 16)
    return np.tile(fwd, (n, 1)), np.tile(rev, (n, 1))


def make_inputs(seed: int, n: int = N_RANKS, cap_in: int = CAP_IN,
                rounds: int = ROUNDS) -> dict:
    """``rounds`` x ``n`` egress frames of ``cap_in`` slots (labels over 16
    bits, departures in [0, 1000) ns, each slot valid with ``OCC``) and
    random per-leaf LUTs."""
    rng = np.random.default_rng(seed)
    return dict(
        labels=rng.integers(0, 1 << 16, (rounds, n, cap_in)).astype(np.int32),
        times=rng.integers(0, 1000, (rounds, n, cap_in)).astype(np.int32),
        valid=rng.random((rounds, n, cap_in)) < OCC,
        fwd=lut(rng, n, 1 << 16, 15, 15), rev=lut(rng, n, 1 << 15, 16, 16))


# ---------------------------------------------------------------------------
# Fabric cases: 3-level (2, 2, 2) plans and a 2-level plan with a pruned top
# ---------------------------------------------------------------------------

THREE = ((2, None, False, None), (2, None, False, None),
         (2, None, True, None))
CAPS = ((2, 8, False, None), (2, 12, False, None), (2, 6, True, None))
# Top level of the 2 x 4 plan: pod j feeds pods j and j + 1 only, so ring
# rotations 2 and 3 carry no enabled pair and are pruned.
RING = np.array([[k in (j, (j + 1) % 4) for k in range(4)] for j in range(4)])
PRUNED = ((2, 6, False, None), (4, 10, False, RING))

# name: (levels, capacity, dead edges, overlay {(side, level): dead edges}).
FABRIC_BASES = {
    "dense": (THREE, 24, (), None),
    "caps": (CAPS, 24, (), None),
    "pruned": (PRUNED, 20, (), None),
    "detour": (CAPS, 24, ((1, 0),), None),
    "exhausted": (THREE, 24, ((1, 0), (1, 1)), None),
    "mixed": (CAPS, 24, ((1, 2), (0, 3, "downlink")), None),
    "overlay": (THREE, 24, (), {("uplink", 1): (1,)}),
    "overlay_down": (CAPS, 24, (), {("downlink", 0): (5,),
                                    ("uplink", 0): (2,)}),
    "overlay_degraded": (CAPS, 24, ((1, 0),), {("uplink", 2): (1,)}),
}
# Every base runs timed in both modes; these also run untimed.
UNTIMED = ("dense", "caps", "pruned", "mixed", "overlay")
# (base, mode, timed) cases that also run T rounds through stream_fn.
STREAMED = (("caps", "gather", True), ("caps", "routed", True),
            ("mixed", "routed", True), ("overlay", "gather", False),
            ("pruned", "routed", False))


def fabric_cases() -> list[tuple[str, str, bool]]:
    return [(base, mode, timed) for base in FABRIC_BASES
            for timed in (False, True)
            if timed or base in UNTIMED
            for mode in ("gather", "routed")]


def case_id(case) -> str:
    base, mode, timed = case
    return f"{base}-{mode}-{'timed' if timed else 'untimed'}"


def build_plan(fab, base: str, mode: str):
    """The compiled plan of a fabric case, through either package's
    ``fabric`` module."""
    levels, capacity, dead, _ = FABRIC_BASES[base]
    spec = fab.FabricSpec(
        levels=tuple(fab.LevelSpec(f, enables=en, link_capacity=cap,
                                   extension=ext)
                     for f, cap, ext, en in levels),
        capacity=capacity, exchange_mode=mode)
    if dead:
        spec = fab.degrade_spec(spec, dead)
    return fab.compile_fabric(spec)


def build_health(fab, plan, base: str, as_array):
    """The case's dynamic overlay (``None`` when it has none), its vectors
    made by ``as_array`` from numpy."""
    overlay = FABRIC_BASES[base][3]
    if overlay is None:
        return None
    sides = {"uplink": [None] * plan.n_levels,
             "downlink": [None] * plan.n_levels}
    for (side, level), dead in overlay.items():
        vec = np.ones(plan.edge_counts[level], bool)
        vec[list(dead)] = False
        sides[side][level] = as_array(vec)
    return fab.FabricHealth(uplink=tuple(sides["uplink"]),
                            downlink=tuple(sides["downlink"]))


# ---------------------------------------------------------------------------
# The port's rank bodies (torch only)
# ---------------------------------------------------------------------------


def _numpy(out, drops) -> list[np.ndarray]:
    return [x.numpy() for x in (*out, *drops)]


def _reset_wire() -> None:
    from repro_torch.core import fabric as fab

    fab._gather_plane.calls = fab._gather_plane.bytes = 0
    fab._routed_plane.sends = fab._routed_plane.recvs = 0
    fab._routed_plane.bytes = 0


def _wire() -> dict:
    from repro_torch.core import fabric as fab

    return dict(gathers=fab._gather_plane.calls,
                gather_bytes=fab._gather_plane.bytes,
                sends=fab._routed_plane.sends, recvs=fab._routed_plane.recvs,
                p2p_bytes=fab._routed_plane.bytes)


def _frame(inputs, rank: int, rounds=0):
    import torch

    from repro_torch.core.events import EventFrame

    return EventFrame(*(torch.from_numpy(np.ascontiguousarray(
        inputs[k][rounds, rank])) for k in ("labels", "times", "valid")))


def fabric_rank(rank: int, world: int, inputs: dict) -> dict:
    """Every fabric case on this rank: ``exchange_fn`` on round 0 with its
    wire counters; for ``STREAMED`` cases ``stream_fn`` over all rounds and
    one ``exchange_fn`` per round; and ``fabric_leaf_index`` on a mesh in
    the right and in the wrong dimension order."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import fabric as fab
    from repro_torch.core.latency import timed_wire
    from repro_torch.parallel import sharding

    torch.set_num_threads(1)           # 8 ranks share the host's cores
    fwd = torch.from_numpy(inputs["fwd"][rank])
    rev = torch.from_numpy(inputs["rev"][rank])
    meshes, out = {}, {}
    for case in fabric_cases():
        base, mode, timed = case
        plan = build_plan(fab, base, mode)
        if plan.fan_ins not in meshes:
            meshes[plan.fan_ins] = sharding.fabric_mesh(plan,
                                                        device_type="cpu")
        ic = fab.FabricInterconnect(
            meshes[plan.fan_ins], plan, timing=timed_wire() if timed else None,
            health=build_health(fab, plan, base, torch.from_numpy))
        _reset_wire()
        res = {"exchange": _numpy(*ic.exchange_fn()(_frame(inputs, rank),
                                                    fwd, rev)),
               "wire": _wire()}
        if case in STREAMED:
            res["stream"] = _numpy(*ic.stream_fn()(
                _frame(inputs, rank, slice(None)), fwd, rev))
            res["rounds"] = [_numpy(*ic.exchange_fn()(_frame(inputs, rank, t),
                                                      fwd, rev))
                             for t in range(inputs["labels"].shape[0])]
        out[case] = res
    mesh = meshes[(2, 2, 2)]
    out["leaf"] = (sharding.fabric_leaf_index(mesh, (2, 2, 2)),
                   [mesh.get_local_rank(n) for n in ("fab0", "fab1", "fab2")],
                   [torch.distributed.get_rank(mesh.get_group(n))
                    for n in ("fab0", "fab1", "fab2")])
    wrong = init_device_mesh("cpu", (2, 2, 2),
                             mesh_dim_names=("fab0", "fab1", "fab2"))
    try:
        sharding.fabric_leaf_index(wrong, (2, 2, 2),
                                   axis_names=("fab0", "fab1", "fab2"))
        out["wrong_order"] = None
    except ValueError as err:
        out["wrong_order"] = str(err)
    return out


def star_rank(rank: int, world: int, inputs: dict) -> dict:
    """Every legacy case on this rank (see ``STAR_CASES``), the barriers
    and the hierarchical all-reduce."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import aggregator as agg
    from repro_torch.core import sync
    from repro_torch.core.events import EventFrame
    from repro_torch.core.latency import timed_wire
    from repro_torch.parallel import collectives

    torch.set_num_threads(1)           # 8 ranks share the host's cores
    star = init_device_mesh("cpu", (world,), mesh_dim_names=("chip",))
    hier = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("pod", "chip"))
    out = {}
    for name, (topo, kw, timed, tables, streamed) in STAR_CASES.items():
        fwd = torch.from_numpy(inputs[f"{tables}_fwd"][rank])
        rev = torch.from_numpy(inputs[f"{tables}_rev"][rank])
        enables = [torch.from_numpy(inputs[k]) for k in ENABLES[topo]]
        ic = agg.StarInterconnect(
            star if topo != "hier" else hier, "chip",
            pod_axis=None if topo != "hier" else "pod",
            timing=timed_wire() if timed else None, **kw)
        frame = (EventFrame(*(torch.from_numpy(inputs[f"eight_{k}"][rank])
                              for k in ("labels", "times", "valid")))
                 if tables == "identity" else _frame(inputs, rank))
        res = {"exchange": _numpy(*ic.exchange_fn()(frame, fwd, rev,
                                                    *enables))}
        if streamed:
            res["stream"] = _numpy(*ic.stream_fn()(
                _frame(inputs, rank, slice(None)), fwd, rev, *enables))
            res["rounds"] = [_numpy(*ic.exchange_fn()(_frame(inputs, rank, t),
                                                      fwd, rev, *enables))
                             for t in range(inputs["labels"].shape[0])]
        out[name] = res
    # The direct wrappers, once each, against StarInterconnect.
    out["star_exchange"] = _numpy(*agg.star_exchange(
        _frame(inputs, rank), "chip", torch.from_numpy(inputs["fwd"][rank]),
        torch.from_numpy(inputs["rev"][rank]),
        torch.from_numpy(inputs["star_en"]), 32, link_capacity=6,
        mesh=star))
    out["hierarchical_exchange"] = _numpy(*agg.hierarchical_exchange(
        _frame(inputs, rank), "chip", "pod",
        torch.from_numpy(inputs["fwd"][rank]),
        torch.from_numpy(inputs["rev"][rank]),
        torch.from_numpy(inputs["intra_en"]),
        torch.from_numpy(inputs["inter_en"]), 24, link_capacity=6,
        pod_capacity=20, timing=timed_wire(), mesh=hier))
    # Barriers: all ready; rank 3 not ready (the whole star, and its pod on
    # the hierarchy's chip axis).
    out["barrier"] = [bool(sync.barrier(torch.tensor(ready), axis, mesh))
                      for ready, axis, mesh in (
                          (True, "chip", star), (rank != 3, "chip", star),
                          (rank != 3, "chip", hier), (rank != 3, "pod", hier),
                          (True, "pod", hier))]
    # The hierarchical all-reduce against flat all-reduces, on
    # integer-valued floats (exact in any order of summation).
    x = torch.from_numpy(inputs["psum_x"][rank])
    odd = x[:3]                     # 3 rows do not divide the 4-rank pods
    flat = [x.clone(), odd.clone()]
    for t in flat:
        torch.distributed.all_reduce(t)
    pod_only = x.clone()
    torch.distributed.all_reduce(pod_only, group=hier.get_group("chip"))
    out["psum"] = dict(
        hier=collectives.hierarchical_psum(x, "chip", "pod", mesh=hier),
        hier_odd=collectives.hierarchical_psum(odd, "chip", "pod", mesh=hier),
        no_pod=collectives.hierarchical_psum(x, "chip", None, mesh=hier),
        mean=collectives.hierarchical_pmean(x, "chip", "pod", mesh=hier),
        flat=flat[0], flat_odd=flat[1], pod_only=pod_only)
    out["psum"] = {k: v.numpy() for k, v in out["psum"].items()}
    return out


# name: (topology, StarInterconnect keywords, timed, LUTs, streamed).
STAR_CASES = {
    "star8": ("star_full", dict(capacity=64), False, "identity", False),
    "star": ("star", dict(capacity=32), False, "random", True),
    "star_link": ("star", dict(capacity=32, link_capacity=6), False,
                  "random", False),
    "star_timed": ("star_self", dict(capacity=32), True, "random", True),
    "hier": ("hier", dict(capacity=24), False, "random", True),
    "hier_caps": ("hier", dict(capacity=24, link_capacity=6,
                               pod_capacity=20), False, "random", False),
    "hier_timed": ("hier", dict(capacity=24), True, "random", False),
    "hier_caps_timed": ("hier", dict(capacity=24, link_capacity=6,
                                     pod_capacity=20), True, "random", True),
}
# The enables each topology's functions take, by input name.
ENABLES = {"star_full": ("full_en",), "star": ("star_en",),
           "star_self": ("self_en",), "hier": ("intra_en", "inter_en")}


def star_inputs(seed: int) -> dict:
    """``make_inputs`` plus the identity-LUT frames of the 8-chip star
    (chip c emits labels 0..7, all valid: each receives 7 x 8), the
    enables, and the all-reduce operands."""
    rng = np.random.default_rng(seed + 1)
    inp = make_inputs(seed)
    n = N_RANKS
    inp["identity_fwd"], inp["identity_rev"] = identity_luts(n)
    inp["random_fwd"], inp["random_rev"] = inp["fwd"], inp["rev"]
    inp["eight_labels"] = np.tile(np.arange(8, dtype=np.int32), (n, 1))
    inp["eight_times"] = np.zeros((n, 8), np.int32)
    inp["eight_valid"] = np.ones((n, 8), bool)
    inp["full_en"] = ~np.eye(n, dtype=bool)
    en = rng.random((n, n)) < 0.7
    np.fill_diagonal(en, False)
    inp["star_en"] = en
    inp["self_en"] = np.ones((n, n), bool)
    inp["intra_en"] = ~np.eye(n // 2, dtype=bool)
    inp["inter_en"] = np.ones((2, 2), bool)
    inp["psum_x"] = rng.integers(-50, 50, (n, 8, 4)).astype(np.float32)
    return inp


# ---------------------------------------------------------------------------
# The reference's oracle (JAX only, 8 host devices, own interpreter)
# ---------------------------------------------------------------------------


def _jax_fabric(inputs: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.core import fabric as fab
    from repro.core.events import EventFrame
    from repro.core.latency import timed_wire
    from repro.parallel.sharding import fabric_mesh

    fwd, rev = jnp.asarray(inputs["fwd"]), jnp.asarray(inputs["rev"])
    frames = EventFrame(*(jnp.asarray(inputs[k])
                          for k in ("labels", "times", "valid")))
    first = jax.tree.map(lambda x: x[0], frames)
    out = {}
    for case in fabric_cases():
        base, mode, timed = case
        plan = build_plan(fab, base, mode)
        ic = fab.FabricInterconnect(
            mesh=fabric_mesh(plan), plan=plan,
            timing=timed_wire() if timed else None,
            health=build_health(fab, plan, base, jnp.asarray))
        o, d = ic.exchange_fn()(first, fwd, rev)
        res = {"exchange": [np.asarray(x) for x in (*o, *d)]}
        if case in STREAMED:
            o, d = ic.stream_fn()(frames, fwd, rev)
            res["stream"] = [np.asarray(x) for x in (*o, *d)]
        out[case] = res
    return out


def _jax_star(inputs: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.core.aggregator import StarInterconnect
    from repro.core.events import EventFrame
    from repro.core.latency import timed_wire

    star = compat.make_mesh((N_RANKS,), ("chip",))
    hier = compat.make_mesh((2, N_RANKS // 2), ("pod", "chip"))
    frames = EventFrame(*(jnp.asarray(inputs[k])
                          for k in ("labels", "times", "valid")))
    out = {}
    for name, (topo, kw, timed, tables, streamed) in STAR_CASES.items():
        fwd = jnp.asarray(inputs[f"{tables}_fwd"])
        rev = jnp.asarray(inputs[f"{tables}_rev"])
        enables = [jnp.asarray(inputs[k]) for k in ENABLES[topo]]
        ic = StarInterconnect(star if topo != "hier" else hier, "chip",
                              pod_axis=None if topo != "hier" else "pod",
                              timing=timed_wire() if timed else None, **kw)
        frame = (EventFrame(*(jnp.asarray(inputs[f"eight_{k}"])
                              for k in ("labels", "times", "valid")))
                 if tables == "identity"
                 else jax.tree.map(lambda x: x[0], frames))
        o, d = ic.exchange_fn()(frame, fwd, rev, *enables)
        res = {"exchange": [np.asarray(x) for x in (*o, *d)]}
        if streamed:
            o, d = ic.stream_fn()(frames, fwd, rev, *enables)
            res["stream"] = [np.asarray(x) for x in (*o, *d)]
        out[name] = res
    # The hierarchical all-reduce: each device's [rows, 4] block of x.
    from jax.sharding import PartitionSpec as P

    from repro.parallel import collectives

    spec = P(("pod", "chip"))
    x = inputs["psum_x"]
    for key, rows, fn in (
            ("hier", 8, lambda v: collectives.hierarchical_psum(
                v, "chip", "pod")),
            ("hier_odd", 3, lambda v: collectives.hierarchical_psum(
                v, "chip", "pod")),
            ("no_pod", 8, lambda v: collectives.hierarchical_psum(
                v, "chip", None)),
            ("mean", 8, lambda v: collectives.hierarchical_pmean(
                v, "chip", "pod"))):
        run = jax.jit(compat.shard_map(fn, mesh=hier, in_specs=spec,
                                       out_specs=spec))
        got = run(jnp.asarray(x[:, :rows].reshape(-1, x.shape[-1])))
        out.setdefault("psum", {})[key] = np.asarray(got).reshape(
            N_RANKS, rows, x.shape[-1])
    return out


def jax_oracle_main(kind: str, in_path: str, out_path: str) -> None:
    inputs = pickle.loads(pathlib.Path(in_path).read_bytes())
    out = (_jax_fabric if kind == "fabric" else _jax_star)(inputs)
    pathlib.Path(out_path).write_bytes(pickle.dumps(out))


@contextlib.contextmanager
def jax_oracle(kind: str, inputs: dict):
    """Start the reference's 8-device oracle on ``inputs`` in its own
    interpreter; the context yields a function that waits for and returns
    its results (so the port's ranks can run meanwhile)."""
    with tempfile.TemporaryDirectory(prefix="sharded_oracle_") as tmp:
        src, dst = pathlib.Path(tmp, "in.pkl"), pathlib.Path(tmp, "out.pkl")
        src.write_bytes(pickle.dumps(inputs))
        prog = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import sharded_cases; "
                "sharded_cases.jax_oracle_main(*sys.argv[2:])")
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "PYTHONPATH": os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")])}
        proc = subprocess.Popen(
            [sys.executable, "-c", prog, str(pathlib.Path(__file__).parent),
             kind, str(src), str(dst)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

        def result() -> dict:
            _, err = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"the JAX oracle failed:\n{err[-3000:]}")
            return pickle.loads(dst.read_bytes())

        try:
            yield result
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@contextlib.contextmanager
def single_rank_group():
    """A one-rank gloo process group in this process (file rendezvous in a
    temporary directory), destroyed on exit."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory(prefix="one_rank_") as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
