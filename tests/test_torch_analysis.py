"""The port's fabric verifier against the JAX package's.

``planlint`` (every check, ``classify_pairs``), the pack units' write-set
model check, ``shrink_plan`` and the byte budgets, and the suppressions
are held against the reference's live functions on the same plans:
diagnostics equal in check, path, message, severity and order, arrays bit
for bit.  Plan faults are planted in both packages' plans alike
(``dataclasses.replace``), pack-unit faults as the same mutant written in
each framework.  The program lint has no live oracle (the reference's
walks jaxprs through ``jax.core.ClosedJaxpr``, which jax 0.9 no longer
has), so each program fault is planted in the torch program and must be
flagged under its check id, and the catalogue must lint clean.  The card
check of the CUDA router kernels is ``cuda``-marked; here its output
reader is held on the plain versions and on corrupted outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import jaxprlint as jlint
from repro.analysis import kernelcheck as jkc
from repro.analysis import planlint as jplan
from repro.analysis import scenarios as jsc
from repro.analysis.diagnostics import Diagnostic as JDiagnostic
from repro.analysis.diagnostics import Suppression as JSuppression
from repro.analysis.diagnostics import apply_suppressions as japply
from repro.core import fabric as jfab
from repro.kernels.spike_router.spike_router import (_pack_indices,
                                                     _pack_segmented_indices)
from repro_torch.analysis import kernelcheck as tkc
from repro_torch.analysis import lint as tlint
from repro_torch.analysis import planlint as tplan
from repro_torch.analysis import programlint as tprog
from repro_torch.analysis import scenarios as tsc
from repro_torch.analysis.diagnostics import (Diagnostic, Suppression,
                                              WARNING, apply_suppressions)
from repro_torch.analysis.suppressions import SUPPRESSIONS
from repro_torch.core import events as tev
from repro_torch.core import fabric as tfab
from repro_torch.kernels.spike_router.ref import (pack_indices,
                                                  pack_segmented_indices)
from repro_torch.parallel.spawn import run_ranks
from torch_threads import share_cores

share_cores()

J_SCENARIOS = {sc.name: sc for sc in jsc.benchmark_plans()}
T_SCENARIOS = {sc.name: sc for sc in tsc.benchmark_plans()}
NAMES = list(J_SCENARIOS)


def rows(diags):
    """Diagnostics of either package as comparable tuples."""
    return [(d.check, d.path, d.message, d.severity) for d in diags]


def replace_level(plan, i, **kw):
    levels = list(plan.levels)
    levels[i] = dataclasses.replace(levels[i], **kw)
    return dataclasses.replace(plan, levels=tuple(levels))


# ---------------------------------------------------------------------------
# planlint and the plan hooks
# ---------------------------------------------------------------------------


def test_scenario_catalogue_matches_reference():
    assert NAMES == list(T_SCENARIOS)
    assert tsc.OCC_SWEEP == jsc.OCC_SWEEP
    for name in NAMES:
        assert (T_SCENARIOS[name].plan.describe()
                == J_SCENARIOS[name].plan.describe())


@pytest.mark.parametrize("name", NAMES)
def test_plan_hooks_match_reference(name):
    pj, pt = J_SCENARIOS[name].plan, T_SCENARIOS[name].plan
    assert pt.group_sizes == pj.group_sizes
    np.testing.assert_array_equal(pt.delivery_levels(), pj.delivery_levels())
    for i in range(pj.n_levels):
        np.testing.assert_array_equal(pt.leaf_entities(i),
                                      pj.leaf_entities(i))
        np.testing.assert_array_equal(pt.level_gate(i), pj.level_gate(i))
        cj, ct = pj.levels[i].detour_counts(), pt.levels[i].detour_counts()
        assert (cj is None) == (ct is None)
        if cj is not None:
            np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("name", NAMES)
def test_lint_plan_and_classify_pairs_match_reference(name):
    sj, st = J_SCENARIOS[name], T_SCENARIOS[name]
    assert rows(tplan.lint_plan(st.plan, st.cap_in, name)) == rows(
        jplan.lint_plan(sj.plan, sj.cap_in, name)) == []
    cj, ct = jplan.classify_pairs(sj.plan), tplan.classify_pairs(st.plan)
    assert list(ct) == list(cj)
    for k in cj:
        assert ct[k].dtype == cj[k].dtype
        np.testing.assert_array_equal(ct[k], cj[k])
    assert tplan.stream_lengths(st.plan, st.cap_in) == jplan.stream_lengths(
        sj.plan, sj.cap_in)


def _layout_fault(kind):
    def make(plan, cap_in):
        layout = [list(s) for s in plan.merge_layout(cap_in)]
        if kind == "overlap":
            layout[0][0] += 4
        elif kind == "under":
            layout[0][0] -= 4
        else:                                  # re-covers, but misaligned
            layout[0][0] += 4
            layout[0][1] -= 4
        return tuple(tuple(s) for s in layout)
    return make


# Planted plan faults: (id, scenario, fault) with ``fault(plan, pkg)``
# returning the corrupted plan of either package (``pkg`` "j" or "t").
def _detour_override(level, edges, host):
    def fault(plan, pkg):
        detour = np.asarray(plan.levels[level].detour).copy()
        detour[list(edges)] = host
        return replace_level(plan, level, detour=detour)
    return fault


def _field(level, **kw):
    return lambda plan, pkg: replace_level(plan, level, **kw)


def _widening(plan, pkg):
    lib = jsc if pkg == "j" else tsc
    name, fan_ins, cap_in, cap = lib.CASES[1]
    caps = list(lib.level_caps(fan_ins, cap_in, 0.05))
    caps[1] = 10_000
    return lib.plan_for(fan_ins, cap, tuple(caps))


def _leaf_uplink_wide(plan, pkg):
    return (jsc if pkg == "j" else tsc).plan_for((12, 10), 128, (99, 40))


def _over_budget_detours(plan, pkg):
    lib = jfab if pkg == "j" else tfab
    spec = lib.FabricSpec(levels=(lib.LevelSpec(fan_in=4),
                                  lib.LevelSpec(fan_in=6)), capacity=16)
    degraded = lib.compile_fabric(lib.degrade_spec(
        lib.compile_fabric(spec).spec, tuple((1, e) for e in range(5))))
    return _detour_override(1, range(5), 5)(degraded, pkg)


def _no_reroute(plan, pkg):
    spec = dataclasses.replace(plan.spec, reroute=False)
    return dataclasses.replace(plan, spec=spec)


def _self_loops(plan, pkg):
    return replace_level(plan, 0, enables=np.ones((12, 12), bool))


PLAN_FAULTS = {
    "detour_through_dead_host": ("EXT_4CASE_96CHIP/exhausted",
                                 _detour_override(1, [0], 1)),
    "detour_through_itself": ("EXT_4CASE_96CHIP/1dead_uplink",
                              _detour_override(1, [0], 0)),
    "detour_out_of_range": ("EXT_4CASE_96CHIP/1dead_uplink",
                            _detour_override(1, [0], 99)),
    "detour_outside_group": ("EXT_4CASE_96CHIP/1dead_uplink",
                             _detour_override(1, [0], 3)),
    "detour_for_alive_edge": ("EXT_4CASE_96CHIP/1dead_uplink",
                              _detour_override(1, [2], 3)),
    "detours_without_dead_uplinks": (
        "FULL_BACKPLANE", _field(0, detour=np.full(12, -1, np.int32))),
    "detours_when_spec_forbids": ("EXT_4CASE_96CHIP/1dead_uplink",
                                  _no_reroute),
    "leaf_detours": ("EXT_4CASE_96CHIP/1dead_uplink", lambda p, k: (
        replace_level(p, 0, uplink_ok=np.r_[False, np.ones(95, bool)],
                      detour=np.r_[np.int32(1), np.full(95, -1, np.int32)]))),
    "over_budget_detours": ("FULL_BACKPLANE", _over_budget_detours),
    "health_vector_length": ("EXT_4CASE_96CHIP/1dead_uplink",
                             _field(1, uplink_ok=np.ones(3, bool))),
    "enables_shape": ("FULL_BACKPLANE",
                      _field(0, enables=np.ones((3, 3), bool))),
    "enables_dtype": ("FULL_BACKPLANE", _field(
        0, enables=(~np.eye(12, dtype=bool)).astype(np.int32))),
    "self_delivery": ("FULL_BACKPLANE", _self_loops),
    "capacity_widening": ("FULL_BACKPLANE", _widening),
    "leaf_uplink_wider_than_frame": ("FULL_BACKPLANE", _leaf_uplink_wide),
    "ingress_wider_than_stream": ("PROJECTED_120CHIP", lambda p, k: (
        dataclasses.replace(p, capacity=100_000))),
    "node_count": ("PROJECTED_120CHIP", lambda p, k: (
        dataclasses.replace(p, n_nodes=119))),
    "extension_level_too_wide": ("FULL_BACKPLANE", lambda p, k: (
        dataclasses.replace(p, spec=dataclasses.replace(p.spec, levels=(
            dataclasses.replace(p.spec.levels[0], extension=True),))))),
}


@pytest.mark.parametrize("fault", list(PLAN_FAULTS))
def test_planted_plan_fault_matches_reference(fault):
    """The whole plan lint of both packages on the same corrupted plan:
    equal diagnostics, in order, and at least one error."""
    name, make = PLAN_FAULTS[fault]
    sj, st = J_SCENARIOS[name], T_SCENARIOS[name]
    bad_j, bad_t = make(sj.plan, "j"), make(st.plan, "t")
    cap = 32 if fault == "leaf_uplink_wider_than_frame" else sj.cap_in
    want = rows(jplan.lint_plan(bad_j, cap, "bad"))
    got = rows(tplan.lint_plan(bad_t, cap, "bad"))
    assert got == want
    assert want, fault
    for check in ("check_fan_in", "check_detours", "check_conservation",
                  "check_shape"):
        if fault in ("health_vector_length", "enables_shape", "node_count"
                     ) and check != "check_shape":
            continue
        assert rows(getattr(tplan, check)(bad_t, "bad")) == rows(
            getattr(jplan, check)(bad_j, "bad")), check
    if fault not in ("health_vector_length", "enables_shape", "node_count"):
        assert rows(tplan.check_capacity_monotone(bad_t, cap, "bad")) == rows(
            jplan.check_capacity_monotone(bad_j, cap, "bad"))


@pytest.mark.parametrize("kind", ["overlap", "under", "misaligned"])
@pytest.mark.parametrize("name", ["FULL_BACKPLANE", "EXT_4CASE_96CHIP"])
def test_planted_merge_layout_matches_reference(name, kind):
    sj, st = J_SCENARIOS[name], T_SCENARIOS[name]
    layout = _layout_fault(kind)(sj.plan, sj.cap_in)
    want = rows(jplan.check_merge_segments(sj.plan, sj.cap_in, "bad",
                                           layout=layout))
    got = rows(tplan.check_merge_segments(st.plan, st.cap_in, "bad",
                                          layout=layout))
    assert got == want and want
    assert {c for c, *_ in got} == {"plan.merge-segments"}
    short = rows(tplan.check_merge_segments(st.plan, st.cap_in, "bad",
                                            layout=layout[:-1] or ((),)))
    assert short == rows(jplan.check_merge_segments(
        sj.plan, sj.cap_in, "bad", layout=layout[:-1] or ((),)))


def test_conservation_classes_track_degradation_like_reference():
    counts = {}
    for name in ("EXT_4CASE_96CHIP", "EXT_4CASE_96CHIP/1dead_uplink",
                 "EXT_4CASE_96CHIP/exhausted"):
        ct = tplan.classify_pairs(T_SCENARIOS[name].plan)
        cover = ct["ungated"].astype(int) + ct["delivered"] + ct["unroutable"]
        assert (cover == 1).all()
        counts[name] = {k: int(v.sum()) for k, v in ct.items()}
    h, d1, ex = counts.values()
    assert h["unroutable"] == 0 and h["rerouted"] == 0
    assert d1["delivered"] == h["delivered"] and d1["rerouted"] > 0
    assert ex["unroutable"] > 0
    assert ex["delivered"] + ex["unroutable"] == h["delivered"]


# ---------------------------------------------------------------------------
# The pack units: index twins and the write-set model check
# ---------------------------------------------------------------------------


TWIN_SHAPES = [(1,), (5,), (8,), (10,), (16,), (700,), (2, 4), (4, 8),
               (3, 3), (12, 64), (4, 1000)]


@pytest.mark.parametrize("shape", TWIN_SHAPES, ids=str)
def test_index_twins_equal_reference_over_the_battery(shape):
    masks = tkc._masks(shape)
    np.testing.assert_array_equal(masks, jkc._masks(shape))
    n = int(np.prod(shape))
    flat = masks.reshape(masks.shape[0], -1)
    for cap in sorted({1, 5, max(1, n // 2), n, n + 3}):
        r_idx, r_keep = jax.vmap(lambda ok: _pack_indices(ok, cap))(
            jnp.asarray(flat))
        idx, keep = pack_indices(torch.from_numpy(flat), cap)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(r_keep))
        if len(shape) == 2:
            r_idx, r_keep = jax.vmap(
                lambda ok: _pack_segmented_indices(ok, cap))(
                    jnp.asarray(masks))
            idx, keep = pack_segmented_indices(torch.from_numpy(masks), cap)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
            np.testing.assert_array_equal(keep.numpy(), np.asarray(r_keep))


def _slots_of(frame_labels, frame_valid, n, cap):
    """(idx, keep) read off a frame whose labels are arrival indices."""
    m = frame_labels.shape[0]
    idx = np.full((m, n), cap)
    keep = np.zeros((m, n), bool)
    for r in range(m):
        slots = np.flatnonzero(frame_valid[r])
        idx[r, frame_labels[r, slots]] = slots
        keep[r, frame_labels[r, slots]] = True
    return idx, keep


@pytest.mark.parametrize("shape", [(8,), (700,), (2, 4), (12, 64), (4, 100)],
                         ids=str)
def test_make_frame_ranks_equal_the_index_twins(shape):
    """The port's pack units scatter by the twins' map: labels are arrival
    indices, so each output slot names the event it took."""
    masks = tkc._masks(shape)
    m, n = masks.shape[0], int(np.prod(shape))
    flat = torch.from_numpy(masks.reshape(m, n))
    labels = torch.arange(n, dtype=torch.int32).expand(m, n)
    for cap in (3, n // 2 + 1, n + 2):
        want_idx, want_keep = pack_indices(flat, cap)
        frame, dropped = tev.make_frame(labels, None, flat.bool(), cap)
        idx, keep = _slots_of(frame.labels.numpy(), frame.valid.numpy(), n,
                              cap)
        np.testing.assert_array_equal(idx, want_idx.numpy())
        np.testing.assert_array_equal(keep, want_keep.numpy())
        np.testing.assert_array_equal(
            dropped.numpy(), flat.sum(1).numpy() - want_keep.sum(1).numpy())
        if len(shape) == 2:
            seg = (shape[1],) * shape[0]
            # Front-compacted segments, as compact=True promises.
            comp = torch.from_numpy(-np.sort(-masks, axis=-1).reshape(m, n))
            want_idx, want_keep = pack_segmented_indices(
                comp.reshape(m, *shape), cap)
            for compact in (False, True):
                frame, _ = tev.make_frame_segmented(
                    labels, None, comp.bool(), cap, seg, compact=compact)
                idx, keep = _slots_of(frame.labels.numpy(),
                                      frame.valid.numpy(), n, cap)
                np.testing.assert_array_equal(idx, want_idx.numpy())
                np.testing.assert_array_equal(keep, want_keep.numpy())


def _catalogue_capacities():
    caps = set()
    for sc in T_SCENARIOS.values():
        caps.add(sc.plan.capacity)
        caps.update(lvl.link_capacity for lvl in sc.plan.levels
                    if lvl.link_capacity is not None)
    return sorted(caps)


@pytest.mark.parametrize("cap", _catalogue_capacities())
def test_check_pack_writeset_matches_reference(cap):
    for jfn, tfn, shape, ref in (
            (_pack_indices, pack_indices, (min(2 * cap, 16),), None),
            (_pack_segmented_indices, pack_segmented_indices,
             (4, max(2, min(cap, 8))), True),
            (_pack_indices, pack_indices, (8,), None),
            (_pack_segmented_indices, pack_segmented_indices, (2, 4), True)):
        want = jkc.check_pack_writeset(jfn, shape, cap, "p",
                                       reference_fn=ref and _pack_indices)
        got = tkc.check_pack_writeset(tfn, shape, cap, "p",
                                      reference_fn=ref and pack_indices)
        assert rows(got) == rows(want) == []
    assert rows(tkc.check_pack_units([cap])) == rows(
        jkc.check_pack_units([cap])) == []


def _t_broken(ok, capacity):
    pos = torch.cumsum(ok, dim=-1) - ok          # rank within segment only
    keep = (ok == 1) & (pos < capacity)
    return (torch.where(keep, pos, capacity).flatten(-2), keep.flatten(-2))


def _j_broken(ok, capacity):
    pos = jnp.cumsum(ok, axis=-1) - ok
    keep = (ok == 1) & (pos < capacity)
    return jnp.where(keep, pos, capacity).reshape(-1), keep.reshape(-1)


def _t_reversed(ok, capacity):
    pos = torch.cumsum(ok, dim=-1) - ok
    keep = (ok == 1) & (pos < capacity)
    k = torch.clamp(ok.sum(-1, keepdim=True), max=capacity)
    return torch.where(keep, k - 1 - pos, capacity), keep


def _j_reversed(ok, capacity):
    pos = jnp.cumsum(ok) - ok
    keep = (ok == 1) & (pos < capacity)
    k = jnp.minimum(ok.sum(), capacity)
    return jnp.where(keep, k - 1 - pos, capacity), keep


def _t_off_by_one(ok, capacity):
    pos = torch.cumsum(ok, dim=-1) - ok
    keep = (ok == 1) & (pos <= capacity)
    return torch.where(keep, pos, capacity), keep


def _j_off_by_one(ok, capacity):
    pos = jnp.cumsum(ok) - ok
    keep = (ok == 1) & (pos <= capacity)
    return jnp.where(keep, pos, capacity), keep


@pytest.mark.parametrize("mutant", [
    ("broken", (2, 4), 5, "kernel.scatter-overlap"),
    ("reversed", (6,), 4, "kernel.scatter-order"),
    ("off_by_one", (6,), 4, "kernel.scatter-bounds")], ids=lambda m: m[0])
def test_pack_mutants_flagged_like_reference(mutant):
    name, shape, cap, check = mutant
    want = jkc.check_pack_writeset(globals()[f"_j_{name}"], shape, cap, name)
    got = tkc.check_pack_writeset(globals()[f"_t_{name}"], shape, cap, name)
    assert rows(got) == rows(want)
    assert [d.check for d in got] == [check]


# ---------------------------------------------------------------------------
# The card check's output reader, on the plain versions here
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [c + (t,) for c in tkc.CARD_CASES
                                  for t in ((False, True)
                                            if c[0] == "merge_pack"
                                            else (False,))], ids=str)
def test_card_reader_clean_on_plain_versions(case):
    kernel, shape, cap, timed = case
    masks = tkc._masks(shape)
    inputs = tkc.card_inputs(kernel, masks, "cpu", timed)
    outs = tkc.card_launch(kernel, inputs, shape, cap)
    assert tkc.read_writeset(masks, outs, cap, "k") == []


def _corrupt(outs, how):
    labels, valid, times, dropped = (None if o is None else o.copy()
                                     for o in outs)
    r = int(np.flatnonzero(valid.sum(1) >= 2)[0])
    if how == "swap":
        labels[r, [0, 1]] = labels[r, [1, 0]]
    elif how == "duplicate":
        labels[r, 1] = labels[r, 0]
    elif how == "foreign":
        labels[r, 0] = 10 ** 6
    elif how == "dropped":
        dropped[r] += 1
    else:
        times[r, 0] += 1
    return [labels, valid, times, dropped]


@pytest.mark.parametrize("how,check", [
    ("swap", "kernel.scatter-order"), ("duplicate", "kernel.scatter-overlap"),
    ("foreign", "kernel.scatter-bounds"),
    ("dropped", "kernel.scatter-conservation"),
    ("times", "kernel.pack-equivalence")])
def test_card_reader_flags_corrupted_outputs(how, check):
    shape, cap = (4, 100), 64
    masks = tkc._masks(shape)
    inputs = tkc.card_inputs("merge_pack", masks, "cpu", True)
    outs = tkc.card_launch("merge_pack", inputs, shape, cap)
    got = tkc.read_writeset(masks, _corrupt(outs, how), cap, "k")
    assert [d.check for d in got] == [check]
    assert got[0].path == f"k/capacity[{cap}]"


def test_card_check_needs_a_card():
    diags = tkc.check_router_kernels("cpu")
    assert [(d.check, d.severity) for d in diags] == [("kernel.devices",
                                                       WARNING)]
    bodies = {(k, tkc.card_body(k, s)) for k, s, _ in tkc.CARD_CASES}
    assert bodies == {("spike_router", "row"), ("spike_router", "tiled"),
                      ("merge_pack", "warp"), ("merge_pack", "block"),
                      ("merge_pack", "tiled"), ("exchange", "row"),
                      ("exchange", "tiled"), ("exchange_stream", "row"),
                      ("exchange_stream", "tiled")}


# ---------------------------------------------------------------------------
# Program lint: shrink_plan, the budgets, planted faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_shrink_plan_and_budgets_match_reference(name):
    sj, st = J_SCENARIOS[name], T_SCENARIOS[name]
    tj, cj = jlint.shrink_plan(sj.plan, sj.cap_in)
    tt, ct = tprog.shrink_plan(st.plan, st.cap_in)
    assert ct == cj and tt.describe() == tj.describe()
    assert tt.capacity == tj.capacity and tt.fan_ins == tj.fan_ins
    for lj, lt in zip(tj.levels, tt.levels):
        assert lt.link_capacity == lj.link_capacity
        np.testing.assert_array_equal(lt.enables, np.asarray(lj.enables))
        for f in ("uplink_ok", "downlink_ok", "detour"):
            a, b = getattr(lj, f), getattr(lt, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(b, a)
    assert rows(tplan.lint_plan(tt, ct, "twin")) == rows(
        jplan.lint_plan(tj, cj, "twin"))
    for plan_j, plan_t, cap in ((sj.plan, st.plan, sj.cap_in),
                                (tj, tt, cj)):
        for timed in (False, True):
            assert tprog.gather_budget_bytes(plan_t, cap, timed=timed) == \
                jlint.gather_budget_bytes(plan_j, cap, timed=timed) > 0
            assert tprog.routed_budget_bytes(plan_t, cap, timed=timed) == \
                jlint.routed_budget_bytes(plan_j, cap, timed=timed)
    assert tprog.LARGE_CONST_ELEMS == jlint.LARGE_CONST_ELEMS


def test_route_step_and_run_stream_lint_clean():
    for name in ("FULL_BACKPLANE", "EXT_4CASE_96CHIP/exhausted"):
        sc = T_SCENARIOS[name]
        for mode in ("gather", "routed"):
            plan = tfab.with_exchange_mode(sc.plan, mode)
            assert tprog.lint_route_step(plan, sc.cap_in,
                                         device="cpu") == []
    assert tprog.lint_run_stream(device="cpu") == []


def test_f64_leak_in_the_route_step_flagged(monkeypatch):
    """An upcast planted in the stacked executor's uplink pack."""
    make_frame = tfab.make_frame

    def leaky(labels, times, valid, capacity):
        return make_frame(labels.to(torch.float64).to(torch.int32), times,
                          valid, capacity)

    monkeypatch.setattr(tfab, "make_frame", leaky)
    sc = T_SCENARIOS["EXT_4CASE_96CHIP"]
    diags = tprog.lint_route_step(sc.plan, sc.cap_in, "prog", device="cpu")
    assert {d.check for d in diags} == {"program.f64"}
    assert diags[0].path == "prog/_to_copy"
    assert "float64" in diags[0].message


def test_step_constant_in_the_route_step_flagged(monkeypatch):
    """Routing tables rebuilt from host data every round: 12 x 2^16
    entries brought in again after the first."""
    lookup = tfab.routing.lookup_fwd

    def reloading(table, labels):
        table = torch.from_numpy(table.numpy().copy())
        return lookup(table, labels)

    monkeypatch.setattr(tfab.routing, "lookup_fwd", reloading)
    sc = T_SCENARIOS["FULL_BACKPLANE"]
    plan = tfab.with_exchange_mode(sc.plan, "routed")   # the merge engine
    diags = tprog.lint_route_step(plan, sc.cap_in, "prog", device="cpu")
    assert [d.check for d in diags] == ["program.step-const"]
    assert diags[0].path == "prog/step/lift_fresh"
    assert "786432-element host data" in diags[0].message


def test_step_constant_in_run_stream_flagged(monkeypatch):
    """A large ramp made in every step of the emulation loop: the longer
    run makes it more often than the one-step run."""
    from repro_torch.snn import stream as tstream

    route = tstream.exchange_spikes

    def ramped(*args, **kw):
        torch.arange(tprog.LARGE_CONST_ELEMS + 1)
        return route(*args, **kw)

    monkeypatch.setattr(tstream, "exchange_spikes", ramped)
    diags = tprog.lint_run_stream("prog", device="cpu")
    assert [d.check for d in diags] == ["program.step-const"]
    assert "made 2 time(s)" in diags[0].message


# Planted wire faults and the checks each must trip, in order: a widened
# plane and a second gather also move more bytes than the plan budgets.
WIRE_FAULTS = {
    "none": [],
    "int32_plane": ["program.gather-widening", "program.collective-budget"],
    "two_gathers": ["program.gather-count", "program.collective-budget"],
    "over_budget": ["program.collective-budget"],
    "routed_gather": ["program.gather-count"]}


def _fault_rank(rank, world, faults):
    """2-rank exchanges on the FULL_BACKPLANE twin, each with one fault of
    ``faults`` planted in this process's executor; returns each one's wire
    log, plan and cap_in."""
    from repro_torch.core import fabric as fab
    from repro_torch.core.events import EventFrame
    from repro_torch.core.routing import identity_tables
    from repro_torch.parallel.sharding import fabric_mesh

    saved = {k: getattr(fab, k) for k in ("_gather_plane", "_routed_plane",
                                          "pack_wire16")}
    gather = saved["_gather_plane"]

    def planted(fn):
        fn.calls = fn.bytes = 0
        fab._gather_plane = fn

    out = {}
    for fault in faults:
        if fault == "int32_plane":
            fab.pack_wire16 = lambda labels, valid: torch.where(
                valid, labels, 0).to(torch.int32)
        elif fault == "two_gathers":
            planted(lambda x, g, level: (gather(x, g, level),
                                         gather(x, g, level))[1])
        elif fault == "over_budget":
            planted(lambda x, g, level: gather(
                torch.cat([x, x], dim=-1), g, level)[..., :x.shape[-1]])
        elif fault == "routed_gather":
            fab._routed_plane = lambda x, g, perms, level: gather(x, g, level)
        plan, cap = tprog.shrink_plan(T_SCENARIOS["FULL_BACKPLANE"].plan, 64)
        if fault == "routed_gather":
            plan = tfab.with_exchange_mode(plan, "routed")
        tables = identity_tables(device="cpu")
        fn = fab.FabricInterconnect(
            mesh=fabric_mesh(plan, device_type="cpu"), plan=plan).exchange_fn()
        frame = EventFrame(torch.arange(cap, dtype=torch.int32),
                           torch.zeros(cap, dtype=torch.int32),
                           torch.ones(cap, dtype=torch.bool))
        with fab.wire_log() as log:
            fn(frame, tables.fwd, tables.rev)
        for k, v in saved.items():
            setattr(fab, k, v)
        out[fault] = ([tuple(c) for c in log], plan, cap)
    return out


@pytest.fixture(scope="module")
def wire_faults():
    """Every planted wire fault's rank-0 result, from one group of ranks."""
    return run_ranks(_fault_rank, 2, list(WIRE_FAULTS), timeout_s=300)[0]


@pytest.mark.parametrize("fault", list(WIRE_FAULTS))
def test_planted_wire_fault_flagged(wire_faults, fault):
    log, plan, cap = wire_faults[fault]
    log = [tfab.WireCall(*c) for c in log]
    assert log and all(c.level == 0 for c in log)
    lint = (tprog.check_routed if plan.exchange_mode == "routed"
            else tprog.check_gathers)
    diags = lint(log, "prog", plan=plan, cap_in=cap)
    assert [d.check for d in diags] == WIRE_FAULTS[fault]
    if fault == "none":
        assert log == [tfab.WireCall("all_gather", 0, torch.int16,
                                     tprog.gather_budget_bytes(plan, cap))]


def test_wire_log_records_only_inside_its_block():
    assert tfab._WIRE_LOG is None
    with tfab.wire_log() as outer:
        tfab._record_wire("all_gather", 1, torch.zeros(2, dtype=torch.int16),
                          8)
        with tfab.wire_log() as inner:
            tfab._record_wire("routed", 0, torch.zeros(1), 4)
        assert inner == [tfab.WireCall("routed", 0, torch.float32, 4)]
    assert outer == [tfab.WireCall("all_gather", 1, torch.int16, 8)]
    assert tfab._WIRE_LOG is None
    tfab._record_wire("routed", 0, torch.zeros(1), 4)        # not recorded


def test_routed_wire_checks_like_reference_semantics():
    """``check_routed`` on hand-made logs: the int32 plane is legal on the
    timed lane only, and any all-gather is an error."""
    sc = T_SCENARIOS["PROJECTED_120CHIP"]
    twin, cap = tprog.shrink_plan(sc.plan, sc.cap_in)
    budget = tprog.routed_budget_bytes(twin, cap)
    assert 0 < budget < tprog.gather_budget_bytes(twin, cap)
    wide = [tfab.WireCall("routed", 0, torch.int32, 4)]
    assert [d.check for d in tprog.check_routed(wide, "p")] == [
        "program.gather-widening"]
    assert tprog.check_routed(wide, "p", timed=True) == []
    over = [tfab.WireCall("routed", 1, torch.int16, budget + 2)]
    assert [d.check for d in tprog.check_routed(
        over, "p", plan=twin, cap_in=cap)] == ["program.collective-budget"]
    missing = tprog.check_gathers([], "p", plan=twin, cap_in=cap)
    assert [(d.check, d.severity) for d in missing] == [
        ("program.gather-count", WARNING)] * twin.n_levels


# ---------------------------------------------------------------------------
# Suppressions and the CLI
# ---------------------------------------------------------------------------


def test_suppression_waives_matching_finding():
    d = Diagnostic("plan.detours", "X/level[1]/edge[0]", "msg")
    active, suppressed = apply_suppressions(
        [d], [Suppression("plan.detours", "X/", reason="known-flaky rig")])
    assert suppressed == [d] and active == []
    assert SUPPRESSIONS == ()


def test_stale_suppression_fails_the_run():
    active, suppressed = apply_suppressions(
        [], [Suppression("plan.detours", reason="long gone")])
    assert suppressed == []
    assert [d.check for d in active] == ["suppression.stale"]
    assert active[0].severity != WARNING
    want, _ = japply([], [JSuppression("plan.detours", reason="long gone")])
    assert rows(active) == rows(want)


def test_undocumented_suppression_fails_the_run():
    d = Diagnostic("plan.detours", "X", "msg")
    active, _ = apply_suppressions([d], [Suppression("plan.detours")])
    assert "suppression.undocumented" in {a.check for a in active}
    want, _ = japply([JDiagnostic("plan.detours", "X", "msg")],
                     [JSuppression("plan.detours")])
    assert rows(active) == rows(want)
    assert d.format() == JDiagnostic("plan.detours", "X", "msg").format()


def test_cli_exit_codes(monkeypatch, capsys):
    monkeypatch.setattr(tlint, "run_lint", lambda **kw: [])
    assert tlint.main(["-q", "--device", "cpu"]) == 0
    bad = Diagnostic("plan.merge-segments", "EXT/level[0]", "segments clash")
    monkeypatch.setattr(tlint, "run_lint", lambda **kw: [bad])
    assert tlint.main(["-q"]) == 1
    out = capsys.readouterr().out
    assert "plan.merge-segments @ EXT/level[0]" in out      # path-qualified
    assert out.strip().splitlines()[-1] == (
        "fabric lint: 1 error(s), 0 warning(s), 0 suppressed across 1 "
        "failing check(s)")
    warn = Diagnostic("plan.detours", "EXT", "odd but legal", WARNING)
    monkeypatch.setattr(tlint, "run_lint", lambda **kw: [warn])
    assert tlint.main(["-q"]) == 0                          # warnings pass
    monkeypatch.setattr(tlint, "run_lint", lambda **kw: [])
    monkeypatch.setattr(tlint, "SUPPRESSIONS",
                        (Suppression("plan.detours", reason="gone"),))
    assert tlint.main(["-q"]) == 1                          # stale waiver
    with pytest.raises(SystemExit):
        tlint.main(["--hlo"])                               # no HLO pass


def test_lint_cli_on_the_catalogue_passes(capsys):
    """The acceptance gate on the CPU: every pass over every scenario is
    error-free, and the one card pass says it did not run."""
    assert tlint.main(["-q", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == ("fabric lint: 0 error(s), 1 warning(s), 0 suppressed "
                       "across 1 failing check(s)")
    assert out[0].startswith("warning: kernel.devices @ spike_router: ")


def test_run_lint_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlint.run_lint()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the router kernels); run on the "
                    "card with -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_check_of_every_router_body_clean(cuda_device):
    assert tkc.check_router_kernels(cuda_device) == []


@pytest.mark.cuda
def test_run_lint_on_the_card_clean(cuda_device):
    findings = tlint.run_lint(device="cuda")
    assert findings == [], [d.format() for d in findings]
