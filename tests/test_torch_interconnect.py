"""The port's §III single-device datapath against the JAX package: the
egress router (``route_and_pack``), the streaming exchange
(``fused_exchange_stream``), the legacy ``route_step`` family, the
Aggregator's ``aggregate``/``aggregate_baseline``, the Node-FPGA
``route_outbound``/``route_inbound`` and the layer-2 wire format.

Inputs are drawn with numpy from fixed seeds and fed to both packages.
Every comparison is bit-exact: these are integer functions.  On the CPU the
kernel wrappers run their plain PyTorch versions; they are held against the
Pallas kernel bodies (``interpret``) at one small shape each and against
the JAX oracles at the others.  The CUDA kernels are held against the same
plain versions on the card (``cuda``-marked tests here, and
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregator as jagg
from repro.core import events as jev
from repro.core import routing as jrt
from repro.core.latency import timed_wire as j_timed_wire
from repro.kernels.spike_router import ops as jops
from repro.kernels.spike_router import ref as jref
from repro_torch import convert
from repro_torch.core import aggregator as tagg
from repro_torch.core import events as tev
from repro_torch.core import routing as trt
from repro_torch.core.latency import timed_wire as t_timed_wire
from repro_torch.kernels.spike_router import ops as tops
from repro_torch.kernels.spike_router import ref as tref
from torch_threads import share_cores

share_cores()

CPU = torch.device("cpu")


def _eq(name, ref, got):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    np.testing.assert_array_equal(got, ref.astype(got.dtype), err_msg=name)


def _frames_eq(name, ref, got):
    for f in ("labels", "times", "valid"):
        _eq(f"{name} {f}", getattr(ref, f), getattr(got, f))


def _fwd_lut(rng, n_lab=4096, enable_frac=0.7):
    """A scrambled fwd LUT over the first ``n_lab`` labels, a share of them
    disabled; every other entry is zero (disabled)."""
    ids = np.arange(n_lab, dtype=np.int32)
    en = rng.random(n_lab) < enable_frac
    return np.array(jrt.build_fwd_table(jnp.asarray(ids),
                                        jnp.asarray((ids * 7 + 3) % 32768),
                                        jnp.asarray(en)))


def _router(rng, n, enable_frac=0.8, n_lab=2048):
    """Stacked per-node LUTs with a label scramble and partial enables, and
    random route enables, as numpy (fwd, rev, enables)."""
    ids = np.arange(n_lab, dtype=np.int32)
    scramble = (ids * 5 + 11) % 32768
    fwd = np.asarray(jrt.build_fwd_table(
        jnp.asarray(ids), jnp.asarray(scramble),
        jnp.asarray(rng.random(n_lab) < enable_frac)))
    rev = np.asarray(jrt.build_rev_table(jnp.asarray(scramble),
                                         jnp.asarray(ids)))
    enables = rng.random((n, n)) < 0.75
    return (np.broadcast_to(fwd, (n, fwd.size)).copy(),
            np.broadcast_to(rev, (n, rev.size)).copy(), enables)


def _egress(rng, shape, p, n_lab=2048):
    labels = rng.integers(0, n_lab, shape).astype(np.int32)
    times = rng.integers(0, 4000, shape).astype(np.int32)
    valid = rng.random(shape) < p
    return labels, times, valid


def _jframe(labels, times, valid):
    return jev.EventFrame(jnp.asarray(labels), jnp.asarray(times),
                          jnp.asarray(valid))


def _tframe(labels, times, valid):
    return tev.EventFrame(*(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (labels, times, valid)))


# ---------------------------------------------------------------------------
# route_and_pack: the egress router
# ---------------------------------------------------------------------------


def test_route_and_pack_matches_pallas():
    """One small shape against the Pallas kernel body: labels above 2^16
    and below 0 exercise the ``& 0xFFFF`` index, a disabled share and
    capacity overflow both occur."""
    rng = np.random.default_rng(20)
    lut = _fwd_lut(rng)
    labels = rng.integers(-(1 << 17), 1 << 17, (3, 96)).astype(np.int32)
    labels[:, ::3] &= 4095                    # a share hits mapped entries
    valid = rng.random((3, 96)) < 0.8
    got = tops.route_and_pack(torch.from_numpy(labels),
                              torch.from_numpy(valid), torch.from_numpy(lut),
                              capacity=16)
    assert got[1].dtype == torch.bool and got[2].dtype == torch.int32
    assert int(got[2].max()) > 0, "no overflow exercised"
    ref = jops.route_and_pack(jnp.asarray(labels), jnp.asarray(valid),
                              jnp.asarray(lut), capacity=16, interpret=True)
    for i, (r, g) in enumerate(zip(ref, got, strict=True)):
        _eq(f"output {i}", r, g)


# (leading shape, n_events, capacity, enable_frac): the JAX suite's router
# cases, plus leading dims.
ROUTER_CASES = [((1,), 128, 256, 1.0), ((2,), 256, 64, 0.7),
                ((4,), 128, 16, 0.3), ((1,), 1024, 512, 0.9),
                ((2, 3), 40, 8, 0.5)]


@pytest.mark.parametrize("lead,n,cap,frac", ROUTER_CASES)
def test_route_and_pack_matches_oracle(lead, n, cap, frac):
    rng = np.random.default_rng(21 + n)
    lut = _fwd_lut(rng, enable_frac=frac)
    labels = rng.integers(0, 4096, (*lead, n)).astype(np.int32)
    valid = rng.random((*lead, n)) < 0.6
    got = tops.route_and_pack(torch.from_numpy(labels),
                              torch.from_numpy(valid), torch.from_numpy(lut),
                              capacity=cap)
    ref_l, ref_v, ref_d = jref.spike_router_ref(
        jnp.asarray(labels.reshape(-1, n)), jnp.asarray(valid.reshape(-1, n)),
        jnp.asarray(lut), capacity=cap)
    _eq("labels", np.asarray(ref_l).reshape(*lead, cap), got[0])
    _eq("valid", np.asarray(ref_v).reshape(*lead, cap), got[1])
    _eq("dropped", np.asarray(ref_d).reshape(lead), got[2])
    # Conservation: every enabled valid event is kept or dropped.
    enabled = valid & ((lut[labels & 0xFFFF] >> 15) & 1).astype(bool)
    np.testing.assert_array_equal(
        got[1].sum(-1).numpy() + got[2].numpy(), enabled.sum(-1))


def test_route_and_pack_identity_router_silences_high_labels():
    """Chips 64 and up emit labels of 2^15 and above, which hit disabled
    entries of the identity fwd table: dropped as disabled, not counted."""
    chips = np.arange(60, 70, dtype=np.int32)
    labels = (chips[:, None] << 9) + np.arange(512, dtype=np.int32)
    valid = np.random.default_rng(22).random(labels.shape) < 0.05
    lut = trt.identity_tables(device="cpu").fwd
    out_l, out_v, dropped = tops.route_and_pack(
        torch.from_numpy(labels), torch.from_numpy(valid), lut, capacity=64)
    kept = out_v.sum(-1).numpy()
    np.testing.assert_array_equal(kept[:4], valid[:4].sum(-1))
    assert (kept[4:] == 0).all() and (dropped.numpy() == 0).all()
    ref = jops.route_and_pack(jnp.asarray(labels), jnp.asarray(valid),
                              jnp.asarray(lut.numpy()), capacity=64)
    for i, (r, g) in enumerate(zip(ref, (out_l, out_v, dropped))):
        _eq(f"output {i}", r, g)


# ---------------------------------------------------------------------------
# fused_exchange_stream: the streaming exchange of the plain star
# ---------------------------------------------------------------------------


def _stream_inputs(seed, n_steps, n, cap_in, p):
    rng = np.random.default_rng(seed)
    labels, _, valid = _egress(rng, (n_steps, n, cap_in), p)
    return labels, valid, *_router(rng, n)


@pytest.mark.parametrize("mode,seed,n_steps,n,cap_in,cap", [
    ("interpret", 30, 3, 4, 16, 12),
    ("jax", 31, 6, 5, 24, 16),
    ("jax", 32, 4, 3, 8, 64)])
def test_fused_exchange_stream_matches_jax(mode, seed, n_steps, n, cap_in,
                                           cap):
    arrays = _stream_inputs(seed, n_steps, n, cap_in, 0.6)
    got = tops.fused_exchange_stream(*map(torch.from_numpy, arrays),
                                     capacity=cap)
    ref = jops.fused_exchange_stream(*map(jnp.asarray, arrays), capacity=cap,
                                     mode=mode)
    for i, (r, g) in enumerate(zip(ref, got, strict=True)):
        _eq(f"{mode} output {i}", r, g)
    if cap < cap_in * n:
        assert int(got[2].max()) > 0, "no overflow exercised"


def test_fused_exchange_stream_equals_route_step_loop():
    """The stream is T ``route_step`` rounds, bit for bit, in every field,
    in the port and against the reference's ``route_step``."""
    labels, valid, fwd, rev, enables = _stream_inputs(33, 5, 4, 16, 0.7)
    state = tagg.RouterState(*map(torch.from_numpy, (fwd, rev, enables)))
    jstate = jagg.RouterState(*map(jnp.asarray, (fwd, rev, enables)))
    out_l, out_v, dropped = tops.fused_exchange_stream(
        torch.from_numpy(labels), torch.from_numpy(valid), state.fwd_tables,
        state.rev_tables, state.route_enables, capacity=20)
    zeros = np.zeros_like(labels[0])
    for t in range(labels.shape[0]):
        frame, d_t = tagg.route_step(
            state, _tframe(labels[t], zeros, valid[t]), 20)
        assert torch.equal(frame.labels, out_l[t])
        assert torch.equal(frame.valid, out_v[t])
        assert torch.equal(d_t, dropped[t])
        assert not frame.times.any()
        ref, ref_d = jagg.route_step(jstate, _jframe(labels[t], zeros,
                                                     valid[t]), 20)
        _frames_eq(f"step {t}", ref, frame)
        _eq(f"step {t} dropped", ref_d, d_t)


def test_fused_exchange_stream_argument_checks():
    labels, valid, fwd, rev, enables = map(
        torch.from_numpy, _stream_inputs(34, 2, 3, 8, 0.5))
    with pytest.raises(ValueError, match="T, n_src, cap_in"):
        tops.fused_exchange_stream(labels[0], valid[0], fwd, rev, enables,
                                   capacity=4)
    with pytest.raises(ValueError, match="must match"):
        tops.fused_exchange_stream(labels, valid[:, :, :1], fwd, rev,
                                   enables, capacity=4)
    with pytest.raises(ValueError, match="enables must be"):
        tops.fused_exchange_stream(labels, valid, fwd, rev, enables[:2],
                                   capacity=4)


# ---------------------------------------------------------------------------
# The route_step family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("timed", [False, True])
def test_route_step_matches(timed):
    rng = np.random.default_rng(40)
    fwd, rev, enables = _router(rng, 6)
    labels, times, valid = _egress(rng, (6, 20), 0.6)
    got, got_d = tagg.route_step(
        tagg.RouterState(*map(torch.from_numpy, (fwd, rev, enables))),
        _tframe(labels, times, valid), 24,
        timing=t_timed_wire() if timed else None)
    ref, ref_d = jagg.route_step(
        jagg.RouterState(*map(jnp.asarray, (fwd, rev, enables))),
        _jframe(labels, times, valid), 24,
        timing=j_timed_wire() if timed else None)
    _frames_eq("ingress", ref, got)
    _eq("dropped", ref_d, got_d)
    assert int(got_d.max()) > 0, "no overflow exercised"


def test_route_step_batch_rows_equal_single_rounds():
    """Leading dims are independent rows: one call equals one per row."""
    rng = np.random.default_rng(41)
    fwd, rev, enables = _router(rng, 4)
    state = tagg.RouterState(*map(torch.from_numpy, (fwd, rev, enables)))
    labels, times, valid = _egress(rng, (3, 4, 16), 0.5)
    batched, d_b = tagg.route_step(state, _tframe(labels, times, valid), 12)
    for b in range(3):
        one, d_1 = tagg.route_step(state, _tframe(labels[b], times[b],
                                                  valid[b]), 12)
        for f in ("labels", "times", "valid"):
            assert torch.equal(getattr(one, f), getattr(batched, f)[b])
        assert torch.equal(d_1, d_b[b])


@pytest.mark.parametrize("caps,timed", [((None, None), False),
                                        ((6, 10), False), ((6, 10), True)])
def test_route_step_hierarchical_matches(caps, timed):
    rng = np.random.default_rng(42)
    n_pods, per = 2, 3
    fwd, rev, _ = _router(rng, n_pods * per)
    intra = rng.random((per, per)) < 0.8
    inter = np.ones((n_pods, n_pods), bool)
    labels, times, valid = _egress(rng, (n_pods * per, 20), 0.5)
    kw = dict(n_pods=n_pods, link_capacity=caps[0], pod_capacity=caps[1])
    enables = np.ones((n_pods * per,) * 2, bool)
    got, got_d = tagg.route_step_hierarchical(
        tagg.RouterState(*map(torch.from_numpy, (fwd, rev, enables))),
        _tframe(labels, times, valid), 16, intra_enables=intra,
        inter_enables=inter, timing=t_timed_wire() if timed else None, **kw)
    ref, ref_d = jagg.route_step_hierarchical(
        jagg.RouterState(*map(jnp.asarray, (fwd, rev, enables))),
        _jframe(labels, times, valid), 16, intra_enables=jnp.asarray(intra),
        inter_enables=jnp.asarray(inter),
        timing=j_timed_wire() if timed else None, **kw)
    _frames_eq("ingress", ref, got)
    for f in ("congestion", "uplink", "unroutable", "rerouted"):
        _eq(f, getattr(ref_d, f), getattr(got_d, f))
    if caps[0] is not None:
        assert int(got_d.uplink.max()) > 0, "no uplink overflow exercised"


def test_route_step_hierarchical_rejects_uneven_pods():
    state = tagg.identity_router(5, device="cpu")
    frame = _tframe(*(np.zeros((5, 4), dt) for dt in (np.int32, np.int32,
                                                      bool)))
    with pytest.raises(ValueError, match="pods evenly"):
        tagg.route_step_hierarchical(state, frame, 8, n_pods=2,
                                     intra_enables=None, inter_enables=None)


def test_route_step_baseline_matches_and_agrees_with_route_step():
    rng = np.random.default_rng(43)
    fwd, rev, enables = _router(rng, 5)
    labels, times, valid = _egress(rng, (5, 24), 0.6)
    state = tagg.RouterState(*map(torch.from_numpy, (fwd, rev, enables)))
    got, got_d = tagg.route_step_baseline(state,
                                          _tframe(labels, times, valid), 16)
    ref, ref_d = jagg.route_step_baseline(
        jagg.RouterState(*map(jnp.asarray, (fwd, rev, enables))),
        _jframe(labels, times, valid), 16)
    _frames_eq("baseline ingress", ref, got)
    _eq("baseline dropped", ref_d, got_d)
    fused, fused_d = tagg.route_step(state, _tframe(labels, times, valid), 16)
    assert torch.equal(torch.where(got.valid, got.labels, 0), fused.labels)
    assert torch.equal(got.valid, fused.valid)
    assert torch.equal(got_d, fused_d)


# ---------------------------------------------------------------------------
# Aggregator, Node-FPGA stages, enables, router hand-over
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [8, 40, 200])
def test_aggregate_and_baseline_match(cap):
    rng = np.random.default_rng(50 + cap)
    labels, times, valid = _egress(rng, (4, 30), 0.5)
    enables = rng.random((4, 5)) < 0.7
    for name in ("aggregate", "aggregate_baseline"):
        got, got_d = getattr(trt, name)(_tframe(labels, times, valid),
                                        torch.from_numpy(enables), cap)
        ref, ref_d = getattr(jrt, name)(_jframe(labels, times, valid),
                                        jnp.asarray(enables), cap)
        _frames_eq(name, ref, got)
        _eq(f"{name} dropped", ref_d, got_d)
    # The fused broadcast keeps leading dims as independent rows.
    two = _tframe(*(np.stack([a, a[::-1]]) for a in (labels, times, valid)))
    both, both_d = trt.aggregate(two, torch.from_numpy(enables), cap)
    one, one_d = trt.aggregate(_tframe(labels, times, valid),
                               torch.from_numpy(enables), cap)
    assert torch.equal(both.labels[0], one.labels)
    assert torch.equal(both_d[0], one_d)


def test_route_outbound_inbound_match():
    rng = np.random.default_rng(51)
    fwd, rev, _ = _router(rng, 1)
    labels, times, valid = _egress(rng, (3, 25), 0.6)
    tables = trt.RoutingTables(torch.from_numpy(fwd[0]),
                               torch.from_numpy(rev[0]))
    jtables = jrt.RoutingTables(jnp.asarray(fwd[0]), jnp.asarray(rev[0]))
    out = trt.route_outbound(tables, _tframe(labels, times, valid))
    ref = jrt.route_outbound(jtables, _jframe(labels, times, valid))
    _frames_eq("outbound", ref, out)
    back = trt.route_inbound(tables, out, system_time=1234)
    ref_back = jrt.route_inbound(jtables, ref, system_time=1234)
    _frames_eq("inbound", ref_back, back)


def test_route_enables_and_identity_tables_match():
    for n, receiver in ((4, 0), (6, 3)):
        _eq("fan-in", jrt.fan_in_route_enables(n, receiver),
            trt.fan_in_route_enables(n, receiver, device="cpu"))
    ids = trt.identity_tables(500, device="cpu")
    assert isinstance(ids, trt.RoutingTables)
    ref = jrt.identity_tables(500)
    _eq("identity fwd", ref.fwd, ids.fwd)
    _eq("identity rev", ref.rev, ids.rev)
    state = tagg.identity_router(5, device="cpu")
    jstate = jagg.identity_router(5)
    for f in ("fwd_tables", "rev_tables", "route_enables"):
        _eq(f, getattr(jstate, f), getattr(state, f))


def test_router_state_from_numpy():
    jstate = jagg.identity_router(3, jrt.feedforward_route_enables(3), 700)
    arrays = {f: np.array(getattr(jstate, f)) for f in jstate._fields}
    state = convert.router_state_from_numpy(arrays, device="cpu")
    assert isinstance(state, tagg.RouterState)
    for f in jstate._fields:
        _eq(f, arrays[f], getattr(state, f))
    assert state.route_enables.dtype == torch.bool
    with pytest.raises(KeyError, match="rev_tables"):
        convert.router_state_from_numpy(
            {k: v for k, v in arrays.items() if k != "rev_tables"},
            device="cpu")


def test_builders_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tagg.identity_router(12),
                 lambda: trt.identity_tables(),
                 lambda: trt.build_fwd_table([1], [2]),
                 lambda: trt.build_rev_table([1], [2]),
                 lambda: trt.full_route_enables(3),
                 lambda: trt.feedforward_route_enables(3),
                 lambda: trt.fan_in_route_enables(3, 0),
                 lambda: tev.empty_frame(4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tev.empty_frame(4, (2,), device="cpu").labels.device == CPU


# ---------------------------------------------------------------------------
# Wire format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,cap", [((3, 40), 16), ((2, 5), 12),
                                       ((2, 3, 30), 30)])
def test_make_frame_argsort_matches(shape, cap):
    rng = np.random.default_rng(60 + cap)
    labels, times, valid = _egress(rng, shape, 0.5, 1 << 16)
    got, got_d = tev.make_frame_argsort(*map(torch.from_numpy,
                                             (labels, times, valid)), cap)
    ref, ref_d = jev.make_frame_argsort(*map(jnp.asarray,
                                             (labels, times, valid)), cap)
    _frames_eq("argsort frame", ref, got)          # garbage slots included
    _eq("dropped", ref_d, got_d)
    packed, packed_d = tev.make_frame(*map(torch.from_numpy,
                                           (labels, times, valid)), cap)
    assert torch.equal(torch.where(got.valid, got.labels, 0), packed.labels)
    assert torch.equal(got_d, packed_d)


def test_concatenate_frames_matches():
    rng = np.random.default_rng(61)
    parts = [_egress(rng, (2, k), 0.6) for k in (5, 9, 7)]
    got, got_d = tev.concatenate_frames([_tframe(*p) for p in parts], 12)
    ref, ref_d = jev.concatenate_frames([_jframe(*p) for p in parts], 12)
    _frames_eq("concatenated", ref, got)
    _eq("dropped", ref_d, got_d)


@pytest.mark.parametrize("cap", [12, 13, 14])
def test_pack_unpack_words_match(cap):
    rng = np.random.default_rng(62 + cap)
    labels, times, valid = _egress(rng, (2, 3, cap), 0.5, 1 << 16)
    valid[0, 0] = False                          # a frame with empty words
    frame, jframe = _tframe(labels, times, valid), _jframe(labels, times,
                                                           valid)
    words, jwords = tev.pack_words(frame), jev.pack_words(jframe)
    for f in ("labels", "times", "valid"):
        _eq(f"words {f}", getattr(jwords, f), getattr(words, f))
    for base, capacity in ((0, None), (70000, cap)):
        got = tev.unpack_words(words, base, capacity)
        ref = jev.unpack_words(jwords, base, capacity)
        _frames_eq(f"unpacked base {base}", ref, got)
    with pytest.raises(ValueError, match="does not match"):
        tev.unpack_words(words, 0, cap - 3)
    n = np.arange(0, 20, dtype=np.int32)
    _eq("words_required", jev.words_required(jnp.asarray(n)),
        tev.words_required(torch.from_numpy(n)))
    assert tev.words_required(7) == 3


# ---------------------------------------------------------------------------
# Body rules and the egress router's in-place rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,body", [(1, "row"), (512, "row"), (513, "row"),
                                    (4096, "row"), (4097, "row"),
                                    (8192, "row"), (8193, "tiled")])
def test_route_and_pack_body_rule(n, body):
    assert tops.route_and_pack_body_for(n) == body


# (n_src, cap_in, n_dst): the streaming exchange takes the exchange
# kernel's bodies by the exchange kernel's rule.
@pytest.mark.parametrize("shape,body", [
    ((12, 64, 12), "row"),                # FULL_BACKPLANE's stream
    ((16, 256, 12), "row"),               # exactly 4,096 items
    ((1, 4097, 12), "tiled"),             # 4,097 items
    ((32, 64, 12), "row"),                # 32 sources, a lane each
    ((33, 64, 12), "tiled"),              # 33 sources
    ((12, 64, 3398), "row"),              # enables just within 48 KiB
    ((12, 64, 3399), "tiled"),            # enables past 48 KiB
])
def test_exchange_stream_body_rule(shape, body):
    assert tops.exchange_body_for(*shape) == body


@pytest.mark.parametrize("n_steps,n_dst,groups", [
    (64, 12, 2),                          # phase 7's stream: 128 CTAs
    (32, 12, 4), (8, 12, 12),             # shorter streams split further
    (8, 5, 5),                            # at most a CTA a destination
    (132, 12, 1), (300, 3, 1),            # the card full at one a timestep
    (0, 12, 12)])
def test_exchange_stream_row_groups_fill_one_wave(n_steps, n_dst, groups):
    assert tops.row_groups(n_steps, n_dst, 132) == groups


def _rows_read_in_place(t, layout):
    """The rows a kernel reads from ``t``'s memory by ``layout``, as a
    [rows, n] tensor."""
    inner, outer_stride, inner_stride = layout
    n = t.shape[-1]
    r = torch.arange(t.numel() // n)[:, None]
    at = ((r // inner) * outer_stride + (r % inner) * inner_stride
          + torch.arange(n)[None, :])
    memory = torch.as_strided(t, (int(at.max()) + 1,), (1,),
                              t.storage_offset())
    return memory[at]


def _views():
    grid = torch.arange(5 * 16, dtype=torch.int32).reshape(5, 16)
    raster = torch.arange(5 * 3 * 16, dtype=torch.int32).reshape(5, 3, 16)
    return {
        "contiguous": (torch.arange(2 * 3 * 4 * 16).reshape(2, 3, 4, 16),
                       (24, 0, 16)),
        "grid_expanded_over_batch": (grid.expand(3, 5, 16), (5, 0, 16)),
        "one_row_expanded": (grid[0].expand(7, 16), (7, 0, 0)),
        "transposed_raster": (raster.transpose(0, 1), (5, 16, 48)),
        "rows_sliced": (torch.arange(6 * 40).reshape(6, 40)[:, 3:19],
                        (6, 0, 40)),
        "size_one_dims": (grid[None, :, None], (5, 0, 16)),
        "one_row": (grid[1], (1, 0, 0)),
        "three_strided_dims": (torch.zeros(4, 3, 2, 16).permute(2, 1, 0, 3),
                               None),
        "last_dim_strided": (grid[:, ::2], None),
    }


@pytest.mark.parametrize("case", list(_views()))
def test_row_layout_reads_the_rows_in_place(case):
    """The rule by which the spike_router kernel reads labels and flags in
    place: a label grid expanded over the batch (phase 7's call), a
    transposed raster, sliced rows; a layout it cannot fold into two
    strides is copied by the wrapper."""
    t, layout = _views()[case]
    assert tops.row_layout(t) == layout
    if layout is not None:
        assert torch.equal(_rows_read_in_place(t, layout),
                           t.reshape(-1, t.shape[-1]))


# ---------------------------------------------------------------------------
# Dispatch: the CPU never launches; the kernels on the card
# ---------------------------------------------------------------------------


def test_cpu_tensors_never_launch():
    before = (tops.route_and_pack.launches,
              tops.fused_exchange_stream.launches)
    test_route_and_pack_matches_oracle((2,), 256, 64, 0.7)
    test_fused_exchange_stream_matches_jax("jax", 31, 6, 5, 24, 16)
    assert (tops.route_and_pack.launches,
            tops.fused_exchange_stream.launches) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py checks them on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lead,n,cap,frac", ROUTER_CASES)
def test_spike_router_kernel_matches_plain(cuda_device, lead, n, cap, frac):
    rng = np.random.default_rng(70 + n)
    lut = torch.from_numpy(_fwd_lut(rng, enable_frac=frac))
    labels = torch.from_numpy(
        rng.integers(-(1 << 17), 1 << 17, (*lead, n)).astype(np.int32))
    valid = torch.from_numpy(rng.random((*lead, n)) < 0.6)
    ref = tref.spike_router_ref(labels, valid, lut, capacity=cap)
    got = tops.route_and_pack(labels.to(cuda_device), valid.to(cuda_device),
                              lut.to(cuda_device), capacity=cap)
    torch.cuda.synchronize()
    for r, g in zip(ref, got, strict=True):
        assert torch.equal(r, g.cpu())


# (lead, n, capacity, body): every body of the spike_router kernel and its
# edges (a warp per 128 events up to 4,096, per 256 beyond), labels
# anywhere in int32.
ROUTER_BODY_CASES = {
    "row_main_shape": ((8, 120), 512, 32, "row"),
    "row_shorter_than_a_run": ((5,), 3, 8, "row"),
    "row_odd_length": ((7,), 37, 12, "row"),
    "row_capacity_0": ((6,), 200, 0, "row"),
    "row_capacity_beyond_n": ((4,), 256, 512, "row"),
    "row_513": ((3,), 513, 40, "row"),
    "row_ragged": ((2, 2), 3001, 300, "row"),
    "row_4096": ((2,), 4096, 700, "row"),
    "row_two_stripes": ((3,), 4097, 300, "row"),
    "row_longest": ((2,), 8192, 8192, "row"),
    "row_capacity_0_long": ((2,), 6000, 0, "row"),
    "tiled": ((2,), 8193, 300, "tiled"),
    "tiled_capacity_beyond_n": ((1,), 9000, 10000, "tiled"),
}


def _route(tensors, cap):
    """route_and_pack on the given tensors, with the body its launch took."""
    before = dict(tops.route_and_pack.launches_by_path)
    got = tops.route_and_pack(*tensors, capacity=cap)
    bodies = [k for k, v in tops.route_and_pack.launches_by_path.items()
              if v != before[k]]
    return got, bodies


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROUTER_BODY_CASES))
def test_spike_router_bodies_match_plain(cuda_device, case):
    lead, n, cap, body = ROUTER_BODY_CASES[case]
    assert tops.route_and_pack_body_for(n) == body
    rng = np.random.default_rng(72 + n)
    lut = _fwd_lut(rng, enable_frac=0.8)
    labels = rng.integers(-(1 << 31), (1 << 31) - 1, (*lead, n),
                          dtype=np.int64).astype(np.int32)
    labels[..., ::2] &= 4095                  # a share hits mapped entries
    valid = rng.random((*lead, n)) < 0.6
    cpu = [torch.from_numpy(a) for a in (labels, valid, lut)]
    ref = tref.spike_router_ref(*cpu, capacity=cap)
    got, bodies = _route([t.to(cuda_device) for t in cpu], cap)
    torch.cuda.synchronize()
    assert bodies == [body]
    for r, g in zip(ref, got, strict=True):
        assert torch.equal(r, g.cpu())
    if cap == 0:                 # every enabled valid event is dropped
        enabled = valid & ((lut[labels & 0xFFFF] >> 15) & 1).astype(bool)
        np.testing.assert_array_equal(got[2].cpu().numpy(), enabled.sum(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("body,n", [("row", 512), ("row", 5000),
                                    ("tiled", 8200)])
def test_spike_router_expanded_view_equals_contiguous_copy(cuda_device, body,
                                                           n):
    """Phase 7's call: the egress label grid expanded over the batch
    (stride 0) and a transposed raster are read in place and give what
    their contiguous copies give."""
    rng = np.random.default_rng(73)
    lut = torch.from_numpy(_fwd_lut(rng)).to(cuda_device)
    grid = torch.from_numpy(rng.integers(0, 8192, (12, n)).astype(
        np.int32)).to(cuda_device)
    raster = torch.from_numpy(rng.random((12, 4, n)) < 0.3).to(cuda_device)
    labels, valid = grid.expand(4, 12, n), raster.transpose(0, 1)
    assert tops.row_layout(labels) == (12, 0, n)
    assert tops.row_layout(valid) == (12, n, 4 * n)
    got, bodies = _route((labels, valid, lut), 40)
    want, _ = _route((labels.contiguous(), valid.contiguous(), lut), 40)
    torch.cuda.synchronize()
    assert bodies == [body]
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    ref = tref.spike_router_ref(labels.cpu(), valid.cpu(), lut.cpu(),
                                capacity=40)
    for r, g in zip(ref, got, strict=True):
        assert torch.equal(r, g.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n_steps,n,cap_in,cap,p,body", [
    (64, 12, 64, 256, 0.05, "row"), (7, 5, 24, 16, 0.6, "row"),
    (300, 3, 8, 4, 0.9, "row"), (4, 16, 256, 300, 0.3, "row"),
    (5, 4, 20, 0, 0.5, "row"), (3, 6, 50, 400, 0.9, "row"),
    (3, 1, 4097, 512, 0.2, "tiled"), (6, 33, 16, 40, 0.5, "tiled")])
def test_exchange_stream_kernel_matches_plain_and_loop(cuda_device, n_steps,
                                                       n, cap_in, cap, p,
                                                       body):
    arrays = [torch.from_numpy(a) for a in
              _stream_inputs(71, n_steps, n, cap_in, p)]
    ref = tref.exchange_stream_ref(*arrays, capacity=cap)
    card = [a.to(cuda_device) for a in arrays]
    before = dict(tops.fused_exchange_stream.launches_by_path)
    got = tops.fused_exchange_stream(*card, capacity=cap)
    loop = tops.fused_exchange(*card, capacity=cap)    # batch = T
    torch.cuda.synchronize()
    assert tops.fused_exchange_stream.launches_by_path == {
        **before, body: before[body] + 1}
    for r, g, lp in zip(ref, got, loop, strict=True):
        assert torch.equal(r, g.cpu())
        assert torch.equal(g, lp)


@pytest.mark.cuda
def test_identity_router_defaults_to_the_card(cuda_device):
    state = tagg.identity_router(12)
    assert all(t.device.type == "cuda" for t in state)
    assert tev.empty_frame(4).valid.device.type == "cuda"
