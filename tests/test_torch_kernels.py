"""The port's wire primitives and exchange-kernel wrappers against the JAX
package.

Inputs are drawn with numpy from fixed seeds and fed to both packages.
Every comparison here is bit-exact: these are integer functions.  On the
CPU the port's wrappers run their plain PyTorch versions; they are held
against the JAX wrappers both in ``mode="interpret"`` (the Pallas kernel
body) and in ``mode="jax"`` (the JAX oracle).  The CUDA kernels are held
against the same plain versions on the card (``cuda``-marked tests here,
and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core import latency as jlat
from repro.core import link as jlink
from repro.core import routing as jrt
from repro.kernels.spike_router import ops as jops
from repro_torch import resolve_device
from repro_torch.core import events as tev
from repro_torch.core import latency as tlat
from repro_torch.core import link as tlink
from repro_torch.core import routing as trt
from repro_torch.kernels.spike_router import ops as tops
from repro_torch.kernels.spike_router import ref as tref
from torch_threads import share_cores

share_cores()

CAPACITY = 16


def _eq(name, ref, got):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    np.testing.assert_array_equal(got, ref.astype(got.dtype), err_msg=name)


def _rev_tables(rng, n):
    """Random rev LUTs, ~15% of entries disabled (bit 16 clear)."""
    en = (rng.random((n, 1 << 15)) < 0.85).astype(np.int64) << 16
    return (rng.integers(0, 1 << 16, (n, 1 << 15)) | en).astype(np.int32)


def _fwd_tables(rng, n):
    """Random fwd LUTs, ~15% of entries disabled (bit 15 clear)."""
    en = (rng.random((n, 1 << 16)) < 0.85).astype(np.int64) << 15
    return (rng.integers(0, 1 << 15, (n, 1 << 16)) | en).astype(np.int32)


# ---------------------------------------------------------------------------
# Wire primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,capacity", [((3, 40), 16), ((2, 4, 24), 8),
                                            ((5, 12), 32), ((1, 5), 8)])
def test_make_frame_matches(shape, capacity):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 1 << 16, shape).astype(np.int32)
    times = rng.integers(0, 1000, shape).astype(np.int32)
    valid = rng.random(shape) < 0.5
    for t in (times, None):
        ref, ref_drop = jev.make_frame(jnp.asarray(labels), None if t is None
                                       else jnp.asarray(t),
                                       jnp.asarray(valid), capacity)
        got, got_drop = tev.make_frame(torch.from_numpy(labels), None if t is
                                       None else torch.from_numpy(t),
                                       torch.from_numpy(valid), capacity)
        for f in ("labels", "times", "valid"):
            _eq(f, getattr(ref, f), getattr(got, f))
        _eq("dropped", ref_drop, got_drop)
        assert got.labels.dtype == got.times.dtype == got_drop.dtype \
            == torch.int32


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("seg_lens", [(8, 8, 8, 8), (4, 12, 6, 10)])
def test_make_frame_segmented_matches(seg_lens, compact):
    rng = np.random.default_rng(2)
    n = sum(seg_lens)
    labels = rng.integers(0, 1 << 16, (3, n)).astype(np.int32)
    times = rng.integers(0, 1000, (3, n)).astype(np.int32)
    if compact:     # keep the front-compaction promise: a prefix per segment
        valid = np.concatenate([np.arange(s)[None] < rng.integers(0, s + 1,
                                                                   (3, 1))
                                for s in seg_lens], axis=1)
    else:
        valid = rng.random((3, n)) < 0.5
    ref, ref_drop = jev.make_frame_segmented(
        jnp.asarray(labels), jnp.asarray(times), jnp.asarray(valid), 12,
        seg_lens, compact=compact)
    got, got_drop = tev.make_frame_segmented(
        torch.from_numpy(labels), torch.from_numpy(times),
        torch.from_numpy(valid), 12, seg_lens, compact=compact)
    for f in ("labels", "times", "valid"):
        _eq(f, getattr(ref, f), getattr(got, f))
    _eq("dropped", ref_drop, got_drop)


def test_wire16_round_trip_matches():
    rng = np.random.default_rng(3)
    labels = rng.integers(-(1 << 20), 1 << 20, (4, 33)).astype(np.int32)
    valid = rng.random((4, 33)) < 0.5
    ref = jev.pack_wire16(jnp.asarray(labels), jnp.asarray(valid))
    got = tev.pack_wire16(torch.from_numpy(labels), torch.from_numpy(valid))
    assert got.dtype == torch.int16
    _eq("words", ref, got)
    for r, g in zip(jev.unpack_wire16(ref), tev.unpack_wire16(got)):
        _eq("unpacked", r, g)


def test_routing_tables_and_lookups_match():
    rng = np.random.default_rng(4)
    chip = rng.permutation(1 << 16)[:300].astype(np.int32)
    wire = rng.integers(0, 1 << 15, 300).astype(np.int32)
    en = rng.random(300) < 0.8
    _eq("fwd", jrt.build_fwd_table(jnp.asarray(chip), jnp.asarray(wire),
                                   jnp.asarray(en)),
        trt.build_fwd_table(chip, wire, en, device="cpu"))
    wire_u = rng.permutation(1 << 15)[:300].astype(np.int32)
    rev_ref = jrt.build_rev_table(jnp.asarray(wire_u), jnp.asarray(chip),
                                  jnp.asarray(en))
    rev_got = trt.build_rev_table(wire_u, chip, en, device="cpu")
    _eq("rev", rev_ref, rev_got)
    ids = jrt.identity_tables(1000)
    ids_got = trt.identity_tables(1000, device="cpu")
    _eq("identity fwd", ids.fwd, ids_got[0])
    _eq("identity rev", ids.rev, ids_got[1])
    labels = rng.integers(0, 1 << 16, (5, 7)).astype(np.int32)
    for r, g in zip(jrt.lookup_rev(rev_ref, jnp.asarray(labels)),
                    trt.lookup_rev(rev_got, torch.from_numpy(labels))):
        _eq("lookup_rev", r, g)
    _eq("full enables", jrt.full_route_enables(6),
        trt.full_route_enables(6, device="cpu"))
    _eq("feedforward enables", jrt.feedforward_route_enables(6),
        trt.feedforward_route_enables(6, device="cpu"))


@pytest.mark.parametrize("level", ["chip", "fpga"])
def test_timed_wire_and_queue_match(level):
    assert tuple(tlat.timed_wire(level=level)) == tuple(
        jlat.timed_wire(level=level))
    assert tlat.DEFAULT_PARAMS.chip_to_chip_ns() == \
        jlat.DEFAULT_PARAMS.chip_to_chip_ns()
    ranks = np.arange(0, 3000, 7, dtype=np.int32)
    for queue in (jlat.timed_wire(level=level).queue, (4, 0, 8)):
        _eq("queue", jlat.queue_wait_i32(jnp.asarray(ranks), queue),
            tlat.queue_wait_i32(torch.from_numpy(ranks), queue))
    assert tlink.LinkConfig().events_per_window(2.0) == \
        jlink.LinkConfig().events_per_window(2.0)


def test_latency_statistics_match():
    lat = np.random.default_rng(5).integers(800, 1400, 257).astype(np.int32)
    ref = jlat.latency_statistics(jnp.asarray(lat, jnp.float32))
    got = tlat.latency_statistics(torch.from_numpy(lat))
    for k, v in ref.items():
        assert got[k] == pytest.approx(float(v), rel=1e-6), k


# ---------------------------------------------------------------------------
# Kernel wrappers (plain versions on the CPU) against the Pallas bodies
# ---------------------------------------------------------------------------

SEG_VARIANTS = {
    "global": (None, False),
    "uniform": ((12, 12, 12, 12), False),
    "uniform_compact": ((12, 12, 12, 12), True),
    "mixed": ((8, 16, 6, 18), False),
    "mixed_compact": ((8, 16, 6, 18), True),
}


def _merge_inputs(seed, wire16, per_row, timed, seg, rows=4, n=48):
    """``rows`` streams of ``n`` events (four of 48 by default): most rows
    overflow CAPACITY, one is empty; compact variants keep each segment
    front-compacted."""
    rng = np.random.default_rng(seed)
    seg_lens, compact = SEG_VARIANTS[seg]
    if compact:
        valid = np.concatenate(
            [np.arange(s)[None] < rng.integers(0, s + 1, (rows, 1))
             for s in seg_lens], axis=1)
    else:
        valid = rng.random((rows, n)) < 0.55
    valid[1] = False                                   # an empty stream
    labels = rng.integers(0, 1 << 15, (rows, n)).astype(np.int32)
    if wire16:
        # Validity rides the words; the caller's mask is the enable lane.
        labels = np.array(jev.pack_wire16(jnp.asarray(labels),
                                          jnp.asarray(valid)))
        valid = (np.ones((rows, n), bool) if compact
                 else rng.random((rows, n)) < 0.9)
    rev = _rev_tables(rng, rows if per_row else 1)
    rev = rev if per_row else rev[0]
    times = rng.integers(0, 1000, (rows, n)).astype(np.int32) if timed \
        else None
    queue = jlat.timed_wire().queue if timed else None
    return labels, valid, rev, times, queue, seg_lens, compact


@pytest.mark.parametrize("seg", list(SEG_VARIANTS))
@pytest.mark.parametrize("wire16,per_row,timed", [
    (False, False, False), (False, True, True),
    (True, False, True), (True, True, False)])
def test_fused_merge_pack_matches_pallas_and_oracle(wire16, per_row, timed,
                                                    seg):
    labels, valid, rev, times, queue, seg_lens, compact = _merge_inputs(
        6, wire16, per_row, timed, seg)
    got = tops.fused_merge_pack(
        torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(rev), capacity=CAPACITY, seg_lens=seg_lens,
        compact=compact,
        times=None if times is None else torch.from_numpy(times),
        queue=queue)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert int(got[-1].max()) > 0, "no overflow exercised"
    for mode in ("interpret", "jax"):
        ref = jops.fused_merge_pack(
            jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(rev),
            capacity=CAPACITY, mode=mode, seg_lens=seg_lens,
            compact=compact,
            times=None if times is None else jnp.asarray(times),
            queue=queue)
        assert len(ref) == len(got)
        for i, (r, g) in enumerate(zip(ref, got)):
            _eq(f"{mode} output {i}", r, g)


def test_fused_merge_pack_per_row_tables_tile_batch_major():
    """[batch, n_tables] streams read table r % n_tables: the stacked
    executor's layout, equal to the reference run once per batch row."""
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 1 << 15, (3, 4, 40)).astype(np.int32)
    valid = rng.random((3, 4, 40)) < 0.5
    rev = _rev_tables(rng, 4)
    got = tops.fused_merge_pack(torch.from_numpy(labels),
                                torch.from_numpy(valid),
                                torch.from_numpy(rev), capacity=CAPACITY)
    for b in range(3):
        ref = jops.fused_merge_pack(jnp.asarray(labels[b]),
                                    jnp.asarray(valid[b]), jnp.asarray(rev),
                                    capacity=CAPACITY, mode="jax")
        for r, g in zip(ref, got):
            _eq(f"batch row {b}", r, g[b])


@pytest.mark.parametrize("per_row", [False, True])
def test_fused_merge_pack_capacity_zero_matches_oracle(per_row):
    """capacity 0: empty outputs, every valid event dropped (the JAX
    oracle; the Pallas body divides by the capacity and cannot run it)."""
    labels, valid, rev, times, queue, _, _ = _merge_inputs(
        11, False, per_row, True, "global")
    got = tops.fused_merge_pack(
        torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(rev), capacity=0, times=torch.from_numpy(times),
        queue=queue)
    ref = jops.fused_merge_pack(
        jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(rev),
        capacity=0, mode="jax", times=jnp.asarray(times), queue=queue)
    assert len(ref) == len(got) == 4
    for i, (r, g) in enumerate(zip(ref, got)):
        _eq(f"output {i}", r, g)
    assert int(got[-1].sum()) == int(valid.sum())


def test_fused_merge_pack_argument_checks():
    lab = torch.zeros((2, 8), dtype=torch.int32)
    rev = torch.zeros(1 << 15, dtype=torch.int32)
    with pytest.raises(ValueError, match="slot-for-slot"):
        tops.fused_merge_pack(lab, torch.zeros((2, 1), dtype=torch.bool), rev,
                              capacity=4)
    with pytest.raises(ValueError, match="times XOR queue"):
        tops.fused_merge_pack(lab, lab.bool(), rev, capacity=4, times=lab)
    with pytest.raises(ValueError, match="must sum"):
        tops.fused_merge_pack(lab, lab.bool(), rev, capacity=4,
                              seg_lens=(4, 3))
    with pytest.raises(ValueError, match="do not tile"):
        tops.fused_merge_pack(lab, lab.bool(), rev.expand(3, -1), capacity=4)


@pytest.mark.parametrize("seed,n_src,cap_in", [(8, 4, 12), (9, 6, 20)])
def test_fused_exchange_matches_pallas_and_oracle(seed, n_src, cap_in):
    rng = np.random.default_rng(seed)
    batch = 2
    labels = rng.integers(0, 1 << 16, (batch, n_src, cap_in)).astype(np.int32)
    valid = rng.random((batch, n_src, cap_in)) < 0.7
    fwd = _fwd_tables(rng, n_src)
    rev = _rev_tables(rng, n_src)
    enables = rng.random((n_src, n_src)) < 0.7
    got = tops.fused_exchange(*(torch.from_numpy(a) for a in
                                (labels, valid, fwd, rev, enables)),
                              capacity=CAPACITY)
    assert int(got[2].max()) > 0, "no overflow exercised"
    for b in range(batch):
        for mode in ("interpret", "jax"):
            ref = jops.fused_exchange(
                jnp.asarray(labels[b]), jnp.asarray(valid[b]),
                jnp.asarray(fwd), jnp.asarray(rev), jnp.asarray(enables),
                capacity=CAPACITY, mode=mode)
            for i, (r, g) in enumerate(zip(ref, got)):
                _eq(f"{mode} batch {b} output {i}", r, g[b])


@pytest.mark.parametrize("shape,body", [
    ((12, 256, 12), "row"),               # FULL_BACKPLANE, one CTA a row
    ((12, 64, 12), "row"),                # route_step's 12 x 64 frames
    ((24, 256, 10), "tiled"),             # longer than one CTA's 4,096
    ((16, 256, 3), "row"),                # exactly one CTA's 4,096 items
    ((1, 4097, 3), "tiled"),              # one item past one CTA
    ((32, 64, 12), "row"),                # a source per lane of a warp
    ((33, 64, 12), "tiled"),              # more sources than lanes
    ((12, 64, 16000), "tiled"),           # enables outgrow shared memory
])
def test_exchange_body_rule(shape, body):
    assert tops.exchange_body_for(*shape) == body


@pytest.mark.parametrize("n,body", [(1, "warp"), (292, "warp"),
                                    (496, "warp"), (512, "warp"),
                                    (513, "block"), (3072, "block"),
                                    (8192, "block"), (8193, "tiled")])
def test_merge_pack_body_rule(n, body):
    assert tops.merge_pack_body_for(n) == body


def test_cpu_tensors_never_launch():
    before = (tops.fused_merge_pack.launches, tops.fused_exchange.launches)
    test_fused_merge_pack_per_row_tables_tile_batch_major()
    assert (tops.fused_merge_pack.launches,
            tops.fused_exchange.launches) == before


def test_entry_points_refuse_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (run on a card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py checks them on the card)")
    return torch.device("cuda")


# (segment layout, (rows, n, capacity)): every layout at the default shape,
# then shapes that reach each body and its edges in the global layout.
MERGE_SHAPES = [(seg, (4, 48, CAPACITY)) for seg in SEG_VARIANTS] + [
    ("global", (6, 47, CAPACITY)),        # odd n: int16 rows off 4-byte
    ("global", (5, 20, 8)),               # rows shorter than a warp
    ("global", (9, 515, 40)),             # the block body, n % 16 != 0
    ("global", (3, 3072, 256)),           # the block body at 3,072 events
    ("global", (2, 8192, 8192)),          # its longest stage (48 KiB timed)
    ("global", (2, 9001, 300)),           # the tiled body
    ("global", (4, 48, 0)),               # capacity 0: everything drops
    ("global", (4, 48, 64)),              # capacity beyond the stream
]


@pytest.mark.cuda
@pytest.mark.parametrize("seg,shape", MERGE_SHAPES,
                         ids=[f"{s}-{r}x{n}-cap{c}"
                              for s, (r, n, c) in MERGE_SHAPES])
@pytest.mark.parametrize("wire16,per_row,timed", [
    (False, False, False), (False, True, True),
    (True, False, True), (True, True, False)])
def test_merge_pack_kernel_matches_plain(cuda_device, wire16, per_row, timed,
                                         seg, shape):
    rows, n, capacity = shape
    labels, valid, rev, times, queue, seg_lens, compact = _merge_inputs(
        6, wire16, per_row, timed, seg, rows, n)
    args = [torch.from_numpy(a) for a in (labels, valid, rev)]
    kw = dict(capacity=capacity, seg_lens=seg_lens, compact=compact,
              queue=queue)
    t = None if times is None else torch.from_numpy(times)
    ref = tref.merge_pack_ref(*args, times=t, **kw)
    body = tops.merge_pack_body_for(n)
    before = dict(tops.fused_merge_pack.launches_by_path)
    got = tops.fused_merge_pack(*(a.to(cuda_device) for a in args),
                                times=None if t is None else
                                t.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert tops.fused_merge_pack.launches_by_path == {
        **before, body: before[body] + 1}
    for r, g in zip(ref, got):
        assert torch.equal(r, g.cpu())


# (batch, n_src, cap_in, n_dst, capacity, occupancy, enable share, body)
EXCHANGE_SHAPES = {
    "square": (3, 12, 64, 12, 256, 0.6, 0.8, "row"),
    "n_src_ne_n_dst": (2, 5, 37, 7, 40, 0.6, 0.7, "row"),
    "ragged_cap_in": (4, 3, 33, 9, 50, 0.9, 0.8, "row"),
    "capacity_0": (2, 4, 20, 3, 0, 0.5, 1.0, "row"),
    "capacity_beyond_stream": (2, 6, 50, 5, 300, 0.9, 0.9, "row"),
    "every_enable_off": (2, 6, 50, 5, 30, 0.9, 0.0, "row"),
    "row_32_sources": (2, 32, 40, 9, 300, 0.5, 0.7, "row"),
    "row_4096_items": (2, 16, 256, 12, 300, 0.3, 0.8, "row"),
    "long_frame_24_sources": (2, 24, 256, 10, 512, 0.5, 0.7, "tiled"),
    "long_frame_ragged": (3, 31, 203, 9, 300, 0.3, 0.8, "tiled"),
    "longest_frame": (1, 32, 2048, 4, 256, 0.05, 0.9, "tiled"),
    "wide_tables_tiled": (2, 100, 8, 100, 16, 0.5, 0.5, "tiled"),
    "long_frame_tiled": (1, 17, 4096, 3, 512, 0.1, 0.9, "tiled"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EXCHANGE_SHAPES))
def test_exchange_kernel_matches_plain(cuda_device, case):
    batch, n_src, cap_in, n_dst, capacity, occ, en_p, body = \
        EXCHANGE_SHAPES[case]
    rng = np.random.default_rng(10)
    arrays = (rng.integers(0, 1 << 16, (batch, n_src, cap_in)).astype(
                  np.int32),
              rng.random((batch, n_src, cap_in)) < occ,
              _fwd_tables(rng, n_src), _rev_tables(rng, n_dst),
              rng.random((n_src, n_dst)) < en_p)
    cpu = [torch.from_numpy(a) for a in arrays]
    ref = tref.exchange_ref(*cpu, capacity=capacity)
    before = dict(tops.fused_exchange.launches_by_path)
    got = tops.fused_exchange(*(a.to(cuda_device) for a in cpu),
                              capacity=capacity)
    torch.cuda.synchronize()
    assert tops.fused_exchange.launches_by_path == {
        **before, body: before[body] + 1}
    for r, g in zip(ref, got):
        assert torch.equal(r, g.cpu())
