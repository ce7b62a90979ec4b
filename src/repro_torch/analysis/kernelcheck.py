"""Kernel write-set checker: the pack units and the CUDA router kernels.

Counterpart of ``src/repro/analysis/kernelcheck.py``.  The cumsum-scatter
at the heart of every pack unit is the one place a rank bug silently
corrupts a *neighbour's* frame: an off-by-one in the base offsets lands
one segment's events inside the next destination's window with no shape
error anywhere.  Two passes prove, per capacity:

  * ``kernel.scatter-bounds``       every scatter index lands in
    ``[0, capacity]`` (slot ``capacity`` is the parked overflow);
  * ``kernel.scatter-overlap``      kept events write *distinct* slots;
  * ``kernel.scatter-order``        kept slots are the dense arrival
    ranks ``0..k-1`` in stream order (the wire preserves order);
  * ``kernel.scatter-conservation`` kept + dropped == offered;
  * ``kernel.pack-equivalence``     the segmented unit (and every kernel)
    is bit-exact with the global unit on the flattened stream.

The **model check** (``check_pack_writeset``, ``check_pack_units``) runs
the index maps the plain versions scatter by, ``ref.pack_indices`` and
``ref.pack_segmented_indices`` (the twins of the reference's
``_pack_indices``/``_pack_segmented_indices``), on the CPU: exhaustive over
every occupancy mask for small streams, structured adversarial masks
(empty/full/prefix/suffix/alternating/segment-aligned) plus a seeded
pseudo-random batch at real sizes.

The **card check** (``check_router_kernels``) replaces the reference's
static walk over Pallas grid mappings, which the CUDA kernels do not have:
it launches every body of the four router kernels (``ops.py``'s
``*_body_for``) on the same mask battery, one mask a row of one batched
launch, with events labelled by their arrival index and identity LUTs, so
each output slot names the event the kernel scattered there.  The five
checks then read the kernel's own scatter map off its output, and
``kernel.aliasing`` holds that no wrapper writes to its inputs (the
egress router reads rows in place).  It needs a CUDA device; given the
CPU it reports a ``kernel.devices`` warning and checks nothing in place
of the kernels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.analysis.diagnostics import Diagnostic, WARNING

EXHAUSTIVE_BITS = 10      # <= 2^10 masks enumerated exhaustively
RNG_MASKS = 48            # deterministic random masks at real sizes


def _masks(shape: tuple[int, ...]) -> np.ndarray:
    """Occupancy masks [M, *shape]: exhaustive when small, adversarial
    structured + seeded random otherwise (the reference's battery)."""
    n = math.prod(shape)
    if n <= EXHAUSTIVE_BITS:
        bits = np.arange(2 ** n)[:, None] >> np.arange(n)[None, :]
        return (bits & 1).astype(np.int32).reshape(-1, *shape)
    rows = [np.zeros(n), np.ones(n)]
    for k in (1, 2, n // 2, n - 1):
        pre = np.zeros(n)
        pre[:k] = 1
        rows.append(pre)
        rows.append(pre[::-1].copy())
    alt = np.zeros(n)
    alt[::2] = 1
    rows.append(alt)
    rows.append(1 - alt)
    if len(shape) == 2:                      # segment-aligned adversaries
        seg = np.zeros(shape)
        seg[::2] = 1                         # every other segment full
        rows.append(seg.reshape(-1))
        seg = np.zeros(shape)
        seg[:, -1] = 1                       # last slot of every segment
        rows.append(seg.reshape(-1))
    rng = np.random.default_rng(0)
    for p in (0.05, 0.3, 0.7):
        rows.extend((rng.random(n) < p).astype(np.int32)
                    for _ in range(RNG_MASKS // 3))
    return np.stack([r.reshape(shape) for r in rows]).astype(np.int32)


def _writeset_findings(flat: np.ndarray, idx: np.ndarray, keep: np.ndarray,
                       capacity: int, path: str, *,
                       ref: tuple[np.ndarray, np.ndarray] | None = None,
                       equivalence: str = "segmented pack disagrees with the "
                                          "global pack on the flattened "
                                          "stream") -> list[Diagnostic]:
    """The five checks over one write set a mask: ``flat`` int[M, n] the
    masks, ``idx`` int[M, n] and ``keep`` bool[M, n] the scatter map,
    ``ref`` the global unit's ``(idx, keep)`` to hold it to.  Stops at the
    first failing mask, as the reference does."""
    def bad(check, msg, m):
        return [Diagnostic(check, f"{path}/capacity[{capacity}]",
                           f"{msg} (occupancy mask {flat[m].tolist()})")]

    for m in range(flat.shape[0]):
        if (idx[m] < 0).any() or (idx[m] > capacity).any():
            return bad("kernel.scatter-bounds",
                       f"scatter index outside [0, {capacity}]", m)
        kept = idx[m][keep[m]]
        if (kept >= capacity).any():
            return bad("kernel.scatter-bounds",
                       "kept event scattered into the overflow slot", m)
        if np.unique(kept).size != kept.size:
            return bad("kernel.scatter-overlap",
                       "two kept events write the same output slot — one "
                       "destination's event overwrites a neighbour's", m)
        k = min(int(flat[m].sum()), capacity)
        if not np.array_equal(kept, np.arange(kept.size)):
            return bad("kernel.scatter-order",
                       "kept slots are not the dense arrival ranks 0..k-1 "
                       "in stream order", m)
        if keep[m].sum() != k or bool((keep[m] & (flat[m] == 0)).any()):
            return bad("kernel.scatter-conservation",
                       f"kept {int(keep[m].sum())} of {int(flat[m].sum())} "
                       f"offered events at capacity {capacity}", m)
        if ref is not None and (not np.array_equal(ref[0][m], idx[m])
                                or not np.array_equal(ref[1][m], keep[m])):
            return bad("kernel.pack-equivalence", equivalence, m)
    return []


def check_pack_writeset(index_fn, shape: tuple[int, ...], capacity: int,
                        path: str, *, reference_fn=None) -> list[Diagnostic]:
    """Model-check one pack unit's scatter map over the mask battery.

    ``index_fn(ok, capacity) -> (idx, keep)`` on a batch of masks ``ok``
    int32 ``[M, *shape]`` (one mask a leading row, as the twins in
    ``kernels/spike_router/ref.py`` take them), returning ``[M, n]`` on the
    flattened stream.  ``reference_fn`` (same signature, on the flattened
    masks ``[M, n]``) asserts bit-equivalence: it pins the segmented unit
    to the global one."""
    masks = _masks(shape)
    idx, keep = index_fn(torch.from_numpy(masks), capacity)
    idx = np.asarray(idx).reshape(masks.shape[0], -1)
    keep = np.asarray(keep).reshape(masks.shape[0], -1).astype(bool)
    flat = masks.reshape(masks.shape[0], -1)
    ref = None
    if reference_fn is not None:
        r_idx, r_keep = reference_fn(torch.from_numpy(flat), capacity)
        ref = (np.asarray(r_idx).reshape(flat.shape),
               np.asarray(r_keep).reshape(flat.shape).astype(bool))
    return _writeset_findings(flat, idx, keep, capacity, path, ref=ref)


def check_pack_units(capacities, path: str = "spike_router"
                     ) -> list[Diagnostic]:
    """Model-check both pack units at each plan-derived capacity (the
    reference's shapes; the paths name the reference's functions, whose
    twins these are)."""
    from repro_torch.kernels.spike_router.ref import (pack_indices,
                                                      pack_segmented_indices)

    diags = []
    for cap in sorted(set(capacities)):
        n = min(2 * cap, 16)
        diags += check_pack_writeset(
            pack_indices, (n,), cap, f"{path}/_pack_indices")
        seg_shape = (4, max(2, min(cap, 8)))
        diags += check_pack_writeset(
            pack_segmented_indices, seg_shape, cap,
            f"{path}/_pack_segmented_indices", reference_fn=pack_indices)
        # exhaustive small shapes: every occupancy pattern
        diags += check_pack_writeset(
            pack_indices, (8,), min(cap, 5), f"{path}/_pack_indices")
        diags += check_pack_writeset(
            pack_segmented_indices, (2, 4), min(cap, 5),
            f"{path}/_pack_segmented_indices", reference_fn=pack_indices)
    return diags


# ---------------------------------------------------------------------------
# The CUDA router kernels: the scatter map read off each body's output
# ---------------------------------------------------------------------------

# (kernel, mask shape, capacity) cases, chosen so that ``ops``'s
# ``*_body_for`` rules reach every body: the first case of each kernel is
# exhaustive (at most 2^10 masks), the rest take the structured and
# random battery at the bodies' real widths, with capacities below the
# stream (overflow) and at the catalogue's.
CARD_CASES = (
    ("spike_router", (8,), 5),
    ("spike_router", (1000,), 37),
    ("spike_router", (6000,), 700),           # 256 events a warp
    ("spike_router", (9000,), 1500),          # past ROUTE_ROW_MAX
    ("merge_pack", (2, 4), 5),
    ("merge_pack", (4, 100), 64),
    ("merge_pack", (4, 1000), 600),           # past WARP_ROW_MAX
    ("merge_pack", (3, 3000), 1500),          # past BLOCK_ROW_MAX
    ("exchange", (2, 4), 5),
    ("exchange", (12, 64), 256),              # FULL_BACKPLANE
    ("exchange", (12, 400), 1000),            # past ROW_EVENTS
    ("exchange", (40, 16), 96),               # past MAX_ROW_SOURCES
    ("exchange_stream", (2, 4), 5),
    ("exchange_stream", (12, 64), 256),
    ("exchange_stream", (12, 400), 1000),
)
CARD_DESTINATIONS = 2       # destinations of the exchange cases
# The timed merge_pack cases' destination queue (service_ns, cc_interval,
# stall_total_ns).
CARD_QUEUE = (8, 4, 16)


def card_body(kernel: str, shape: tuple[int, ...]) -> str:
    """The body ``ops`` picks for one card case."""
    from repro_torch.kernels.spike_router import ops

    n = math.prod(shape)
    if kernel == "spike_router":
        return ops.route_and_pack_body_for(n)
    if kernel == "merge_pack":
        return ops.merge_pack_body_for(n)
    return ops.exchange_body_for(shape[0], shape[1], CARD_DESTINATIONS)


def card_inputs(kernel: str, masks: np.ndarray, device,
                timed: bool = False) -> dict:
    """A card case's operands for the mask battery ``masks`` [M, *shape]:
    one mask a row (a timestep of the stream), each event labelled by its
    arrival index in the merged stream, identity LUTs with every enable
    bit set, all route enables on.  The egress router gets its label grid
    expanded over the rows (stride 0), which it reads in place."""
    from repro_torch.core.routing import identity_tables

    m, n = masks.shape[0], math.prod(masks.shape[1:])
    tables = identity_tables(device=device)
    ok = torch.from_numpy(masks.astype(bool)).to(device)
    arrival = torch.arange(n, dtype=torch.int32, device=device)
    if kernel == "spike_router":
        return {"labels": arrival.expand(m, n), "valid": ok,
                "lut": tables.fwd}
    if kernel == "merge_pack":
        inputs = {"labels": arrival.repeat(m, 1), "valid": ok.reshape(m, n),
                  "rev_lut": tables.rev}
        if timed:
            inputs["times"] = arrival.repeat(m, 1)
        return inputs
    n_src = masks.shape[1]
    return {"labels": arrival.reshape(masks.shape[1:]).repeat(m, 1, 1),
            "valid": ok,
            "fwd_luts": tables.fwd.expand(n_src, -1).contiguous(),
            "rev_luts": tables.rev.expand(CARD_DESTINATIONS,
                                          -1).contiguous(),
            "enables": torch.ones((n_src, CARD_DESTINATIONS),
                                  dtype=torch.bool, device=device)}


def card_launch(kernel: str, inputs: dict, shape: tuple[int, ...],
                capacity: int) -> list:
    """One call of the kernel's wrapper on ``card_inputs``: its outputs as
    host numpy ``[labels [R, cap], valid [R, cap], times or None, dropped
    [R]]``, one row per (mask, destination)."""
    from repro_torch.kernels.spike_router import ops

    a = inputs
    if kernel == "spike_router":
        outs = ops.route_and_pack(a["labels"], a["valid"], a["lut"],
                                  capacity=capacity)
    elif kernel == "merge_pack":
        timed = "times" in a
        outs = ops.fused_merge_pack(
            a["labels"], a["valid"], a["rev_lut"], capacity=capacity,
            seg_lens=(shape[1],) * shape[0],
            times=a.get("times"), queue=CARD_QUEUE if timed else None)
    else:
        fn = (ops.fused_exchange if kernel == "exchange"
              else ops.fused_exchange_stream)
        outs = fn(a["labels"], a["valid"], a["fwd_luts"], a["rev_luts"],
                  a["enables"], capacity=capacity)
    host = [o.reshape(-1, capacity).cpu().numpy() for o in outs[:-1]]
    host.append(outs[-1].reshape(-1).cpu().numpy())
    if len(host) == 3:
        host.insert(2, None)
    return host


def _scatter_map(labels: np.ndarray, valid: np.ndarray, flat: np.ndarray,
                 capacity: int, path: str) -> tuple[np.ndarray, np.ndarray,
                                                    list[Diagnostic]]:
    """Reads ``(idx, keep)`` off the output slots: slot ``j`` holding label
    ``i`` is event ``i`` scattered to ``j``.  A valid slot naming no event
    its row offered, or one event in two slots, is reported here."""
    rows, n = flat.shape
    idx = np.full((rows, n), capacity, np.int64)
    keep = np.zeros((rows, n), bool)
    for r in range(rows):
        slots = np.flatnonzero(valid[r])
        lab = labels[r][slots]

        def bad(check, msg):
            return idx, keep, [Diagnostic(
                check, f"{path}/capacity[{capacity}]",
                f"{msg} (occupancy mask {flat[r].tolist()})")]

        foreign = (lab < 0) | (lab >= n)
        if not foreign.any():
            foreign = flat[r][lab] == 0
        if foreign.any():
            j = int(slots[np.flatnonzero(foreign)[0]])
            return bad("kernel.scatter-bounds",
                       f"output slot {j} holds {int(labels[r][j])}, no "
                       f"event its row offered — a write from outside the "
                       f"row's window")
        if np.unique(lab).size != lab.size:
            return bad("kernel.scatter-overlap",
                       "one event written to two output slots")
        idx[r, lab] = slots
        keep[r, lab] = True
    return idx, keep, []


def read_writeset(masks: np.ndarray, outs: list, capacity: int,
                  path: str) -> list[Diagnostic]:
    """The five checks on a kernel's output (``card_launch``'s): the
    scatter map read off the slots against the global pack unit, the
    dropped counts, and on a timed merge the timestamp lane (arrival index
    plus the destination queue of its slot)."""
    from repro_torch.kernels.spike_router.ref import (dest_queue_ns,
                                                      pack_indices)

    labels, valid, times, dropped = outs
    per = labels.shape[0] // masks.shape[0]       # destinations a mask
    flat = np.repeat(masks.reshape(masks.shape[0], -1), per, axis=0)
    idx, keep, diags = _scatter_map(labels, valid, flat, capacity, path)
    if diags:
        return diags
    r_idx, r_keep = pack_indices(torch.from_numpy(flat), capacity)
    diags = _writeset_findings(
        flat, idx, keep, capacity, path, ref=(r_idx.numpy(), r_keep.numpy()),
        equivalence="the kernel's scatter map disagrees with the global "
                    "pack unit on the flattened stream")
    if diags:
        return diags
    offered = flat.sum(axis=1)
    bad = np.flatnonzero(dropped != offered - keep.sum(axis=1))
    if bad.size:
        r = int(bad[0])
        return [Diagnostic(
            "kernel.scatter-conservation", f"{path}/capacity[{capacity}]",
            f"dropped {int(dropped[r])} but kept {int(keep[r].sum())} of "
            f"{int(offered[r])} offered events (occupancy mask "
            f"{flat[r].tolist()})")]
    if times is not None:
        wait = dest_queue_ns(capacity, CARD_QUEUE, "cpu").numpy()
        want = np.where(valid, labels + wait[None, :], 0)
        if not np.array_equal(times, want):
            r = int(np.flatnonzero((times != want).any(axis=1))[0])
            return [Diagnostic(
                "kernel.pack-equivalence", f"{path}/capacity[{capacity}]",
                f"the timestamp lane's scatter disagrees with the label "
                f"lane's (occupancy mask {flat[r].tolist()})")]
    return []


def check_card_case(kernel: str, shape: tuple[int, ...], capacity: int,
                    device, *, timed: bool = False,
                    path: str = "spike_router") -> list[Diagnostic]:
    """Launch one kernel body on the mask battery and check the write set
    it produced (``read_writeset``), that the intended body ran, and that
    no input changed (``kernel.aliasing``)."""
    from repro_torch.kernels.spike_router import ops

    wrapper = {"spike_router": ops.route_and_pack,
               "merge_pack": ops.fused_merge_pack,
               "exchange": ops.fused_exchange,
               "exchange_stream": ops.fused_exchange_stream}[kernel]
    body = card_body(kernel, shape)
    kpath = f"{path}/{kernel}[{body}{', timed' if timed else ''}]"
    masks = _masks(shape)
    inputs = card_inputs(kernel, masks, device, timed)
    copies = {k: v.clone() for k, v in inputs.items()}
    before = dict(wrapper.launches_by_path)
    outs = card_launch(kernel, inputs, shape, capacity)
    ran = {b: c - before[b] for b, c in wrapper.launches_by_path.items()
           if c != before[b]}
    diags = []
    if ran != {body: 1}:
        diags.append(Diagnostic(
            "kernel.body", kpath,
            f"expected one launch of the {body!r} body, the wrapper counted "
            f"{ran}"))
    diags += read_writeset(masks, outs, capacity, kpath)
    for name, t in inputs.items():
        if not torch.equal(t, copies[name]):
            diags.append(Diagnostic(
                "kernel.aliasing", kpath,
                f"the wrapper wrote to its input {name!r}"))
    return diags


def check_router_kernels(device="cuda", path: str = "spike_router"
                         ) -> list[Diagnostic]:
    """The card check: every body of the four router kernels on the mask
    battery (``CARD_CASES``; merge_pack untimed and timed).  Given a
    device that is not a CUDA device it checks nothing and says so in a
    ``kernel.devices`` warning: the plain versions are not checked in the
    kernels' place."""
    device = torch.device(device)
    if device.type != "cuda":
        return [Diagnostic(
            "kernel.devices", path,
            f"skipped: the card check launches the CUDA router kernels and "
            f"needs a CUDA device, given {device} (run `python -m "
            f"repro_torch.analysis.lint` on a machine with a card)",
            WARNING)]
    diags = []
    for kernel, shape, cap in CARD_CASES:
        for timed in ((False, True) if kernel == "merge_pack" else (False,)):
            diags += check_card_case(kernel, shape, cap, device, timed=timed,
                                     path=path)
    return diags
