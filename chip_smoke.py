"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of the CUDA kernels from
   ``src/repro_torch/kernels/**/csrc`` into ``build/repro_torch/``.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, every variant, bit-exact; device time per launch
   (CUDA-graph replay), the plain version's time, and the byte bound.
3. The main path at full width (512 neurons x 256 rows per chip, batch 8,
   64 steps): ``run_stream`` on FULL_BACKPLANE (untimed gather: the
   exchange kernel), EXT_4CASE_96CHIP (timed, gather and routed) and
   PROJECTED_120CHIP (timed), with each kernel's launch count checked.
4. The port on the card against the port on the CPU: same network, dyadic
   weights and drives, 16 steps; integer outputs equal up to near-threshold
   spike flips (``repro_torch.parity``), the exchange stage bit-exact under
   teacher forcing.

Any failure exits non-zero.  The last line is the result for the harness.
It needs the repository's ``src/`` beside it and a CUDA device; without
either it fails before printing a result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import parity  # noqa: E402
from repro_torch.analysis import scenarios  # noqa: E402
from repro_torch.core import fabric as fablib  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.spike_router import ops, ref  # noqa: E402
from repro_torch.snn import network as netlib  # noqa: E402
from repro_torch.snn import stream  # noqa: E402
from repro_torch.core.latency import timed_wire  # noqa: E402

DEV = torch.device("cuda")
BATCH, STEPS, CHECK_STEPS, PROFILE_STEPS = 8, 64, 16, 8
# Each synapse row receives an external spike with this probability per
# step: on the feed-forward network it puts the neurons' spike occupancy
# near the catalogue's 5% headline (measured and printed in phase 3).
DRIVE_P = 0.035
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
OPS_PER_S = 67e12                # H100 SXM float32 outside the tensor cores
KERNEL_SOURCES = {
    "merge_pack": ("src/repro_torch/kernels/spike_router/csrc/merge_pack.cu",
                   "src/repro/kernels/spike_router/spike_router.py:498"),
    "exchange": ("src/repro_torch/kernels/spike_router/csrc/exchange.cu",
                 "src/repro/kernels/spike_router/spike_router.py:379"),
}
# Main-path runs of phase 3: (scenario, exchange mode, timed).
MAIN_PATHS = (("FULL_BACKPLANE", "gather", False),
              ("EXT_4CASE_96CHIP", "gather", True),
              ("EXT_4CASE_96CHIP", "routed", True),
              ("PROJECTED_120CHIP", "gather", True))
CHECK_PATHS = (("FULL_BACKPLANE", "gather", False),
               ("EXT_4CASE_96CHIP", "gather", True),
               ("PROJECTED_120CHIP", "routed", True))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def graph_ms(fn, launches: int = 50, replays: int = 20) -> float:
    """Device time per call: ``launches`` calls captured in one CUDA graph,
    replayed, timed with CUDA events (host overhead excluded)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def eager_ms(fn, iters: int = 20) -> float:
    """Time per call as called (host overhead included), CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: int, ops_done: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_done / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(outs_a, outs_b) -> float:
    err = 0.0
    for a, b in zip(outs_a, outs_b, strict=True):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                                 f"{b.dtype}{tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a.long() - b.long()).abs().max()))
    return err


# ---------------------------------------------------------------------------
# Phase 2 inputs: synthetic streams at the main path's shapes
# ---------------------------------------------------------------------------


def lut(gen, n: int, size: int, enable_bit: int, payload_bits: int):
    """Random LUTs, ~15% of entries disabled."""
    payload = torch.randint(0, 1 << payload_bits, (n, size), generator=gen,
                            device=DEV, dtype=torch.int32)
    en = (torch.rand((n, size), generator=gen, device=DEV) < 0.85)
    return payload | (en.to(torch.int32) << enable_bit)


def merge_case(gen, rows, seg_lens, n_tables, wire16, timed, compact, occ):
    """Front-compacted segments (count ~ Binomial(len, occ), every 7th row
    dense so it overflows), or independent slots when not compact."""
    n = sum(seg_lens)
    occ_row = torch.full((rows, 1), occ, device=DEV)
    occ_row[::7] = 0.9
    if compact:
        parts = []
        for s in seg_lens:
            k = (torch.rand((rows, s), generator=gen, device=DEV)
                 < occ_row).sum(-1, keepdim=True)
            parts.append(torch.arange(s, device=DEV)[None] < k)
        valid = torch.cat(parts, dim=-1)
    else:
        valid = torch.rand((rows, n), generator=gen, device=DEV) < occ_row
    labels = torch.randint(0, 1 << 15, (rows, n), generator=gen, device=DEV,
                           dtype=torch.int32)
    if wire16:
        # Validity rides the words; the caller's mask is the enable lane.
        labels = torch.where(valid, labels | (1 << 15), 0).to(torch.int16)
        valid = torch.ones_like(valid)
    rev = lut(gen, n_tables, 1 << 15, 16, 16)
    kw = dict(capacity=None, seg_lens=seg_lens, compact=compact)
    if timed:
        kw["times"] = torch.randint(0, 4000, (rows, n), generator=gen,
                                    device=DEV, dtype=torch.int32)
        kw["queue"] = timed_wire().queue
    return (labels, valid, rev if n_tables > 1 else rev[0]), kw


def merge_cost(args, kw, outs) -> tuple[int, int]:
    """Bytes the merge must move (inputs read once, the rev entries of the
    kept events only, outputs written once) and its integer operations
    (about ten per input slot and per output slot)."""
    labels, valid, _ = args
    kept = int(outs[1].sum())
    nbytes = (labels.numel() * labels.element_size() + valid.numel()
              + 4 * kept + sum(o.numel() * o.element_size() for o in outs))
    if kw.get("times") is not None:
        nbytes += kw["times"].numel() * 4
    return nbytes, 10 * (labels.numel() + outs[0].numel())


def phase2(results: dict) -> None:
    gen = torch.Generator(device=DEV).manual_seed(2)
    plans = {name: scenarios.engine_network(name, device="cpu")[::2]
             for name, *_ in scenarios.CASES}

    def shape_of(name, mode):
        cfg, plan = plans[name]
        plan = fablib.with_exchange_mode(plan, mode)
        return cfg.n_chips * BATCH, fablib.merge_segments(plan, cfg.capacity), \
            cfg.capacity, cfg.n_chips

    # (variant, scenario, mode, wire16, per-row tables, timed, compact)
    variants = (
        ("ext_gather_timed", "EXT_4CASE_96CHIP", "gather", False, True, True,
         True),
        ("ext_routed_timed_wire16", "EXT_4CASE_96CHIP", "routed", True, True,
         True, True),
        ("proj_gather_timed", "PROJECTED_120CHIP", "gather", False, True,
         True, True),
        ("proj_routed_untimed_wire16", "PROJECTED_120CHIP", "routed", True,
         True, False, True),
        ("full_gather_timed_uniform", "FULL_BACKPLANE", "gather", False,
         True, True, False),
        ("ext_gather_shared_rev_global", "EXT_4CASE_96CHIP", "gather", False,
         False, False, False),
        ("ext_routed_shared_rev_wire16_global", "EXT_4CASE_96CHIP", "routed",
         True, False, False, False),
    )
    err = 0.0
    main_case = None
    for name, scen, mode, wire16, per_row, timed, compact in variants:
        rows, segs, cap, n_tables = shape_of(scen, mode)
        args, kw = merge_case(gen, rows, segs, n_tables if per_row else 1,
                              wire16, timed, compact, 0.05)
        kw["capacity"] = cap
        if not compact:
            kw["seg_lens"] = None if "global" in name else segs
        got = ops.fused_merge_pack(*args, **kw)
        want = ref.merge_pack_ref(*args, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"merge_pack {name}: kernel != plain "
                                 f"(max abs err {e})")
        err = max(err, e)
        ms = graph_ms(lambda: ops.fused_merge_pack(*args, **kw))
        nbytes, nops = merge_cost(args, kw, got)
        b_ms, b_by = bound(nbytes, nops)
        print(f"phase 2: merge_pack {name}: rows {rows} x {sum(segs)} "
              f"events -> cap {cap}, dropped {int(got[-1].sum())}, exact; "
              f"kernel {ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
              f"({b_by})", flush=True)
        if name == "ext_gather_timed":
            main_case = (args, kw, ms, b_ms, b_by)
    args, kw, ms, b_ms, b_by = main_case
    results["merge_pack"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=eager_ms(lambda: ref.merge_pack_ref(*args, **kw)),
        eager_ms=eager_ms(lambda: ops.fused_merge_pack(*args, **kw)),
        bound_ms=b_ms, bound_by=b_by)

    # The exchange kernel: FULL_BACKPLANE's shape (batch x 12 sources x 256
    # egress slots, capacity 256), identity-like tables and all-to-all
    # enables as on the main path, then random tables, random enables and
    # dense traffic so destinations overflow.
    cfg, plan = plans["FULL_BACKPLANE"]
    n, cap = cfg.n_chips, cfg.capacity
    err = 0.0
    main_case = None
    for name, occ, random_luts in (("main_path_tables", 0.05, False),
                                   ("random_tables_overflow", 0.6, True)):
        labels = ((torch.arange(n, device=DEV, dtype=torch.int32)[:, None]
                   << 9) + torch.randint(0, 512, (BATCH, n, cap),
                                         generator=gen, device=DEV,
                                         dtype=torch.int32))
        valid = torch.rand((BATCH, n, cap), generator=gen, device=DEV) < occ
        if random_luts:
            fwd = lut(gen, n, 1 << 16, 15, 15)
            rev = lut(gen, n, 1 << 15, 16, 16)
            enables = torch.rand((n, n), generator=gen, device=DEV) < 0.7
        else:
            params = netlib.to_device(
                scenarios.engine_network("FULL_BACKPLANE", device="cpu")[1],
                DEV)
            fwd, rev = params.router.fwd_tables, params.router.rev_tables
            enables = torch.from_numpy(plan.levels[0].enables).to(DEV)
        args = (labels, valid, fwd, rev, enables)
        got = ops.fused_exchange(*args, capacity=cap)
        want = ref.exchange_ref(*args, capacity=cap)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"exchange {name}: kernel != plain "
                                 f"(max abs err {e})")
        err = max(err, e)
        ms = graph_ms(lambda: ops.fused_exchange(*args, capacity=cap))
        # Bytes: frames read once, the fwd entries of the valid events, the
        # enables, the rev entries of the kept events, outputs written once.
        nbytes = (labels.numel() * 5 + 4 * int(valid.sum()) + enables.numel()
                  + 4 * int(got[1].sum())
                  + sum(o.numel() * o.element_size() for o in got))
        nops = 10 * (labels.numel() * n + got[0].numel())
        b_ms, b_by = bound(nbytes, nops)
        print(f"phase 2: exchange {name}: {BATCH} x {n} x {cap} -> cap "
              f"{cap}, dropped {int(got[2].sum())}, exact; kernel "
              f"{ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by})",
              flush=True)
        if main_case is None:
            main_case = (args, ms, b_ms, b_by)
    args, ms, b_ms, b_by = main_case
    results["exchange"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=eager_ms(lambda: ref.exchange_ref(*args, capacity=cap)),
        eager_ms=eager_ms(lambda: ops.fused_exchange(*args, capacity=cap)),
        bound_ms=b_ms, bound_by=b_by)
    for k, r in results.items():
        print(f"phase 2: {k}: kernel {r['ms'] * 1e3:.2f} us (graph replay), "
              f"{r['eager_ms'] * 1e3:.2f} us as called, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f}"
              f" us ({r['bound_by']})", flush=True)


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def phase3(launches: dict, gpu: str) -> None:
    for name, mode, timed in MAIN_PATHS:
        cfg, params, plan = scenarios.engine_network(name, device=DEV)
        plan = fablib.with_exchange_mode(plan, mode)
        state = netlib.init_state(cfg, BATCH, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(3)
        drives = (torch.rand((STEPS, cfg.n_chips, BATCH, cfg.chip.n_rows),
                             generator=gen, device=DEV)
                  < DRIVE_P).to(torch.float32)
        stream.run_stream(params, state, drives[:4], cfg, fabric=plan,
                          timed=timed, device=DEV)            # warm-up
        torch.cuda.synchronize()
        ops.fused_merge_pack.launches = 0
        ops.fused_exchange.launches = 0
        t0 = time.perf_counter()
        out = stream.run_stream(params, state, drives, cfg, fabric=plan,
                                timed=timed, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"merge_pack": ops.fused_merge_pack.launches,
                  "exchange": ops.fused_exchange.launches}
        one_level = plan.n_levels == 1 and not timed and mode == "gather"
        want = {"exchange": STEPS if one_level else 0,
                "merge_pack": 0 if one_level else STEPS}
        if counts != want:
            raise AssertionError(f"{name}/{mode}: launches {counts}, "
                                 f"expected {want}")
        for k, v in counts.items():
            launches[k] += v
        spikes = int(out.spikes.sum())
        if spikes == 0:
            raise AssertionError(f"{name}/{mode}: no spikes")
        for f in ("dropped", "uplink_dropped", "latency_ns"):
            x = getattr(out, f)
            if x.dtype != torch.int32:
                raise AssertionError(f"{f} is {x.dtype}")
        line = (f"phase 3: {name}/{mode}/{'timed' if timed else 'untimed'}: "
                f"{cfg.n_chips} chips x {cfg.chip.n_neurons} neurons x "
                f"{cfg.chip.n_rows} rows, batch {BATCH}, {STEPS} steps in "
                f"{wall:.3f} s = {STEPS / wall:.1f} steps/s, "
                f"{spikes / wall:.4g} egress events/s, spike occupancy "
                f"{spikes / out.spikes.numel():.4f}, dropped "
                f"{int(out.dropped.sum())}, uplink dropped "
                f"{int(out.uplink_dropped.sum())}, launches {counts}")
        if timed:
            stats = stream.stream_latency_stats(out)
            line += (f", delivered {stats['count'] / wall:.4g} events/s, "
                     f"latency median {stats['median_ns']:.0f} ns, p99 "
                     f"{stats['p99_ns']:.0f} ns")
        print(line + f" [{gpu}]", flush=True)
        print(f"phase 3: {name}/{mode}: "
              + device_breakdown(lambda: stream.run_stream(
                  params, state, drives[:PROFILE_STEPS], cfg, fabric=plan,
                  timed=timed, device=DEV)) + f" [{gpu}]", flush=True)


def device_breakdown(fn) -> str:
    """Where a short run's time goes, from a torch.profiler trace: the
    card's busy share of the wall time (kernel time summed over the run,
    under the profiler's own overhead) and the two kernels' share of the
    busy time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel events only: the operators that launched them carry the same
    # time again as their own device time.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    device = {e.key: e.self_device_time_total for e in kernels}
    per_step = sum(e.count for e in kernels) / PROFILE_STEPS
    busy = sum(device.values())
    if not busy:
        return "device time not measured (the profiler saw no kernels)"
    ours = sum(t for k, t in device.items()
               if "merge_pack_kernel" in k or "exchange_kernel" in k)
    top = ", ".join(f"{k[:40]} {t / busy:.2f}" for k, t in sorted(
        device.items(), key=lambda kv: -kv[1])[:3])
    return (f"{PROFILE_STEPS} profiled steps: {wall_us / PROFILE_STEPS:.0f} "
            f"us/step wall, {per_step:.0f} device operations/step, device "
            f"busy {busy / wall_us:.3f} of it, ported "
            f"kernels {ours / busy:.3f} of device time; top: {top}")


# ---------------------------------------------------------------------------
# Phase 4: the card against the CPU
# ---------------------------------------------------------------------------


def phase4() -> None:
    for name, mode, timed in CHECK_PATHS:
        nets = {}
        for side, dev in (("cpu", torch.device("cpu")), ("card", DEV)):
            # The same seed gives the same network on both devices.
            cfg, params, plan = scenarios.engine_network(name, device=dev)
            # Dyadic weights and drives: the synapse product is exact in
            # float32 in any sum order.
            params = params._replace(chips=params.chips._replace(
                w_scale=torch.full_like(params.chips.w_scale, 2.0 ** -8)))
            nets[side] = (params, fablib.with_exchange_mode(plan, mode), dev)
        gen = torch.Generator().manual_seed(4)
        shape = (CHECK_STEPS, cfg.n_chips, BATCH, cfg.chip.n_rows)
        drives = ((torch.rand(shape, generator=gen) < 0.1)
                  * torch.randint(4, 20, shape, generator=gen) / 16)
        state = netlib.init_state(cfg, BATCH, device="cpu")
        runs = {side: stream.run_stream(p, state, drives, cfg, fabric=pl,
                                        timed=timed, device=dev)
                for side, (p, pl, dev) in nets.items()}
        cpu_params, cpu_plan, _ = nets["cpu"]

        def margin_at(t):
            before = (stream.run_stream(cpu_params, state, drives[:t], cfg,
                                        fabric=cpu_plan, device="cpu").state
                      if t else state)
            return parity.spike_margin(cpu_params, before, drives[t], cfg)

        report = parity.compare_streams(runs["cpu"], runs["card"], margin_at)
        # Teacher forcing: both devices route the CPU run's own spikes.
        spikes = runs["cpu"].spikes.transpose(0, 1)
        timing = timed_wire(cfg.latency) if timed else None
        on_cpu = stream.exchange_spikes(cpu_params, spikes, cfg, cpu_plan,
                                        timing)
        on_card = stream.exchange_spikes(nets["card"][0], spikes.to(DEV), cfg,
                                         nets["card"][1], timing)
        for field, a, b in zip(("drives", "dropped", "uplink", "latency_ns",
                                "latency_valid", "unroutable", "rerouted"),
                               on_cpu, on_card):
            parity.assert_equal(f"{name} teacher-forced {field}", a, b)
        spk = int(runs["cpu"].spikes.sum())
        if spk == 0:
            raise AssertionError(f"{name}: no spikes to compare")
        print(f"phase 4: {name}/{mode}/{'timed' if timed else 'untimed'}: "
              f"card == CPU over {CHECK_STEPS} steps ({spk} spikes, "
              f"{len(report['flips'])} near-threshold flips "
              f"{report['flips'][:5]}, final state max err "
              f"{report['state_max_err']}); teacher-forced exchange "
              f"bit-exact", flush=True)


def main() -> None:
    gpu = card()
    print(f"phase 1: card {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for stem, path in sorted(libs.items()):
        log = pathlib.Path(f"{path}.log")
        usage = [ln.strip() for ln in (log.read_text().splitlines()
                                       if log.exists() else [])
                 if "registers" in ln or "spill" in ln]
        print(f"phase 1: {stem}: {' | '.join(usage) or 'cached build'}",
              flush=True)

    results: dict = {}
    phase2(results)
    launches = {k: 0 for k in KERNEL_SOURCES}
    phase3(launches, gpu)
    phase4()

    kernels = []
    for k, (source, replaces) in KERNEL_SOURCES.items():
        r = results[k]
        kernels.append(dict(
            name=k, route="cuda", source=source, replaces=replaces,
            launches=launches[k], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
        if not launches[k]:
            raise AssertionError(f"{k} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
