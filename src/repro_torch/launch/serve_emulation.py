"""Emulation-as-a-service CLI: continuous-batched sessions on one fabric.

Port of ``src/repro/launch/serve_emulation.py``, the demo driver for
``runtime.engine.EmulationEngine``: N tenant sessions of random Poisson
stimulus are submitted against one of the catalogue fabrics
(``analysis.scenarios``), admitted into S slots FIFO as slots free up, and
stepped to completion through one window program.  Prints a per-tenant
accounting table (steps, spikes, the four drop fields, latency percentiles
when ``--timed``) plus aggregate experiments/s.

    PYTHONPATH=src python -m repro_torch.launch.serve_emulation \\
        --scenario EXT_4CASE_96CHIP --sessions 12 --slots 4 --small \\
        --device cpu

runs on the CPU; without ``--device`` it runs on the card, through the
exchange and merge-pack kernels.  ``--small`` shrinks the per-chip array
so the 96-chip fabric steps quickly on the CPU; drop it for the full
256x512 synapse arrays.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.analysis import scenarios as scen
from repro_torch.runtime.engine import EmulationEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="EXT_4CASE_96CHIP",
                    choices=[c[0] for c in scen.CASES])
    ap.add_argument("--sessions", type=int, default=12,
                    help="total tenant sessions to submit")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent sessions S (batch rows)")
    ap.add_argument("--steps", type=int, default=32,
                    help="max session length; lengths sample [steps/2, steps]")
    ap.add_argument("--window", type=int, default=8,
                    help="steps advanced per engine step (scheduling quantum)")
    ap.add_argument("--rate", type=float, default=scen.OCC_HEADLINE,
                    help="per-row stimulus spike probability per step")
    ap.add_argument("--timed", action="store_true",
                    help="per-event wire latency -> per-tenant percentiles")
    ap.add_argument("--plastic", action="store_true",
                    help="per-slot online STDP (each tenant evolves its "
                    "own weight copy)")
    ap.add_argument("--small", action="store_true",
                    help="reduced per-chip array (32 neurons x 16 rows)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    chip = None
    if args.small:
        from repro_torch.snn import chip as chiplib
        chip = chiplib.ChipConfig(n_neurons=32, n_rows=16)
    cfg, params, plan = scen.engine_network(args.scenario, chip=chip,
                                            seed=args.seed, device=device)

    plasticity = None
    if args.plastic:
        from repro_torch.snn.plasticity import STDPConfig
        plasticity = STDPConfig()

    eng = EmulationEngine(params, cfg, slots=args.slots,
                          max_steps=args.steps, window=args.window,
                          plan=plan, timed=args.timed, plasticity=plasticity,
                          keep_spikes=False, device=device)
    print(f"{args.scenario}: {cfg.n_chips} chips, S={args.slots} slots, "
          f"window={args.window}; compiling window program ...")
    eng.warm()

    rng = np.random.default_rng(args.seed)
    sids = []
    for _ in range(args.sessions):
        length = int(rng.integers(max(1, args.steps // 2), args.steps + 1))
        stim = (rng.uniform(size=(length, cfg.chip.n_rows))
                < args.rate).astype(np.float32)
        sids.append(eng.submit(stim))
    print(f"submitted {args.sessions} sessions "
          f"({eng.active} running, {eng.queued} queued)")

    t0 = time.perf_counter()
    windows = 0
    while eng.active or eng.queued:
        done = eng.step()
        windows += 1
        if done:
            print(f"  window {windows:3d}: {done} finished, "
                  f"{eng.active} running, {eng.queued} queued")
    wall = time.perf_counter() - t0

    print(f"\n{'sid':>4} {'steps':>5} {'spikes':>7} {'drop':>5} {'uplk':>5} "
          f"{'unrt':>5} {'rert':>5} {'ttr_ms':>8}"
          + ("  p99_lat_ns" if args.timed else ""))
    for sid in sids:
        r = eng.collect(sid)
        line = (f"{r.session_id:>4} {r.steps:>5} {r.spike_count:>7} "
                f"{r.dropped:>5} {r.uplink_dropped:>5} {r.unroutable:>5} "
                f"{r.rerouted:>5} {r.time_to_result_s * 1e3:>8.1f}")
        if args.timed:
            p99 = r.latency["p99_ns"]
            line += (f"  {p99:.0f}" if r.latency["count"]
                     else "  - (no events)")
        print(line)
    print(f"\n{args.sessions} experiments in {wall * 1e3:.1f} ms emulation "
          f"wall time ({args.sessions / wall:.1f} experiments/s, "
          f"{windows} windows)")


if __name__ == "__main__":
    main()
