"""Fabric verifier CLI: ``python -m repro_torch.analysis.lint``.

Port of ``src/repro/analysis/lint.py``.  Runs every pass over every
benchmark scenario (healthy and degraded):

  * plan verifier   (``planlint``)    invariants on each compiled plan;
  * program lint    (``programlint``) the traced torch program of
    ``fabric_route_step`` (gather and routed), of ``fabric_exchange`` on
    each plan's shrunk twin (gloo ranks, one exchange lint per health
    signature, both exchange modes: the routed twin pins zero all-gathers
    and the per-edge byte budget) and of ``run_stream``;
  * kernel checker  (``kernelcheck``) the pack units' write-set model
    check at every plan capacity, and on a card every body of the four
    CUDA router kernels checked from its own output;
  * suppression lint: stale or undocumented waivers fail the run.

``--device`` picks where the programs run: ``cuda`` (the default; the
kernels run) or ``cpu`` (their plain versions run, and the card check
reports a ``kernel.devices`` warning instead of checking anything in the
kernels' place).  The reference's ``--hlo`` pass has no counterpart: the
wire counters the program lint reads measure the bytes it estimated from
HLO text.  Exit status 0 iff no error-severity finding survives
suppression.
"""

from __future__ import annotations

import sys
import time

from repro_torch.analysis import kernelcheck, planlint, programlint
from repro_torch.analysis.diagnostics import (Diagnostic, WARNING,
                                              apply_suppressions)
from repro_torch.analysis.scenarios import benchmark_plans
from repro_torch.analysis.suppressions import SUPPRESSIONS
from repro_torch.core import fabric as fablib


def run_lint(device=None, verbose: bool = False,
             seconds: dict | None = None) -> list[Diagnostic]:
    """All passes over all scenarios; returns raw (unsuppressed) findings.
    ``device`` as in every entry point: the card unless it says ``cpu``.
    ``seconds``, when given, gains each pass's wall time by name."""
    seconds = {} if seconds is None else seconds

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    diags: list[Diagnostic] = []
    capacities: set[int] = set()
    exchange_seen: set[str] = set()
    exchanges = []
    for sc in benchmark_plans():
        if verbose:
            print(f"lint: {sc.name}: {sc.plan.describe()}", file=sys.stderr)
        diags += timed("planlint", planlint.lint_plan, sc.plan, sc.cap_in,
                       sc.name)
        diags += timed("fabric_route_step", programlint.lint_route_step,
                       sc.plan, sc.cap_in, f"{sc.name}/fabric_route_step",
                       device=device)
        diags += timed("fabric_route_step", programlint.lint_route_step,
                       fablib.with_exchange_mode(sc.plan, "routed"),
                       sc.cap_in, f"{sc.name}/fabric_route_step[routed]",
                       device=device)
        # One shrunk-twin exchange lint per health signature (the twin only
        # depends on the level structure + which levels carry dead edges).
        sig = (sc.name.split("/")[0],
               tuple((lvl.uplink_ok is not None, lvl.downlink_ok is not None)
                     for lvl in sc.plan.levels))
        if str(sig) not in exchange_seen:
            exchange_seen.add(str(sig))
            exchanges.append((sc.plan, sc.cap_in,
                              f"{sc.name}/fabric_exchange"))
            exchanges.append((fablib.with_exchange_mode(sc.plan, "routed"),
                              sc.cap_in, f"{sc.name}/fabric_exchange[routed]"))
        capacities.add(sc.plan.capacity)
        capacities.update(lvl.link_capacity for lvl in sc.plan.levels
                          if lvl.link_capacity is not None)
    # The twins of one size share one group of ranks.
    diags += timed("fabric_exchange", programlint.lint_fabric_exchanges,
                   exchanges, device=device)
    diags += timed("run_stream", programlint.lint_run_stream, "run_stream",
                   device=device)
    diags += timed("pack_units", kernelcheck.check_pack_units, capacities)
    diags += timed("router_kernels", kernelcheck.check_router_kernels,
                   "cuda" if device is None else device)
    return diags


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Static invariant checks on fabric plans, the torch "
                    "exchange programs and the CUDA pack units.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the programs and kernels run (default "
                             "cuda; cpu runs the plain versions and skips "
                             "the card check with a warning)")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="suppress the per-scenario progress lines")
    args = parser.parse_args(argv)

    findings = run_lint(device=args.device, verbose=not args.quiet)
    active, suppressed = apply_suppressions(findings, SUPPRESSIONS)
    errors = [d for d in active if d.severity != WARNING]
    for d in active:
        print(d.format())
    n_checks = len({d.check for d in findings}) if findings else 0
    print(f"fabric lint: {len(errors)} error(s), "
          f"{len(active) - len(errors)} warning(s), "
          f"{len(suppressed)} suppressed"
          + (f" across {n_checks} failing check(s)" if n_checks else ""))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
