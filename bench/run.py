"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (a ``workloads`` entry of ``BENCHMARK.json``) names its
configuration and traffic mix; the mix's ``runner`` runs the system under
test (the port, ``repro_torch``, from ``src/``) on inputs made from the
seed: set-up (weights, drives, the compiled fabric, one warm call of the
cell's own shapes), then the measured window of ``--seconds``, then, with
``--trace 1``, a few calls under ``torch.profiler`` for the per-layer
metrics.  Once the window has closed and the program's state is freed,
the plain reference judges what the timed path produced
(``bench/lib/check.py``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or its per-layer metrics with ``--trace 1``),
``device``, ``breakdown`` and ``work`` (traced: the events the counted
kernels handled), ``timing`` (set-up, window and check seconds, the
window's calls, and the second from process start at which each phase
of set-up ended) and ``check``, each number compared beside its limit,
which also closes standard error.

Without a CUDA card, with fewer cards than the cell asks for, or with
JAX or the JAX package (``repro``) loaded, it prints no result and exits
with a code other than 0.  Kernels build once into ``build/`` inside the
checkout.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()     # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


class RunContext:
    """One run's settings and the device hooks the runners call.

    ``mark(phase)`` notes the seconds from process start at which a
    phase of set-up ended (``timing.setup_phases`` of the result line)."""

    def __init__(self, *, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device, t_process: float):
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_process = device, t_process
        self.phases = {}

    def mark(self, phase: str) -> None:
        self.sync()
        self.phases[phase] = time.perf_counter() - self.t_process

    def window_open(self, now: float, deadline: float, calls: int) -> bool:
        """Whether the window takes another call after ``calls``."""
        return now < deadline

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch
        self.sync()
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import gc

        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.empty_cache()


def run_cell(cell: dict, bench: dict, ctx: RunContext) -> dict:
    """Run ``cell`` once; returns its result line (a dict)."""
    import importlib
    from types import SimpleNamespace

    from bench.lib import check, readers, spec

    runner = importlib.import_module(
        f"bench.lib.{ctx.traffic['runner']}_runner")
    res = runner.run(ctx)
    correct, compared = check.judge(res["numbers"], spec.limits(cell["name"]))
    kind = device_kind(ctx.device)
    device = {"platform": "gpu" if ctx.cuda else "cpu", "kind": kind,
              "count": 1, "memory_peak_bytes": res["memory_peak"]}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"]}
    metrics = {}
    if ctx.trace:
        c = res["ctx"]
        trace = c["trace"]
        rctx = SimpleNamespace(**c, device_kind=kind)
        for m in spec.metrics_of(cell["name"], "per_layer", bench):
            value = spec.reader(m["name"])(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        line["breakdown"] = trace.breakdown()
        line["work"] = readers.work_totals(c["counters"])
    else:
        values = {**res["end_to_end"], "setup_s": res["setup_s"]}
        for m in spec.metrics_of(cell["name"], "end_to_end", bench):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line["metrics"] = metrics
    device["power_limit"] = power_limit() if ctx.cuda else None
    line["device"] = device
    line["timing"] = {**{k: res[k] for k in ("setup_s", "window_s",
                                             "window_calls", "check_s")},
                      "setup_phases": ctx.phases}
    line["check"] = compared
    return line


def device_kind(device) -> str:
    if device.type == "cuda":
        import torch
        return torch.cuda.get_device_name(device)
    return "cpu"


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # Kernel caches at fixed paths inside the checkout.
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "extensions")
    import torch

    from bench.lib import guard, spec

    t_imports = time.perf_counter() - T_PROCESS

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"{args.workload}: needs {cell['chips']} CUDA card(s), found "
              f"{cards}; no result", file=sys.stderr)
        return 2
    ctx = RunContext(config=spec.config(cell["config"]),
                     traffic=spec.traffic(cell["traffic"]), seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace),
                     device=torch.device("cuda", 0), t_process=T_PROCESS)
    ctx.phases["imports"] = t_imports
    torch.cuda.init()
    torch.empty(1, device=ctx.device)
    ctx.mark("cuda")
    line = run_cell(cell, bench, ctx)
    found = guard.forbidden_modules()
    if found:
        print(f"the process holds JAX or the JAX package: {found}; no "
              "result", file=sys.stderr)
        return 3
    for name, (value, limit) in line["check"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
