"""Where the benchmark's pieces live, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells; each cell
names a configuration (``bench/configs/<config>.json``) and a traffic mix
(``bench/traffic/<traffic>.json``, read by the runner its ``runner`` key
names); each per-layer metric is a reader ``bench/metrics/<metric>.py``;
the limits of the output comparison are ``bench/limits/<cell>.json``.  A
new cell, configuration, mix or metric is new files and new entries, never
an edit of a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The ``workloads`` entry ``name`` (KeyError if the file has none)."""
    bench = benchmark() if bench is None else bench
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return _json(BENCH / "limits" / f"{cell_name}.json")


def metrics_of(cell_name: str, kind: str, bench: dict | None = None
               ) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports: those
    without ``workloads`` and those that list it."""
    bench = benchmark() if bench is None else bench
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str):
    """The ``read(ctx)`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
