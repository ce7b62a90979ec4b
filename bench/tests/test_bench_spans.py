"""The metrics read from the program's own stage spans: a traced run of
each cell, cut to the CPU, gives each one the cell lists a finite,
positive number (``tests/test_torch_obs.py`` holds that an untraced run
records nothing)."""

import functools
import math

import pytest

from bench.lib import spec
from bench.tests import tiny
from repro_torch import obs

SPAN_METRICS = ("chip_step_us_per_step.stream", "route_us_per_step.stream",
                "pack_us_per_step.stream", "plasticity_ms_per_step.engine",
                "to_host_ms_per_window.engine", "to_host_gb_per_s.engine")
CASES = [(cell, m["name"]) for m in spec.benchmark()["per_layer"]
         if m["name"] in SPAN_METRICS for cell in m["workloads"]]


@functools.cache
def traced_line(cell: str) -> dict:
    """One traced tiny run of ``cell`` on a fresh recorder."""
    obs.reset()
    try:
        return tiny.run(cell, trace=True)
    finally:
        obs.reset()


def test_every_span_metric_is_listed_in_a_cell():
    assert {name for _, name in CASES} == set(SPAN_METRICS)


@pytest.mark.parametrize("cell,metric", CASES)
def test_a_traced_run_reads_the_span_metric(cell, metric):
    line = traced_line(cell)
    assert line["correct"]
    value = line["metrics"][metric]["value"]
    assert math.isfinite(value) and value > 0
