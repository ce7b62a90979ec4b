"""The benchmark's cells cut to a size a CPU test can hold: the same
runners, check and limits, on a 4-chip star or an 8-chip 3-level fabric,
a few rows and steps, and three calls (or engine steps) in the window."""

from __future__ import annotations

import copy
import time

import torch

from bench.lib import spec
from bench.run import RunContext, run_cell

SEED = 2 ** 31 + 11


def shrink(config: dict, traffic: dict) -> tuple[dict, dict]:
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    if len(config["fan_ins"]) == 1:
        config.update(chips=4, fan_ins=[4], capacity=64,
                      link_capacities=[None])
    else:
        # scenarios.level_caps((2, 2, 2), cap_in 24, occupancy 0.05)
        config.update(chips=8, fan_ins=[2, 2, 2], capacity=32,
                      link_capacities=[8, 8, 10])
    if traffic["runner"] == "stream":
        traffic.update(batch=8, steps=8, check_sample=3, traced_calls=1)
    else:
        traffic.update(slots=4, tenants=4, window=4, lengths=[4, 8],
                       pool=10, check_sample=3, traced_calls=1)
    return config, traffic


class TinyContext(RunContext):
    """A run whose window holds three calls (or engine steps), whatever
    they take on the CPU."""

    def window_open(self, now: float, deadline: float, calls: int) -> bool:
        return calls < 3


def context(cell_name: str, *, seed: int = SEED, trace: bool = False):
    bench = spec.benchmark()
    cell = spec.cell(cell_name, bench)
    config, traffic = shrink(spec.config(cell["config"]),
                             spec.traffic(cell["traffic"]))
    ctx = TinyContext(config=config, traffic=traffic, seed=seed,
                      seconds=30.0, trace=trace, device=torch.device("cpu"),
                      t_process=time.perf_counter())
    return cell, bench, ctx


def run(cell_name: str, **kw) -> dict:
    cell, bench, ctx = context(cell_name, **kw)
    return run_cell(cell, bench, ctx)


CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
