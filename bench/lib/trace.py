"""The device trace of a traced window, from ``torch.profiler``.

Each traced call runs inside its own profiler session; ``Trace`` sums
the sessions: device time and launches by kernel name, the seconds in
which an operation ran on the device (the union of their intervals), the
wall time of the traced calls, and the idle gaps between device
operations named by what the host was doing when each began (the
innermost host event open at the gap's start).
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_runner", "user_annotation",
             "python_function")
GEMM = re.compile(r"gemm|xmma|cutlass|cublas", re.IGNORECASE)


class Trace:
    def __init__(self):
        self.kernels = defaultdict(lambda: [0, 0.0])   # name -> [n, seconds]
        self.gaps = defaultdict(float)                 # host activity -> s
        self.busy_s = 0.0
        self.window_s = 0.0

    @property
    def device_ops(self) -> int:
        return sum(n for n, _ in self.kernels.values())

    def seconds(self, pattern) -> float:
        """Device seconds of the operations whose name matches
        ``pattern`` (a compiled regex or a substring)."""
        match = (pattern.search if hasattr(pattern, "search")
                 else (lambda k: pattern in k))
        return sum(s for k, (_, s) in self.kernels.items() if match(k))

    def launches(self, pattern) -> int:
        match = (pattern.search if hasattr(pattern, "search")
                 else (lambda k: pattern in k))
        return sum(n for k, (n, _) in self.kernels.items() if match(k))

    def run(self, fn):
        """Run ``fn`` (which synchronises the card before it returns) in a
        profiler session and add its trace; returns ``fn``'s result."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            result = fn()
            self.window_s += time.perf_counter() - t0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.add(events)
        return result

    def add(self, events: list) -> None:
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append((float(e["ts"]), float(e["dur"]), e["name"]))
            elif cat in HOST_CATS:
                host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                             e["name"]))
        for _, dur, name in dev:
            k = self.kernels[name]
            k[0] += 1
            k[1] += dur * 1e-6
        dev.sort()
        host.sort()
        starts = [h[0] for h in host]
        end = None
        for ts, dur, _ in dev:
            if end is not None and ts > end:
                self.gaps[_host_at(host, starts, end)] += (ts - end) * 1e-6
            if end is None or ts > end:
                self.busy_s += dur * 1e-6
                end = ts + dur
            elif ts + dur > end:
                self.busy_s += (ts + dur - end) * 1e-6
                end = ts + dur

    def breakdown(self) -> dict:
        ops = sorted(((k, s) for k, (_, s) in self.kernels.items()),
                     key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, s] for k, s in ops],
                "idle_gaps": [[k, s] for k, s in gaps]}


def _host_at(host, starts, t: float, depth: int = 400) -> str:
    """The innermost host event open at ``t``: of those started by ``t``,
    the latest whose end lies past it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - depth), -1):
        if host[j][1] > t:
            return host[j][2]
    return "host (no event open)"
