"""The engine runner: tenants of the shared fabric, each a closed loop
around ``runtime.engine.EmulationEngine`` (submit, step, collect).

Traffic keys: ``slots`` (S, the engine's batch rows), ``tenants``,
``window`` (steps an engine step advances), ``timed``, ``lengths`` [lo,
hi] (session lengths, uniform, the same multiset for every seed),
``stim_chips`` and ``stim_p`` (each stimulated row spikes with this
probability a step), ``plasticity`` (per-session STDP constants),
``pool`` (stimuli made at set-up, reused in turn), ``check_sample``
(finished sessions the reference follows, drawn from the seed, with the
longest) and ``traced_calls`` (engine steps traced after the window).

Every tenant submits its next session when it has collected its last.
A session's time is from its submit to its collect on the benchmark's
clock; the window counts the sessions collected inside it.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from bench.lib import check, inputs, program, stats
from bench.lib.trace import GEMM, Trace
from bench.reference import snn as ref


class _Sample:
    """The sessions kept for the reference: a reservoir drawn from the
    seed, plus the first session of the longest length."""

    def __init__(self, seed: int, size: int, longest: int):
        self.rng = np.random.default_rng([int(seed), 3])
        self.size, self.longest = size, longest
        self.kept, self.seen, self.long = [], 0, None

    def offer(self, item) -> None:
        stim, _ = item
        if self.long is None and stim.shape[0] == self.longest:
            self.long = item
            return
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.size:
            self.kept[j] = item

    def items(self) -> list:
        return self.kept + ([self.long] if self.long is not None else [])


def run(run_ctx) -> dict:
    from repro_torch.runtime import engine as englib
    from repro_torch.snn import stream as stlib

    cfg_file, traffic = run_ctx.config, run_ctx.traffic
    dev = run_ctx.device
    gen = inputs.generator(run_ctx.seed, dev)
    weights, row_sign, w_scale = inputs.chip_params(cfg_file, gen, dev)
    pool = inputs.session_pool(cfg_file, traffic, run_ctx.seed)
    run_ctx.mark("inputs")
    cfg, params, plan = program.build(cfg_file, weights, row_sign, w_scale,
                                      device=dev)
    eng = englib.EmulationEngine(
        params, cfg, slots=traffic["slots"], max_steps=traffic["lengths"][1],
        plan=plan, window=traffic["window"],
        stim_chips=tuple(traffic["stim_chips"]), timed=traffic["timed"],
        plasticity=program.stdp_config(traffic), device=dev)
    run_ctx.mark("program")
    eng.warm()
    run_ctx.mark("warm")
    setup_s = time.perf_counter() - run_ctx.t_process

    sample = _Sample(run_ctx.seed, traffic["check_sample"],
                     traffic["lengths"][1])
    next_stim = itertools.count()
    submitted = {}                      # sid -> (submit time, stimulus)

    def submit():
        stim = pool[next(next_stim) % len(pool)]
        sid = eng.submit(stim)
        submitted[sid] = (time.perf_counter(), stim)

    step_spans, latencies = [], []
    t_start = time.perf_counter()
    deadline = t_start + run_ctx.seconds
    for _ in range(traffic["tenants"]):
        submit()
    steps = 0
    while True:
        t0 = time.perf_counter()
        eng.step()
        t1 = time.perf_counter()
        step_spans.append(t1 - t0)
        steps += 1
        for sid in eng.done:
            result = eng.collect(sid)
            t_sub, stim = submitted.pop(sid)
            latencies.append(time.perf_counter() - t_sub)
            sample.offer((stim, result))
            if t1 < deadline:
                submit()
        if not run_ctx.window_open(t1, deadline, steps):
            break
    window_s = time.perf_counter() - t_start

    trace = counters = None
    if run_ctx.trace:
        trace, counters = Trace(), []
        for _ in range(len(submitted), traffic["tenants"]):
            submit()
        seen = []
        real = stlib.run_stream

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            seen.append(out.latency_valid)
            return out

        stlib.run_stream = spy
        try:
            for _ in range(traffic["traced_calls"]):
                trace.run(eng.step)
                for sid in eng.done:
                    eng.collect(sid)
                    submitted.pop(sid)
                    submit()
        finally:
            stlib.run_stream = real
        T, n, S, cap = seen[0].shape
        layout = plan.merge_layout(cfg_file["capacity"])
        counters = [{"launches": T, "batch": S, "n": n, "capacity": cap,
                     "kept": int(v.sum()),
                     "merge_slots": sum(sum(level) for level in layout)}
                    for v in seen]
    peak = run_ctx.memory_peak()
    del eng, params
    run_ctx.free()

    t_check = time.perf_counter()
    net = ref.Net(cfg_file, weights, row_sign, w_scale)
    numbers = check.engine_numbers(net, traffic, sample.items(), dev)
    check_s = time.perf_counter() - t_check
    done = len(latencies)
    e2e = {"experiments_per_s": done / window_s}
    if done:
        e2e["result_p95_s"] = stats.percentile(latencies, 95)
    return {
        "setup_s": setup_s, "window_s": window_s, "memory_peak": peak,
        "window_calls": steps,
        "check_s": check_s,
        "attempted": done, "failed": 0, "numbers": numbers,
        "end_to_end": e2e,
        "ctx": {"spans": {"engine.step": step_spans}, "trace": trace,
                "counters": counters,
                "traced_steps": traffic["window"] * traffic["traced_calls"],
                "config": cfg_file,
                "traffic": traffic, "gemm": GEMM},
    }
