"""The stream runner: a sweep of independent experiments, the batch rows
of one ``run_stream`` call after another over one network, closed loop.

Traffic keys: ``mode`` ("event" or "dense"), ``timed``, ``exchange_mode``
("gather" or "routed"), ``batch`` rows, ``steps`` a call (T), ``drive_p``
(an external spike on each synapse row and step with this probability),
``check_sample`` (the rows the reference follows) and ``traced_calls``
(the calls traced after the window in a ``--trace 1`` run).

One drive tensor f32[T, n, batch, rows] is made at set-up and every call
takes it; the network state carries from call to call, and each call
starts once the last one's outputs are synchronised.  The window counts
emulated steps of the whole batch over its whole time.
"""

from __future__ import annotations

import time

import torch

from bench.lib import check, inputs, program
from bench.lib.trace import GEMM, Trace
from bench.reference import snn as ref

BITS = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8)


class Recorder:
    """The program's outputs of the sampled rows, every call from set-up
    on: spikes bit-packed, per-step drop counts and, timed, the sum and
    count of the delivered latencies."""

    def __init__(self, rows, timed: bool, device):
        self.idx = torch.tensor(rows, dtype=torch.long, device=device)
        self.timed = timed
        self.bits = BITS.to(device)
        self.parts = {"spikes": [], "dropped": [], "uplink": []}
        if timed:
            self.parts.update(lat_sum=[], lat_n=[])

    def add(self, out) -> None:
        s = out.spikes.index_select(2, self.idx) > 0.5
        *lead, k = s.shape
        self.parts["spikes"].append(
            s.reshape(*lead, k // 8, 8).to(torch.uint8).mul_(self.bits)
            .sum(-1, dtype=torch.uint8))
        self.parts["dropped"].append(out.dropped.index_select(2, self.idx))
        self.parts["uplink"].append(
            out.uplink_dropped.index_select(2, self.idx))
        if self.timed:
            val = out.latency_valid.index_select(2, self.idx)
            lat = out.latency_ns.index_select(2, self.idx)
            self.parts["lat_sum"].append(
                torch.where(val, lat, 0).sum(-1, dtype=torch.int64))
            self.parts["lat_n"].append(val.sum(-1, dtype=torch.int32))

    @property
    def n_steps(self) -> int:
        return sum(p.shape[0] for p in self.parts["spikes"])

    def raster(self, t0: int, t1: int) -> torch.Tensor:
        """bool[t1 - t0, n, R, neurons] (after ``compact``)."""
        packed = self.parts["spikes"][0][t0:t1]
        s = (packed[..., None] & self.bits) != 0
        return s.reshape(*packed.shape[:-1], -1)

    def outputs(self) -> dict:
        return {k: torch.cat(v) for k, v in self.parts.items()
                if k != "spikes"}

    def compact(self) -> None:
        """Join the per-call parts (so ``raster`` slices one tensor)."""
        self.parts = {k: [torch.cat(v)] for k, v in self.parts.items()}


def run(run_ctx) -> dict:
    from repro_torch.snn import network as netlib
    from repro_torch.snn import stream as stlib

    cfg_file, traffic = run_ctx.config, run_ctx.traffic
    dev = run_ctx.device
    gen = inputs.generator(run_ctx.seed, dev)
    weights, row_sign, w_scale = inputs.chip_params(cfg_file, gen, dev)
    T, B = traffic["steps"], traffic["batch"]
    drives = inputs.drives(cfg_file, T, B, traffic["drive_p"], gen, dev)
    run_ctx.mark("inputs")
    cfg, params, plan = program.build(
        cfg_file, weights, row_sign, w_scale,
        exchange_mode=traffic.get("exchange_mode", "gather"), device=dev)
    mode, timed = traffic["mode"], traffic["timed"]
    kw = {"mode": mode, "timed": timed, "device": dev}
    if mode == "dense":
        kw["route_mats"] = netlib.routing_matrices(params, cfg)
    else:
        kw["fabric"] = plan
    run_ctx.mark("program")
    rows = inputs.sample_rows(run_ctx.seed, B, traffic["check_sample"])
    rec = Recorder(rows, timed, dev)
    ext_rows = drives.index_select(2, rec.idx).clone()
    state = netlib.init_state(cfg, B, device=dev)

    def call(st):
        out = stlib.run_stream(params, st, drives, cfg, **kw)
        rec.add(out)
        run_ctx.sync()
        return out

    # Set-up: one warm call of the cell's own shapes (loads the kernels).
    state = call(state).state
    run_ctx.mark("warm")
    setup_s = time.perf_counter() - run_ctx.t_process

    spans = []
    t_start = time.perf_counter()
    deadline = t_start + run_ctx.seconds
    calls = 0
    while True:
        t0 = time.perf_counter()
        state = call(state).state
        t1 = time.perf_counter()
        spans.append(t1 - t0)
        calls += 1
        if not run_ctx.window_open(t1, deadline, calls):
            break
    window_s = t1 - t_start

    trace = counters = None
    if run_ctx.trace:
        trace, counters = Trace(), []
        for _ in range(traffic["traced_calls"]):
            out = trace.run(lambda: call(state))
            state = out.state
            counters.append(_work(out, cfg_file, plan, mode, timed))
            del out
    peak = run_ctx.memory_peak()

    final = {k: getattr(state.chips.neurons, k).index_select(1, rec.idx)
             for k in ("v", "i_syn", "w_adapt", "refrac")}
    final["inflight"] = state.inflight.index_select(2, rec.idx)
    del state, drives, params, kw
    run_ctx.free()
    rec.compact()
    t_check = time.perf_counter()
    net = ref.Net(cfg_file, weights, row_sign, w_scale)
    numbers = check.stream_numbers(net, traffic, rec, ext_rows, final)
    run_ctx.sync()
    steps = T * calls
    return {
        "setup_s": setup_s, "window_s": window_s, "memory_peak": peak,
        "window_calls": calls,
        "check_s": time.perf_counter() - t_check,
        "attempted": calls, "failed": 0, "numbers": numbers,
        "end_to_end": {"steps_per_s": steps / window_s},
        "ctx": {"spans": {"run_stream": spans}, "trace": trace,
                "counters": counters,
                "traced_steps": T * traffic["traced_calls"],
                "config": cfg_file, "traffic": traffic, "gemm": GEMM},
    }


def _work(out, config: dict, plan, mode: str, timed: bool) -> dict:
    """The work of one traced call, counted from its outputs (read after
    the profiler stopped): the launches, slots and events the exchange
    and merge kernels had to handle."""
    if mode == "dense":
        return {}
    T, n, B, K = out.spikes.shape
    cap = config["capacity"]
    per_chip = out.spikes.sum(-1)                        # [T, n, B]
    egress = torch.clamp(per_chip, max=cap)
    chips = torch.arange(n, device=per_chip.device)
    limit = 1 << config["wire_label_bits"]
    enabled = ((chips << ref.NEURON_BITS) < limit)[None, :, None]
    valid = (egress * enabled).sum()
    work = {"launches": T, "batch": B, "n": n, "cap_in": cap,
            "capacity": plan.capacity, "valid": int(valid)}
    if timed:
        work["kept"] = int(out.latency_valid.sum())
    else:
        # Every enabled event is offered to all chips but its own; the
        # drop counts hold egress overflow and congestion.
        egress_drop = torch.clamp(per_chip - cap, min=0).sum()
        congestion = out.dropped.sum() - egress_drop
        work["kept"] = int((n - 1) * valid - congestion)
    work["merge_slots"] = sum(
        sum(level) for level in plan.merge_layout(cap))
    return work
