"""How ``correct`` is decided: the program's outputs on the timed path
against the plain reference (``bench/reference/snn.py``), run once the
window has closed and the program's state is freed.

Stream cells: R batch rows drawn from the seed, followed through every
call from set-up on (rows are independent experiments).  Engine cells: a
sample of the finished sessions drawn from the seed, with the longest
among them.  Each number has its limit in ``bench/limits/<cell>.json``;
a run is correct when every number lies at or under its limit.

* ``spike_gap``: the widest distance from threshold of a membrane whose
  spike the program decided otherwise than the float64 reference, driven
  by the program's own raster (``snn.follow``); rounding of float32
  reaches about 1e-6 of the threshold, a lower precision or a fault much
  further.
* ``state_gap``: the widest gap of the final membrane state (v, synaptic
  and adaptation current) of the followed rows, each as a share of the
  reference's largest magnitude of that quantity.
* ``weight_gap``: the widest gap of a session's final weights and traces
  (per-session plasticity).
* ``mismatches``: integer outputs that differ — per step and chip the
  drop counts (egress and congestion, uplink), on the timed lane the sum
  and count of delivered latencies, the final delay line and refractory
  counters; per session its steps, spike count, drop fields and latency
  statistics.  Exact: limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference import snn as ref


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [value, limit]}) over every number compared."""
    check = {k: [numbers[k], limits[k]] for k in numbers}
    ok = all(v <= lim for v, lim in check.values())
    return ok, check


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest gap as a share of the reference's largest magnitude."""
    scale = float(b.double().abs().max()) if b.numel() else 0.0
    return _gap(a, b) / scale if scale else _gap(a, b)


def stream_numbers(net: ref.Net, traffic: dict, rec, ext_rows, final
                   ) -> dict:
    """``rec``: the recorder of the program's sampled rows; ``ext_rows``
    f32[T, n, R, rows] the external drives of one call (every call reuses
    them); ``final``: the program's final state of the rows (``v``,
    ``i_syn``, ``w_adapt``, ``refrac`` [n, R, neurons], ``inflight``
    [delay, n, R, rows])."""
    T = ext_rows.shape[0]
    dev = ext_rows.device

    def ext(t0, t1):
        return ext_rows[torch.arange(t0, t1, device=dev) % T]

    f = ref.follow(net, rec.n_steps, rec.raster, ext, mode=traffic["mode"],
                   timed=traffic["timed"])
    prog = rec.outputs()
    mism = 0
    for k in ("dropped", "uplink", "lat_sum", "lat_n"):
        if k in prog:
            mism += int((prog[k].long() != f.routed[k].long()).sum())
    mism += int((final["inflight"].float() != f.state["inflight"]).sum())
    mism += int((final["refrac"].long() != f.state["refrac"]).sum())
    state_gap = max(_rel_gap(final[k], f.state[k])
                    for k in ("v", "i_syn", "w_adapt"))
    return {"spike_gap": f.spike_gap, "state_gap": state_gap,
            "mismatches": mism}


def engine_numbers(net: ref.Net, traffic: dict, sessions, device) -> dict:
    """``sessions``: (stimulus f32[L, n_stim, rows], ``SessionResult``)
    pairs; each is followed from rest as its own batch-1 run."""
    stdp = ref.STDP(**traffic["plasticity"])
    stim_chips = torch.tensor(traffic["stim_chips"], device=device)
    n, rows = net.fabric.n, net.fabric.rows
    spike_gap = weight_gap = 0.0
    mism = 0
    for stim, r in sessions:
        L = stim.shape[0]
        spikes = torch.from_numpy(r.spikes).to(device)[:, :, None] > 0.5
        drive = torch.zeros((L, n, 1, rows), device=device)
        drive[:, stim_chips, 0] = torch.from_numpy(stim).to(device)
        f = ref.follow(net, L, lambda t0, t1: spikes[t0:t1],
                       lambda t0, t1: drive[t0:t1], timed=traffic["timed"],
                       stdp=stdp)
        spike_gap = max(spike_gap, f.spike_gap)
        for got, want in zip(r.plasticity, f.plasticity):
            weight_gap = max(weight_gap, _gap(
                torch.from_numpy(np.asarray(got)).to(device), want[:, 0]))
        want = {"steps": L, "spike_count": int(spikes.sum()),
                "dropped": int(f.routed["dropped"].sum()),
                "uplink_dropped": int(f.routed["uplink"].sum()),
                "unroutable": 0, "rerouted": 0}
        mism += sum(getattr(r, k) != v for k, v in want.items())
        if traffic["timed"]:
            lat = f.routed["lat"][f.routed["lat_valid"]].double().cpu()
            mism += _latency_mismatches(r.latency, lat.numpy())
    return {"spike_gap": spike_gap, "weight_gap": weight_gap,
            "mismatches": mism}


def _latency_mismatches(got: dict, lat: np.ndarray) -> int:
    """A session's latency statistics against the reference's delivered
    latencies: the count, median and 1st/99th percentiles, exact."""
    if got["count"] != lat.size:
        return 1
    if not lat.size:
        return 0
    want = [np.median(lat), *np.percentile(lat, [1.0, 99.0])]
    have = [got["median_ns"], got["p01_ns"], got["p99_ns"]]
    return sum(float(a) != float(b) for a, b in zip(have, want))
