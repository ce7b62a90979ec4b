"""The control of the correctness check: the plain reference put in the
program's place, in the precision below the configuration's, must come
out not correct.

    python3 bench/control.py --workload <cell> --seed <n> --seconds <s>

runs the cell exactly as ``bench/run.py`` does (same inputs, set-up,
window and check), with ``repro_torch.snn.stream.run_stream`` (which the
stream runner calls and the engine calls for every window) replaced by
the reference's free-running closed loop (``snn.stream``): the synapse
product in TF32 (operands rounded to a 10-bit mantissa, float32 sums),
per-session plasticity in bfloat16.  It prints the result line, whose
``correct`` has to read false.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def reference_run_stream(config: dict, precision: str = "tf32",
                         plast_precision: str = "bfloat16"):
    """A stand-in for the port's ``run_stream`` built on the reference,
    taking and returning the port's types."""
    import torch
    from repro_torch.snn import chip as chiplib
    from repro_torch.snn import network as netlib
    from repro_torch.snn import neuron as nrn
    from repro_torch.snn import plasticity as plas
    from repro_torch.snn.stream import StreamOut

    from bench.reference import snn as ref

    def run_stream(params, state, ext_drives, cfg, *, mode="event",
                   timed=False, plasticity=None, plasticity_state=None,
                   slot_mask=None, device=None, **_):
        c = params.chips
        net = ref.Net(config, c.weights, c.row_sign, c.w_scale)
        ns = state.chips.neurons
        st = {"v": ns.v, "i_syn": ns.i_syn, "w_adapt": ns.w_adapt,
              "refrac": ns.refrac.long(), "inflight": state.inflight}
        stdp = plast = None
        if plasticity is not None:
            stdp = ref.STDP(**dataclasses.asdict(plasticity))
            plast = tuple(plasticity_state)
        out, st, plast = ref.stream(
            net, st, ext_drives, mode=mode, timed=timed, stdp=stdp,
            plast=plast, slot_mask=slot_mask, precision=precision,
            plast_precision=plast_precision)
        T, n, B, _ = ext_drives.shape
        zeros = torch.zeros((T, n, B), dtype=torch.int32,
                            device=ext_drives.device)
        if timed:
            lat, lat_valid = out["lat"], out["lat_valid"]
        else:
            lat = torch.zeros((T, n, B, 0), dtype=torch.int32,
                              device=ext_drives.device)
            lat_valid = lat.bool()
        chips = chiplib.ChipState(neurons=nrn.NeuronState(
            v=st["v"], i_syn=st["i_syn"], w_adapt=st["w_adapt"],
            refrac=st["refrac"].int()))
        return StreamOut(
            state=netlib.NetworkState(chips=chips, inflight=st["inflight"]),
            spikes=out["spikes"], dropped=out["dropped"],
            uplink_dropped=out["uplink"], latency_ns=lat,
            latency_valid=lat_valid, unroutable=zeros, rerouted=zeros,
            plasticity=(None if plast is None
                        else plas.SlotPlasticityState(*plast)))

    return run_stream


def run_control(cell: dict, bench: dict, ctx) -> dict:
    """``run.run_cell`` with the reference in the program's place."""
    from repro_torch.snn import stream as stlib

    from bench.run import run_cell

    real = stlib.run_stream
    stlib.run_stream = reference_run_stream(ctx.config)
    try:
        return run_cell(cell, bench, ctx)
    finally:
        stlib.run_stream = real


def main(argv=None) -> int:
    import argparse
    import time

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    t_process = time.perf_counter()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.lib import spec
    from bench.run import RunContext

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    if not torch.cuda.is_available():
        print("the control runs on the card; no result", file=sys.stderr)
        return 2
    ctx = RunContext(config=spec.config(cell["config"]),
                     traffic=spec.traffic(cell["traffic"]), seed=args.seed,
                     seconds=args.seconds, trace=False,
                     device=torch.device("cuda", 0), t_process=t_process)
    line = run_control(cell, bench, ctx)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
