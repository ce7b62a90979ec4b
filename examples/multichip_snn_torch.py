"""The paper's 4-chip prototype, end to end, on the PyTorch/CUDA port
(``examples/multichip_snn.py`` with ``repro_torch``).

Builds a feed-forward 3-chip BSS-2 network joined by the Aggregator star,
runs it through the streaming emulation engine (``run_stream``: the whole
time loop in one call), verifies the *event* datapath (LUT routing,
capacity frames, congestion drops; on the card the exchange kernel once a
step) against the differentiable dense mode and against the per-step
dispatch loop, measures the Fig 5 latency distribution for the same
fan-in pattern, and trains the network with surrogate gradients through
the routed fabric.

  PYTHONPATH=src python examples/multichip_snn_torch.py [--steps 60]
  PYTHONPATH=src python examples/multichip_snn_torch.py --device cpu

The weights, batches and Fig 5 draws come from ``torch.Generator``s
seeded as the JAX script's keys, so the printed numbers differ from that
script's.
"""

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import latency_statistics, simulate_fan_in
from repro_torch.snn import network as netlib
from repro_torch.snn import training as trlib
from repro_torch.snn import (init_feedforward, routing_matrices,
                             run_event_steps, run_stream)

FIG5_RATES = (10e6, 50e6, 83.3e6)
FIG5_SPIKES = 2 ** 15


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def config() -> trlib.TrainConfig:
    return trlib.TrainConfig(
        network=netlib.NetworkConfig(n_chips=3, capacity=600),
        n_steps=32, n_classes=4, lr=0.2)


def check_datapath(params, mats, drives: torch.Tensor,
                   cfg: trlib.TrainConfig, device) -> dict:
    """The streamed event datapath against the dense surrogate and against
    the per-step loop on ``drives`` f32[T, n_chips, batch, n_rows], both
    paths timed after a warm-up."""
    device = resolve_device(device)
    net = cfg.network
    state = netlib.init_state(net, drives.shape[2], device=device)
    dense = run_stream(params, state, drives, net, mode="dense",
                       route_mats=mats, device=device)

    def stream():
        return run_stream(params, state, drives, net, device=device)

    event = stream()
    same_dense = bool(torch.equal(dense.spikes, event.spikes))
    drops = int(event.dropped.sum())
    print(f"event == dense spike trains: {same_dense} (drops: {drops})")

    # run_stream runs the T-step loop in one call; compare against T
    # per-step dispatches of the same datapath.
    run_event_steps(params, state, drives, net, device=device)
    sync(device)
    t0 = time.perf_counter()
    _, loop_spikes, _ = run_event_steps(params, state, drives, net,
                                        device=device)
    sync(device)
    t_loop = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream()
    sync(device)
    t_stream = time.perf_counter() - t0
    same_loop = bool(torch.equal(loop_spikes, event.spikes))
    print(f"streaming engine == per-step loop: {same_loop} "
          f"({cfg.n_steps} steps: {t_loop*1e3:.1f} ms loop → "
          f"{t_stream*1e3:.1f} ms streamed, {t_loop/t_stream:.1f}x)")
    return {"event_equals_dense": same_dense, "drops": drops,
            "stream_equals_loop": same_loop, "loop_ms": t_loop * 1e3,
            "stream_ms": t_stream * 1e3}


def fig5(device) -> list[dict]:
    """The 3:1 fan-in latency at each of ``FIG5_RATES``, one generator a
    rate (seeded with the rate in Hz) on the host, as the card-against-CPU
    checks draw."""
    out = []
    for rate in FIG5_RATES:
        stats = latency_statistics(simulate_fan_in(
            rate, FIG5_SPIKES, torch.Generator().manual_seed(int(rate)),
            device=device))
        print(f"fan-in 3:1 @ {rate/1e6:5.1f} MHz/sender: median "
              f"{stats['median_ns']:6.0f} ns, p99 "
              f"{stats['p99_ns']:6.0f} ns, jitter "
              f"{stats['jitter_frac']*100:4.1f}%")
        out.append({"rate_hz": rate, **stats})
    return out


def zeros_like_floats(tree):
    """The momentum: every float32 tensor of a ``NetworkParams`` tree
    zeroed, the integer and boolean ones kept."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree) if tree.dtype == torch.float32 \
            else tree
    return type(tree)(*(zeros_like_floats(x) for x in tree))


def train(params, mats, cfg: trlib.TrainConfig, steps: int, batch_at,
          device) -> dict:
    """``steps`` momentum-SGD ``train_step``s, step ``i`` on the (drives,
    labels) that ``batch_at(i)`` returns; returns the losses, accuracies
    and rates a step."""
    device = resolve_device(device)
    mom = zeros_like_floats(params)
    hist = {"loss": [], "acc": [], "rate": []}
    t0 = time.perf_counter()
    for i in range(steps):
        drives, labels = batch_at(i)
        params, mom, loss, aux = trlib.train_step(params, mom, mats, drives,
                                                  labels, cfg, device=device)
        hist["loss"].append(float(loss))
        hist["acc"].append(float(aux["acc"]))
        hist["rate"].append(float(aux["rate"]))
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {hist['loss'][-1]:.3f}  "
                  f"acc {hist['acc'][-1]:.2f}  rate {hist['rate'][-1]:.3f}")
    sync(device)
    seconds = time.perf_counter() - t0
    print(f"trained {steps} steps in {seconds:.0f}s — "
          "gradients flowed through the multi-chip routing fabric")
    return {**hist, "train_s": seconds}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config()
    params = init_feedforward(cfg.network, seed=0, device=device)
    mats = routing_matrices(params, cfg.network)

    # --- streamed event datapath == dense surrogate == per-step loop ------
    drives, _ = trlib.make_batch(cfg, args.batch,
                                 generator=torch.Generator().manual_seed(1),
                                 device=device)
    out = check_datapath(params, mats, drives, cfg, device)

    # --- Fig 5: latency of the 3:1 fan-in on this fabric ------------------
    out["fig5"] = fig5(device)

    # --- surrogate-gradient training through the routed fabric ------------
    def batch_at(i):
        return trlib.make_batch(
            cfg, args.batch, generator=torch.Generator().manual_seed(100 + i),
            device=device)

    out.update(train(params, mats, cfg, args.steps, batch_at, device))
    return out


if __name__ == "__main__":
    main()
