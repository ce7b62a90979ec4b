"""Quickstart on the PyTorch/CUDA port: one BSS-2 chip + the multi-chip
spike-routing datapath (``examples/quickstart.py`` with ``repro_torch``).

Runs in seconds:
  1. drive a single emulated chip with a Poisson stimulus,
  2. route its output spikes through the fwd LUT → Aggregator → reverse LUT
     path (the paper's §III datapath; on the card ``route_step`` launches
     the exchange kernel),
  3. print the deterministic latency budget of that path (§IV numbers).

  PYTHONPATH=src python examples/quickstart_torch.py                # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The weights and the stimulus come from ``torch.Generator``s seeded as the
JAX script's keys (0 and 1), so the spike and event counts differ from
that script's; the latency budget is the same line.
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (DEFAULT_PARAMS, identity_router, make_frame,
                              route_step)
from repro_torch.snn import (ChipConfig, chip_step, init_chip_params,
                             init_chip_state, poisson_encode,
                             spikes_to_labels)

N_STEPS = 50
RATE = 0.4
N_CHIPS = 4


def sync(device: torch.device) -> None:
    """Wait for the card before a count is read on the host."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def emulate_chip(params, stimulus: torch.Tensor, cfg: ChipConfig
                 ) -> tuple[int, torch.Tensor]:
    """Step one chip (the port's chip axis of size 1, batch 1) through
    ``stimulus`` f32[T, 1, 1, n_rows]; returns (output spikes over all
    steps, the last step's spikes f32[1, n_neurons])."""
    device = stimulus.device
    state = init_chip_state(cfg, 1, 1, device=device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    for t in range(stimulus.shape[0]):
        state, out_spikes = chip_step(params, state, stimulus[t], cfg)
        total += out_spikes.sum().to(torch.int64)
    sync(device)
    return int(total), out_spikes[0]


def route_spikes(out_spikes: torch.Tensor, n_chips: int = N_CHIPS, *,
                 use_fused: bool | None = None):
    """Tap chip 0's spikes f32[1, n_neurons] as labels, tile them to
    ``n_chips`` egress frames of capacity 512 and run one exchange round
    of the all-to-all star (``use_fused`` as ``route_step`` takes it);
    returns (ingress frames, congestion drops int32[n_chips])."""
    labels, valid = spikes_to_labels(out_spikes, chip_id=0)
    labels = labels.repeat(n_chips, 1)
    frame, _ = make_frame(labels, torch.zeros_like(labels),
                          valid.repeat(n_chips, 1), capacity=512)
    router = identity_router(n_chips, device=out_spikes.device)
    return route_step(router, frame, capacity=1024, use_fused=use_fused)


def latency_line(p=DEFAULT_PARAMS) -> str:
    return (f"latency budget: 2×MGT hops {p.mgt_path_ns():.0f} ns + "
            f"CDC {p.n_fpgas * p.cdc_ns_per_fpga:.0f} ns + "
            f"pack/LUT {2 * p.pack_lut_ns:.0f} ns + arb {p.mux_arb_ns:.0f} "
            f"ns + 2×layer-2 {2 * p.l2_link_ns:.0f} ns + on-chip "
            f"{p.on_chip_ns:.0f} ns = {p.chip_to_chip_ns():.0f} ns "
            f"chip-to-chip (paper: 0.9–1.3 µs)")


def run(params, stimulus: torch.Tensor, cfg: ChipConfig) -> dict:
    """The script's three steps on chip parameters (chip axis of size 1)
    and a stimulus f32[T, 1, 1, n_rows] on one device; prints its three
    lines and returns their numbers."""
    # --- 1. one chip: 512 AdEx/LIF neurons, 256×512 synapse crossbar ------
    total_out, out_spikes = emulate_chip(params, stimulus, cfg)
    print(f"chip emulation: {total_out} output spikes over "
          f"{stimulus.shape[0]} steps ({cfg.n_neurons} neurons, "
          f"{cfg.n_rows * cfg.n_neurons} synapses)")

    # --- 2. multi-chip routing: 4-chip prototype, all-to-all --------------
    ingress, drops = route_spikes(out_spikes)
    sync(out_spikes.device)
    received, dropped = ingress.count().tolist(), drops.tolist()
    print(f"routing: each chip received {received} events "
          f"(dropped {dropped}) through fwd-LUT → star → rev-LUT")

    # --- 3. the latency budget of that path (paper §IV) -------------------
    line = latency_line()
    print(line)
    return {"spikes": total_out, "received": received, "dropped": dropped,
            "latency_line": line}


def inputs(device: torch.device):
    """The chip config, its parameters (chip axis of size 1) and the
    Poisson stimulus f32[T, 1, 1, n_rows], drawn as ``main`` draws them."""
    cfg = ChipConfig()
    params = init_chip_params(1, cfg, torch.Generator().manual_seed(0))
    params = type(params)(*(t.to(device) for t in params))
    stimulus = poisson_encode(torch.full((1, 1, cfg.n_rows), RATE), N_STEPS,
                              generator=torch.Generator().manual_seed(1),
                              device=device)
    return cfg, params, stimulus


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg, params, stimulus = inputs(resolve_device(args.device))
    return run(params, stimulus, cfg)


if __name__ == "__main__":
    main()
