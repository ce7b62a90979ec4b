"""The system under test, built from a configuration file: the port's
``NetworkConfig``, its compiled ``FabricPlan`` and its ``NetworkParams``
over the benchmark's seeded weights.

Only this module, the runners and the control's adapter import the port
(``repro_torch``); the reference never does.  The port's own constructors
lay out what the configuration states (``scenarios.level_caps`` and
``plan_for`` compile the plan; ``init_feedforward`` the row map;
``identity_router`` the all-enabled routes), and every number the
configuration states for the reference is checked here against what the
port derives, so the two sides run one deployment.
"""

from __future__ import annotations


def build(config: dict, weights, row_sign, w_scale, *,
          exchange_mode: str = "gather", device):
    """Returns ``(cfg, params, plan)``; raises if the configuration file
    and the port disagree on a derived number."""
    from repro_torch.analysis import scenarios
    from repro_torch.core import aggregator
    from repro_torch.core import fabric as fablib
    from repro_torch.core.latency import timed_wire
    from repro_torch.snn import chip as chiplib
    from repro_torch.snn import network as netlib
    from repro_torch.snn import neuron as nrn

    fan_ins = tuple(config["fan_ins"])
    caps = scenarios.level_caps(fan_ins, config["cap_in"],
                                config["occupancy"])
    if list(caps) != list(config["link_capacities"]):
        raise ValueError(f"link capacities: the port derives {caps}, the "
                         f"configuration states {config['link_capacities']}")
    plan = fablib.with_exchange_mode(
        scenarios.plan_for(fan_ins, config["capacity"], caps), exchange_mode)
    chip = chiplib.ChipConfig(n_neurons=config["chip"]["neurons"],
                              n_rows=config["chip"]["synapse_rows"],
                              neuron=nrn.NeuronParams(**config["neuron"]))
    if chiplib.WEIGHT_BITS != config["chip"]["weight_bits"]:
        raise ValueError(f"weight bits: port {chiplib.WEIGHT_BITS}, "
                         f"configuration {config['chip']['weight_bits']}")
    cfg = netlib.NetworkConfig(n_chips=config["chips"],
                               capacity=config["capacity"], chip=chip)
    if cfg.delay_steps != config["delay_steps"]:
        raise ValueError(f"delay steps: port {cfg.delay_steps}, "
                         f"configuration {config['delay_steps']}")
    wire = dict(config["timed_wire"])
    if timed_wire(cfg.latency)._asdict() != wire:
        raise ValueError(f"timed wire: port {timed_wire(cfg.latency)}, "
                         f"configuration {wire}")
    params = netlib.init_feedforward(cfg, device=device)
    params = params._replace(
        chips=chiplib.ChipParams(weights=weights, row_sign=row_sign,
                                 w_scale=w_scale),
        router=aggregator.identity_router(config["chips"], device=device))
    return cfg, params, plan


def stdp_config(traffic: dict):
    from repro_torch.snn import plasticity as plas

    return plas.STDPConfig(**traffic["plasticity"])
