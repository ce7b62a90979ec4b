"""Canonical fabric scenarios, the paper's deployment shapes.

Port of ``src/repro/analysis/scenarios.py``:

  * ``FULL_BACKPLANE``    — 12 chips, one star (the deployed system, §IV);
  * ``PROJECTED_120CHIP`` — 10 backplanes x 12 chips, two-layer (§V);
  * ``EXT_4CASE_96CHIP``  — 12 chips x 2 backplanes x 4 cases chained over
    the Aggregator's 4 extension lanes (3 levels), plus its degraded
    variants (one detoured dead uplink, detours exhausted).
"""

from __future__ import annotations

import math
from typing import Iterator, NamedTuple

from repro_torch import resolve_device
from repro_torch.core import fabric as fablib
from repro_torch.core.aggregator import identity_router
from repro_torch.core.fabric import (FabricPlan, FabricSpec, LevelSpec,
                                     compile_fabric)
from repro_torch.snn import chip as chiplib
from repro_torch.snn import network as netlib

OCC_HEADLINE = 0.05                 # §IV paper-typical frame occupancy
OCC_SWEEP = (0.02, 0.10, 0.50)

# (name, per-level fan-ins leaf-first, cap_in, ingress capacity).  Chip k
# lives in backplane k//12, case k//24, ...
CASES = (
    ("FULL_BACKPLANE", (12,), 64, 256),
    ("PROJECTED_120CHIP", (12, 10), 32, 128),
    ("EXT_4CASE_96CHIP", (12, 2, 4), 24, 96),
)

# Health states of the 3-level extension fabric: (variant, dead (level,
# edge) pairs fed to ``fabric.degrade_spec``).
DEGRADED_VARIANTS = (
    ("healthy", ()),
    ("1dead_uplink", ((1, 0),)),             # backplane 0 → detour via 1
    ("exhausted", ((1, 0), (1, 1))),         # both case-0 uplinks dead
)


def level_caps(fan_ins, cap_in: int, occupancy: float):
    """Per-level compact-before-gather capacities with 2-4x headroom over
    the occupancy budget, saturating at the raw stream sizes; the 1-level
    star keeps dense lanes."""
    if len(fan_ins) == 1:
        return (None,)
    lane = min(cap_in, max(4, 4 * math.ceil(cap_in * occupancy)))
    caps = [lane]
    raw = lane
    leaves = 1
    for f in fan_ins[:-1]:
        leaves *= f
        raw = raw * f
        caps.append(min(raw, max(8, 2 * math.ceil(leaves * cap_in
                                                  * occupancy))))
        raw = caps[-1]
    return tuple(caps)


def plan_for(fan_ins, cap: int, caps) -> FabricPlan:
    """Compile the topology's plan (the top level rides the extension lanes
    on 3+-level fabrics)."""
    levels = tuple(
        LevelSpec(fan_in=f, link_capacity=c,
                  extension=(len(fan_ins) > 2 and i == len(fan_ins) - 1))
        for i, (f, c) in enumerate(zip(fan_ins, caps)))
    return compile_fabric(FabricSpec(levels=levels, capacity=cap))


def engine_network(name: str, *, occupancy: float = OCC_HEADLINE,
                   chip: chiplib.ChipConfig | None = None, seed: int = 0,
                   device=None):
    """A ready-to-emulate network on a catalogue fabric: the compiled plan,
    its ``NetworkConfig`` and feed-forward params (weights from a
    ``torch.Generator`` seeded with ``seed``) with an all-enabled identity
    router.  ``chip`` overrides the per-chip dimensions.

    Returns ``(cfg, params, plan)``.
    """
    device = resolve_device(device)
    case = next((c for c in CASES if c[0] == name), None)
    if case is None:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"have {[c[0] for c in CASES]}")
    _, fan_ins, cap_in, cap = case
    n = math.prod(fan_ins)
    plan = plan_for(fan_ins, cap, level_caps(fan_ins, cap_in, occupancy))
    cfg = netlib.NetworkConfig(n_chips=n, capacity=cap,
                               chip=chip or chiplib.ChipConfig())
    params = netlib.init_feedforward(cfg, seed=seed, device=device)
    params = params._replace(router=identity_router(n, device=device))
    return cfg, params, plan


class Scenario(NamedTuple):
    """One deployment: a compiled plan plus its egress frame width."""

    name: str          # e.g. "EXT_4CASE_96CHIP/1dead_uplink"
    plan: FabricPlan
    cap_in: int


def benchmark_plans(occupancy: float = OCC_HEADLINE) -> Iterator[Scenario]:
    """The three deployment shapes, plus the degraded health states of the
    3-level extension fabric."""
    for name, fan_ins, cap_in, cap in CASES:
        healthy = plan_for(fan_ins, cap, level_caps(fan_ins, cap_in,
                                                    occupancy))
        yield Scenario(name, healthy, cap_in)
        if len(fan_ins) != 3:
            continue
        for variant, dead in DEGRADED_VARIANTS:
            if dead:
                plan = compile_fabric(fablib.degrade_spec(healthy.spec, dead))
                yield Scenario(f"{name}/{variant}", plan, cap_in)
