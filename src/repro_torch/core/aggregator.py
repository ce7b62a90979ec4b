"""The Aggregator's routing state (paper §III).

Port of ``RouterState`` and ``identity_router`` from
``src/repro/core/aggregator.py``: the stacked per-node LUTs the hop-graph executor
(``repro_torch.core.fabric``) reads.  The legacy wrappers and the sharded
star exchange are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import routing


class RouterState(NamedTuple):
    """Static routing state (stacked per-node tables)."""

    fwd_tables: torch.Tensor      # int32[n_nodes, 2^16]
    rev_tables: torch.Tensor      # int32[n_nodes, 2^15]
    route_enables: torch.Tensor   # bool[n_nodes, n_nodes]


def identity_router(n_nodes: int, route_enables: torch.Tensor | None = None,
                    n_labels: int | None = None, *, device="cpu"
                    ) -> RouterState:
    fwd, rev = routing.identity_tables(n_labels, device=device)
    if route_enables is None:
        route_enables = routing.full_route_enables(n_nodes, device=device)
    return RouterState(
        fwd_tables=fwd.expand(n_nodes, -1).contiguous(),
        rev_tables=rev.expand(n_nodes, -1).contiguous(),
        route_enables=route_enables.to(device))
