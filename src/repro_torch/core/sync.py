"""Decentralized barrier synchronization (paper §II/§III).

Port of ``src/repro/core/sync.py``.  Every participating Node-FPGA sends a
readiness command to the Aggregator over its MGT link; once requests from
*all* participants have arrived, the Aggregator toggles an external
system-start signal, releasing all playback executions within one 8 ns
system-clock cycle.  The logic has configurable timeout and refractory
periods as fault-recovery mechanisms, and is fully symmetric.

An all-reduce over a mesh axis *is* this barrier: it is decentralized,
symmetric and releases all participants together (``barrier``, on
``torch.distributed``).  The timeout/refractory recovery semantics live at
two levels:

  * functionally: ``barrier_release_time`` / ``refractory_mask`` model the
    logic on tensors (used by tests and the latency model);
  * host-level: ``runtime.watchdog`` applies the same timeout → recover →
    refractory cycle to stream windows (checkpoint/restart), and
    ``runtime.watchdog.WatchdogConfig.from_sync`` converts a barrier
    configuration into the watchdog's seconds at the 8 ns system clock.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import transport_device

SYSTEM_CLOCK_NS = 8.0

_INT32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """Aggregator barrier configuration (§III)."""

    n_participants: int = 12
    timeout_cycles: int = 125_000_000      # 1 s at 125 MHz
    refractory_cycles: int = 12_500        # 100 µs lockout after a release


def barrier(ready, axis_name: str, mesh) -> torch.Tensor:
    """Decentralized barrier across the ranks of ``mesh``'s dimension
    ``axis_name``.

    Every rank contributes its readiness; the result is True on *all*
    ranks iff all were ready: one all-reduce counts the ready ranks (the
    Aggregator's role), a second the participants, and the comparison
    broadcast plays the external start signal.  Returns a bool tensor on
    ``ready``'s device.
    """
    ready = torch.as_tensor(ready)
    group = mesh.get_group(axis_name)
    wire = transport_device(group, ready.device)
    n_ready = ready.to(device=wire, dtype=torch.int32, copy=True)
    n_all = torch.ones_like(n_ready)
    dist.all_reduce(n_ready, group=group)
    dist.all_reduce(n_all, group=group)
    return (n_ready == n_all).to(ready.device)


def barrier_release_time(ready_times, cfg: SyncConfig
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Functional model of the Aggregator's synchronization logic.

    Args:
      ready_times: int32[n] cycle at which each node's readiness command
        arrives; a negative value means the node never reports (fault).
      cfg: timeout / refractory configuration.

    Returns:
      (release_cycle, timed_out), 0-d int32 and bool tensors on the input's
      device: the cycle at which the start signal toggles and whether the
      timeout recovery fired.  On timeout the signal is released at
      ``timeout_cycles`` so healthy nodes can proceed / recover.
    """
    ready_times = torch.as_tensor(ready_times).to(torch.int32)
    missing = ready_times < 0
    latest = torch.where(missing, _INT32_MAX, ready_times).max()
    timed_out = missing.any() | (latest > cfg.timeout_cycles)
    release = torch.where(timed_out,
                          torch.tensor(cfg.timeout_cycles, dtype=torch.int32,
                                       device=ready_times.device), latest)
    return release, timed_out


def refractory_mask(request_times, release_cycle, cfg: SyncConfig
                    ) -> torch.Tensor:
    """Requests arriving within the refractory window after a release are
    ignored (True = accepted)."""
    request_times = torch.as_tensor(request_times).to(torch.int32)
    release = torch.as_tensor(release_cycle, device=request_times.device)
    return request_times >= release + cfg.refractory_cycles


def start_alignment_ns() -> float:
    """Real-time-section start alignment guarantee: one system clock (§III)."""
    return SYSTEM_CLOCK_NS
