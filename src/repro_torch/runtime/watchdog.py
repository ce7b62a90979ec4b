"""Step watchdog: the Aggregator's timeout + refractory recovery, host-side.

Port of ``src/repro/runtime/watchdog.py`` (the port keeps its own copy:
it imports nothing of the JAX package).  The barrier logic in hardware
(``core.sync``) releases on timeout so healthy nodes recover, then ignores
requests for a refractory period.  Stream windows get the same treatment:
a deadline derived from an EMA of recent window times detects hangs and
stragglers; recovery (checkpoint restore) is followed by a refractory
window during which the watchdog will not fire again (so a slow
post-restore window doesn't cascade).

The semantics are shared with ``core.sync``: timeout → release/recover →
refractory lockout is one mechanism at two levels, in-graph cycles for the
Aggregator barrier (``SyncConfig.timeout_cycles`` / ``refractory_cycles``),
host seconds here.  ``WatchdogConfig.from_sync`` converts a barrier
configuration into the equivalent host-side watchdog (cycles × the 8 ns
system clock), and ``runtime.elastic.run_supervised_stream`` wires the
fired watchdog to checkpoint-restore onto a degraded fabric plan.

The watchdog times the host's wall clock between ``__enter__`` and
``__exit__``: a caller timing work on the card synchronizes with it inside
the ``with`` block, or the EMA sees only the host's dispatch.
"""

from __future__ import annotations

import dataclasses
import threading
import time


@dataclasses.dataclass
class WatchdogConfig:
    deadline_factor: float = 5.0     # deadline = factor × EMA(step time)
    min_deadline_s: float = 10.0
    ema_alpha: float = 0.2
    refractory_s: float = 30.0       # suppress triggers after a recovery

    @classmethod
    def from_sync(cls, sync_cfg, *, clock_ns: float | None = None,
                  deadline_factor: float = 5.0,
                  ema_alpha: float = 0.2) -> "WatchdogConfig":
        """Host-side twin of an Aggregator barrier config: the barrier's
        cycle counts become wall-clock seconds at the system clock, keeping
        the two recovery layers on one timeout/refractory policy."""
        from repro_torch.core.sync import SYSTEM_CLOCK_NS

        ns = SYSTEM_CLOCK_NS if clock_ns is None else clock_ns
        return cls(deadline_factor=deadline_factor,
                   min_deadline_s=sync_cfg.timeout_cycles * ns * 1e-9,
                   ema_alpha=ema_alpha,
                   refractory_s=sync_cfg.refractory_cycles * ns * 1e-9)


class StepWatchdog:
    def __init__(self, cfg: WatchdogConfig | None = None, on_timeout=None):
        # Default constructed per instance — a shared module-level default
        # would leak config mutations across unrelated watchdogs.
        self.cfg = WatchdogConfig() if cfg is None else cfg
        self.on_timeout = on_timeout
        self.ema: float | None = None
        self._timer: threading.Timer | None = None
        self._last_recovery = 0.0
        self.timeouts = 0

    @property
    def deadline_s(self) -> float:
        if self.ema is None:
            return self.cfg.min_deadline_s
        return max(self.cfg.min_deadline_s,
                   self.cfg.deadline_factor * self.ema)

    def _fire(self):
        now = time.monotonic()
        if now - self._last_recovery < self.cfg.refractory_s:
            return                       # refractory: ignore
        self.timeouts += 1
        self._last_recovery = now
        if self.on_timeout is not None:
            self.on_timeout()

    def __enter__(self):
        self._t0 = time.monotonic()
        self._timer = threading.Timer(self.deadline_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        assert self._timer is not None
        self._timer.cancel()
        dt = time.monotonic() - self._t0
        self.observe(dt)
        return False

    def observe(self, step_time_s: float):
        """Feed an externally measured step time into the EMA."""
        self.ema = step_time_s if self.ema is None else \
            (1 - self.cfg.ema_alpha) * self.ema \
            + self.cfg.ema_alpha * step_time_s
