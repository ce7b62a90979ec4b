"""The port's step watchdog (``repro_torch.runtime.watchdog``) against the
reference battery (``tests/test_watchdog.py``): the deadline arithmetic,
firing and suppression, EMA seeding, the per-instance default config, and
``from_sync``, which must give the reference's config field for field.

Timing tests keep deadlines at 0.2 s or less and sleeps under 1 s; the
refractory logic is driven by a patched ``time.monotonic``, so it does not
depend on the machine's load.
"""

import dataclasses
import time

import pytest

from repro.core.sync import SyncConfig as JSyncConfig
from repro.runtime import watchdog as jwd
from repro_torch.core.sync import SYSTEM_CLOCK_NS, SyncConfig
from repro_torch.runtime import watchdog as twd
from repro_torch.runtime.watchdog import StepWatchdog, WatchdogConfig
from torch_threads import share_cores

share_cores()

# ---------------------------------------------------------------------------
# config construction
# ---------------------------------------------------------------------------


def test_default_config_is_per_instance():
    a, b = StepWatchdog(), StepWatchdog()
    assert a.cfg is not b.cfg
    a.cfg.min_deadline_s = 0.001
    assert b.cfg.min_deadline_s == WatchdogConfig().min_deadline_s


def test_explicit_config_is_used_verbatim():
    cfg = WatchdogConfig(min_deadline_s=1.25)
    wd = StepWatchdog(cfg)
    assert wd.cfg is cfg
    assert wd.deadline_s == 1.25


def test_defaults_match_reference():
    assert (dataclasses.asdict(WatchdogConfig())
            == dataclasses.asdict(jwd.WatchdogConfig()))


@pytest.mark.parametrize("kw", [{}, {"clock_ns": 4.0},
                                {"deadline_factor": 2.0, "ema_alpha": 0.5}])
@pytest.mark.parametrize("sync", [{}, {"timeout_cycles": 1000,
                                       "refractory_cycles": 7}])
def test_from_sync_matches_reference(sync, kw):
    got = WatchdogConfig.from_sync(SyncConfig(**sync), **kw)
    ref = jwd.WatchdogConfig.from_sync(JSyncConfig(**sync), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_from_sync_converts_cycles_to_seconds():
    sync = SyncConfig()
    cfg = WatchdogConfig.from_sync(sync)
    assert cfg.min_deadline_s == pytest.approx(
        sync.timeout_cycles * SYSTEM_CLOCK_NS * 1e-9)
    assert cfg.min_deadline_s == pytest.approx(1.0)
    assert cfg.refractory_s == pytest.approx(100e-6)
    fast = WatchdogConfig.from_sync(sync, clock_ns=4.0)
    assert fast.min_deadline_s == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# deadline-from-EMA arithmetic
# ---------------------------------------------------------------------------


def test_deadline_floor_before_any_observation():
    wd = StepWatchdog(WatchdogConfig(deadline_factor=3.0, min_deadline_s=2.0))
    assert wd.ema is None
    assert wd.deadline_s == 2.0


def test_deadline_tracks_ema_above_floor():
    wd = StepWatchdog(WatchdogConfig(deadline_factor=3.0, min_deadline_s=0.1,
                                     ema_alpha=0.5))
    ref = jwd.StepWatchdog(jwd.WatchdogConfig(deadline_factor=3.0,
                                              min_deadline_s=0.1,
                                              ema_alpha=0.5))
    for x in (1.0, 2.0, 0.01, 7.5):
        wd.observe(x)
        ref.observe(x)
        assert wd.ema == ref.ema and wd.deadline_s == ref.deadline_s
    wd = StepWatchdog(WatchdogConfig(deadline_factor=3.0, min_deadline_s=0.1,
                                     ema_alpha=0.5))
    wd.observe(1.0)
    assert wd.deadline_s == pytest.approx(3.0)
    wd.observe(2.0)
    assert wd.ema == pytest.approx(1.5)
    assert wd.deadline_s == pytest.approx(4.5)


def test_deadline_floor_dominates_small_ema():
    wd = StepWatchdog(WatchdogConfig(deadline_factor=2.0, min_deadline_s=5.0))
    wd.observe(0.01)
    assert wd.deadline_s == 5.0


def test_context_exit_feeds_ema():
    wd = StepWatchdog(WatchdogConfig(min_deadline_s=10.0, ema_alpha=1.0))
    with wd:
        time.sleep(0.02)
    assert wd.ema is not None and wd.ema >= 0.02
    assert wd.timeouts == 0


# ---------------------------------------------------------------------------
# firing + refractory
# ---------------------------------------------------------------------------


def test_timeout_fires_callback_and_counts():
    fired = []
    wd = StepWatchdog(WatchdogConfig(deadline_factor=1.0, min_deadline_s=0.05,
                                     ema_alpha=1.0, refractory_s=0.0),
                      on_timeout=lambda: fired.append(True))
    with wd:
        time.sleep(0.2)
    assert fired == [True]
    assert wd.timeouts == 1


def test_no_fire_within_deadline():
    wd = StepWatchdog(WatchdogConfig(deadline_factor=1.0, min_deadline_s=0.2))
    with wd:
        time.sleep(0.01)
    assert wd.timeouts == 0


class FakeClock:
    """A ``time.monotonic`` the test advances by hand."""

    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


@pytest.mark.parametrize("module", [twd, jwd], ids=["port", "reference"])
def test_refractory_logic_on_a_patched_clock(monkeypatch, module):
    """``_fire`` counts a timeout unless the last recovery lies less than
    ``refractory_s`` back; both packages agree fire for fire."""
    clock = FakeClock()
    monkeypatch.setattr(module.time, "monotonic", clock)
    fired = []
    wd = module.StepWatchdog(module.WatchdogConfig(refractory_s=30.0),
                             on_timeout=lambda: fired.append(clock.now))
    wd._fire()                          # first: 1000 s since "recovery" 0
    clock.now += 29.9
    wd._fire()                          # inside the lockout: ignored
    clock.now += 0.1
    wd._fire()                          # exactly 30 s later: fires
    clock.now += 5.0
    wd._fire()
    assert fired == [1000.0, 1030.0]
    assert wd.timeouts == 2
    # A watchdog created less than refractory_s after the clock's origin
    # starts inside the lockout (recovery time 0), as in the reference.
    clock.now = 10.0
    young = module.StepWatchdog(module.WatchdogConfig(refractory_s=30.0))
    young._fire()
    assert young.timeouts == 0


def test_refractory_suppresses_a_real_second_fire(monkeypatch):
    """End to end through the timer thread: the second overrun falls in the
    refractory window and is ignored."""
    fired = []
    wd = StepWatchdog(WatchdogConfig(deadline_factor=1.0, min_deadline_s=0.05,
                                     ema_alpha=1.0, refractory_s=10.0),
                      on_timeout=lambda: fired.append(True))
    wd._last_recovery = -1e9            # clear of the origin lockout
    with wd:
        time.sleep(0.15)
    with wd:
        time.sleep(0.2)                 # past the 0.15 s deadline
    assert len(fired) == 1 and wd.timeouts == 1


def test_fires_again_after_refractory_expires():
    wd = StepWatchdog(WatchdogConfig(deadline_factor=1.0, min_deadline_s=0.04,
                                     ema_alpha=1.0, refractory_s=0.0))
    with wd:
        time.sleep(0.1)
    with wd:                            # deadline = ema ≈ 0.1 s
        time.sleep(0.3)
    assert wd.timeouts == 2
