"""The port's barrier model (``repro_torch.core.sync``) against the JAX
package's, exactly: the same release cycle, timeout flag and refractory
acceptance on the same numpy inputs, and the same constants."""

import numpy as np
import pytest
import torch

from repro.core import sync as jsync
from repro_torch import core as tcore
from repro_torch.core import sync as tsync
from torch_threads import share_cores

share_cores()

CONFIGS = [(jsync.SyncConfig(), tsync.SyncConfig()),
           (jsync.SyncConfig(n_participants=4, timeout_cycles=1000,
                             refractory_cycles=50),
            tsync.SyncConfig(n_participants=4, timeout_cycles=1000,
                             refractory_cycles=50))]


def ready_cases(rng, n):
    """All ready early, one late past the timeout, one missing, all missing,
    and random arrivals around the short timeout."""
    yield np.arange(n, dtype=np.int32) * 7
    late = np.arange(n, dtype=np.int32)
    late[-1] = 200_000_000
    yield late
    missing = np.arange(n, dtype=np.int32)
    missing[n // 2] = -1
    yield missing
    yield np.full(n, -1, np.int32)
    yield rng.integers(0, 1200, n).astype(np.int32)
    yield np.array([1000] * n, np.int32)             # exactly at the timeout


@pytest.mark.parametrize("config", range(len(CONFIGS)))
def test_barrier_release_time_matches(config):
    jcfg, tcfg = CONFIGS[config]
    rng = np.random.default_rng(config)
    for n in (1, 4, 12):
        for ready in ready_cases(rng, n):
            ref_rel, ref_to = jsync.barrier_release_time(ready, jcfg)
            rel, to = tsync.barrier_release_time(torch.from_numpy(ready),
                                                 tcfg)
            assert rel.dtype == torch.int32 and to.dtype == torch.bool
            assert int(rel) == int(ref_rel), (ready, int(rel))
            assert bool(to) == bool(ref_to), ready


@pytest.mark.parametrize("config", range(len(CONFIGS)))
def test_refractory_mask_matches(config):
    jcfg, tcfg = CONFIGS[config]
    rng = np.random.default_rng(10 + config)
    requests = rng.integers(0, 200_000, 64).astype(np.int32)
    for release in (0, 37, 1000, 150_000):
        ref = np.asarray(jsync.refractory_mask(
            requests, np.int32(release), jcfg))
        got = tsync.refractory_mask(torch.from_numpy(requests),
                                    torch.tensor(release, dtype=torch.int32),
                                    tcfg)
        np.testing.assert_array_equal(got.numpy(), ref)
    # Numpy inputs and a released cycle from the barrier model compose.
    rel, _ = tsync.barrier_release_time(np.array([3, 9, 5], np.int32), tcfg)
    got = tsync.refractory_mask(np.array([9, 9 + tcfg.refractory_cycles]),
                                rel, tcfg)
    assert got.tolist() == [False, True]


def test_constants_and_config_match():
    assert tsync.SYSTEM_CLOCK_NS == jsync.SYSTEM_CLOCK_NS == 8.0
    assert tsync.start_alignment_ns() == jsync.start_alignment_ns()
    assert vars(tsync.SyncConfig()) == vars(jsync.SyncConfig())


def test_barrier_is_the_sharded_executors():
    """The barrier is a collective of the sharded executor: two
    all-reduces over a mesh axis (here a one-rank group; 8 ranks in
    ``test_torch_sharded_star.py``)."""
    from torch.distributed.device_mesh import init_device_mesh

    import sharded_cases

    with sharded_cases.single_rank_group():
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("chip",))
        for ready in (True, False):
            got = tsync.barrier(torch.tensor(ready), "chip", mesh)
            assert got.dtype == torch.bool and bool(got) is ready


def test_core_exports_the_reference_sync_names():
    for name in ("SyncConfig", "barrier", "barrier_release_time",
                 "refractory_mask"):
        assert getattr(tcore, name) is getattr(tsync, name)
