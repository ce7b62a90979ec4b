"""Production mesh construction (port of ``src/repro/launch/mesh.py``).

Single pod: 256 chips as (data=16, model=16).  Multi-pod: 2 pods = 512 chips
as (pod=2, data=16, model=16) — the ``pod`` axis is the paper's second-layer
interconnect (DESIGN.md §6).

A mesh is a ``DeviceMesh`` over the default process group, which must hold
as many ranks as the mesh has devices (``launch.dryrun`` runs a fake group
of 256 or 512 in one process).  The functions build it when called, so
importing this module touches no process group.  ``device_type`` is the
card's unless the caller asks for ``"cpu"`` (``repro_torch.resolve_device``,
which raises when no card is present).
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch import resolve_device


def _make_mesh(shape: tuple, axes: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a default process group "
                           f"of {math.prod(shape)} ranks: call "
                           "torch.distributed.init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the default group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int | None = None,
                    device_type: str | None = None):
    """Small mesh for tests (the default group must hold data·model·pod
    ranks)."""
    if pod:
        return _make_mesh((pod, data, model), ("pod", "data", "model"),
                          device_type)
    return _make_mesh((data, model), ("data", "model"), device_type)
