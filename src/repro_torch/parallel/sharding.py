"""Fabric meshes: nested axes, one per hop-graph level.

Port of the fabric part of ``src/repro/parallel/sharding.py``.  The
exchange fabric (``repro_torch.core.fabric``) maps every topology level to
one mesh dimension, level 1 (the backplane star) innermost and the top
level outermost, so a leaf's index is its rank in the mesh.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group; each dimension's process group carries that level's exchange.

The LM shardings of the reference module (``param_shardings`` and the
rest) are not ported yet (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import math

import numpy as np
import torch.distributed as dist


def fabric_axis_names(plan) -> tuple[str, ...]:
    """Mesh axis names for a fabric plan, leaf level first: fab0, fab1, ..."""
    return tuple(f"fab{i}" for i in range(plan.n_levels))


def fabric_mesh(plan, device_type: str = "cuda"):
    """Nested device mesh for a ``fabric.FabricPlan``: one dimension per
    level, top level outermost, over the default process group (which must
    hold ``plan.n_nodes`` ranks).  ``device_type`` is the mesh's device
    type, the card unless the caller asks for ``"cpu"``; the backend of the
    default group decides how the levels' collectives move their bytes."""
    from torch.distributed.device_mesh import init_device_mesh

    names = fabric_axis_names(plan)
    shape = tuple(lvl.fan_in for lvl in reversed(plan.levels))
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(reversed(names)))


def fabric_leaf_index(mesh, fan_ins, axis_names=None) -> int:
    """This rank's global leaf index, from its mesh coordinates.

    Leaf-major layout: axis 0 (the backplane star) is the fastest, so
    ``leaf = sum_i coord(axis_i) * prod(fan_in[:i])``; ``axis_names`` lists
    the axes leaf level first (default: the mesh's dimensions reversed).
    Raises ``ValueError`` unless the leaf equals the rank's position in the
    mesh, i.e. unless the mesh puts level 0 innermost as ``fabric_mesh``
    does: each rank passes its own leaf's frame, so the two must agree.
    """
    axes = (tuple(axis_names) if axis_names is not None
            else tuple(reversed(mesh.mesh_dim_names)))
    if len(axes) != len(fan_ins):
        raise ValueError(f"{len(axes)} mesh axes for {len(fan_ins)} fabric "
                         "levels")
    leaf, stride = 0, 1
    for name, f in zip(axes, fan_ins):
        leaf += mesh.get_local_rank(name) * stride
        stride *= int(f)
    where = mesh.mesh.flatten().tolist().index(dist.get_rank())
    if leaf != where or stride != mesh.mesh.numel():
        raise ValueError(
            f"leaf index {leaf} of a {math.prod(fan_ins)}-leaf fabric is not "
            f"this rank's position {where} in the {mesh.mesh.numel()}-rank "
            "mesh: the mesh must put level 0 innermost (fabric_mesh)")
    return leaf


def edge_neighbor_permutes(enables, *, prune: bool
                           ) -> tuple[tuple[tuple[int, int], ...], ...]:
    """Edge-neighbor index maps of one fabric level: the point-to-point
    schedule that replaces that level's all-gather in routed mode.

    Returns one ``((src, dst), ...)`` pair tuple per ring rotation
    ``r = 1..fan_in-1``: rotation ``r`` ships child slot ``j``'s stream to
    slot ``(j + r) % fan_in``; the own slot (``r = 0``) never travels.
    With ``prune`` (the top level, whose plane feeds no further uplink
    cascade) pairs the static route-enable matrix disables are dropped, so
    a disabled edge costs no wire at all; its plane row stays zero, which
    decodes as invalid.  Non-top levels keep full rotations: the ungated
    cascade aggregates whole entity streams.
    """
    en = np.asarray(enables, dtype=bool)
    f = en.shape[0]
    if en.shape != (f, f):
        raise ValueError(f"enables must be square, got {en.shape}")
    perms = []
    for r in range(1, f):
        pairs = tuple((j, (j + r) % f) for j in range(f)
                      if not prune or en[j, (j + r) % f])
        perms.append(pairs)
    return tuple(perms)
