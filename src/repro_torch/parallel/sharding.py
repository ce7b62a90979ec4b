"""Device meshes and shardings on ``torch.distributed``: the fabric's nested
meshes and the LM harness's logical-axis rules (port of
``src/repro/parallel/sharding.py``).

**Fabric meshes.**  The exchange fabric (``repro_torch.core.fabric``) maps
every topology level to one mesh dimension, level 1 (the backplane star)
innermost and the top level outermost, so a leaf's index is its rank in
the mesh.  The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the default process group; each dimension's process group carries that
level's exchange.

**LM shardings (2D FSDP × TP, pod-hierarchical).**  Mesh axes
(``launch.mesh``): ``(pod, data, model)`` in production, ``(data, model)``
single-pod.  Mapping policy:

  * ``model``  — tensor/expert parallelism: attention heads, FFN hidden,
    expert dim, vocab.  This is the *backplane* of the paper's star: dense
    collectives (all-to-all for MoE dispatch, all-reduce for TP partials)
    stay inside the fastest mesh axis, exactly like intra-backplane spikes.
  * ``(pod, data)`` — FSDP: parameters/optimizer state sharded over the data
    axes, all-gathered per layer.  Gradient reduce-scatter crosses pods only
    once per step — the second-layer hop.

Conflict/divisibility handling: axes are resolved left-to-right; a logical
axis maps to its mesh axes only if the dim is divisible by their product and
none of them is already taken by an earlier dim — otherwise that dim stays
replicated.  This lets one rule set serve all ten architectures (e.g.
grok-1's 8 experts cannot take the 16-way ``model`` axis, so its expert FFN
dim takes it instead; whisper's odd 51865-vocab head stays replicated).

GSPMD's pieces map onto DTensor (``torch.distributed.tensor``): a
``PartitionSpec`` (the reference's per-dimension mesh axes, kept as such)
becomes ``Shard``/``Replicate`` placements over the ``DeviceMesh``
(``to_placements``; a combined entry such as ``("pod", "data")`` shards
its dimension on both mesh dimensions, outer first, as GSPMD does),
``jax.device_put(x, sharding)`` becomes ``distribute_tensor``
(``shard_params``, ``distribute``) and ``with_sharding_constraint``
becomes ``redistribute`` (``constrain``).  Where GSPMD would replicate an
operand of an op it cannot partition, the port redistributes to
``Replicate()`` at that site itself (``on_replicas``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig


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


# ---------------------------------------------------------------------------
# LM shardings: logical axes → mesh axes
# ---------------------------------------------------------------------------

# logical axis → mesh axes (tuple = combined axes)
RULES: dict[Any, Any] = {
    "vocab": ("model",),
    "heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "embed": ("pod", "data"),
    "layers": (),
    None: (),
}


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor, as JAX's: None (replicated), a
    mesh axis name, or a tuple of names (the dimension split over all of
    them, outer first).  Trailing dimensions left out are replicated.  A
    tuple of one name is that name and an empty tuple None, as in JAX."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                return (tuple(e) if len(e) > 1 else e[0]) if e else None
            return e

        return super().__new__(cls, tuple(map(canon, entries)))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class MeshShape(NamedTuple):
    """A stand-in for a mesh where only its axis names and sizes count
    (``resolve_spec`` and the ``*_shardings`` functions read nothing
    else): specs for a production mesh without its ranks."""

    mesh_dim_names: tuple
    shape: tuple


class NamedSharding(NamedTuple):
    """A mesh and a ``PartitionSpec`` on it; ``placements`` are DTensor's."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def check_mesh(mesh) -> None:
    """Raise ``ValueError`` unless ``mesh`` spans the default process
    group's ranks (one rank without a group)."""
    n = math.prod(tuple(mesh.shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"the mesh {dict(_mesh_sizes(mesh))} has {n} "
                         f"devices, but the default process group has "
                         f"{world} rank{'s' if world != 1 else ''}: one "
                         "rank a device")


def to_placements(spec, mesh) -> tuple:
    """DTensor placements (one a mesh dimension) of a ``PartitionSpec``.

    Raises ``ValueError`` if a mesh axis is unknown or used twice, or if a
    combined entry lists its axes out of mesh order: DTensor splits a
    dimension over several mesh dimensions outer first, so ``("data",
    "pod")`` has no placement."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"{spec}: mesh axes {unknown} not in {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the combined axes {axes} of dimension "
                             f"{dim} are not in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]} used twice")
            # A split over one device is no split: Replicate keeps DTensor
            # from refusing views that merge "sharded" dimensions.
            out[i] = Shard(dim) if sizes[i] > 1 else Replicate()
    return tuple(out)


def resolve_spec(axes: tuple, shape: tuple, mesh,
                 rules: dict | None = None) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec with conflict/divisibility
    fallback."""
    rules = rules or RULES
    sizes = _mesh_sizes(mesh)
    used: set[str] = set()
    out = []
    for axis, dim in zip(axes, shape):
        mesh_axes = tuple(a for a in rules.get(axis, ()) if a in sizes)
        if mesh_axes and not (set(mesh_axes) & used):
            total = math.prod(sizes[a] for a in mesh_axes)
            if dim % total == 0:
                used.update(mesh_axes)
                out.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
                continue
        out.append(None)
    return P(*out)


def param_shardings(params, mesh, rules: dict | None = None) -> dict:
    """``{parameter name: NamedSharding}`` for a ``Params`` module, from
    each parameter's logical axes."""
    from repro_torch.models.layers import param_axes

    axes = param_axes(params)
    return {name: NamedSharding(mesh, resolve_spec(axes[name], tuple(p.shape),
                                                   mesh, rules))
            for name, p in params.named_parameters()}


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def batch_shardings(cfg: ModelConfig, mesh):
    """Sharding for a training/prefill batch dict (by key)."""
    da = _data_axes(mesh)

    def spec(key):
        if key == "embeds":
            return NamedSharding(mesh, P(da, None, None))
        return NamedSharding(mesh, P(da, None))

    return spec


def cache_shardings(cfg: ModelConfig, mesh, caches):
    """Decode-cache shardings, in the structure of ``caches``.

    Attention KV caches shard over batch (data axes) and — since small
    kv-head counts often cannot take the 16-way model axis — over the
    *sequence* dim on ``model`` (flash-decoding-style split-K).  When the
    batch itself doesn't divide the data axes (long_500k: batch 1), the
    sequence dim takes the *whole* mesh instead.  SSM states shard heads on
    ``model``.
    """
    da = _data_axes(mesh)
    sizes = _mesh_sizes(mesh)
    model = sizes.get("model", 1)
    da_size = math.prod(sizes[a] for a in da) if da else 1
    full_mesh = (*da, "model")

    def leaf_spec(x):
        shape = tuple(x.shape)
        b_ok = len(shape) >= 2 and shape[1] % da_size == 0
        b_spec = da if b_ok else None
        if len(shape) == 5:          # KV cache / SSM state [L, B, H|S, ...]
            if not b_ok and shape[3] % (da_size * model) == 0:
                return P(None, None, None, full_mesh, None)
            if shape[2] % model == 0:
                return P(None, b_spec, "model", None, None)
            if shape[3] % model == 0:
                return P(None, b_spec, None, "model", None)
            return P(None, b_spec, None, None, None)
        if len(shape) == 4:
            # MLA latent [L, B, S, lora] or conv state [L, B, K, C]
            if not b_ok and shape[2] % (da_size * model) == 0:
                return P(None, None, full_mesh, None)
            if shape[2] % model == 0:
                return P(None, b_spec, "model", None)
            return P(None, b_spec, None, None)
        if len(shape) == 3:
            return P(None, b_spec, None)
        return P(*([None] * len(shape)))

    return map_tree(lambda x: NamedSharding(mesh, leaf_spec(x)), caches)


def map_tree(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists, tuples and
    NamedTuples, in its structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return tree


def data_sharding_if_divisible(mesh, shape: tuple) -> NamedSharding:
    """Batch-dim sharding over the data axes, or replicated if indivisible."""
    da = _data_axes(mesh)
    sizes = _mesh_sizes(mesh)
    da_size = math.prod(sizes[a] for a in da) if da else 1
    lead = da if shape and shape[0] % da_size == 0 else None
    return NamedSharding(mesh, P(lead, *([None] * (len(shape) - 1))))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t``, which every rank holds whole (drawn from one seed, read from
    one checkpoint, built by the data pipeline), as a DTensor laid out by
    ``sharding`` (``jax.device_put``): each rank keeps its own piece and
    nothing moves."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def shard_params(params, mesh, rules: dict | None = None):
    """Lay every parameter of a ``Params`` module, which every rank holds
    whole, out by ``param_shardings``, in place: each becomes a parameter
    holding a DTensor (its ``requires_grad`` kept).  Returns ``params``."""
    from torch import nn

    shardings = param_shardings(params, mesh, rules)
    for name, sharding in shardings.items():
        *path, leaf = name.split(".")
        mod = params.get_submodule(".".join(path))
        old = mod._parameters[leaf]
        mod._parameters[leaf] = nn.Parameter(
            distribute(old.detach(), sharding),
            requires_grad=old.requires_grad)
    return params


def splittable(x, dim: int, parts: int):
    """``x``, ready to have dimension ``dim`` split into ``parts`` and the
    rest (``reshape(..., parts, -1, ...)``).  DTensor cannot view a
    dimension sharded over mesh dimensions whose sizes do not divide
    ``parts`` (smollm-135m's 9 heads of a 576-wide projection on a 16-way
    ``model`` axis) and raises; GSPMD replicates there, so those mesh
    dimensions are redistributed to ``Replicate()`` first.  A plain tensor
    comes back as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    shards = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    if parts % math.prod(x.device_mesh.size(i) for i in shards) == 0:
        return x
    return replicate_dim(x, dim)


def replicate_dim(x, dim: int):
    """A DTensor with dimension ``dim`` whole on every rank: the mesh
    dimensions that shard it redistributed to ``Replicate()``, the others
    kept.  A plain tensor comes back as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    placements = [Replicate() if p.is_shard(dim) else p
                  for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def shard_offset(x, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` of a
    DTensor split evenly there (0 where ``dim`` is whole)."""
    mesh = x.device_mesh
    dim = dim % x.ndim
    idx, n = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n //= mesh.size(i)
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx * n


def heads_layout(x) -> list:
    """``x``'s placements on its batch and head dimensions (0 and 1), every
    other dimension whole."""
    from torch.distributed.tensor import Replicate

    return [p if p.is_shard() and p.dim in (0, 1) else Replicate()
            for p in x.placements]


def on_heads(fn, *xs, per_head=()):
    """``fn(*xs, *per_head)`` for work that is independent for each batch
    row and head (attention, the linear scan): ``xs`` are [B, H, ...] and
    ``per_head`` [H, ...] tensors.  On DTensors each ``x`` is laid out as
    the first one's batch and head shards with every other dimension whole,
    each ``per_head`` tensor on the same heads, ``fn`` runs on every rank's
    local pieces, and its tensor results keep the first one's layout.
    (DTensor's own einsums flatten [B, H], which torch 2.11 refuses where
    both are sharded.)  Plain tensors: ``fn`` as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lead = next((x for x in xs if isinstance(x, DTensor)), None)
    if lead is None:
        return fn(*xs, *per_head)
    mesh, layout = lead.device_mesh, heads_layout(lead)
    head = [Shard(0) if p.is_shard(1) else Replicate() for p in layout]
    # A per-head tensor's gradient on each rank sums its own batch rows
    # only: a partial sum over the mesh dimensions that split the batch.
    head_grad = [Partial() if p.is_shard(0) else h
                 for p, h in zip(layout, head)]
    local = [x.redistribute(mesh, layout).to_local() for x in xs]
    local += [h.redistribute(mesh, head).to_local(grad_placements=head_grad)
              for h in per_head]
    return map_tree(lambda t: DTensor.from_local(t, mesh, layout,
                                                 run_check=False),
                    fn(*local))


def write_at(dst, src, dim: int, index: int) -> None:
    """``dst``'s entries ``index:index + n`` along ``dim`` set to ``src``
    (n entries along ``dim``) in place, cast to ``dst``'s dtype: a decode
    step's new K/V into its cache.  On a DTensor ``src`` is laid out as
    ``dst`` but whole along ``dim``, and each rank writes the entries that
    fall in its own piece of ``dim`` (DTensor's slice assignment into a
    dimension split across ranks would write at the global positions of
    each local piece)."""
    from torch.distributed.tensor import DTensor, Replicate

    src = src.to(dst.dtype)
    if not isinstance(dst, DTensor):
        dst.narrow(dim, index, src.shape[dim]).copy_(src)
        return
    src = src.redistribute(dst.device_mesh, [
        Replicate() if p.is_shard(dim) else p for p in dst.placements])
    local, lo = dst.to_local(), shard_offset(dst, dim)
    a = max(index, lo)
    b = min(index + src.shape[dim], lo + local.shape[dim])
    if a < b:
        local.narrow(dim, a - lo, b - a).copy_(
            src.to_local().narrow(dim, a - index, b - a))


def full(t):
    """The whole tensor of a DTensor on every rank (a collective: every
    rank calls it); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# Activation sharding constraints
# ---------------------------------------------------------------------------
#
# Propagation alone picks bad layouts when a dim doesn't divide the mesh
# (e.g. smollm's 9 heads on a 16-way model axis replicated whole attention
# score tensors).  Models call ``constrain(x, pattern)`` at layer boundaries;
# inside an ``activation_shardings(mesh)`` scope this redistributes a DTensor
# to divisibility-checked placements; outside it, and on plain tensors, it
# is a no-op (single-device paths never see a mesh).

_ACT_CTX: list = []


class activation_shardings:
    """Context manager enabling activation constraints.  Inside it, a plain
    tensor that meets a DTensor counts as replicated: the plain tensors of
    the model code (positions, masks) are the same on every rank."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        from torch.distributed.tensor.experimental import implicit_replication

        self._stack.enter_context(implicit_replication())
        _ACT_CTX.append(self.mesh)
        return self

    def __exit__(self, *exc):
        _ACT_CTX.pop()
        self._stack.close()
        return False


def _axis_ok(dim: int, mesh, axes) -> bool:
    sizes = _mesh_sizes(mesh)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if not all(a in sizes for a in axes):
        return False
    return dim % math.prod(sizes[a] for a in axes) == 0


def data_shard_count() -> int:
    """Number of data-axis shards in the active activation-sharding scope
    (1 outside a scope — single-device tests and CPU smoke paths)."""
    if not _ACT_CTX:
        return 1
    mesh = _ACT_CTX[-1]
    sizes = _mesh_sizes(mesh)
    return math.prod(sizes[a] for a in _data_axes(mesh))


def constrain_spec(shape: tuple, pattern: str, mesh) -> PartitionSpec:
    """The ``PartitionSpec`` that ``constrain`` gives a tensor of
    ``shape``."""
    da = _data_axes(mesh)
    ndim = len(shape)
    spec: list = [None] * ndim
    pat = pattern.replace(" ", "")
    assert len(pat) == ndim, (pattern, shape)
    used_model = False
    for i, ch in enumerate(pat):
        if ch == "b" and _axis_ok(shape[i], mesh, da):
            spec[i] = da
        elif ch in ("h", "v", "e") and not used_model \
                and _axis_ok(shape[i], mesh, "model"):
            spec[i] = "model"
            used_model = True
        elif ch == "c" and _axis_ok(shape[i], mesh, da) and "b" not in pat:
            spec[i] = da
    if "h" in pat and not used_model:
        # fallback: split the sequence dim (first 's') on the model axis
        for i, ch in enumerate(pat):
            if ch == "s" and shape[i] > 1 \
                    and _axis_ok(shape[i], mesh, "model"):
                spec[i] = "model"
                used_model = True
                break
    return P(*spec)


def constrain(x, pattern: str):
    """Constrain activation sharding by per-dim letter pattern.

    Letters:  b=batch (data axes) · s=sequence (model, fallback only)
              h=heads (model) · d/k/f=feature (unsharded) · v=vocab (model)
              e=experts (model) · c=capacity (data axes) · .=unsharded

    'h' falls back to sharding the *sequence* dim on the model axis when the
    head count doesn't divide it (flash-decoding-style split), keeping score
    tensors partitioned for archs like smollm (9 heads) and phi3 (10 kv).
    Inside a scope a DTensor is redistributed to the pattern's placements;
    outside one, or for a plain tensor, ``x`` comes back as it is.
    """
    from torch.distributed.tensor import DTensor

    if not _ACT_CTX or not isinstance(x, DTensor):
        return x
    mesh = _ACT_CTX[-1]
    spec = constrain_spec(tuple(x.shape), pattern, mesh)
    return x.redistribute(mesh, to_placements(spec, mesh))


def on_replicas(fn, *args):
    """``fn(*args)`` for an op DTensor cannot partition (it has no sharding
    strategy, such as ``searchsorted``): every DTensor argument is
    redistributed to ``Replicate()`` (an all-gather, what GSPMD does for
    such an op), ``fn`` runs on the whole local copies, and its tensor
    results come back as replicated DTensors.  Gradients flow through.
    Without a DTensor argument this is ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate

    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    out = fn(*(a.redistribute(mesh, rep).to_local()
               if isinstance(a, DTensor) else a for a in args))
    return map_tree(lambda t: DTensor.from_local(t, mesh, rep,
                                                  run_check=False), out)
