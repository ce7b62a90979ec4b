"""Hierarchical, pod-aware collectives (the second-layer star, §V).

Port of ``src/repro/parallel/collectives.py`` on ``torch.distributed``.
The paper joins backplane Aggregators through a second-layer node: local
traffic pays 2 transceiver hops, cross-backplane traffic 4.  Gradient
reduction is scheduled the same way: **reduce-scatter inside the pod**
(fast, star-local), **all-reduce across pods** on the shard only (narrow,
second-layer), then **all-gather inside the pod**.  Cross-pod bytes shrink
by the intra-pod shard factor, the reason the paper aggregates per
backplane before up-linking.

The axes are dimensions of a ``DeviceMesh``; every rank of the mesh calls
with its own tensor, the PyTorch SPMD idiom.  ``transport_device`` is the
one rule for where a collective's bytes travel: on the card for NCCL, in
host memory for gloo (whose point-to-point and gather paths take host
tensors).  A tensor on another device goes there with one copy and comes
back with one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def transport_device(group, device: torch.device) -> torch.device:
    """Where ``group``'s collectives move a tensor that lives on ``device``:
    the card itself under NCCL, the host under any other backend."""
    device = torch.device(device)
    if device.type == "cuda" and "nccl" in str(dist.get_backend(group)):
        return device
    return torch.device("cpu")


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    wire = x.to(transport_device(group, x.device), copy=True)
    dist.all_reduce(wire, group=group)
    return wire.to(x.device)


def hierarchical_psum(x: torch.Tensor, data_axis: str = "data",
                      pod_axis: str | None = "pod", *, mesh) -> torch.Tensor:
    """All-reduce over ``data_axis`` x ``pod_axis`` structured as intra-pod
    reduce-scatter → inter-pod all-reduce → intra-pod all-gather (a plain
    all-reduce inside the pod when the leading dim does not divide it)."""
    data = mesh.get_group(data_axis)
    if pod_axis is None:
        return _all_reduce(x, data)
    n_local = dist.get_world_size(data)
    full_rs = x.shape[0] % n_local == 0
    if full_rs:
        # Reduce-scatter along the fast intra-pod axis.
        wire = x.to(transport_device(data, x.device), copy=True)
        chunks = list(wire.chunk(n_local, dim=0))
        scattered = torch.empty_like(chunks[0])
        dist.reduce_scatter(scattered, chunks, group=data)
    else:
        scattered = _all_reduce(x, data)
    # Narrow inter-pod exchange (the second-layer hop).
    reduced = _all_reduce(scattered, mesh.get_group(pod_axis))
    if not full_rs:
        return reduced
    wire = reduced.to(transport_device(data, x.device))
    parts = [torch.empty_like(wire) for _ in range(n_local)]
    dist.all_gather(parts, wire, group=data)
    return torch.cat(parts, dim=0).to(x.device)


def hierarchical_pmean(x: torch.Tensor, data_axis: str = "data",
                       pod_axis: str | None = "pod", *, mesh) -> torch.Tensor:
    """``hierarchical_psum`` divided by the number of ranks it sums over."""
    total = dist.get_world_size(mesh.get_group(data_axis))
    if pod_axis is not None:
        total *= dist.get_world_size(mesh.get_group(pod_axis))
    return hierarchical_psum(x, data_axis, pod_axis, mesh=mesh) / total


def cross_pod_bytes(nbytes_per_device: int, data_size: int) -> float:
    """Bytes each device sends across the pod boundary under the
    hierarchical schedule (vs. flat all-reduce sending the full buffer)."""
    return nbytes_per_device / data_size
