"""The collective record and cost count of a traced step (the port's
counterpart of ``src/repro/analysis/hlo.py``).

The JAX package reads a compiled program's collectives from its optimized
HLO text.  The port compiles nothing: a step runs eagerly on DTensors, and
``StepTrace`` (a dispatch mode) watches the ops each rank runs on its
*local* shards.  From them it records:

* each collective DTensor issues (``_c10d_functional`` ops), with its kind,
  dtype and output shape (``Collective``), under the reference's five kind
  names (``COLLECTIVE_OPS``); output bytes are the wire proxy, as the
  reference counts them;
* flops of the local ops, by ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode`` on DTensors counts the global op, not the
  device's);
* bytes accessed: each local op's inputs plus outputs, which in eager mode
  is the traffic (view ops, which move nothing, and allocations left out);
* the peak of the live op outputs' bytes.

The metadata passes of DTensor's sharding propagation (global shapes under
a ``FakeTensorMode``) are not the device's work and are skipped.  The
tensors may be real or on the ``meta`` device: the count needs shapes
only, so a step of a 314 B-parameter model traces without memory.
"""

from __future__ import annotations

import math
import weakref
from collections import defaultdict
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# c10d functional op → the reference's kind name.
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}

# Ops that move no bytes: allocations and metadata queries.
_NO_TRAFFIC = ("aten.empty", "aten.empty_strided", "aten.empty_like",
               "aten.detach", "aten.lift_fresh", "aten.sym_size",
               "aten.sym_stride", "aten.sym_numel", "aten.is_contiguous",
               "prim.")


class Collective(NamedTuple):
    """One collective: its kind (a ``COLLECTIVE_OPS`` name) and the dtype
    and shape of each of its outputs."""

    kind: str
    outputs: tuple          # ((torch.dtype, shape tuple), ...)

    @property
    def nbytes(self) -> int:
        return sum(math.prod(shape) * dtype.itemsize
                   for dtype, shape in self.outputs)

    def describe(self) -> str:
        shapes = ", ".join(f"{_dtype_name(dt)}[{','.join(map(str, s))}]"
                           for dt, s in self.outputs)
        return f"{self.kind}: {shapes}"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def collective_bytes(records) -> dict[str, int]:
    """Total output bytes per collective kind (proxy for wire traffic),
    and ``"_counts"``: the number of each kind."""
    out: dict[str, int] = defaultdict(int)
    counts: dict[str, int] = defaultdict(int)
    for r in records:
        out[r.kind] += r.nbytes
        counts[r.kind] += 1
    out_d = dict(out)
    out_d["_counts"] = dict(counts)
    return out_d


def total_collective_bytes(records) -> int:
    per = collective_bytes(records)
    return sum(v for k, v in per.items() if not k.startswith("_"))


def collective_schedule(records, limit: int = 20) -> list[str]:
    """Ordered list of collectives (kind and output shapes) as issued."""
    return [r.describe() for r in list(records)[:limit]]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTrace(TorchDispatchMode):
    """Counts what the ops run inside it cost on this rank's local tensors
    (module docstring): ``flops``, ``bytes``, ``collectives`` (a list of
    ``Collective``), ``peak_live_bytes`` and ``n_ops``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.collectives: list[Collective] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0

    def _freed(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor handles it and runs the local ops, which come back
            # through this mode.
            return NotImplemented
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                  # sharding propagation's metadata run
        name = str(func)
        if name.startswith("_c10d_functional."):
            op = name.split(".")[1]
            if op in _KINDS:
                self.collectives.append(Collective(_KINDS[op], tuple(
                    (t.dtype, tuple(t.shape)) for t in _tensors(out))))
            return out
        if func.is_view or name.startswith(_NO_TRAFFIC):
            return out
        self.n_ops += 1
        if func._overloadpacket in self._flops:
            self.flops += self._flops[func._overloadpacket](
                *args, **kwargs, out_val=out)
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            if any(t is i for i in ins):
                continue                # written in place: already live
            n = _nbytes(t)
            self.live_bytes += n
            weakref.finalize(t, self._freed, n)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        return out
