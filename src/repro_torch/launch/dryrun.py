"""Multi-pod dry run: trace one step of every (arch × shape × mesh) cell
(port of ``src/repro/launch/dryrun.py``).

For each cell this driver
  1. starts a fake process group of 256 (16×16) or 512 (2×16×16) ranks in
     this one process (``torch.testing``'s ``FakeStore`` and the ``"fake"``
     backend: every rank's collectives are no-ops) and builds the
     production mesh over it,
  2. lays out parameters, optimizer state, batch and caches by the
     logical-axis rules (``parallel.sharding``) as DTensors whose local
     shards live on the ``meta`` device — shapes only, nothing allocated,
     grok-1-314b's 314 B parameters included,
  3. runs the cell's step as rank 0, once to warm DTensor's caches and
     once under ``analysis.hlo.StepTrace``, which counts that device's
     flops, bytes accessed and collectives, and
  4. appends the three-term roofline record (``analysis.roofline``, H100
     constants) to a JSON results file (resumable: completed cells are
     skipped on re-run).

Where the JAX package compiles without allocating and reads
``cost_analysis()``, the port traces.  It runs its layers in a Python loop,
so the trace counts every layer: the full-depth count is the record.
``extrapolated_costs`` (the reference's two shallow probes, which it needs
because XLA counts a scanned layer once) is kept and reported beside it.
``bytes_per_device`` keeps the reference's keys: ``arguments`` (the local
shards of the step's inputs), ``outputs``, ``aliased`` (outputs written
in place into inputs: the updated parameters and moments, the decode
caches), ``temps`` (the peak of live op outputs) and ``total_live``.

The fake group owns the default process group: run the dry run in a
process of its own (``python -m repro_torch.launch.dryrun``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch smollm-135m,qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.analysis import hlo as hlolib
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.shapes import (SHAPES, SHAPE_NAMES, cell_supported,
                                       input_specs)
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shardlib
from repro_torch.runtime.trainer import make_train_step, shard_opt_state

DEFAULT_OUT = os.path.join("results", "dryrun.json")


@contextlib.contextmanager
def fake_group(world: int):
    """A fake default process group of ``world`` ranks in this process,
    this process rank 0; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run's fake group needs a process without "
                           "a default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _abstract_params(cfg: ModelConfig):
    """The parameters on the ``meta`` device: shapes only."""
    return M.init_params(None, cfg, device="meta")


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples; a module's are its
    parameters."""
    if isinstance(tree, torch.nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _nbytes(tensors) -> int:
    """Local bytes of the tensors (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor

    local = [t.to_local() if isinstance(t, DTensor) else t for t in tensors]
    return sum(t.numel() * t.element_size() for t in local)


def build_cell(cfg: ModelConfig, shape_name: str, mesh):
    """Returns ``(fn, args)``: the cell's step and its arguments, laid out
    on ``mesh`` as DTensors over ``meta`` shards; ``fn(*args)`` runs one
    step (a train step updates its parameters and moments in place).
    ``shape_name``: a ``SHAPES`` name or a shape dict of its own."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    spec = input_specs(cfg, shape)
    kind = spec["kind"]
    params = _abstract_params(cfg)

    def put(x, sharding):
        return shardlib.distribute(x, sharding)

    def put_batch(batch):
        return {k: put(v, shardlib.data_sharding_if_divisible(
            mesh, tuple(v.shape))) for k, v in batch.items()}

    if kind == "train":
        opt = shard_opt_state(adamw.init(params), params, mesh)
        shardlib.shard_params(params, mesh)
        params.requires_grad_(True)
        step = make_train_step(cfg, adamw.AdamWConfig(), mesh=mesh,
                               device="meta")
        return step, (params, opt, put_batch(spec["batch"]))

    shardlib.shard_params(params, mesh)
    if kind == "prefill":
        def prefill_step(params, batch):
            with shardlib.activation_shardings(mesh):
                logits, caches, _ = M.prefill(params, batch, cfg)
            return logits, caches

        return prefill_step, (params, put_batch(spec["batch"]))

    # decode: one new token against the caches, written in place.
    def serve_step(params, tokens, caches, index, *extra):
        enc = extra[0] if extra else None
        with shardlib.activation_shardings(mesh):
            return M.decode_step(params, tokens, caches, index, cfg,
                                 encoder_out=enc)

    def put_caches(caches):
        return shardlib.map_tree(
            lambda t: put(t, shardlib.cache_shardings(cfg, mesh, t)), caches)

    # The new token goes to the cache's last position (a full cache).
    args = [params,
            put(spec["tokens"], shardlib.data_sharding_if_divisible(
                mesh, tuple(spec["tokens"].shape))),
            put_caches(spec["caches"]), shape["seq_len"] - 1]
    if "encoder_out" in spec:
        args.append(put(spec["encoder_out"],
                        shardlib.data_sharding_if_divisible(
                            mesh, tuple(spec["encoder_out"].shape))))
    return serve_step, tuple(args)


def probe_configs(cfg: ModelConfig) -> tuple:
    """Shallow probe configs for per-layer cost extrapolation.

    XLA's cost_analysis counts while-loop (scan) bodies once, so the JAX
    package extrapolates from two unrolled shallow compiles:
    total = c1 + (U − u1)·(c2 − c1)/(u2 − u1).  The port's trace counts
    every layer; the same extrapolation is kept as a check on it.

    Returns (cfg1, u1, cfg2, u2, U_effective_units).
    """
    if cfg.attn_every:                       # zamba2: unit = group of layers
        per = cfg.attn_every
        c1 = dataclasses.replace(cfg, n_layers=2 * per, scan_layers=False)
        c2 = dataclasses.replace(cfg, n_layers=4 * per, scan_layers=False)
        return c1, 2, c2, 4, cfg.n_layers / per
    if cfg.encoder_layers:                   # whisper: unit = enc+dec pair
        c1 = dataclasses.replace(cfg, n_layers=2, encoder_layers=2,
                                 scan_layers=False)
        c2 = dataclasses.replace(cfg, n_layers=4, encoder_layers=4,
                                 scan_layers=False)
        return c1, 2, c2, 4, cfg.n_layers
    dense = cfg.first_dense_layers
    c1 = dataclasses.replace(cfg, n_layers=dense + 2, scan_layers=False)
    c2 = dataclasses.replace(cfg, n_layers=dense + 4, scan_layers=False)
    return c1, 2, c2, 4, cfg.n_layers - dense


def trace_step(fn, args) -> dict:
    """Run ``fn(*args)`` once to warm DTensor's caches, then once more under
    ``StepTrace``; the traced run's per-device costs: ``flops``, ``bytes``,
    ``coll`` (collective bytes), ``collectives``, ``bytes_per_device`` and
    ``n_ops``.  (DTensor's first call of an op plans its sharding and may
    redistribute by other local ops than its later calls; the steady state
    is what a training or serving loop runs.  On ``meta`` tensors the
    first run's in-place updates change nothing.)"""
    ins = _leaves(args)
    fn(*args)
    with hlolib.StepTrace() as trace:
        outs = _leaves(fn(*args))
    arguments, outputs = _nbytes(ins), _nbytes(outs)
    # Outputs written in place into the arguments (the updated parameters
    # and moments of a train step, a decode step's caches).
    ids = {id(t) for t in ins}
    aliased = _nbytes([t for t in outs if id(t) in ids])
    temps = trace.peak_live_bytes
    return {"flops": float(trace.flops), "bytes": float(trace.bytes),
            "coll": float(hlolib.total_collective_bytes(trace.collectives)),
            "collectives": trace.collectives, "n_ops": trace.n_ops,
            "bytes_per_device": {
                "arguments": arguments, "outputs": outputs, "temps": temps,
                "aliased": aliased,
                "total_live": arguments + outputs + temps - aliased}}


def _cell_costs(cfg: ModelConfig, shape_name: str, mesh) -> dict:
    """Trace one variant; return its per-device costs."""
    fn, args = build_cell(cfg, shape_name, mesh)
    return trace_step(fn, args)


def extrapolated_costs(cfg: ModelConfig, shape_name: str, mesh) -> dict:
    c1cfg, u1, c2cfg, u2, units = probe_configs(cfg)
    c1 = _cell_costs(c1cfg, shape_name, mesh)
    c2 = _cell_costs(c2cfg, shape_name, mesh)
    out = {}
    for k in ("flops", "bytes", "coll"):
        slope = (c2[k] - c1[k]) / (u2 - u1)
        out[k] = max(c1[k] + (units - u1) * slope, 0.0)
        out[f"{k}_slope_per_unit"] = slope
    out["probe_units"] = [u1, u2, units]
    return out


def _parse_overrides(pairs: list[str]) -> dict:
    """--set key=value pairs → typed config overrides."""
    out = {}
    for pair in pairs or []:
        key, _, val = pair.partition("=")
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        if val in ("True", "False"):
            val = val == "True"
        out[key] = val
    return out


def cell_id(arch: str, shape_name: str, multi_pod: bool,
            mesh_shape: tuple | None = None, batch: int | None = None,
            seq_len: int | None = None) -> str:
    """``arch|shape|mesh``; a shape's batch or sequence set apart from
    ``SHAPES`` shows as ``shape[batch x seq]``."""
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    shape = SHAPES[shape_name]
    if batch or seq_len:
        shape_name = (f"{shape_name}[{batch or shape['global_batch']}x"
                      f"{seq_len or shape['seq_len']}]")
    return f"{arch}|{shape_name}|{'x'.join(map(str, mesh_shape))}"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             probes: bool = True, overrides: dict | None = None,
             donate_cache: bool = False, device=None,
             mesh_shape: tuple | None = None, batch: int | None = None,
             seq_len: int | None = None) -> dict:
    """Trace one cell in a fake group of its mesh's size (this process must
    hold no process group).  ``device``: the mesh's device type, the card
    unless the caller asks for ``"cpu"``.  ``mesh_shape`` replaces the
    production mesh by a ``(data, model)`` or ``(pod, data, model)`` mesh
    of that shape, and ``batch``/``seq_len`` the shape's global batch and
    sequence.  The port's decode step always writes its caches in place,
    so ``donate_cache`` is only recorded."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ok, reason = cell_supported(cfg, shape_name)
    cid = cell_id(arch, shape_name, multi_pod, mesh_shape, batch, seq_len)
    if not ok:
        return {"cell": cid, "status": "skipped", "reason": reason}

    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_desc = "x".join(map(str, mesh_shape))
    shape = dict(SHAPES[shape_name])
    shape.update({k: v for k, v in (("global_batch", batch),
                                    ("seq_len", seq_len)) if v})
    device_type = resolve_device(device).type
    chips = math.prod(mesh_shape)
    kind = shape["kind"]
    with fake_group(chips):
        if mesh_shape in ((16, 16), (2, 16, 16)):
            mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                        device_type=device_type)
        else:
            mesh = make_debug_mesh(*mesh_shape[-2:],
                                   pod=(mesh_shape[0] if len(mesh_shape) == 3
                                        else None),
                                   device_type=device_type)
        t0 = time.time()
        fn, args = build_cell(cfg, shape, mesh)
        t_build = time.time() - t0
        costs = trace_step(fn, args)
        t_trace = time.time() - t0 - t_build
        ext = extrapolated_costs(cfg, shape, mesh) if probes else None
    print(f"[{cid}] traced {costs['n_ops']} local ops in "
          f"{t_trace:.1f} s: flops={costs['flops']:.3e} "
          f"bytes={costs['bytes']:.3e} coll={costs['coll']:.3e}; "
          f"bytes_per_device {costs['bytes_per_device']}")
    roof = rl.analyze(costs, arch=arch, shape_name=shape_name, shape=shape,
                      kind=kind, mesh_desc=mesh_desc, chips=chips, cfg=cfg)
    print(rl.format_row(roof))
    rec = {"cell": cid, "status": "ok", "arch": arch,
           "shape": shape_name, "mesh": mesh_desc, "kind": kind,
           "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
           "n_ops": costs["n_ops"], "roofline": roof.to_dict(),
           "collective_schedule": hlolib.collective_schedule(
               costs["collectives"], limit=12)}
    if ext is not None:
        rec["extrapolated_costs"] = ext
    if donate_cache:
        rec["donate_cache"] = True
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="an arch, or several separated by commas")
    ap.add_argument("--shape", default=None,
                    help="a shape, or several separated by commas")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--set", nargs="*", dest="overrides", default=[],
                    help="config overrides, e.g. --set attn_block_kv=512")
    ap.add_argument("--donate-cache", action="store_true",
                    help="recorded only: the port's decode step writes its "
                         "caches in place")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the shallow extrapolation probes")
    ap.add_argument("--device", default=None,
                    help="mesh device type (default: the card; 'cpu' off "
                         "it)")
    ap.add_argument("--mesh", default=None,
                    help="a mesh other than the production one: DATAxMODEL "
                         "or PODxDATAxMODEL, e.g. 1x1")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="sequence length in place of the shape's")
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(n) for n in args.mesh.split("x"))
                  if args.mesh else None)
    overrides = _parse_overrides(args.overrides)

    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    archs = (ARCH_NAMES if (args.all or not args.arch)
             else args.arch.split(","))
    shapes = (SHAPE_NAMES if (args.all or not args.shape)
              else args.shape.split(","))
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                cid = cell_id(arch, shape, multi_pod, mesh_shape, args.batch,
                              args.seq_len)
                if results.get(cid, {}).get("status") in ("ok", "skipped"):
                    print(f"[{cid}] cached, skipping")
                    continue
                print(f"=== {cid} ===", flush=True)
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, multi_pod,
                                   probes=not args.no_probes,
                                   overrides=overrides,
                                   donate_cache=args.donate_cache,
                                   device=args.device, mesh_shape=mesh_shape,
                                   batch=args.batch, seq_len=args.seq_len)
                    if overrides:
                        rec["overrides"] = overrides
                except Exception as e:  # noqa: BLE001 — record and continue
                    traceback.print_exc()
                    rec = {"cell": cid, "status": "failed",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(cid)
                rec["wall_s"] = round(time.time() - t0, 1)
                print(f"[{cid}] wall time {rec['wall_s']} s", flush=True)
                results[cid] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1, default=str)
    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_fail = sum(1 for r in results.values() if r["status"] == "failed")
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if failures:
        print("failures:", failures)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
