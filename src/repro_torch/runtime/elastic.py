"""The durable long-run stream harness (checkpoint → watchdog → resume).

Port of the stream side of ``src/repro/runtime/elastic.py``.  It captures
the *full* state a long emulation run needs to survive preemption:

* ``save_stream_state`` / ``restore_stream_checkpoint`` checkpoint the
  ``NetworkState`` (chip states + the in-flight delay line, kept in shift
  order so any window length resumes bit-exactly), the online-plasticity
  traces and evolving weights (``snn.plasticity.StreamPlasticityState`` or
  ``SlotPlasticityState`` — the chips' weights at step t exist nowhere
  else), the random state, the global step counter, and a
  ``stream_fingerprint`` of the fabric spec + network config that
  ``restore`` validates — resuming a checkpoint onto a different topology
  or config fails loudly instead of silently diverging.  The files are the
  reference's format and leaf names (``ckpt.checkpoint``), and the
  fingerprint is the reference's digest of the same configuration, so a
  stream checkpoint written by either package resumes in the other.

* ``run_supervised_stream`` advances the emulation in watchdog-supervised
  windows (the host twin of the Aggregator barrier's timeout → recover →
  refractory cycle, ``core.sync``), checkpointing on a configurable cadence
  (``ckpt_every``) with bounded retention (``keep`` → ``ckpt.prune``, which
  never removes the only checkpoint that verifies).  A fired watchdog
  restores the newest *valid* on-disk checkpoint — not necessarily the
  current window's boundary — and reruns the whole span from there as one
  stream call, so cadence > 1 still recovers bit-exactly.  Each window is
  one plain ``run_stream`` call (the reference caches a jitted program per
  window; the port has nothing to compile).

* ``resume_supervised_stream`` is the preemption entry point: after a kill
  a fresh process points it at the same checkpoint directory and drive
  schedule, and it restarts from the newest checkpoint that verifies
  (quarantining corrupt ones), validates the fingerprint, and produces
  outputs bit-exact with the uninterrupted run — plasticity included, and
  composable with the link-fault schedules (``faults`` rebased per window
  via ``fabric.shift_faults``).

The random state (leaf ``rng``; the stream itself is deterministic and
only carries it):

* a ``torch.Generator`` is saved as its ``get_state()`` (uint8) with
  ``rng_impl = "torch.Generator:<device type>"`` and restores as a new
  Generator of that device type with ``set_state``.  Such a checkpoint
  restores only in the port: the reference refuses the impl name.
* a JAX typed key read from a reference checkpoint (``rng_impl`` a JAX
  impl name such as ``"threefry2x32"``, uint32 key data) restores as
  ``KeyData(data, impl)`` and is saved again under the same impl, so a
  reference → port → reference round trip gives back the same typed key.
  The port does no arithmetic on the uint32 data.
* any other tensor is raw key data (``rng_impl`` null), as in the
  reference.

``resume_on_mesh`` restores an LM training checkpoint (written unsharded
by either package's ``Trainer``) onto a device mesh: parameters and AdamW
moments laid out by ``param_shardings``, everything else replicated.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.checkpoint import CheckpointError

GENERATOR_IMPL = "torch.Generator:"


def resume_on_mesh(directory: str, state_like, mesh, params_key="params",
                   step: int | None = None):
    """Load the latest checkpoint (or ``step``'s) and shard it for ``mesh``.

    ``state_like``: the state's structure, freshly initialized:
    ``state_like[params_key]`` a ``Params`` module (the shapes and the
    logical axes), ``"opt"`` (optional) an ``AdamWState`` whose ``m`` and
    ``v`` are ``{name: tensor}`` dicts, and other keys trees of tensors.
    Every rank reads the whole checkpoint (the JAX package's format and
    leaf names) and keeps its pieces, so nothing crosses the group.

    Returns ``(state, manifest)``: ``state[params_key]`` and the moments as
    ``{name: DTensor}`` laid out by ``param_shardings``, the step and every
    other leaf replicated.
    """
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shardlib
    from repro_torch.runtime.trainer import flat, nested

    shardlib.check_mesh(mesh)
    params = state_like[params_key]
    pshard = shardlib.param_shardings(params, mesh)
    rep = shardlib.replicated(mesh)

    def like(key, sub):
        if key == params_key:
            return nested(adamw.named(params))
        if key == "opt":
            return adamw.AdamWState(step=sub.step, m=nested(sub.m),
                                    v=nested(sub.v))
        return sub

    def put(tree):
        return {n: shardlib.distribute(t, pshard[n])
                for n, t in flat(tree).items()}

    def put_replicated(t):
        return shardlib.distribute(t, rep)

    tree, manifest = ckpt.restore(
        directory, {k: like(k, v) for k, v in state_like.items()}, step,
        device=mesh.device_type)
    state = {}
    for key, sub in tree.items():
        if key == params_key:
            state[key] = put(sub)
        elif key == "opt":
            state[key] = adamw.AdamWState(step=put_replicated(sub.step),
                                          m=put(sub.m), v=put(sub.v))
        else:
            state[key] = shardlib.map_tree(put_replicated, sub)
    return state, manifest


# ---------------------------------------------------------------------------
# Full stream-state capture
# ---------------------------------------------------------------------------


class KeyData(NamedTuple):
    """A JAX typed PRNG key carried by the port: its raw key data (uint32)
    and the impl name (e.g. ``"threefry2x32"``) it is saved under."""

    data: torch.Tensor
    impl: str


class StreamCheckpoint(NamedTuple):
    """Everything a streamed run needs to continue from a checkpoint."""

    state: object                 # snn.network.NetworkState
    plasticity: object | None    # snn.plasticity.*PlasticityState
    rng: object | None           # torch.Generator, KeyData or raw tensor
    step: int                    # global stream step of the checkpoint
    manifest: dict


def _canon(x):
    """Canonical JSON-able form of configs/specs for fingerprinting (the
    reference's, value for value)."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__type__": type(x).__name__,
                **{f.name: _canon(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {str(k): _canon(v)
                for k, v in sorted(x.items(), key=lambda kv: str(kv[0]))}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, torch.Tensor):             # host copy first
        return _canon(x.detach().cpu().tolist())
    if hasattr(x, "tolist"):                    # numpy arrays and scalars
        return _canon(np.asarray(x).tolist())
    return repr(x)


def stream_fingerprint(cfg, *, fabric=None, plasticity=None,
                       extra=None) -> str:
    """Identity of a streamed run's static configuration — sha256 over the
    canonical JSON of the network config, the fabric *spec* (topology,
    capacities, enables, health — not the compiled tables), and the
    plasticity config.  Stored in every stream checkpoint's metadata and
    validated on restore: state from one topology cannot silently seed a
    run on another.  Equal to the reference's for the same
    configuration."""
    payload = {"cfg": _canon(cfg),
               "fabric": None if fabric is None else _canon(fabric.spec),
               "plasticity": _canon(plasticity),
               "extra": _canon(extra)}
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _stream_tree(state, *, plasticity=None, rng=None,
                 step: int | None = None) -> dict:
    """The checkpointable stream tree (named leaves, device-agnostic).

    Optional capture rides as extra top-level keys so two-leaf
    checkpoints keep restoring: the reader decides what to expect from the
    manifest, not from the code version.
    """
    tree = {"chips": state.chips, "inflight": state.inflight}
    if plasticity is not None:
        tree["plasticity"] = plasticity
    if rng is not None:
        tree["rng"] = rng
    if step is not None:
        tree["step"] = np.asarray(step, np.int32)
    return tree


def _stream_payload(step: int, state, metadata, plasticity, rng,
                    fingerprint):
    """(tree, metadata) of a stream checkpoint, the random state stored as
    its raw data with its impl name."""
    meta = dict(metadata or {})
    meta["stream_step"] = int(step)
    meta["has_plasticity"] = plasticity is not None
    if fingerprint is not None:
        meta["fingerprint"] = fingerprint
    if rng is not None:
        if isinstance(rng, torch.Generator):
            meta["rng_impl"] = GENERATOR_IMPL + rng.device.type
            rng = rng.get_state()
        elif isinstance(rng, KeyData):
            meta["rng_impl"] = rng.impl
            rng = rng.data
        else:
            meta["rng_impl"] = None
    tree = _stream_tree(state, plasticity=plasticity, rng=rng, step=step)
    return tree, meta


def save_stream_state(directory: str, step: int, state,
                      metadata: dict | None = None, *,
                      plasticity=None, rng=None,
                      fingerprint: str | None = None) -> str:
    """Checkpoint the full stream state at a window boundary.

    Beyond the ``NetworkState`` (chip states + shift-order in-flight delay
    line), captures the online-plasticity traces/weights, the random state
    (see the module docstring), the global step, and the run fingerprint —
    everything ``restore_stream_checkpoint`` needs to resume bit-exactly.
    """
    tree, meta = _stream_payload(step, state, metadata, plasticity, rng,
                                 fingerprint)
    return ckpt.save(directory, step, tree, metadata=meta)


def restore_stream_checkpoint(directory: str, state_like, *,
                              step: int | None = None,
                              plasticity_like=None,
                              expect_fingerprint: str | None = None,
                              quarantine: bool = False,
                              device=None) -> StreamCheckpoint:
    """Restore a stream checkpoint with everything it captured.

    ``state_like`` supplies the ``NetworkState`` structure; when the
    checkpoint carries plasticity state, ``plasticity_like`` (e.g.
    ``snn.network.init_stream_plasticity(params, batch)``) must supply that
    structure too — restoring a plastic run without it raises instead of
    silently dropping the evolved weights.  ``step=None`` resumes from the
    newest checkpoint that *verifies* (corrupt/partial ones skipped, and
    quarantined when ``quarantine``).  ``expect_fingerprint`` (from
    ``stream_fingerprint``) must match the checkpoint's recorded
    fingerprint.  Tensors come back on ``device`` (default CUDA).
    """
    if step is None:
        step = ckpt.latest_step(directory, quarantine=quarantine)
        if step is None:
            raise FileNotFoundError(
                f"no valid stream checkpoints under {directory}")
    manifest = ckpt.read_manifest(directory, step)
    by_name = {e["name"]: e for e in manifest.get("leaves", [])}
    meta = manifest.get("metadata", {})

    has_plast = any(n.startswith("plasticity") for n in by_name)
    if has_plast and plasticity_like is None:
        raise CheckpointError(
            f"stream checkpoint step {step} carries online-plasticity state "
            f"(evolved weights + traces); pass plasticity_like= (e.g. "
            f"snn.network.init_stream_plasticity(params, batch)) so it can "
            f"be restored — dropping it would silently lose the run")
    if expect_fingerprint is not None:
        got = meta.get("fingerprint")
        if got != expect_fingerprint:
            raise CheckpointError(
                f"stream checkpoint step {step} was written by a different "
                f"run configuration: fingerprint {got!r} != expected "
                f"{expect_fingerprint!r} (fabric spec / network config / "
                f"plasticity config changed)")

    rng_like = None
    if "rng" in by_name:
        e = by_name["rng"]
        rng_like = np.zeros(tuple(e["shape"]), np.dtype(e["dtype"]))
    tree_like = _stream_tree(
        state_like, plasticity=plasticity_like if has_plast else None,
        rng=rng_like, step=step if "step" in by_name else None)
    tree, manifest = ckpt.restore(directory, tree_like, step=step,
                                  device=device, quarantine=quarantine)

    rng = tree.get("rng")
    impl = meta.get("rng_impl")
    if rng is not None and impl:
        if impl.startswith(GENERATOR_IMPL):
            gen = torch.Generator(device=impl[len(GENERATOR_IMPL):])
            gen.set_state(rng.cpu())
            rng = gen
        else:
            rng = KeyData(data=rng, impl=impl)
    return StreamCheckpoint(
        state=type(state_like)(chips=tree["chips"],
                               inflight=tree["inflight"]),
        plasticity=tree.get("plasticity"), rng=rng,
        step=int(tree["step"]) if "step" in tree else step,
        manifest=manifest)


def restore_stream_state(directory: str, state_like, step: int | None = None,
                         *, device=None):
    """Restore just the ``NetworkState`` of a (non-plastic) stream
    checkpoint.  Returns ``(state, manifest)``."""
    ck = restore_stream_checkpoint(directory, state_like, step=step,
                                   device=device)
    return ck.state, ck.manifest


# ---------------------------------------------------------------------------
# Watchdog-supervised windows (stall recovery + durable checkpoints)
# ---------------------------------------------------------------------------


_DATA_FIELDS = ("spikes", "dropped", "uplink_dropped", "latency_ns",
                "latency_valid", "unroutable", "rerouted")


def run_supervised_stream(params, state, ext_drives, cfg, *,
                          fabric, window: int, ckpt_dir: str,
                          watchdog=None,
                          on_recover: Callable | None = None,
                          stall_probe: Callable | None = None,
                          stream_kwargs: dict | None = None,
                          plasticity=None, plasticity_state=None,
                          rng=None,
                          ckpt_every: int = 1, keep: int | None = None,
                          step_offset: int = 0,
                          faults: Sequence | None = None,
                          fault_mode: str = "mask",
                          async_checkpoint: bool = True,
                          device=None):
    """Run ``snn.stream.run_stream`` in watchdog-supervised windows.

    The drive sequence advances ``window`` steps at a time; window
    boundaries checkpoint the *full* stream state (network + plasticity +
    random state + step + fingerprint) on the ``ckpt_every`` cadence, with
    retention bounded by ``keep`` (``ckpt.prune`` — never the last verified
    checkpoint).  Each window runs under the watchdog's deadline and is
    synchronized with the card inside it, so the deadline's EMA times the
    window's work, not its dispatch.  A fired watchdog marks the window
    failed: its outputs are discarded, the newest *valid* checkpoint at or
    before the window start is restored (corrupt/partial ones
    quarantined), ``on_recover(window_index, plan)`` supplies the plan to
    resume on (default: keep the current plan), and the whole span from
    the restored step through the window end reruns as one stream call —
    all subsequent windows stay on the recovered plan.  The rerun happens
    inside the watchdog's refractory period, mirroring the barrier's
    post-release lockout (``core.sync``).

    Args:
      fabric: the (healthy) ``FabricPlan`` the stream starts on.
      window: steps per supervised window (> 0; the last may be short).
      watchdog: a ``runtime.watchdog.StepWatchdog``; default constructs one
        with stock config (10 s minimum deadline).
      on_recover: plan supplier after a timeout — typically returns
        ``compile_fabric(degrade_spec(fabric.spec, dead_edges))``.
      stall_probe: test/diagnostic hook called (with the window index) while
        the watchdog is armed, *after* the window's outputs are ready — a
        probe that blocks past the deadline simulates a stalled stream.
      stream_kwargs: forwarded to every ``run_stream`` call (e.g.
        ``timed=True``, ``use_fused=False``).
      plasticity / plasticity_state: online plasticity (``STDPConfig`` +
        optional initial state, shared or per slot) — the evolving traces
        and weights thread through the windows and every checkpoint, bit
        for bit with one long plastic run.
      rng: random state carried as durable state (checkpointed and
        returned by ``resume_supervised_stream``; see the module
        docstring).
      ckpt_every: checkpoint every Nth window boundary (≥ 1; the first
        window of the invocation always checkpoints).
      keep: retain only the newest ``keep`` verified checkpoints
        (``None`` = keep everything).
      step_offset: global step of ``ext_drives[0]`` — set by
        ``resume_supervised_stream`` so checkpoints, fault schedules and
        window indices stay in whole-run coordinates.
      faults / fault_mode: a whole-run ``fabric.FaultEvent`` schedule
        (global steps); each window sees its slice via
        ``fabric.shift_faults``.
      async_checkpoint: write checkpoints from one background writer
        thread, overlapping the (fsync-bound) IO with the next window's
        compute.  The boundary's tree is copied to host numpy on the
        calling thread first (the card's tensors are not the writer's to
        read); the thread only hashes, writes and fsyncs.  The directory
        stays single-writer (each save joins the previous one first), and
        every consumer of the checkpoint — recovery, the final return, the
        next save — joins the writer before touching disk; writer errors
        surface at the next join.  ``False`` saves synchronously.
      device: where the windows run (default CUDA).

    Returns:
      ``(out, recoveries)`` — ``out`` is a ``StreamOut`` covering all steps
      (windows concatenated on the time axis, final state from the last
      window, final plasticity state in ``out.plasticity``), ``recoveries``
      a list of dicts describing each recovery (window index, fired step,
      restored step, plan summary).
    """
    from repro_torch.core import fabric as fablib
    from repro_torch.runtime.watchdog import StepWatchdog
    from repro_torch.snn import plasticity as plaslib
    from repro_torch.snn import stream as stlib

    if window <= 0:
        raise ValueError(f"window must be positive: {window}")
    if ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1: {ckpt_every}")
    device = resolve_device(device)
    kwargs = dict(stream_kwargs or {})
    wd = StepWatchdog() if watchdog is None else watchdog
    n_steps = ext_drives.shape[0]
    plan = fabric
    fingerprint = stream_fingerprint(cfg, fabric=fabric,
                                     plasticity=plasticity)
    plast = plasticity_state
    if plasticity is not None and plast is None:
        plast = plaslib.init_stream_stdp(params.chips.weights,
                                         ext_drives.shape[2])
    recoveries: list[dict] = []
    outs: list[tuple] = []            # (StreamOut, global start, length)
    writer = (ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
              if async_checkpoint else None)
    pending: list = []                # in-flight writer futures (≤ 1)

    def flush_writer():
        while pending:
            pending.pop(0).result()   # re-raises writer errors here

    def checkpoint_now(step, st, plast_st, plan_desc):
        tree, meta = _stream_payload(step, st, {"plan": plan_desc}, plast_st,
                                     rng, fingerprint)

        def _do(tree):
            ckpt.save(ckpt_dir, step, tree, metadata=meta)
            if keep is not None:
                ckpt.prune(ckpt_dir, keep=keep)
        if writer is None:
            _do(tree)
        else:
            tree = ckpt.host_tree(tree)   # on this thread, before it moves
            flush_writer()            # single writer: previous save first
            pending.append(writer.submit(_do, tree))

    def run_span(gstart, drives_w, st, pl, plast_st):
        extra = {}
        if faults:
            extra = dict(faults=fablib.shift_faults(faults, gstart,
                                                    drives_w.shape[0]),
                         fault_mode=fault_mode)
        out = stlib.run_stream(params, st, drives_w, cfg, fabric=pl,
                               plasticity=plasticity,
                               plasticity_state=plast_st, device=device,
                               **extra, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    try:
        for start in range(0, n_steps, window):
            gstart = step_offset + start
            widx = gstart // window
            drives_w = ext_drives[start:start + window]
            if start == 0 or widx % ckpt_every == 0:
                checkpoint_now(gstart, state, plast, plan.describe())
            fired_before = wd.timeouts
            with wd:
                out = run_span(gstart, drives_w, state, plan, plast)
                if stall_probe is not None:
                    stall_probe(widx)
            if wd.timeouts > fired_before:
                # Timeout → recover: drop everything back to the newest
                # valid checkpoint, resume on the (degraded) plan, and rerun
                # the whole span to the window end as one stream call.  The
                # rerun sits in the refractory period.
                flush_writer()
                s = ckpt.latest_step(ckpt_dir, max_step=gstart,
                                     quarantine=True)
                if s is None or s < step_offset:
                    raise CheckpointError(
                        f"no valid checkpoint at or before step {gstart} "
                        f"(>= {step_offset}) to recover from under "
                        f"{ckpt_dir}")
                ck = restore_stream_checkpoint(
                    ckpt_dir, state, step=s,
                    plasticity_like=(plast if plasticity is not None
                                     else None),
                    expect_fingerprint=fingerprint, device=device)
                if on_recover is not None:
                    plan = on_recover(widx, plan)
                recoveries.append({"window": widx, "step": gstart,
                                   "restored_step": s,
                                   "plan": plan.describe()})
                outs = [o for o in outs if o[1] < s]
                local_s = s - step_offset
                span = ext_drives[local_s:start + drives_w.shape[0]]
                out = run_span(s, span, ck.state, plan, ck.plasticity)
                outs.append((out, s, span.shape[0]))
                rng = ck.rng if ck.rng is not None else rng
            else:
                outs.append((out, gstart, drives_w.shape[0]))
            state = out.state
            plast = out.plasticity
        flush_writer()
    finally:
        if writer is not None:
            writer.shutdown(wait=True)
    parts = [o for o, _, _ in outs]
    merged = {f: torch.cat([getattr(o, f) for o in parts])
              for f in _DATA_FIELDS}
    return parts[-1]._replace(state=state, plasticity=plast,
                              **merged), recoveries


def resume_supervised_stream(params, state_like, ext_drives, cfg, *,
                             fabric, window: int, ckpt_dir: str,
                             plasticity=None, watchdog=None,
                             on_recover: Callable | None = None,
                             stall_probe: Callable | None = None,
                             stream_kwargs: dict | None = None,
                             ckpt_every: int = 1, keep: int | None = None,
                             faults: Sequence | None = None,
                             fault_mode: str = "mask",
                             async_checkpoint: bool = True,
                             device=None):
    """Restart a preempted supervised stream from disk.

    The preemption-survival entry point: a fresh process (the old one
    crashed, was killed, or lost its node — possibly mid-checkpoint) points
    this at the same checkpoint directory and the *full* drive schedule,
    and the run continues from the newest checkpoint that verifies:
    partial and bit-rotted directories are quarantined, the fingerprint is
    validated against (cfg, fabric, plasticity), and the remaining windows
    run under the same supervision.  The concatenation of the pre-kill
    output prefix ``[:resumed_step]`` with the returned output is bit-exact
    with an uninterrupted run — spikes, drops, latencies, final state, and
    plasticity included.  The checkpoint may come from either package.

    Args:
      state_like: a freshly initialized ``NetworkState`` (structure donor).
      ext_drives: the whole run's drives, step 0 onward — the resume point
        indexes into it.
      Remaining arguments as in ``run_supervised_stream``.

    Returns:
      ``(out, info)`` — ``out`` covers steps ``[resumed_step:]``; ``info``
      has ``resumed_step``, the restored checkpoint's ``manifest``, the
      restored ``rng``, and the in-run ``recoveries`` list.
    """
    from repro_torch.snn import network as netlib

    device = resolve_device(device)
    fingerprint = stream_fingerprint(cfg, fabric=fabric,
                                     plasticity=plasticity)
    step = ckpt.latest_step(ckpt_dir, quarantine=True)
    if step is None:
        raise FileNotFoundError(
            f"nothing to resume: no checkpoint under {ckpt_dir} verifies")
    plast_like = (netlib.init_stream_plasticity(params, ext_drives.shape[2])
                  if plasticity is not None else None)
    ck = restore_stream_checkpoint(ckpt_dir, state_like, step=step,
                                   plasticity_like=plast_like,
                                   expect_fingerprint=fingerprint,
                                   quarantine=True, device=device)
    out, recoveries = run_supervised_stream(
        params, ck.state, ext_drives[step:], cfg, fabric=fabric,
        window=window, ckpt_dir=ckpt_dir, watchdog=watchdog,
        on_recover=on_recover, stall_probe=stall_probe,
        stream_kwargs=stream_kwargs, plasticity=plasticity,
        plasticity_state=ck.plasticity, rng=ck.rng,
        ckpt_every=ckpt_every, keep=keep, step_offset=step,
        faults=faults, fault_mode=fault_mode,
        async_checkpoint=async_checkpoint, device=device)
    return out, {"resumed_step": step, "manifest": ck.manifest,
                 "rng": ck.rng, "recoveries": recoveries}
