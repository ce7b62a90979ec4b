"""Emulation-as-a-service: the batched multi-tenant streaming engine.

Port of ``src/repro/runtime/engine.py``.  The paper's multi-chip system is
shared silicon driven by experiment-control FPGAs: many independent
experiments ride one physical fabric, and throughput is experiments
completed, not steps of one run.  ``EmulationEngine`` is the software
twin — S concurrent tenant *sessions* run as rows of the batch axis of one
``snn.stream.run_stream`` window over a shared ``FabricPlan``:

* ``submit()`` places a tenant's stimulus into a free slot's row of the
  host-side stimulus buffer; the slot's state reset to the init row is
  written into that slot's rows at the next ``step()``, before its window
  runs (only the admitted rows are written, not the whole batched state).
  A checkpoint-restored row (``runtime.elastic``) is written into its
  slot's rows at admission;
* ``step()`` advances every occupied slot one window through the fabric
  (composable with ``timed=`` / ``overlap=`` / ``plasticity=`` / routed
  exchange plans) — idle slots and finished sessions' tail steps are
  masked (``run_stream(slot_mask=...)``) so they emit no events, cost no
  drop accounting and freeze their plasticity rows;
* ``collect()`` returns a finished session's spikes plus per-tenant
  accounting (spike counts, all four drop fields, latency percentiles via
  ``snn.stream.masked_latency_stats``) and frees the slot;
* ``evict()`` checkpoints the tenant's row — resubmitting with
  ``restore_from=`` resumes bit-exactly.  The checkpoint is the
  reference's format: a row evicted by either package's engine resumes in
  the other's.

Sessions are structurally isolated: the exchange runs each batch row on
its own, so slot b's events never reach slot b'.  Per-slot online
plasticity (``plasticity=STDPConfig(...)``) gives every session its own
evolving weight copy (``SlotPlasticityState``) and is bit-exact with S
independent batch-1 runs.

A FIFO request queue with admission-on-free-slot (continuous-batching
style) sits on top; the CLI demo is ``launch/serve_emulation.py``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.runtime import elastic
from repro_torch.snn import network as netlib
from repro_torch.snn import stream as stlib

_DROP_FIELDS = ("dropped", "uplink_dropped", "unroutable", "rerouted")


@dataclasses.dataclass
class SessionResult:
    """Per-tenant accounting of one finished (or evicted) session."""

    session_id: int
    steps: int                     # emulated steps delivered to the tenant
    spikes: np.ndarray | None      # f32[steps, n_chips, n_neurons]
    #                                (None in accounting-only engines)
    spike_count: int
    dropped: int                   # egress + congestion drops (summed)
    uplink_dropped: int            # compact-before-gather uplink overflow
    unroutable: int                # lost to dead edges, no surviving route
    rerouted: int                  # delivered over extension-lane detours
    latency: dict[str, float] | None   # masked per-slot percentile stats
    #                                (incl. ``count``; None when untimed)
    plasticity: Any | None         # final per-session plasticity row
    #                                (numpy traces + evolved weights, batch
    #                                axis squeezed; None when non-plastic)
    submitted_at: float            # time.perf_counter() seconds: only the
    finished_at: float             #   difference of the two means anything
    evicted_to: str | None = None  # checkpoint directory when evicted

    @property
    def time_to_result_s(self) -> float:
        return self.finished_at - self.submitted_at


@dataclasses.dataclass
class _Session:
    """Host-side accumulator for one occupied slot."""

    sid: int
    length: int
    submitted_at: float
    delivered: int = 0                 # steps accounted so far
    spike_windows: list = dataclasses.field(default_factory=list)
    spike_count: float = 0.0
    drops: dict = dataclasses.field(default_factory=lambda: {
        "dropped": 0, "uplink_dropped": 0, "unroutable": 0, "rerouted": 0})
    lat_samples: list = dataclasses.field(default_factory=list)


def _write_rows(tree, row, slots: torch.Tensor, axis: int) -> None:
    """Write the batch-1 ``row`` tree into ``tree``'s rows ``slots`` along
    the batch ``axis``, in place."""
    if isinstance(tree, torch.Tensor):
        index = (slice(None),) * axis + (slots,)
        tree[index] = row.to(tree.device)
        return
    for t, r in zip(tree, row):
        _write_rows(t, r, slots, axis)


def _read_row(tree, slot: int, axis: int):
    """``tree``'s batch row ``slot`` along ``axis`` (kept, size 1), as a
    copy."""
    if isinstance(tree, torch.Tensor):
        return tree.narrow(axis, slot, 1).clone()
    return type(tree)(*(_read_row(t, slot, axis) for t in tree))


class EmulationEngine:
    """S sessions as batch rows of one window program.

    Args:
      params / cfg: the shared network (every tenant runs the same
        topology — one program, many experiments).
      slots: number of concurrent sessions S (the batch axis size).
      max_steps: stimulus-buffer length per slot (longest admissible
        session).
      plan: a compiled ``FabricPlan`` (or None for the default star).
      window: steps advanced per ``step()`` call — the scheduling quantum;
        insert/evict/collect happen at window boundaries.
      stim_chips: which chips a tenant's stimulus drives (the stimulus
        buffer only stores these rows).
      timed / overlap / use_fused: forwarded to ``run_stream``.
      plasticity: an ``STDPConfig`` switches on *per-slot* online
        plasticity (``SlotPlasticityState``).  The per-slot weight copies
        cost S times the shared array.
      keep_spikes: when False, each window returns per-slot reduced
        accounting only (spike counts + drop sums) instead of the full
        spike rasters — the high-throughput mode for large S.
      device: where the sessions run (default CUDA; raises if absent).
    """

    def __init__(self, params: netlib.NetworkParams,
                 cfg: netlib.NetworkConfig, *, slots: int, max_steps: int,
                 plan=None, window: int = 8,
                 stim_chips: Sequence[int] = (0,),
                 timed: bool = False, overlap: bool = False,
                 use_fused: bool | None = None,
                 plasticity=None, keep_spikes: bool = True, device=None):
        if window < 1 or max_steps < window:
            raise ValueError("need window >= 1 and max_steps >= window")
        self.device = resolve_device(device)
        self.params = netlib.to_device(params, self.device)
        self.cfg, self.plan = cfg, plan
        self.slots, self.window = slots, window
        self.max_steps = max_steps
        self.stim_chips = tuple(stim_chips)
        self.timed, self.overlap, self.use_fused = timed, overlap, use_fused
        self.plasticity = plasticity
        self.keep_spikes = keep_spikes

        self._state = netlib.init_state(cfg, slots, device=self.device)
        self._plast = (netlib.init_slot_plasticity(self.params, slots)
                       if plasticity is not None else None)
        n_stim = len(self.stim_chips)
        # Host-side: admissions write one row in place and each step
        # gathers every slot's window at its cursor.  Padded by one window
        # so the final partial window's gather stays inside the buffer
        # (its tail is masked anyway).
        self._stim = np.zeros((slots, max_steps + window, n_stim,
                               cfg.chip.n_rows), np.float32)
        # Slots admitted fresh since the last step(): their state reset to
        # the init row is written at the start of the next step().
        self._pending_reset = np.zeros((slots,), bool)
        self._cursor = np.zeros((slots,), np.int32)
        self._length = np.zeros((slots,), np.int32)
        self._sessions: list[_Session | None] = [None] * slots
        self._queue: deque = deque()
        self._results: dict[int, SessionResult] = {}
        self._next_sid = 0
        self._fingerprint = elastic.stream_fingerprint(
            cfg, fabric=plan, plasticity=plasticity)
        self._row_like = netlib.init_state(cfg, 1, device=self.device)
        self._row_plast_like = (netlib.init_slot_plasticity(self.params, 1)
                                if plasticity is not None else None)
        self._stim_idx = torch.tensor(self.stim_chips, dtype=torch.long,
                                      device=self.device)

    # -- the window program -------------------------------------------------

    def _insert(self, slots: np.ndarray, row_state, row_plast) -> None:
        """Write a batch-1 state (and plasticity) row into ``slots``."""
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        _write_rows(self._state.chips, row_state.chips, idx, 1)
        _write_rows(self._state.inflight, row_state.inflight, idx, 2)
        if self._plast is not None:
            _write_rows(self._plast, row_plast, idx, 1)

    def _extract(self, slot: int):
        """Slot ``slot``'s batch-1 state and plasticity rows (copies)."""
        row_state = netlib.NetworkState(
            chips=_read_row(self._state.chips, slot, 1),
            inflight=_read_row(self._state.inflight, slot, 2))
        row_plast = (None if self._plast is None
                     else _read_row(self._plast, slot, 1))
        return row_state, row_plast

    def _window(self, mask: np.ndarray, reset: np.ndarray):
        """One window over every slot: reset the freshly admitted rows to
        the init row, gather each slot's stimulus window at its cursor
        (gated by ``mask``, bool[window, slots]) and run the stream.
        Returns (state, plasticity, payload)."""
        with obs.span("engine.gather"):
            if reset.any():
                # Freshly admitted slots start from the init row, written
                # into their rows only.
                self._insert(np.flatnonzero(reset), self._row_like,
                             self._row_plast_like)
            steps = self._cursor[:, None] + np.arange(self.window)[None, :]
            win = self._stim[np.arange(self.slots)[:, None], steps]
            win = np.where(mask.T[:, :, None, None], win, np.float32(0.0))
            drives = torch.zeros((self.window, self.cfg.n_chips, self.slots,
                                  self.cfg.chip.n_rows), dtype=torch.float32,
                                 device=self.device)
            drives[:, self._stim_idx] = torch.from_numpy(
                np.ascontiguousarray(win.transpose(1, 2, 0, 3))).to(
                    self.device)
        out = stlib.run_stream(
            self.params, self._state, drives, self.cfg, fabric=self.plan,
            timed=self.timed, overlap=self.overlap, use_fused=self.use_fused,
            plasticity=self.plasticity, plasticity_state=self._plast,
            slot_mask=torch.from_numpy(mask).to(self.device),
            device=self.device)
        if self.keep_spikes:
            payload = out._replace(state=None, plasticity=None)
        else:
            payload = {"spike_count": out.spikes.sum(dim=(0, 1, 3)),
                       **{k: getattr(out, k).sum(dim=(0, 1))
                          for k in _DROP_FIELDS}}
            if self.timed:
                payload["latency_ns"] = out.latency_ns
                payload["latency_valid"] = out.latency_valid
        return out.state, out.plasticity, payload

    # -- introspection ------------------------------------------------------

    @property
    def active(self) -> int:
        """Occupied slots."""
        return sum(s is not None for s in self._sessions)

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def done(self) -> tuple[int, ...]:
        """Session ids with an uncollected result."""
        return tuple(self._results)

    # -- request path -------------------------------------------------------

    def submit(self, stimulus, *, restore_from: str | None = None) -> int:
        """Queue one session; admitted into a slot as soon as one is free.

        ``stimulus``: f32[T, n_rows] (single stim chip) or
        f32[T, len(stim_chips), n_rows] — T <= max_steps emulation steps.
        ``restore_from``: a checkpoint directory
        written by ``evict`` (by either package's engine) — the session
        resumes from its checkpointed row (cursor, state and plasticity
        restored; the stimulus must be the original full schedule).
        Returns the session id.
        """
        stim = np.asarray(stimulus, np.float32)
        if stim.ndim == 2:
            stim = stim[:, None, :]
        if stim.shape[1:] != (len(self.stim_chips), self.cfg.chip.n_rows):
            raise ValueError(
                f"stimulus must be [T, {len(self.stim_chips)}, "
                f"{self.cfg.chip.n_rows}], got {stim.shape}")
        if stim.shape[0] > self.max_steps:
            raise ValueError(f"session length {stim.shape[0]} exceeds "
                             f"max_steps={self.max_steps}")
        sid = self._next_sid
        self._next_sid += 1
        self._queue.append((sid, stim, restore_from, time.perf_counter()))
        self._admit()
        return sid

    def _admit(self) -> None:
        while self._queue:
            free = next((i for i, s in enumerate(self._sessions)
                         if s is None), None)
            if free is None:
                return
            sid, stim, restore_from, t_sub = self._queue.popleft()
            if restore_from is None:
                # Fresh session: the slot's reset to the init row happens
                # at the next step().
                self._pending_reset[free] = True
                start = 0
            else:
                ck = elastic.restore_stream_checkpoint(
                    restore_from, self._row_like,
                    plasticity_like=self._row_plast_like,
                    expect_fingerprint=self._fingerprint,
                    device=self.device)
                self._insert(np.array([free]), ck.state, ck.plasticity)
                self._pending_reset[free] = False
                start = ck.step
            self._stim[free] = 0.0
            self._stim[free, :stim.shape[0]] = stim
            self._cursor[free] = start
            self._length[free] = stim.shape[0]
            # ``delivered`` counts steps emulated by *this* engine run — a
            # restored session resumes at cursor=start but its result only
            # carries the post-restore windows (stitch with the evicted
            # partial result for the full raster).
            self._sessions[free] = _Session(sid=sid, length=stim.shape[0],
                                            submitted_at=t_sub)

    # -- advance ------------------------------------------------------------

    @obs.span("engine.step")
    def step(self) -> int:
        """Advance every occupied slot one window; finalize sessions whose
        cursor reached their length and admit queued requests into the
        freed slots.  Returns the number of sessions finished this call."""
        occ = np.array([s is not None for s in self._sessions])
        if not occ.any():
            return 0
        remaining = np.where(occ, self._length - self._cursor, 0)
        mask = (np.arange(self.window)[:, None] < remaining[None, :])
        reset = self._pending_reset.copy()
        self._state, self._plast, payload = self._window(mask, reset)
        # Only the resets this call materialized — _admit below may flag
        # new ones for the *next* window.
        self._pending_reset &= ~reset
        self._account(payload, remaining)
        self._cursor = np.where(
            occ, np.minimum(self._cursor + self.window, self._length),
            self._cursor).astype(np.int32)
        finished = 0
        for slot in range(self.slots):
            if occ[slot] and self._cursor[slot] >= self._length[slot]:
                self._finalize(slot)
                finished += 1
        self._admit()
        return finished

    def warm(self) -> None:
        """Run the window program once on the real shapes without
        advancing any session (an all-masked window whose result is
        discarded: ``run_stream`` never writes its inputs) — call before
        timing so the clock never includes a kernel's first build."""
        self._window(np.zeros((self.window, self.slots), bool),
                     np.zeros((self.slots,), bool))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @obs.span("engine.account")
    def _account(self, payload, remaining) -> None:
        def host(x):
            a = x.detach().cpu().numpy()
            obs.count("engine.to_host_bytes", a.nbytes)
            return a

        lat = lat_valid = None
        if self.keep_spikes:
            spikes = host(payload.spikes)
            drops = {k: host(getattr(payload, k)) for k in _DROP_FIELDS}
            if self.timed:
                lat, lat_valid = (host(payload.latency_ns),
                                  host(payload.latency_valid))
        else:
            sums = {k: host(v) for k, v in payload.items()
                    if k not in ("latency_ns", "latency_valid")}
            if self.timed:
                lat, lat_valid = (host(payload["latency_ns"]),
                                  host(payload["latency_valid"]))
        for slot, sess in enumerate(self._sessions):
            if sess is None or remaining[slot] <= 0:
                continue
            w = int(min(self.window, remaining[slot]))
            if self.keep_spikes:
                sess.spike_windows.append(spikes[:w, :, slot])
                sess.spike_count += float(spikes[:w, :, slot].sum())
                for k, v in drops.items():
                    sess.drops[k] += int(v[:, :, slot].sum())
            else:
                sess.spike_count += float(sums["spike_count"][slot])
                for k in sess.drops:
                    sess.drops[k] += int(sums[k][slot])
            if lat is not None:
                sess.lat_samples.append(
                    lat[:, :, slot][lat_valid[:, :, slot]])
            sess.delivered += w

    # -- completion ---------------------------------------------------------

    def _session_latency(self, sess: _Session):
        if not self.timed:
            return None
        samples = (np.concatenate(sess.lat_samples)
                   if sess.lat_samples else np.zeros((0,), np.int32))
        samples = torch.from_numpy(samples)
        return stlib.masked_latency_stats(
            samples, torch.ones(samples.shape, dtype=torch.bool),
            strict=False)

    def _session_plasticity(self, slot: int):
        if self._plast is None:
            return None
        if self._pending_reset[slot]:
            # Admitted but never stepped: the slot's rows are still the
            # previous tenant's — the true row is the init row.
            row = self._row_plast_like
        else:
            _, row = self._extract(slot)
        rows = [x.detach().cpu().numpy() for x in row]
        obs.count("engine.to_host_bytes", sum(a.nbytes for a in rows))
        return type(row)(*(a[:, 0] for a in rows))

    def _result_of(self, slot: int, *, evicted_to=None) -> SessionResult:
        sess = self._sessions[slot]
        spikes = None
        if self.keep_spikes:
            spikes = (np.concatenate(sess.spike_windows, axis=0)
                      if sess.spike_windows
                      else np.zeros((0, self.cfg.n_chips,
                                     self.cfg.chip.n_neurons), np.float32))
        return SessionResult(
            session_id=sess.sid, steps=sess.delivered, spikes=spikes,
            spike_count=int(sess.spike_count),
            latency=self._session_latency(sess),
            plasticity=self._session_plasticity(slot),
            submitted_at=sess.submitted_at, finished_at=time.perf_counter(),
            evicted_to=evicted_to, **sess.drops)

    @obs.span("engine.finalize")
    def _finalize(self, slot: int) -> None:
        result = self._result_of(slot)
        self._results[result.session_id] = result
        self._sessions[slot] = None

    def collect(self, session_id: int) -> SessionResult:
        """Pop a finished session's result (KeyError while still running)."""
        return self._results.pop(session_id)

    def evict(self, session_id: int, ckpt_dir: str) -> SessionResult:
        """Checkpoint a running tenant's row and free its slot.

        The row (chip states, in-flight delay-line slice, plasticity
        traces + evolved weights) goes through the crash-consistent
        ``runtime.elastic`` writer with the engine's fingerprint; the
        returned partial ``SessionResult`` carries the output so far and
        ``evicted_to=ckpt_dir``.  Resubmit the original stimulus with
        ``restore_from=ckpt_dir`` to resume bit-exactly.
        """
        slot = next((i for i, s in enumerate(self._sessions)
                     if s is not None and s.sid == session_id), None)
        if slot is None:
            raise KeyError(f"session {session_id} is not running")
        if self._pending_reset[slot]:
            # Admitted but never stepped: checkpoint the init row (the
            # slot's rows are still the previous tenant's).
            row_state, row_plast = self._row_like, self._row_plast_like
            self._pending_reset[slot] = False
        else:
            row_state, row_plast = self._extract(slot)
        elastic.save_stream_state(
            ckpt_dir, int(self._cursor[slot]), row_state,
            plasticity=row_plast, fingerprint=self._fingerprint,
            metadata={"session_length": int(self._length[slot])})
        result = self._result_of(slot, evicted_to=ckpt_dir)
        self._sessions[slot] = None
        self._admit()
        return result

    def drain(self) -> dict[int, SessionResult]:
        """Step until every running and queued session finishes; returns
        (without popping) the result map."""
        while self.active or self._queue:
            self.step()
        return dict(self._results)
