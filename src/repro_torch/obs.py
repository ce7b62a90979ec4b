"""Stage spans and counters, recorded only while ``torch.profiler`` runs.

The program marks its stages with ``span(name)`` (a context manager, or a
decorator where a whole function is one stage) and counts work with
``count(name, n)``.  Nothing switches them on but an active profiler
session (``torch.autograd.profiler._is_profiler_enabled``): there is no
option, environment variable or flag.  Outside a session a span costs a
dictionary lookup, a flag test and a list append and pop, and a count
returns at once.

Inside a session each span

* enters ``torch.profiler.record_function(name)``, so the stage is a
  ``user_annotation`` in the profiler's trace, on the device events'
  clock;
* notes the host clock (``time.perf_counter_ns``) at entry and exit; a
  stack of open spans gives each its self time (its time less that of the
  spans opened inside it);
* once CUDA is initialised, records a pair of timing events on the current
  stream: the stream's time from the stage's first operation to its last.
  The events are read in ``summary()``, after a synchronise, never while
  the program runs; until then each closed span holds its pair.  Without
  CUDA the stream time is the host time (CPU operations are
  synchronous).

``summary()`` sums the spans by name and returns the counters; ``reset()``
clears both.  One recorder serves the process; spans are opened and closed
on one thread, on one CUDA device.
"""

from __future__ import annotations

import functools
import time

import torch
from torch.autograd import profiler as _profiler


class _Frame:
    """One open (or closed, unread) span."""

    __slots__ = ("name", "parent", "annotation", "t0", "host", "child_host",
                 "start", "end", "child_stream")

    def __init__(self, name: str, parent: "_Frame | None"):
        self.name, self.parent = name, parent
        self.child_host = 0
        self.child_stream = 0.0
        self.start = self.end = None


class _Recorder:
    def __init__(self):
        self.stack: list[_Frame] = []
        self.pending: list[_Frame] = []
        self.totals: dict[str, list] = {}
        self.counters: dict[str, int] = {}
        self.events: list = []       # timing events free for reuse

    def _event(self):
        return (self.events.pop() if self.events
                else torch.cuda.Event(enable_timing=True))

    def open(self, name: str) -> None:
        frame = _Frame(name, self.stack[-1] if self.stack else None)
        frame.annotation = _profiler.record_function(name)
        frame.annotation.__enter__()
        if torch.cuda.is_initialized():
            frame.start, frame.end = self._event(), self._event()
            frame.start.record()
        self.stack.append(frame)
        frame.t0 = time.perf_counter_ns()

    def close(self) -> None:
        t1 = time.perf_counter_ns()
        frame = self.stack.pop()
        if frame.end is not None:
            frame.end.record()
        frame.annotation.__exit__(None, None, None)
        frame.host = t1 - frame.t0
        if frame.parent is not None:
            frame.parent.child_host += frame.host
        if frame.end is None:
            self._add(frame, frame.host * 1e-9)
            return
        self.pending.append(frame)

    def _add(self, frame: _Frame, stream_s: float) -> None:
        """Sum a closed span whose stream time is known."""
        if frame.parent is not None:
            frame.parent.child_stream += stream_s
        t = self.totals.setdefault(frame.name, [0, 0, 0, 0.0, 0.0])
        t[0] += 1
        t[1] += frame.host
        t[2] += frame.host - frame.child_host
        t[3] += stream_s
        t[4] += stream_s - frame.child_stream

    def read(self) -> None:
        """Synchronise and read the pending spans' events in the order
        they closed (a child before its parent)."""
        if self.pending:
            torch.cuda.synchronize()
        for frame in self.pending:
            self._add(frame, frame.start.elapsed_time(frame.end) * 1e-3)
            self.events += (frame.start, frame.end)
        self.pending.clear()


_REC = _Recorder()


class _Stage:
    """``span(name)``'s object: a context manager and a decorator that
    records only while the profiler runs.  ``opened`` holds, for each
    entry not yet exited (the innermost last), whether it opened a span,
    so an exit closes only what its own entry opened: a stage may nest in
    itself, and a profiler may start or stop inside an open stage."""

    __slots__ = ("name", "opened")

    def __init__(self, name: str):
        self.name = name
        self.opened: list[bool] = []

    def __enter__(self):
        on = _profiler._is_profiler_enabled
        if on:
            _REC.open(self.name)
        self.opened.append(on)
        return self

    def __exit__(self, *exc) -> bool:
        if self.opened.pop():
            _REC.close()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def staged(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return staged


_STAGES: dict[str, _Stage] = {}


def span(name: str) -> _Stage:
    """The stage ``name``: ``with span(name): ...`` or ``@span(name)``.
    One shared object per name; it records only inside a profiler
    session."""
    stage = _STAGES.get(name)
    if stage is None:
        stage = _STAGES[name] = _Stage(name)
    return stage


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (inside a profiler session)."""
    if _profiler._is_profiler_enabled:
        _REC.counters[name] = _REC.counters.get(name, 0) + int(n)


def summary() -> dict:
    """``{"spans": {name: {count, host_s, self_host_s, stream_s,
    self_stream_s}}, "counters": {name: n}}`` over every span closed and
    every count made since the last ``reset()``; synchronises the card
    first if a span's events are unread."""
    _REC.read()
    spans = {name: {"count": n, "host_s": host * 1e-9,
                    "self_host_s": self_host * 1e-9, "stream_s": stream,
                    "self_stream_s": self_stream}
             for name, (n, host, self_host, stream, self_stream)
             in _REC.totals.items()}
    return {"spans": spans, "counters": dict(_REC.counters)}


def reset() -> None:
    """Forget every closed span and every count."""
    _REC.read()
    _REC.totals.clear()
    _REC.counters.clear()
