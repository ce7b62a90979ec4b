"""Faults planted in the program's timed path, for the tests that see
``correct`` come out false: each patches a function of the port for the
duration of a ``with`` block."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name: str, wrap):
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def state_unchanged():
    """Every ``run_stream`` call hands back the state it was given."""
    from repro_torch.snn import stream

    def wrap(real):
        def run_stream(params, state, *args, **kwargs):
            out = real(params, state, *args, **kwargs)
            return out._replace(state=state,
                                plasticity=kwargs.get("plasticity_state"))
        return run_stream

    return _patched(stream, "run_stream", wrap)


def half_batch():
    """Every ``run_stream`` call leaves out the second half of its batch
    rows: they emit nothing."""
    from repro_torch.snn import stream

    def wrap(real):
        def run_stream(*args, **kwargs):
            out = real(*args, **kwargs)
            b = out.spikes.shape[2]
            out.spikes[:, :, b // 2:] = 0.0
            return out
        return run_stream

    return _patched(stream, "run_stream", wrap)


def no_exchange():
    """The exchange between chips is left out: every step's routed drive
    is zero, in event and dense mode."""
    from repro_torch.snn import stream

    def wrap_event(real):
        def exchange_spikes(*args, **kwargs):
            drives, *rest = real(*args, **kwargs)
            return (drives * 0.0, *rest)
        return exchange_spikes

    def wrap_dense(real):
        def route_dense(spikes, layout):
            return real(spikes, layout) * 0.0
        return route_dense

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(stream, "exchange_spikes", wrap_event))
    stack.enter_context(_patched(stream, "route_dense", wrap_dense))
    return stack


def altered_answer():
    """One answer altered where it is produced: neuron 7 of chip 0 has its
    spike flipped at the first step of every call, in every row."""
    from repro_torch.snn import stream

    def wrap(real):
        def run_stream(*args, **kwargs):
            out = real(*args, **kwargs)
            out.spikes[0, 0, :, 7] = 1.0 - out.spikes[0, 0, :, 7]
            return out
        return run_stream

    return _patched(stream, "run_stream", wrap)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "altered_answer": altered_answer}
