"""Percent of the traced engine steps' wall time in which no operation
ran on the device."""

from bench.lib import readers


def read(ctx):
    return readers.idle_percent(ctx)
