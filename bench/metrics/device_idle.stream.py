"""Percent of the traced ``run_stream`` calls' wall time in which no
operation ran on the device."""

from bench.lib import readers


def read(ctx):
    return readers.idle_percent(ctx)
