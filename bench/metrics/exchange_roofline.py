"""The ``exchange`` kernel's share of its roofline over the traced calls
(``bench/lib/roofline.py::exchange_cost`` over its device time)."""

from bench.lib import readers


def read(ctx):
    return readers.exchange_share(ctx)
