"""The ``merge_pack`` kernel's share of its roofline over the traced
engine steps (``bench/lib/roofline.py::merge_cost``)."""

from bench.lib import readers


def read(ctx):
    return readers.merge_share(ctx)
