"""The dense BEV scatter's share of its bytes bound, over its launches in the traced stretch."""

from benchmark.lib import readers


def read(run):
    return readers.scatter_roofline_pct(run)
