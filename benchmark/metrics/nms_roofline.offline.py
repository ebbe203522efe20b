"""NMS (mask kernel and sweep) as a share of its bound, over its calls in the traced stretch."""

from benchmark.lib import readers


def read(run):
    return readers.nms_roofline_pct(run)
