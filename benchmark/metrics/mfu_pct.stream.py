"""Network FLOPs of a frame over the median detect time, against 989 TFLOP/s (bf16, dense)."""

from benchmark.lib import readers


def read(run):
    return readers.mfu_pct(run)
