"""Network FLOPs of the window's frames over the window, against 989 TFLOP/s (bf16, dense)."""

from benchmark.lib import readers


def read(run):
    return readers.mfu_pct(run)
