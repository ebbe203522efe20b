"""Operations, bytes and the card's peaks: the yardstick of the roofline
and MFU metrics.

The kernel rules follow the program's kernel table (`chip_smoke.py`),
counted for the kernel alone as the device trace times it: NMS costs 15
operations per pair of valid boxes of a row and reads the boxes and the
valid flags; the scatter kernel reads each feature row and its
coordinates and writes the row into the canvas (the canvas's zero fill is
a separate memset, which the table's call time included and a kernel's
trace time does not). What a family's network does with them, its FLOPs
and the sizes its kernels see, is the family's
(`benchmark/families/<family>.py`).
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
NMS_OPS_PER_PAIR = 15

# the program's kernels by their names in a device trace
KERNELS = {
    "scatter": re.compile(r"\bscatter_rows<[^<>,]+, (?:\(int\))?0>"),
    "nms": re.compile(r"\b(?:mask_tiles|sweep)\("),
}


def scatter_bytes(rows: int, width: int, batch: int, elem: int = 2) -> float:
    """One launch at `batch` over a buffer of `rows` pillars of `width`
    features: every row read and written into the canvas, its coordinates
    read."""
    return batch * (2 * rows * width * elem + rows * 3 * 4)


def nms_bound_s(valid_per_row: list[int], k: int) -> tuple[float, str]:
    """One call over rows of `k` boxes with these valid counts → (seconds,
    the bound that applies)."""
    rows = len(valid_per_row)
    ops = sum(n * (n - 1) / 2 for n in valid_per_row) * NMS_OPS_PER_PAIR
    moved = rows * k * 4 * 4 + 2 * rows * k
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
