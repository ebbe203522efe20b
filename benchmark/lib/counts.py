"""Operations, bytes and the card's peaks: the yardstick of the roofline
and MFU metrics.

The kernel rules follow the program's kernel table (`chip_smoke.py`),
counted for the kernel alone as the device trace times it: NMS costs 15
operations per pair of valid boxes of a row and reads the boxes and the
valid flags; the scatter kernel reads each feature row and its
coordinates and writes the row into the canvas (the canvas's zero fill is
a separate memset, which the table's call time included and a kernel's
trace time does not). The network's FLOPs are counted from the layer
shapes, two per multiply-add.
"""

from __future__ import annotations

import re

from benchmark.reference import pointpillars as ref

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


def network_flops(geo: ref.Geometry) -> float:
    """One frame's forward pass: the pillar layer, the RPN's convolutions
    and deconvolutions and the three heads."""
    nx, ny = geo.grid[0], geo.grid[1]
    flops = 2.0 * geo.max_voxels * geo.max_points_per_voxel * ref.PFN_IN * ref.PFN_OUT
    cin, h, w = ref.PFN_OUT, nx, ny
    fx, fy = geo.feature
    for depth, width, stride, up in zip(ref.RPN_LAYERS, ref.RPN_FILTERS, ref.RPN_UP_STRIDES, ref.RPN_UP_FILTERS):
        h, w = (h + 1) // 2, (w + 1) // 2
        flops += 2.0 * h * w * width * cin * 9                        # the stride-2 entry conv
        flops += 2.0 * h * w * width * width * 9 * rpn_convs(depth)   # the residual units
        flops += 2.0 * (h * stride) * (w * stride) * up * width      # the upsample branch
        cin = width
    a = geo.num_channels
    flops += 2.0 * fx * fy * sum(ref.RPN_UP_FILTERS) * a * (1 + ref.BOX_CODE + 2)
    return flops


def rpn_convs(depth: int) -> int:
    """3x3 convolutions of a block's residual units: two per pair of layers, one more."""
    return 2 * (depth // 2) + 1


def scatter_bytes(geo: ref.Geometry, batch: int, elem: int = 2) -> float:
    """One launch at `batch`: every row of the pillar buffer read and
    written into the canvas, its coordinates read."""
    v = geo.max_voxels
    return batch * (2 * v * ref.PFN_OUT * elem + v * 3 * 4)


def scatter_bound_s(geo: ref.Geometry, batch: int) -> float:
    """The dense scatter at `batch`."""
    return scatter_bytes(geo, batch) / HBM_BYTES_PER_S


def nms_bound_s(valid_per_row: list[int], k: int) -> tuple[float, str]:
    """One call over rows of `k` boxes with these valid counts → (seconds,
    the bound that applies)."""
    rows = len(valid_per_row)
    ops = sum(n * (n - 1) / 2 for n in valid_per_row) * NMS_OPS_PER_PAIR
    moved = rows * k * 4 * 4 + 2 * rows * k
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
