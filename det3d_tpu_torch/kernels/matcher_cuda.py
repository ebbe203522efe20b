"""Anchor target matcher: the CUDA kernels' wrappers.

Counterpart of `assign_class_pallas` in the JAX package
(kernels/matcher_pallas.py, `_gt_max_kernel` and `_assign_kernel`): target
assignment that never builds the (G, A) IoU matrix. `csrc/matcher.cu` has
two kernels, each launched once per call for every class and every sample
of the batch: pass 1 (`gt_max_bits_cuda`) takes each gt's best IoU over its
class's included anchors, pass 2 (`assign_cuda`) assigns every anchor;
`match_cuda` runs both. Both cull by anchor chunk: a warp owns `CHUNK`
consecutive anchors and visits only the gt whose standup box reaches the
chunk's bounding box (`MatcherTables.chunk_bv`); the pairs it never visits
have IoU exactly 0 and are given back as such.

The plain twin is the dense `targets._assign_one_class`, per sample and
class (`targets.TargetAssigner.plain`); `targets.TargetAssigner` dispatches
on the device of its input, as `scatter_to_bev` does. Labels, weights and
dir equal the plain version's; targets agree to the rounding of the
device's `logf`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from det3d_tpu_torch.kernels import build

MAX_G = 256        # csrc/matcher.cu keeps a sample's gt rows in shared memory
MAX_CLASSES = 8
CHUNK = 128        # consecutive anchors of one row of `chunk_bv`: a warp's, 4 a lane
# in `match_cuda`, pass 2 starts while pass 1 still runs and waits for it only
# before its first chunk with a candidate gt (PERF.md has both ways' times)
ASSIGN_EARLY = True

# launches of each kernel: one per call of its wrapper
gt_max_counter = build.LaunchCounter()
assign_counter = build.LaunchCounter()


class MatcherTables(NamedTuple):
    """The anchor set on the device. The kernels read `anchors_t`,
    `anchors_bv`, `chunk_bv`, `class_start` and `thresholds` (`anchors` gives
    them only A); the plain version reads `anchors` and `anchors_bv`."""

    anchors: torch.Tensor      # (A, 7) float32, anchor-major flat order
    anchors_bv: torch.Tensor   # (A, 4) float32 standup boxes
    class_start: torch.Tensor  # (ncls + 1,) int32 flat offsets of the classes
    thresholds: torch.Tensor   # (ncls, 2) float32 [matched, unmatched]
    anchors_t: torch.Tensor    # (7, A) float32: `anchors` as planes
    chunk_bv: torch.Tensor     # (ceil(A / CHUNK), 4) float32: `targets.chunk_boxes`


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from `csrc/matcher.cu`."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.det3d_matcher_gt_max.argtypes = [p] * 7 + [i] * 6 + [p, p]
    lib.det3d_matcher_gt_max.restype = ctypes.c_int
    lib.det3d_matcher_assign.argtypes = [p] * 11 + [i] * 6 + [p] * 5
    lib.det3d_matcher_assign.restype = ctypes.c_int
    lib.det3d_matcher_chunk.restype = ctypes.c_int
    if lib.det3d_matcher_chunk() != CHUNK:
        raise RuntimeError(f"matcher.cu owns {lib.det3d_matcher_chunk()} anchors a warp, CHUNK is {CHUNK}")
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("matcher"))


def _check(tables: MatcherTables, mask, gt_boxes, gt_bv, gt_classes, gt_valid) -> None:
    a = tables.anchors.shape[0]
    ncls = tables.class_start.shape[0] - 1
    b, g = gt_valid.shape
    want = {
        "anchors": (tables.anchors, (a, 7), torch.float32),
        "anchors_bv": (tables.anchors_bv, (a, 4), torch.float32),
        "anchors_t": (tables.anchors_t, (7, a), torch.float32),
        "chunk_bv": (tables.chunk_bv, (-(-a // CHUNK), 4), torch.float32),
        "class_start": (tables.class_start, (ncls + 1,), torch.int32),
        "thresholds": (tables.thresholds, (ncls, 2), torch.float32),
        "mask": (mask, (b, a), torch.bool),
        "gt_boxes": (gt_boxes, (b, g, 7), torch.float32),
        "gt_bv": (gt_bv, (b, g, 4), torch.float32),
        "gt_classes": (gt_classes, (b, g), torch.int32),
        "gt_valid": (gt_valid, (b, g), torch.bool),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    for name, (t, _, _) in want.items():
        if t.device.type != "cuda" or t.device != mask.device:
            raise ValueError(f"{name} must be a CUDA tensor on the mask's device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"G={g} is outside the kernel's range [1, {MAX_G}]")
    if not 1 <= ncls <= MAX_CLASSES:
        raise ValueError(f"{ncls} classes; the kernel takes 1 to {MAX_CLASSES}")
    for name in ("anchors_bv", "anchors_t", "chunk_bv"):
        if getattr(tables, name).data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")


def gt_max_bits_cuda(tables: MatcherTables, mask, gt_boxes, gt_bv, gt_classes, gt_valid,
                     parts: int = 3) -> torch.Tensor:
    """Launch pass 1: (B, G) int32, the float32 bits of each gt's best IoU
    over the included anchors of its class, -1 for padding and where no such
    anchor exists (`decode_gt_max` turns them into floats). One kernel launch
    behind a memset of the result; `parts` is for timing them apart (bit 0
    the memset, bit 1 the kernel) and gives a wrong result unless it is 3."""
    _check(tables, mask, gt_boxes, gt_bv, gt_classes, gt_valid)
    b, g = gt_valid.shape
    bits = torch.empty((b, g), dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):  # the runtime launches on the current device
        err = _lib().det3d_matcher_gt_max(
            tables.anchors_bv.data_ptr(), tables.chunk_bv.data_ptr(), mask.data_ptr(), gt_bv.data_ptr(),
            gt_classes.data_ptr(), gt_valid.data_ptr(), tables.class_start.data_ptr(),
            tables.class_start.shape[0] - 1, b, tables.anchors.shape[0], g, tables.chunk_bv.shape[0],
            parts, bits.data_ptr(), torch.cuda.current_stream(mask.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"matcher.cu gt-max failed with CUDA error {err}")
    if parts & 2:
        gt_max_counter.launches += 1
    return bits


def decode_gt_max(bits: torch.Tensor) -> torch.Tensor:
    """Pass 1's bits → float32 best IoUs, -1 where there is none."""
    return torch.where(bits < 0, -1.0, bits.view(torch.float32))


def assign_cuda(tables: MatcherTables, mask, gt_boxes, gt_bv, gt_classes, gt_valid, gmax_bits,
                early: bool = False):
    """Launch pass 2 with pass 1's `gmax_bits`: labels (B, A) int32,
    targets (B, 7, A) float32, weights (B, A) float32, dirs (B, A) int32.
    `early` lets it start while the kernel before it on the stream still
    runs; it waits for that kernel before it reads `gmax_bits` or ends, and
    reads its other inputs at once. So pass `early` only where that kernel
    is pass 1 (which has waited for whatever made those inputs), as
    `match_cuda` does."""
    _check(tables, mask, gt_boxes, gt_bv, gt_classes, gt_valid)
    b, g = gt_valid.shape
    if tuple(gmax_bits.shape) != (b, g) or gmax_bits.dtype != torch.int32 or not gmax_bits.is_contiguous():
        raise ValueError(f"gmax_bits must be contiguous ({b}, {g}) int32")
    a = tables.anchors.shape[0]
    dev = mask.device
    labels = torch.empty((b, a), dtype=torch.int32, device=dev)
    targets = torch.empty((b, 7, a), dtype=torch.float32, device=dev)
    weights = torch.empty((b, a), dtype=torch.float32, device=dev)
    dirs = torch.empty((b, a), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the runtime launches on the current device
        err = _lib().det3d_matcher_assign(
            tables.anchors_t.data_ptr(), tables.anchors_bv.data_ptr(), tables.chunk_bv.data_ptr(),
            mask.data_ptr(), gt_boxes.data_ptr(), gt_bv.data_ptr(), gt_classes.data_ptr(), gt_valid.data_ptr(),
            gmax_bits.data_ptr(), tables.class_start.data_ptr(), tables.thresholds.data_ptr(),
            tables.class_start.shape[0] - 1, b, a, g, tables.chunk_bv.shape[0],
            int(early),
            labels.data_ptr(), targets.data_ptr(), weights.data_ptr(), dirs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"matcher.cu assign failed with CUDA error {err}")
    assign_counter.launches += 1
    return labels, targets, weights, dirs


def match_cuda(tables: MatcherTables, mask, gt_boxes, gt_bv, gt_classes, gt_valid):
    """Both passes on CUDA tensors. mask (B, A) bool; gt_boxes (B, G, 7),
    gt_bv (B, G, 4) their standup boxes, gt_classes (B, G) int32 1-based,
    gt_valid (B, G) bool. Returns labels (B, A) int32, targets (B, 7, A)
    float32, weights (B, A) float32 and dirs (B, A) int32."""
    bits = gt_max_bits_cuda(tables, mask, gt_boxes, gt_bv, gt_classes, gt_valid)
    return assign_cuda(tables, mask, gt_boxes, gt_bv, gt_classes, gt_valid, bits, early=ASSIGN_EARLY)
