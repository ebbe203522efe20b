"""Greedy NMS keep masks: the CUDA kernel's wrapper and its plain version.

Input: boxes (ncls, K, 4) f32 minmax [x1, y1, x2, y2], each class's rows in
descending score order, and valid (ncls, K) bool. Output: keep (ncls, K)
bool, the exact greedy keep set under the +1-pixel-convention IoU of the
reference; the caller applies the `post_max_size` rank cap
(`ops.nms.rank_cap`). A 2-D (K, 4) input is one class.

Counterpart of `nms_keep_pallas` in the JAX package (kernels/nms_pallas.py,
`_nms_kernel`). `nms_keep` is the PyTorch custom op `det3d::nms_keep`, so
`torch.export` records it as one node and a CUDA graph captures its
launches: on a CPU tensor it runs `nms_keep_plain` (ops/nms.greedy_keep), on
a CUDA tensor it launches `csrc/nms.cu` (the suppression mask of all
classes over the whole card, then one sweep per class, two launches back to
back for one call) or raises; its fake gives the keep mask's shape (the
mask scratch stays inside the op).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from det3d_tpu_torch.kernels import build
from det3d_tpu_torch.ops.nms import greedy_keep

MAX_K = 1024  # csrc/nms.cu keeps one 32-bit word of `removed` per lane
MASK_ROW_WORDS = MAX_K // 32  # words per row of the suppression mask

# calls of the CUDA kernels: one per `nms_keep` call on CUDA tensors
counter = build.LaunchCounter()


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dim() not in (2, 3) or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (K, 4) or (ncls, K, 4), got {tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:-1]:
        raise ValueError(f"valid {tuple(valid.shape)} does not match boxes {tuple(boxes.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if boxes.device != valid.device:
        raise ValueError("boxes and valid are on different devices")


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The plain PyTorch keep mask, on any device."""
    _check(boxes, valid)
    return greedy_keep(boxes, valid, iou_threshold)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("nms")
    fn = lib.det3d_nms_keep
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def mask_scratch(boxes: torch.Tensor) -> torch.Tensor:
    """The suppression mask's scratch tensor for `boxes`; the kernels write
    every word they read, so it is not initialised."""
    return torch.empty((*boxes.shape[:-1], MASK_ROW_WORDS), dtype=torch.int32, device=boxes.device)


def launch(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float, mask: torch.Tensor, parts: int = 7):
    """Launch `csrc/nms.cu` on checked CUDA tensors, uncounted: both kernels,
    the sweep started early (`parts` 7; 3 starts it only when the mask kernel
    has finished), or only the mask kernel (1) or only the sweep over an
    earlier mask (2), which is how the two are timed apart."""
    k = boxes.shape[-2]
    ncls = boxes.shape[0] if boxes.dim() == 3 else 1
    keep = torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = _lib().det3d_nms_keep(
        boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), mask.data_ptr(), ncls, k, iou_threshold, parts, stream
    )
    if err != 0:
        raise RuntimeError(f"nms.cu failed with CUDA error {err}")
    return keep


def nms_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Launch `csrc/nms.cu` on CUDA tensors: all classes in one call."""
    _check(boxes, valid)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep_cuda needs CUDA tensors, got {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    k = boxes.shape[-2]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} is outside the kernel's range [1, {MAX_K}]")
    keep = launch(boxes, valid, iou_threshold, mask_scratch(boxes))
    counter.launches += 1
    return keep


_nms_op = torch.library.custom_op(
    "det3d::nms_keep", nms_keep_plain, mutates_args=(), device_types="cpu",
    schema="(Tensor boxes, Tensor valid, float iou_threshold) -> Tensor",
)
_nms_op.register_kernel("cuda")(nms_keep_cuda)
_nms_op.register_fake(lambda boxes, valid, iou_threshold: torch.empty_like(valid))


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy keep mask of pre-sorted boxes: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors (the op `det3d::nms_keep`)."""
    _check(boxes, valid)
    return _nms_op(boxes, valid, float(iou_threshold))
