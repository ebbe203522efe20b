"""Greedy NMS keep masks: the CUDA kernel's wrapper and its plain version.

Input: boxes (ncls, K, 4) f32 minmax [x1, y1, x2, y2], each class's rows in
descending score order, and valid (ncls, K) bool. Output: keep (ncls, K)
bool, the exact greedy keep set under the +1-pixel-convention IoU of the
reference; the caller applies the `post_max_size` rank cap
(`ops.nms.rank_cap`). A 2-D (K, 4) input is one class.

Counterpart of `nms_keep_pallas` in the JAX package (kernels/nms_pallas.py,
`_nms_kernel`). `nms_keep` dispatches on the device of its input: a CPU
tensor takes `nms_keep_plain` (ops/nms.greedy_keep), a CUDA tensor launches
`csrc/nms.cu`, one block per class in one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from det3d_tpu_torch.kernels import build
from det3d_tpu_torch.ops.nms import greedy_keep

MAX_K = 1024  # csrc/nms.cu keeps one 32-bit word of `removed` per lane

# launches of the CUDA kernel: one per `nms_keep` call on CUDA tensors
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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def nms_keep_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Launch `csrc/nms.cu` on CUDA tensors: all classes in one launch."""
    _check(boxes, valid)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep_cuda needs CUDA tensors, got {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    k = boxes.shape[-2]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} is outside the kernel's range [1, {MAX_K}]")
    ncls = boxes.shape[0] if boxes.dim() == 3 else 1
    keep = torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = _lib().det3d_nms_keep(
        boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), ncls, k, iou_threshold, stream
    )
    if err != 0:
        raise RuntimeError(f"nms.cu failed with CUDA error {err}")
    counter.launches += 1
    return keep


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy keep mask of pre-sorted boxes: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if boxes.device.type == "cuda":
        return nms_keep_cuda(boxes, valid, iou_threshold)
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, valid, iou_threshold)
    raise ValueError(f"unsupported device {boxes.device}")
