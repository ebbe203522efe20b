"""The train step's fence: an identity copy whose gradient passes through.

Counterpart of `s2b_fence` in the JAX package (kernels/fence_pallas.py,
`_copy_kernel`, VJP `_fence_bwd`): the JAX train step wraps `cls_preds` in
it, and so does the port's (`train/trainer.py`). `s2b_fence` dispatches on
the device of its input: a CUDA tensor launches `csrc/fence.cu`, a CPU
tensor takes the plain version, `x.clone()`. Either way the forward result
is a new tensor bit-equal to `x` (contiguous for the kernel), and the
backward hands the cotangent back unchanged.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from det3d_tpu_torch.kernels import build

MAX_RANK = 6

# launches of the CUDA kernel: one per forward on a CUDA tensor
counter = build.LaunchCounter()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fence")
    fn = lib.det3d_fence_copy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return lib


def fence_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version, on any device."""
    return x.clone()


def _iteration_layout(x: torch.Tensor) -> tuple[list[int], list[int], list[int]]:
    """(sizes, source strides, output strides) of the copy's iteration
    space: unit axes dropped, axes ordered by falling source stride (so
    neighbouring threads read neighbouring source elements), and
    neighbouring axes merged where both strides allow it. The output is
    contiguous in the logical order."""
    out_strides = torch.empty(x.shape, device="meta").stride()
    axes = sorted((d for d in range(x.dim()) if x.shape[d] != 1), key=lambda d: -x.stride(d))
    sizes: list[int] = []
    src: list[int] = []
    dst: list[int] = []
    for d in axes:
        size, s_src, s_dst = x.shape[d], x.stride(d), out_strides[d]
        if sizes and src[-1] == size * s_src and dst[-1] == size * s_dst:
            sizes[-1] *= size
            src[-1], dst[-1] = s_src, s_dst
        else:
            sizes.append(size)
            src.append(s_src)
            dst.append(s_dst)
    return sizes, src, dst


def fence_copy_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/fence.cu`: a contiguous copy of a CUDA tensor of any
    dtype and at most 6 axes."""
    if x.device.type != "cuda":
        raise ValueError(f"fence_copy_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() > MAX_RANK:
        raise ValueError(f"the fence copies at most {MAX_RANK} axes, got {x.dim()}")
    if x.element_size() not in (1, 2, 4, 8) or x.is_complex():
        raise TypeError(f"unsupported dtype {x.dtype}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dims, src, dst = _iteration_layout(x)
    arrays = [(ctypes.c_int64 * MAX_RANK)(*v) for v in (dims, src, dst)]
    err = _lib().det3d_fence_copy(
        x.data_ptr(), out.data_ptr(), x.numel(), x.element_size(), len(dims),
        *(ctypes.addressof(a) for a in arrays), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fence.cu failed with CUDA error {err}")
    counter.launches += 1
    return out


class _Fence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if x.device.type == "cuda":
            return fence_copy_cuda(x)
        if x.device.type == "cpu":
            return fence_copy_plain(x)
        raise ValueError(f"unsupported device {x.device}")

    @staticmethod
    def backward(ctx, grad):
        return grad


def s2b_fence(x: torch.Tensor) -> torch.Tensor:
    """Identity through a copy: the CUDA kernel for CUDA tensors, `clone`
    for CPU tensors; the gradient passes through."""
    return _Fence.apply(x)
