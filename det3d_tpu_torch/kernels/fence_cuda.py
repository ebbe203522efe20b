"""The train step's fence: an identity copy whose gradient passes through.

Counterpart of `s2b_fence` in the JAX package (kernels/fence_pallas.py,
`_copy_kernel`, VJP `_fence_bwd`): the JAX train step wraps `cls_preds` in
it, and so does the port's (`train/trainer.py`). `s2b_fence` dispatches on
the device of its input: a CUDA tensor launches `csrc/fence.cu`, a CPU
tensor takes the plain version, `x.clone(memory_format=
torch.contiguous_format)`. Either way the forward result is a new contiguous
tensor bit-equal to `x`, and the backward hands the cotangent back unchanged.

`csrc/fence.cu` holds three kernels; `copy_plan` picks one from the shape of
the strides alone (it runs on CPU tensors too): `contiguous` (16 bytes per
thread), `transpose` (the source's unit-stride run is not the output's
unit-stride axis, as in the head's channels-last `cls_preds` view: tiles go
through shared memory and leave as 16-byte stores) and `generic` (one element
per thread). `route_launches` counts the launches of each.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from det3d_tpu_torch.kernels import build

MAX_RANK = 6
ROUTES = ("contiguous", "transpose", "generic")  # the index is the C function's `route`
VEC_BYTES = 16  # a thread's store in the contiguous and transpose kernels
MAX_TILE = 128  # pixels of a transpose tile: one batch of loads per thread at `cls_preds`' 9 channels
TILE_BYTES = 48 * 1024  # shared memory a transpose tile may take

# launches of the CUDA kernels: one per forward on a CUDA tensor, and the
# same launches by the kernel that ran
counter = build.LaunchCounter()
route_launches: collections.Counter[str] = collections.Counter()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fence")
    fn = lib.det3d_fence_copy
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def fence_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version, on any device: a contiguous copy (a bare `clone`
    of a view that is not dense keeps the view's stride order)."""
    return x.clone(memory_format=torch.contiguous_format)


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


class CopyPlan(NamedTuple):
    """Which kernel of `csrc/fence.cu` copies a tensor, and over what."""

    route: str  # one of ROUTES
    sizes: list[int]  # the iteration space (`_iteration_layout`)
    src: list[int]
    dst: list[int]
    inner: int = 0  # transpose: trailing axes that form the source's unit-stride run (1 or 2)
    tile: int = 0  # transpose: pixels per block, a power of two
    row: int = 0  # transpose: elements per shared-memory row


def copy_plan(x: torch.Tensor) -> CopyPlan:
    """The kernel for `x`, from its shape, strides and element size.

    One merged unit-stride axis is `contiguous`. `transpose` needs the
    ordered axes to end in (..., P, run): P has output stride 1, and the run
    is one axis of source stride 1 or two axes that are contiguous in the
    source (the head's (anchor, k) pair), small enough that 16 pixels of it
    fit a tile. The tile is the largest power of two up to MAX_TILE pixels
    that fits TILE_BYTES, no larger than P needs; its rows are padded to an
    odd number of 16-byte pieces. Anything else is `generic`."""
    sizes, src, dst = _iteration_layout(x)
    if not sizes or (len(sizes) == 1 and src[0] == 1):
        return CopyPlan("contiguous", sizes, src, dst)
    elt = x.element_size()
    for inner in (1, 2):
        pixel = len(sizes) - inner - 1
        if pixel < 0 or src[-1] != 1 or dst[pixel] != 1 or (inner == 2 and src[-2] != sizes[-1]):
            continue
        run = math.prod(sizes[pixel + 1:])
        tile = min(MAX_TILE, max(VEC_BYTES, 1 << (sizes[pixel] - 1).bit_length()))
        while tile > VEC_BYTES and run * (tile * elt + VEC_BYTES) > TILE_BYTES:
            tile //= 2
        if run * (tile * elt + VEC_BYTES) > TILE_BYTES:
            continue
        pieces = tile * elt // VEC_BYTES
        row = tile + (VEC_BYTES // elt if pieces % 2 == 0 else 0)
        return CopyPlan("transpose", sizes, src, dst, inner, tile, row)
    return CopyPlan("generic", sizes, src, dst)


def fence_copy_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/fence.cu`: a contiguous copy of a CUDA tensor of any
    dtype and at most 6 axes, by the kernel that `copy_plan` names."""
    if x.device.type != "cuda":
        raise ValueError(f"fence_copy_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() > MAX_RANK:
        raise ValueError(f"the fence copies at most {MAX_RANK} axes, got {x.dim()}")
    if x.element_size() not in (1, 2, 4, 8) or x.is_complex():
        raise TypeError(f"unsupported dtype {x.dtype}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    plan = copy_plan(x)
    arrays = [(ctypes.c_int64 * MAX_RANK)(*v) for v in (plan.sizes, plan.src, plan.dst)]
    with torch.cuda.device(x.device):  # the runtime launches on the current device
        err = _lib().det3d_fence_copy(
            x.data_ptr(), out.data_ptr(), x.numel(), x.element_size(), ROUTES.index(plan.route), len(plan.sizes),
            *(ctypes.addressof(a) for a in arrays), plan.inner, plan.tile, plan.row,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fence.cu ({plan.route}) failed with CUDA error {err}")
    counter.launches += 1
    route_launches[plan.route] += 1
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
    """Identity through a contiguous copy: the CUDA kernel for CUDA tensors,
    `fence_copy_plain` for CPU tensors; the gradient passes through."""
    return _Fence.apply(x)
