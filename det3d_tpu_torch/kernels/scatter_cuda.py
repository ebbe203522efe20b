"""BEV canvas scatter: the CUDA kernel's wrapper and its plain version.

Pillar features (B, V, C) and pillar coordinates (B, V, 3) become the dense,
zero-initialised canvas (B, nx, ny, C): row v lands on cell (x, y) =
coors[b, v, :2]; rows whose x is negative (empty pillar slots) are dropped,
and so are rows outside the grid. Cells are unique, so no two rows collide.

Counterpart of `scatter_to_bev_pallas` in the JAX package
(kernels/scatter_pallas.py, `_canvas_kernel`, and its VJP `_scatter_bwd`).
`scatter_to_bev` is differentiable: its backward gathers each kept row's
cotangent from the canvas (zero for dropped rows). Forward and backward
dispatch on the device of their input: CPU tensors take the plain versions
(`scatter_to_bev_plain`, `scatter_to_bev_bwd_plain`), CUDA tensors launch
`csrc/scatter.cu` (`det3d_scatter_to_bev`, `det3d_scatter_to_bev_bwd`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from det3d_tpu_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


# launches of the CUDA kernels: one per forward / backward on CUDA tensors
counter = build.LaunchCounter()
bwd_counter = build.LaunchCounter()


def _check(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy) -> None:
    if pillar_features.dim() != 3 or coors.dim() != 3 or coors.shape[-1] != 3:
        raise ValueError(
            f"expected feats (B, V, C) and coors (B, V, 3), got "
            f"{tuple(pillar_features.shape)} and {tuple(coors.shape)}"
        )
    if pillar_features.shape[:2] != coors.shape[:2]:
        raise ValueError("feats and coors disagree on (B, V)")
    if pillar_features.dtype not in _DTYPES:
        raise TypeError(f"feats must be float32 or bfloat16, got {pillar_features.dtype}")
    if coors.dtype != torch.int32:
        raise TypeError(f"coors must be int32, got {coors.dtype}")
    if pillar_features.device != coors.device:
        raise ValueError("feats and coors are on different devices")
    if len(grid_xy) != 2 or min(grid_xy) < 1:
        raise ValueError(f"bad grid {grid_xy}")


def scatter_to_bev_plain(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy) -> torch.Tensor:
    """The plain PyTorch scatter, on any device."""
    _check(pillar_features, coors, grid_xy)
    nx, ny = grid_xy
    b, v, c = pillar_features.shape
    bi, x, y, keep = _kept_rows(coors, grid_xy)
    canvas = pillar_features.new_zeros((b, nx, ny, c))
    canvas[bi[keep], x[keep], y[keep]] = pillar_features[keep]
    return canvas


def _kept_rows(coors: torch.Tensor, grid_xy):
    """(batch index, x, y, keep) of every pillar row; `keep` drops empty
    slots and rows outside the grid."""
    nx, ny = grid_xy
    b, v = coors.shape[:2]
    x = coors[..., 0].long()
    y = coors[..., 1].long()
    keep = (x >= 0) & (x < nx) & (y >= 0) & (y < ny)
    bi = torch.arange(b, device=coors.device)[:, None].expand(b, v)
    return bi, x, y, keep


def scatter_to_bev_bwd_plain(grad_canvas: torch.Tensor, coors: torch.Tensor) -> torch.Tensor:
    """The plain backward on any device: (B, nx, ny, C) canvas cotangent →
    (B, V, C) feature cotangent, each kept row's cell gathered, zero
    elsewhere."""
    b, nx, ny, c = grad_canvas.shape
    bi, x, y, keep = _kept_rows(coors, (nx, ny))
    dfeats = grad_canvas.new_zeros((b, coors.shape[1], c))
    dfeats[keep] = grad_canvas[bi[keep], x[keep], y[keep]]
    return dfeats


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("scatter")
    fn = lib.det3d_scatter_to_bev
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bwd = lib.det3d_scatter_to_bev_bwd
    bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib


def scatter_to_bev_cuda(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy) -> torch.Tensor:
    """Launch `csrc/scatter.cu` on CUDA tensors (fill + row copy)."""
    _check(pillar_features, coors, grid_xy)
    if pillar_features.device.type != "cuda":
        raise ValueError(f"scatter_to_bev_cuda needs CUDA tensors, got {pillar_features.device}")
    if not (pillar_features.is_contiguous() and coors.is_contiguous()):
        raise ValueError("feats and coors must be contiguous")
    nx, ny = grid_xy
    b, v, c = pillar_features.shape
    canvas = torch.empty((b, nx, ny, c), dtype=pillar_features.dtype, device=pillar_features.device)
    stream = torch.cuda.current_stream(pillar_features.device).cuda_stream
    err = _lib().det3d_scatter_to_bev(
        pillar_features.data_ptr(), coors.data_ptr(), canvas.data_ptr(),
        b, v, c, pillar_features.element_size(), nx, ny, stream,
    )
    if err != 0:
        raise RuntimeError(f"scatter.cu failed with CUDA error {err}")
    counter.launches += 1
    return canvas


def scatter_to_bev_bwd_cuda(grad_canvas: torch.Tensor, coors: torch.Tensor) -> torch.Tensor:
    """Launch the backward gather of `csrc/scatter.cu` on CUDA tensors. The
    cotangent is read through its strides (channels must be its innermost,
    unit-stride axis), so the channels-last map a convolution hands back is
    never copied."""
    if grad_canvas.dim() != 4 or coors.dim() != 3 or coors.shape[-1] != 3 or grad_canvas.shape[0] != coors.shape[0]:
        raise ValueError(f"expected grad (B, nx, ny, C) and coors (B, V, 3), got "
                         f"{tuple(grad_canvas.shape)} and {tuple(coors.shape)}")
    if grad_canvas.dtype not in _DTYPES or coors.dtype != torch.int32:
        raise TypeError(f"grad must be float32 or bfloat16 and coors int32, got {grad_canvas.dtype}, {coors.dtype}")
    if grad_canvas.device.type != "cuda" or coors.device != grad_canvas.device:
        raise ValueError(f"scatter_to_bev_bwd_cuda needs CUDA tensors, got {grad_canvas.device}, {coors.device}")
    if grad_canvas.stride(3) != 1 and grad_canvas.shape[3] > 1:
        raise ValueError(f"grad must have unit channel stride, got strides {grad_canvas.stride()}")
    if not coors.is_contiguous():
        raise ValueError("coors must be contiguous")
    b, nx, ny, c = grad_canvas.shape
    v = coors.shape[1]
    dfeats = torch.empty((b, v, c), dtype=grad_canvas.dtype, device=grad_canvas.device)
    sb, sx, sy, _ = grad_canvas.stride()
    err = _lib().det3d_scatter_to_bev_bwd(
        grad_canvas.data_ptr(), coors.data_ptr(), dfeats.data_ptr(),
        b, v, c, grad_canvas.element_size(), nx, ny, sb, sx, sy,
        torch.cuda.current_stream(grad_canvas.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"scatter.cu backward failed with CUDA error {err}")
    bwd_counter.launches += 1
    return dfeats


def _on_device(cuda_fn, plain_fn, t: torch.Tensor):
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"unsupported device {t.device}")


class _ScatterToBev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pillar_features, coors, grid_xy):
        ctx.save_for_backward(coors)
        fwd = _on_device(scatter_to_bev_cuda, scatter_to_bev_plain, pillar_features)
        return fwd(pillar_features, coors, grid_xy)

    @staticmethod
    def backward(ctx, grad_canvas):
        (coors,) = ctx.saved_tensors
        bwd = _on_device(scatter_to_bev_bwd_cuda, scatter_to_bev_bwd_plain, grad_canvas)
        return bwd(grad_canvas, coors), None, None


def scatter_to_bev(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy) -> torch.Tensor:
    """(B, V, C) features + (B, V, 3) int32 coords → (B, nx, ny, C) canvas,
    differentiable in the features: the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors."""
    return _ScatterToBev.apply(pillar_features, coors, tuple(grid_xy))
