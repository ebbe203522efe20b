"""BEV canvas scatter: the CUDA kernel's wrapper and its plain version.

Pillar features (B, V, C) and pillar coordinates (B, V, 3) become the dense,
zero-initialised canvas (B, nx, ny, C): row v lands on cell (x, y) =
coors[b, v, :2]; rows whose x is negative (empty pillar slots) are dropped,
and so are rows outside the grid. Cells are unique, so no two rows collide.

Counterpart of `scatter_to_bev_pallas` in the JAX package
(kernels/scatter_pallas.py, `_canvas_kernel`). `scatter_to_bev` dispatches
on the device of its input: a CPU tensor takes `scatter_to_bev_plain`, a
CUDA tensor launches `csrc/scatter.cu`. Forward only for now.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from det3d_tpu_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


# launches of the CUDA kernel: one per `scatter_to_bev` call on CUDA tensors
counter = build.LaunchCounter()


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
    x = coors[..., 0].long()
    y = coors[..., 1].long()
    keep = (x >= 0) & (x < nx) & (y >= 0) & (y < ny)
    bi = torch.arange(b, device=coors.device)[:, None].expand(b, v)
    canvas = pillar_features.new_zeros((b, nx, ny, c))
    canvas[bi[keep], x[keep], y[keep]] = pillar_features[keep]
    return canvas


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("scatter")
    fn = lib.det3d_scatter_to_bev
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
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


def scatter_to_bev(pillar_features: torch.Tensor, coors: torch.Tensor, grid_xy) -> torch.Tensor:
    """(B, V, C) features + (B, V, 3) int32 coords → (B, nx, ny, C) canvas:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if pillar_features.device.type == "cuda":
        return scatter_to_bev_cuda(pillar_features, coors, grid_xy)
    if pillar_features.device.type == "cpu":
        return scatter_to_bev_plain(pillar_features, coors, grid_xy)
    raise ValueError(f"unsupported device {pillar_features.device}")
