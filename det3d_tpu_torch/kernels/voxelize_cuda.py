"""Pillar voxelization of a batch: the CUDA kernels' wrapper and the op `det3d::voxelize`.

`voxelize_batch(points, num_points, spec, fcfs)` bins B padded clouds
(points (B, max_points, C) float32, counts (B,)) into the `VoxelizedFrame`
fields with a leading B. It calls the PyTorch custom op `det3d::voxelize`,
so `torch.export` records it as one node and a CUDA graph captures its
launches: on a CPU tensor it runs the plain version, `ops.voxelize.voxelize`
frame by frame, stacked; on a CUDA tensor it launches `csrc/voxelize.cu`
(six launches, one call for the batch, nothing read back to the host) or
raises for input the kernels do not take; its fake gives the outputs'
shapes, dtypes and strides. The outputs are bit-identical to the plain
version's in both slot orders. The kernels replace no Pallas kernel: the
JAX package leaves voxelization to XLA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from det3d_tpu_torch.kernels import build
from det3d_tpu_torch.ops.voxelize import VoxelizedFrame, VoxelizerSpec, grid_tensors, voxelize

THREADS = 256  # csrc/voxelize.cu's block
TILE = THREADS * 4  # rows (first-occurrence order) or cells (cell-id order) of a scan tile
MAX_POINTS_PER_VOXEL = 1536  # a fill block's 8 slots x max_num_points rows in 48 KB of shared memory

# calls of the CUDA kernels: one per `det3d::voxelize` call on a CUDA tensor
counter = build.LaunchCounter()


# --- the plain version -----------------------------------------------------------


def _spec(voxel_size, offset, grid_size, max_voxels: int, max_num_points: int) -> VoxelizerSpec:
    return VoxelizerSpec(tuple(float(v) for v in voxel_size), tuple(float(v) for v in offset),
                         tuple(int(v) for v in grid_size), int(max_voxels), int(max_num_points))


def _empty(points: torch.Tensor, max_voxels: int, max_num_points: int) -> tuple[torch.Tensor, ...]:
    """Uninitialised outputs of the op's shapes and dtypes."""
    b, _, c = points.shape
    i32 = dict(dtype=torch.int32, device=points.device)
    return (points.new_empty((b, max_voxels, max_num_points, c)), torch.empty((b, max_voxels, 3), **i32),
            torch.empty((b, max_voxels), **i32), torch.empty((b,), **i32))


def voxelize_plain(points: torch.Tensor, num_points: torch.Tensor, voxel_size, offset, grid_size, max_voxels: int,
                   max_num_points: int, fcfs: bool) -> tuple[torch.Tensor, ...]:
    """The plain version, on any device: `ops.voxelize.voxelize` of each
    frame, stacked."""
    spec = _spec(voxel_size, offset, grid_size, max_voxels, max_num_points)
    if points.shape[0] == 0:
        return _empty(points, spec.max_voxels, spec.max_num_points)
    grid = grid_tensors(spec, points.device)
    frames = [voxelize(points[i], num_points[i], spec, grid, fcfs=fcfs) for i in range(points.shape[0])]
    return tuple(torch.stack(x) for x in zip(*frames))


# --- the kernels ----------------------------------------------------------------


class Plan(NamedTuple):
    """The kernels' int32 scratch, one buffer: each part's offset in words
    (16-byte aligned), and the words in all."""

    tiles: int       # scan tiles a frame
    slots: int       # (B, max_voxels, 4): cell, segment offset, points, fill
    table: int       # (B, cells, 2): first row (then the slot), points
    tile_sums: int   # (B, tiles, 2): heads, points
    seg: int         # (B, max_points): row indices by pillar
    words: int


def plan(batch: int, rows: int, cells: int, max_voxels: int, fcfs: bool) -> Plan:
    tiles = -(-(rows if fcfs else cells) // TILE)
    sizes = (batch * max_voxels * 4, batch * cells * 2, batch * tiles * 2, batch * rows)
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += -(-size // 4) * 4
    return Plan(tiles, *offsets, at)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("voxelize")
    fn = lib.det3d_voxelize
    i32, f32 = ctypes.c_int, ctypes.c_float
    fn.argtypes = [ctypes.c_void_p] * 10 + [i32] * 3 + [f32] * 6 + [i32] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_kernel_input(points: torch.Tensor, num_points: torch.Tensor, spec: VoxelizerSpec) -> None:
    """Raise for input the kernels do not take (the device last, so that
    the other checks run on CPU tensors too)."""
    if points.dim() != 3 or points.dtype != torch.float32 or not points.is_contiguous():
        raise ValueError(f"points must be a contiguous (B, max_points, C) float32 tensor, got {points.dtype} "
                         f"{tuple(points.shape)} with strides {points.stride()}")
    b, n, c = points.shape
    if not 1 <= b <= 65535 or c < 3:
        raise ValueError(f"points {tuple(points.shape)}: the kernels take 1 to 65535 frames of at least 3 channels")
    if n < spec.max_voxels:
        raise ValueError(f"points has {n} rows, fewer than max_voxels={spec.max_voxels}")
    if num_points.shape != (b,) or num_points.dtype != torch.int32 or num_points.device != points.device:
        raise ValueError(f"num_points must be ({b},) int32 on {points.device}, got {num_points.dtype} "
                         f"{tuple(num_points.shape)} on {num_points.device}")
    if not 1 <= spec.max_num_points <= MAX_POINTS_PER_VOXEL:
        raise ValueError(f"max_num_points {spec.max_num_points}: the kernels take 1 to {MAX_POINTS_PER_VOXEL}")
    if min(spec.grid_size) < 1 or int(np.prod(spec.grid_size)) >= 2**31:
        raise ValueError(f"grid {spec.grid_size}: the kernels take 1 to 2**31 - 1 cells")
    if points.device.type != "cuda":
        raise ValueError(f"voxelize_cuda needs CUDA tensors, got {points.device}")


def launch(points: torch.Tensor, num_points: torch.Tensor, spec: VoxelizerSpec, fcfs: bool,
           out: tuple[torch.Tensor, ...], scratch: torch.Tensor, p: Plan) -> None:
    """Launch `csrc/voxelize.cu` on checked input into `out` (voxels, coors,
    points per voxel, pillars), uncounted."""
    b, n, c = points.shape
    nx, ny, nz = spec.grid_size
    word = scratch.element_size()
    base = scratch.data_ptr()
    with torch.cuda.device(points.device):  # the runtime launches on the current device
        err = _lib().det3d_voxelize(
            points.data_ptr(), num_points.data_ptr(), *(t.data_ptr() for t in out),
            base + p.slots * word, base + p.table * word, base + p.tile_sums * word, base + p.seg * word,
            b, n, c, *spec.voxel_size, *spec.offset, nx, ny, nz, spec.max_voxels, spec.max_num_points, int(fcfs),
            torch.cuda.current_stream(points.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"voxelize.cu failed with CUDA error {err}")


def voxelize_cuda(points: torch.Tensor, num_points: torch.Tensor, voxel_size, offset, grid_size, max_voxels: int,
                  max_num_points: int, fcfs: bool) -> tuple[torch.Tensor, ...]:
    """Launch `csrc/voxelize.cu` on CUDA tensors: the plain version's
    outputs, bit for bit."""
    spec = _spec(voxel_size, offset, grid_size, max_voxels, max_num_points)
    check_kernel_input(points, num_points, spec)
    b, n, _ = points.shape
    out = _empty(points, spec.max_voxels, spec.max_num_points)
    p = plan(b, n, int(np.prod(spec.grid_size)), spec.max_voxels, fcfs)
    scratch = torch.empty((p.words,), dtype=torch.int32, device=points.device)
    launch(points, num_points, spec, fcfs, out, scratch, p)
    counter.launches += 1
    return out


_SCHEMA = ("(Tensor points, Tensor num_points, float[] voxel_size, float[] offset, int[] grid_size, int max_voxels, "
           "int max_num_points, bool fcfs) -> (Tensor, Tensor, Tensor, Tensor)")
_voxelize_op = torch.library.custom_op("det3d::voxelize", voxelize_plain, mutates_args=(), device_types="cpu",
                                       schema=_SCHEMA)
_voxelize_op.register_kernel("cuda")(voxelize_cuda)
_voxelize_op.register_fake(lambda points, num_points, voxel_size, offset, grid_size, max_voxels, max_num_points, fcfs:
                           _empty(points, max_voxels, max_num_points))


def counts_tensor(num_points, batch: int, device: torch.device) -> torch.Tensor:
    """The frames' point counts as a (batch,) int32 tensor on `device`: a
    count on the device stays there (nothing is read back); a host count
    of one frame becomes a fill on the device, no copy."""
    if not isinstance(num_points, torch.Tensor):
        num_points = torch.as_tensor(np.asarray(num_points), dtype=torch.int32)
    if num_points.numel() == 1 and num_points.device.type == "cpu" and device.type != "cpu":
        return torch.full((batch,), int(num_points), dtype=torch.int32, device=device)
    return num_points.to(device=device, dtype=torch.int32).reshape(batch)


def voxelize_batch(points: torch.Tensor, num_points, spec: VoxelizerSpec, fcfs: bool = True) -> VoxelizedFrame:
    """B padded clouds (B, max_points, C) and their counts (B,) → the
    `VoxelizedFrame` fields with a leading B: the kernels on a CUDA tensor,
    the plain version on a CPU tensor (the op `det3d::voxelize`)."""
    counts = counts_tensor(num_points, points.shape[0], points.device)
    return VoxelizedFrame(*_voxelize_op(points, counts, [float(v) for v in spec.voxel_size],
                                        [float(v) for v in spec.offset], [int(v) for v in spec.grid_size],
                                        int(spec.max_voxels), int(spec.max_num_points), bool(fcfs)))
