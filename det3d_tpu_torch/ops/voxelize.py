"""Pillar voxelization on the device (PyTorch, static shapes, no host sync).

Counterpart of the JAX package's `ops/voxelize.voxelize` with `fcfs=True`
(reference: framework/voxel_generator.py:82-106). The outputs — `voxels`,
`coors`, `num_points_per_voxel`, `voxel_num` — are bit-identical to it:

  1. every point gets a linear cell id; out-of-range and padding points get
     a sentinel that sorts last;
  2. a stable sort groups points by cell while keeping arrival order inside
     each cell, so "the first `max_num_points` points of each pillar" is the
     reference's;
  3. segment heads are where the sorted id changes; a second sort of the
     heads by arrival index gives the pillar slots in first-occurrence order
     (reference-identical pillar selection when `max_voxels` binds);
  4. a reverse cumulative min over head positions bounds each segment, and
     one gather fills the dense `(max_voxels, max_num_points, C)` buffer.

Known, documented divergence (kept from the JAX package): when the pillar
cap binds, the reference stops consuming points entirely at the first
over-cap new cell (voxel_generator.py:96-97 `break`), dropping later points
even for already-open pillars; this version keeps filling open pillars to
their point cap. The kept pillar set is identical.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from det3d_tpu_torch.config import Config


class VoxelizerSpec(NamedTuple):
    """Static voxelization parameters."""

    voxel_size: tuple[float, float, float]
    offset: tuple[float, float, float]          # snapped detection offset
    grid_size: tuple[int, int, int]             # (nx, ny, nz)
    max_voxels: int
    max_num_points: int

    @classmethod
    def from_config(cls, cfg: Config) -> "VoxelizerSpec":
        return cls(
            voxel_size=tuple(cfg.voxel_size),
            offset=tuple(cfg.detection_offset),
            grid_size=tuple(cfg.grid_size),
            max_voxels=cfg.max_voxels,
            max_num_points=cfg.max_num_points,
        )


class VoxelizedFrame(NamedTuple):
    """Fixed-shape voxelization result for one frame, padded to
    `max_voxels`; `coors` rows of unused slots are -1."""

    voxels: torch.Tensor             # (max_voxels, max_num_points, C) float32
    coors: torch.Tensor              # (max_voxels, 3) int32; -1 on empty slots
    num_points_per_voxel: torch.Tensor  # (max_voxels,) int32
    voxel_num: torch.Tensor          # () int32


@functools.cache
def _grid_tensors(spec: VoxelizerSpec, device: torch.device):
    """The grid's voxel size, offset and size as tensors on `device`, made
    once: a tensor made from a Python list copies to the card and waits for
    it, which would stall every frame."""
    return (
        torch.tensor(spec.voxel_size, dtype=torch.float32, device=device),
        torch.tensor(spec.offset, dtype=torch.float32, device=device),
        torch.tensor(spec.grid_size, dtype=torch.int32, device=device),
    )


def point_cell_coords(points: torch.Tensor, spec: VoxelizerSpec):
    """Per-point integer cell coordinate and in-grid flag (floor-divide
    binning of reference voxel_generator.py:89-92)."""
    voxel_size, offset, grid = _grid_tensors(spec, points.device)
    coor = torch.floor((points[:, :3] - offset) / voxel_size).to(torch.int32)
    inside = ((coor >= 0) & (coor < grid)).all(dim=-1)
    return coor, inside


def voxelize(points: torch.Tensor, num_points: torch.Tensor | int, spec: VoxelizerSpec) -> VoxelizedFrame:
    """Bin a padded point cloud into dense pillar buffers.

    Args:
      points: (max_points, C) float32; rows at and beyond `num_points` are
        padding. `max_points` must be at least `spec.max_voxels`.
      num_points: the true point count (int or 0-dim tensor).
      spec: static voxelization parameters.
    """
    n, c = points.shape
    if n < spec.max_voxels:
        raise ValueError(f"points has {n} rows, fewer than max_voxels={spec.max_voxels}")
    dev = points.device
    nx, ny, nz = spec.grid_size
    num_cells = nx * ny * nz
    mv, mp = spec.max_voxels, spec.max_num_points

    coor, inside = point_cell_coords(points, spec)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    valid = inside & (pos < num_points)

    cell_id = coor[:, 0] * (ny * nz) + coor[:, 1] * nz + coor[:, 2]
    cell_id = torch.where(valid, cell_id, num_cells)  # sentinel sorts last

    sid, order = torch.sort(cell_id, stable=True)
    spoints = points[order]
    svalid = sid < num_cells

    prev = torch.cat([sid.new_full((1,), -1), sid[:-1]])
    head = (sid != prev) & svalid                 # first point of each pillar
    voxel_num = torch.clamp(head.sum(dtype=torch.int32), max=mv)

    # first-occurrence slot order: heads keyed by their arrival index sort
    # to the front; the sort's indices are the heads' sorted positions
    head_key = torch.where(head, order, n)
    headpos = torch.sort(head_key, stable=True).indices[:mv]
    valid_slot = torch.arange(mv, device=dev) < voxel_num

    # exclusive suffix-min of head positions → end of each head's segment,
    # clamped to the valid-point count (sentinel points sort last)
    total_valid = svalid.sum()
    arr = torch.where(head, pos, n)
    suffix_min = torch.flip(torch.cummin(torch.flip(arr, [0]), 0).values, [0])
    next_head = torch.cat([suffix_min[1:], suffix_min.new_full((1,), n)])
    seg_end = torch.minimum(next_head[headpos], total_valid)
    counts = torch.where(
        valid_slot, torch.clamp(seg_end - headpos, max=mp), 0
    ).to(torch.int32)

    # coors derived arithmetically from the sorted cell id
    sid_slot = sid[headpos]
    cx = sid_slot // (ny * nz)
    rem = sid_slot % (ny * nz)
    coors = torch.where(
        valid_slot[:, None],
        torch.stack([cx, rem // nz, rem % nz], dim=1),
        -1,
    ).to(torch.int32)

    # slot s's points are rows [headpos[s], headpos[s] + counts[s]) of spoints
    slot = torch.arange(mp, device=dev)
    rows = torch.clamp(headpos[:, None] + slot[None, :], max=n - 1)
    keep = slot[None, :] < counts[:, None]
    voxels = torch.where(keep[..., None], spoints[rows], 0.0)
    return VoxelizedFrame(voxels, coors, counts, voxel_num)
