"""Pillar voxelization on the device (PyTorch, static shapes, no host sync).

Counterpart of the JAX package's `ops/voxelize.voxelize` (reference:
framework/voxel_generator.py:82-106), in both of its slot orders. The
outputs — `voxels`, `coors`, `num_points_per_voxel`, `voxel_num` — are
bit-identical to it. With `fcfs=True` (the default, the reference's order):

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

With `fcfs=False` the slots follow cell-id order, one sort fewer:

  1. as above, one stable sort of the cell ids, the sentinel last;
  2. segment heads as above; a running max of the head positions gives each
     point's segment start (its place in its pillar), a running sum of the
     heads its pillar's slot;
  3. three scatters — the points, each kept head's coordinates and a count
     per kept point — write the buffers; a dropped row (an invalid point,
     a pillar past `max_voxels`, a point past `max_num_points`) goes to a
     sentinel row past the end, which is cut off.

When `max_voxels` binds, this order keeps the pillars of the lowest cell
ids, not the first to occur; under the cap both orders keep the same
pillars with the same points, in other slots.

Known, documented divergence (kept from the JAX package): when the pillar
cap binds, the reference stops consuming points entirely at the first
over-cap new cell (voxel_generator.py:96-97 `break`), dropping later points
even for already-open pillars; this version keeps filling open pillars to
their point cap. The kept pillar set is identical.
"""

from __future__ import annotations

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


def grid_tensors(spec: VoxelizerSpec, device: torch.device):
    """The grid's voxel size, offset and size as tensors on `device`, for
    the caller to make once and hold (`DetectorModule` keeps them as
    buffers): a tensor made from a Python list copies to the card and waits
    for it, which would stall every frame."""
    return (
        torch.tensor(spec.voxel_size, dtype=torch.float32, device=device),
        torch.tensor(spec.offset, dtype=torch.float32, device=device),
        torch.tensor(spec.grid_size, dtype=torch.int32, device=device),
    )


def point_cell_coords(points: torch.Tensor, grid):
    """Per-point integer cell coordinate and in-grid flag (floor-divide
    binning of reference voxel_generator.py:89-92); `grid` is
    `grid_tensors(spec, points.device)`."""
    voxel_size, offset, size = grid
    coor = torch.floor((points[:, :3] - offset) / voxel_size).to(torch.int32)
    inside = ((coor >= 0) & (coor < size)).all(dim=-1)
    return coor, inside


def voxelize(points: torch.Tensor, num_points: torch.Tensor | int, spec: VoxelizerSpec,
             grid, *, fcfs: bool = True) -> VoxelizedFrame:
    """Bin a padded point cloud into dense pillar buffers.

    Args:
      points: (max_points, C) float32; rows at and beyond `num_points` are
        padding. `max_points` must be at least `spec.max_voxels`.
      num_points: the true point count (int or 0-dim tensor).
      spec: static voxelization parameters.
      grid: the grid's (voxel size, offset, size) tensors on the points'
        device, `grid_tensors(spec, points.device)`.
      fcfs: pillar slots in first-occurrence order (the reference's pillar
        selection under the `max_voxels` cap) at the cost of a second sort;
        with `fcfs=False` slots follow cell-id order.
    """
    n, c = points.shape
    if n < spec.max_voxels:
        raise ValueError(f"points has {n} rows, fewer than max_voxels={spec.max_voxels}")
    dev = points.device
    nx, ny, nz = spec.grid_size
    num_cells = nx * ny * nz
    mv, mp = spec.max_voxels, spec.max_num_points

    coor, inside = point_cell_coords(points, grid)
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
    if not fcfs:
        return _cell_id_ordered(spoints, coor[order], svalid, head, pos, voxel_num, spec)

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


def _cell_id_ordered(spoints, scoor, svalid, head, pos, voxel_num, spec: VoxelizerSpec) -> VoxelizedFrame:
    """The `fcfs=False` buffers from the cell-sorted points: slot = the
    pillar's rank in cell-id order, place = the point's arrival rank in its
    pillar (the stable sort kept arrival order); rows that no slot keeps
    land on a sentinel row past the end, cut off after each scatter."""
    c = spoints.shape[1]
    mv, mp = spec.max_voxels, spec.max_num_points
    seg_start = torch.cummax(torch.where(head, pos, -1), 0).values
    place = pos - seg_start
    slot = torch.cumsum(head, 0) - 1                  # -1 before the first head
    keep = svalid & (slot < mv) & (place < mp)
    flat = torch.where(keep, slot * mp + place, mv * mp)
    voxels = spoints.new_zeros((mv * mp + 1, c))
    voxels[flat] = spoints
    head_slot = torch.where(head & (slot < mv), slot, mv)
    coors = scoor.new_full((mv + 1, 3), -1)
    coors[head_slot] = scoor
    counts = torch.zeros(mv + 1, dtype=torch.int32, device=spoints.device)
    counts.index_add_(0, torch.where(keep, slot, mv), torch.ones_like(slot, dtype=torch.int32))
    return VoxelizedFrame(voxels[:mv * mp].reshape(mv, mp, c), coors[:mv], counts[:mv], voxel_num)
