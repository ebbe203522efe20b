"""Anchor occupancy culling via a BEV summed-area table (PyTorch).

Counterpart of the JAX package's `ops/anchor_mask.py` (reference:
framework/box_np_ops.py:159-257): a scatter-add occupancy image, two
cumulative sums, and a 4-corner lookup per anchor. The SAT holds integer
counts far below 2^24, so every value is exact and the masks are
element-identical to the JAX ones. The corner cells are precomputed on the
host (`anchors.anchor_corner_cells`).
"""

from __future__ import annotations

import torch


def occupancy_sat(coors: torch.Tensor, grid_xy: tuple[int, int]) -> torch.Tensor:
    """Pillar coords (max_voxels, 3) int32, -1 rows dropped → (nx, ny)
    float32 summed-area table of the BEV occupancy image."""
    nx, ny = grid_xy
    used = coors[:, 0] >= 0
    cx = torch.where(used, coors[:, 0], 0).long()
    cy = torch.where(used, coors[:, 1], 0).long()
    occ = torch.zeros((nx, ny), dtype=torch.float32, device=coors.device)
    # unused rows add 0.0 at (0, 0): a no-op that keeps the shapes static
    occ.index_put_((cx, cy), used.to(torch.float32), accumulate=True)
    return torch.cumsum(torch.cumsum(occ, dim=0), dim=1)


def anchors_mask_from_sat(sat: torch.Tensor, corner_cells: torch.Tensor) -> torch.Tensor:
    """4-corner SAT lookup per anchor → bool mask (N,): the reference's
    inclusive-SAT expression `ID - IB - IC + IA > 0`, verbatim."""
    minx, miny, maxx, maxy = (corner_cells[:, i].long() for i in range(4))
    id_ = sat[maxx, maxy]
    ia = sat[minx, miny]
    ib = sat[maxx, miny]
    ic = sat[minx, maxy]
    return (id_ - ib - ic + ia) > 0


def compute_anchors_mask(coors: torch.Tensor, corner_cells: torch.Tensor, grid_xy) -> torch.Tensor:
    """Pillar coords → flat per-anchor occupancy mask (N,)."""
    return anchors_mask_from_sat(occupancy_sat(coors, grid_xy), corner_cells)


def anchors_mask_from_sat_separable(sat: torch.Tensor, index_vectors) -> torch.Tensor:
    """Separable SAT lookup: the same expression evaluated with row and
    column takes per anchor channel. `index_vectors` holds, per channel,
    (rows_min, rows_max, cols_min, cols_max) long tensors on the SAT's
    device. Output is spatial anchor-major (C, fx, fy)."""
    masks = []
    for rows_min, rows_max, cols_min, cols_max in index_vectors:
        t = sat[rows_max] - sat[rows_min]              # (fx, ny)
        m = t[:, cols_max] - t[:, cols_min]            # (fx, fy)
        masks.append(m > 0)
    return torch.stack(masks, dim=0)


def compute_anchors_mask_separable(coors: torch.Tensor, index_vectors, grid_xy) -> torch.Tensor:
    return anchors_mask_from_sat_separable(occupancy_sat(coors, grid_xy), index_vectors)
