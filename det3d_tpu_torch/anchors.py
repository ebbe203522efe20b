"""Anchor grid generation and per-class bookkeeping (host-side numpy, built
once per detector).

The port's own copy of the JAX package's `anchors.py` together with the two
numpy helpers it needs from there (`limit_period_np`, and the SAT corner
cells of `ops/anchor_mask.py`). Per class, for each (size, rotation) pair, a
dense grid of box anchors over the feature map, concatenated into one flat
**anchor-major** set: flat = channel·(fx·fy) + (x·fy + y), channels in
[class][size][rot] order (reference: framework/anchor_assigner.py:284-320).
Row-major flatten of the head's (nch, fx, fy) predictions is this order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from det3d_tpu_torch.config import Config


def limit_period_np(val, offset: float, period: float):
    """Wrap `val` into [-offset·period, (1-offset)·period)
    (reference box_np_ops.limit_period)."""
    return val - np.floor(val / period + offset) * period


def _rbbox2d_to_near_bbox_np(rbboxes: np.ndarray) -> np.ndarray:
    """Rotated BEV box [x, y, xdim, ydim, yaw] → nearest axis-aligned minmax
    box (reference: framework/box_np_ops.py:308-320)."""
    rots = rbboxes[..., -1]
    cond = (np.abs(limit_period_np(rots, 0.5, np.pi)) > np.pi / 4)[..., None]
    dims = np.where(cond, rbboxes[:, [3, 2]], rbboxes[:, [2, 3]])
    centers = rbboxes[:, :2]
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)


def anchor_corner_cells(anchors_bv: np.ndarray, voxel_size, offset, grid_size) -> np.ndarray:
    """Anchor BEV minmax boxes → clipped integer SAT lookup cells (N, 4):
    floor-divide corners into the voxel grid, clamp to [0, grid-1]
    (reference framework/box_np_ops.py:288-305)."""
    stride = np.asarray(voxel_size, np.float32)
    off = np.asarray(offset, np.float32)
    coor = np.empty((anchors_bv.shape[0], 4), np.int32)
    coor[:, 0] = np.floor((anchors_bv[:, 0] - off[0]) / stride[0])
    coor[:, 1] = np.floor((anchors_bv[:, 1] - off[1]) / stride[1])
    coor[:, 2] = np.floor((anchors_bv[:, 2] - off[0]) / stride[0])
    coor[:, 3] = np.floor((anchors_bv[:, 3] - off[1]) / stride[1])
    np.clip(coor[:, 0], 0, None, out=coor[:, 0])
    np.clip(coor[:, 1], 0, None, out=coor[:, 1])
    np.clip(coor[:, 2], None, grid_size[0] - 1, out=coor[:, 2])
    np.clip(coor[:, 3], None, grid_size[1] - 1, out=coor[:, 3])
    return coor


def separable_corner_index_vectors(corner_cells: np.ndarray, grid_hw, num_channels: int):
    """Per anchor channel: (rows_min, rows_max, cols_min, cols_max) index
    vectors, or None if any channel's cells are not row/column-separable.

    Each channel is one regular (fx, fy) grid of equal boxes, so its minx /
    maxx cells depend only on the row and miny / maxy only on the column;
    this extracts (and verifies) that structure from the exact cells."""
    fx, fy = grid_hw
    cells_all = corner_cells.reshape(num_channels, fx, fy, 4)
    out = []
    for ch in range(num_channels):
        cells = cells_all[ch]
        rows_min, cols_min = cells[:, 0, 0], cells[0, :, 1]
        rows_max, cols_max = cells[:, 0, 2], cells[0, :, 3]
        ok = (
            np.array_equal(cells[..., 0], np.broadcast_to(rows_min[:, None], (fx, fy)))
            and np.array_equal(cells[..., 1], np.broadcast_to(cols_min[None, :], (fx, fy)))
            and np.array_equal(cells[..., 2], np.broadcast_to(rows_max[:, None], (fx, fy)))
            and np.array_equal(cells[..., 3], np.broadcast_to(cols_max[None, :], (fx, fy)))
        )
        if not ok:
            return None
        out.append((rows_min, rows_max, cols_min, cols_max))
    return out


@dataclasses.dataclass(frozen=True)
class AnchorSet:
    """The full flat anchor set (anchor-major) plus per-class views."""

    anchors: np.ndarray            # (A, 7) float32  [x,y,z,l,w,h,yaw]
    anchors_bv: np.ndarray         # (A, 4) float32  nearest-axis minmax BEV boxes
    corner_cells: np.ndarray       # (A, 4) int32    SAT lookup cells
    matched_threshold: np.ndarray  # (A,) float32
    unmatched_threshold: np.ndarray  # (A,) float32
    grid_hw: tuple                 # (fx, fy) shared feature-map grid
    num_channels: int              # anchors per location (9 for the default specs)
    class_channels: dict           # name -> (c0, c1) channel range per class
    anchors_by_class: dict         # name -> (fx*fy*(c1-c0), 7) contiguous view
    anchors_bv_by_class: dict      # name -> (fx*fy*(c1-c0), 4) contiguous view
    mask_index_vectors: tuple | None  # separable SAT row/col vectors per channel

    @property
    def num_anchors(self) -> int:
        return self.anchors.shape[0]


def _generate_one(size, rotation, feature_map_size, strides, offsets) -> np.ndarray:
    """One (size, rotation) anchor grid in x-major (meshgrid 'ij') order,
    with z at half the anchor height (reference anchor_assigner.py:300-320)."""
    fx, fy, fz = (int(v) for v in feature_map_size)
    x_stride, y_stride, z_stride = (float(s) for s in strides)
    x_off = float(offsets[0]) + x_stride / 2
    y_off = float(offsets[1]) + y_stride / 2
    z_off = float(size[2]) / 2

    x_centers = np.arange(fx, dtype=np.float32) * x_stride + x_off
    y_centers = np.arange(fy, dtype=np.float32) * y_stride + y_off
    z_centers = np.arange(fz, dtype=np.float32) * z_stride + z_off

    xs, ys, zs = np.meshgrid(x_centers, y_centers, z_centers, indexing="ij")
    out = np.empty((fx, fy, fz, 7), np.float32)
    out[..., 0] = xs
    out[..., 1] = ys
    out[..., 2] = zs
    out[..., 3:6] = np.asarray(size, np.float32)
    out[..., 6] = float(rotation)
    return out.reshape(-1, 7)


def build_anchors(cfg: Config) -> AnchorSet:
    """Build the flat anchor set for all classes, anchor-major."""
    fx, fy, _ = cfg.class_specs[0].feature_map_size
    for spec in cfg.class_specs:
        if tuple(spec.feature_map_size[:2]) != (fx, fy):
            raise ValueError("the shared flat anchor layout requires one feature-map grid")

    channel_grids = []   # per (class, size, rot): (fx*fy, 7) grid
    matched_ch, unmatched_ch = [], []
    class_channels: dict[str, tuple[int, int]] = {}
    for spec in cfg.class_specs:
        c0 = len(channel_grids)
        strides = np.asarray(cfg.detection_range_diff, np.float32) / np.asarray(
            spec.feature_map_size, np.float32
        )
        for size in spec.sizes:
            for rotation in spec.rotations:
                channel_grids.append(
                    _generate_one(size, rotation, spec.feature_map_size, strides, cfg.detection_offset)
                )
                matched_ch.append(spec.matched_threshold)
                unmatched_ch.append(spec.unmatched_threshold)
        class_channels[spec.name] = (c0, len(channel_grids))

    a = len(channel_grids)
    anchors = np.ascontiguousarray(np.concatenate(channel_grids, axis=0))
    anchors_bv = _rbbox2d_to_near_bbox_np(anchors[:, [0, 1, 3, 4, 6]])
    corner_cells = anchor_corner_cells(
        anchors_bv, cfg.voxel_size, cfg.detection_offset, cfg.grid_size
    )

    hw = fx * fy
    anchors_by_class, anchors_bv_by_class = {}, {}
    for name, (c0, c1) in class_channels.items():
        anchors_by_class[name] = anchors[c0 * hw : c1 * hw]
        anchors_bv_by_class[name] = anchors_bv[c0 * hw : c1 * hw]

    vectors = separable_corner_index_vectors(corner_cells, (fx, fy), a)
    return AnchorSet(
        anchors=anchors,
        anchors_bv=anchors_bv,
        corner_cells=corner_cells,
        matched_threshold=np.repeat(np.asarray(matched_ch, np.float32), hw),
        unmatched_threshold=np.repeat(np.asarray(unmatched_ch, np.float32), hw),
        grid_hw=(fx, fy),
        num_channels=a,
        class_channels=class_channels,
        anchors_by_class=anchors_by_class,
        anchors_bv_by_class=anchors_bv_by_class,
        mask_index_vectors=tuple(vectors) if vectors is not None else None,
    )
