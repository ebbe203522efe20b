"""Headless BEV scene rendering (matplotlib Agg).

The port's copy of the JAX package's `viewer/render.py`, the counterpart of
the reference's PyQt5/pyqtgraph OpenGL viewer (reference: viewer.py:34-695,
viewer/bbox_plot.py, viewer/views.py): the point cloud, gt against
detection boxes with FP/FN coloring by BEV IoU (viewer.py:667-694
`get_false_pos_neg`), the anchors overlay (viewer.py:370-380) and the
voxel-grid occupancy overlay (viewer/views.py:192 `draw_voxels`) render to
PNG. The drawing is numpy on the host; the BEV IoU of the FP/FN match
(`ops/rotated_iou`) and the camera projection of 3D boxes (`ops/geometry`)
run in torch on `device` ("cuda" unless the caller names another).

Colors follow the reference (bbox_plot.py): gt green, detections yellow,
false positives red, false negatives orange.
"""

from __future__ import annotations

from pathlib import Path

import matplotlib
import numpy as np

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import torch  # noqa: E402
from matplotlib.collections import LineCollection  # noqa: E402

GT_COLOR = "#00d000"
DT_COLOR = "#e0c000"
FP_COLOR = "#e02020"
FN_COLOR = "#ff8800"
ANCHOR_COLOR = "#3060ff"


def _box_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) [x y z l w h yaw] → (N, 4, 2) BEV corners."""
    if boxes.size == 0:
        return np.zeros((0, 4, 2), np.float32)
    corners_norm = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32) - 0.5
    corners = boxes[:, None, [3, 4]] * corners_norm[None]
    s, c = np.sin(boxes[:, 6]), np.cos(boxes[:, 6])
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
    return np.einsum("npi,nij->npj", corners, rot) + boxes[:, None, :2]


def _box_segments(corners: np.ndarray) -> np.ndarray:
    """(N, 4, 2) corners + heading tick → (N*5, 2, 2) line segments."""
    if corners.size == 0:
        return np.zeros((0, 2, 2), np.float32)
    closed = np.concatenate([corners, corners[:, :1]], axis=1)  # (N, 5, 2)
    edges = np.stack([closed[:, :-1], closed[:, 1:]], axis=2)   # (N, 4, 2, 2)
    # heading tick: center → middle of the +x edge (corners 2-3)
    center = corners.mean(axis=1)
    front = (corners[:, 2] + corners[:, 3]) / 2
    ticks = np.stack([center, front], axis=1)[:, None]           # (N, 1, 2, 2)
    return np.concatenate([edges, ticks], axis=1).reshape(-1, 2, 2)


def match_fp_fn(gt_boxes: np.ndarray, dt_boxes: np.ndarray, iou_thresh: float = 0.3,
                device=None) -> tuple[np.ndarray, np.ndarray]:
    """(is_fp per dt, is_fn per gt) by greedy BEV-IoU matching (reference
    viewer.py:667-694); the IoUs on `device`."""
    if len(dt_boxes) == 0:
        return np.zeros((0,), bool), np.ones((len(gt_boxes),), bool)
    if len(gt_boxes) == 0:
        return np.ones((len(dt_boxes),), bool), np.zeros((0,), bool)
    from det3d_tpu_torch.ops.rotated_iou import rotate_iou_eval_np

    iou = rotate_iou_eval_np(dt_boxes[:, [0, 1, 3, 4, 6]].astype(np.float32),
                             gt_boxes[:, [0, 1, 3, 4, 6]].astype(np.float32), device=device)
    matched_gt = np.zeros(len(gt_boxes), bool)
    is_fp = np.ones(len(dt_boxes), bool)
    for d in np.argsort(-iou.max(axis=1)):
        g = int(np.argmax(iou[d]))
        if iou[d, g] >= iou_thresh and not matched_gt[g]:
            matched_gt[g] = True
            is_fp[d] = False
    return is_fp, ~matched_gt


class BEVRenderer:
    """Composable BEV figure: points, boxes, anchors, voxel grid."""

    def __init__(self, detection_range=(-80, -80, 80, 80), figsize: float = 12.0, background: str = "#101018",
                 fig_ax=None, device=None):
        """`fig_ax=(fig, ax)` reuses an existing figure (cleared) instead of
        creating one — the interactive viewer redraws into the same window;
        `device`: where the FP/FN match computes its IoUs."""
        self.range = detection_range
        self.device = device
        if fig_ax is not None:
            self.fig, self.ax = fig_ax
            self.ax.clear()
            self.fig.set_facecolor(background)
        else:
            self.fig, self.ax = plt.subplots(figsize=(figsize, figsize), facecolor=background)
        self.ax.set_facecolor(background)
        self.ax.set_xlim(self.range[0], self.range[2])
        self.ax.set_ylim(self.range[1], self.range[3])
        self.ax.set_aspect("equal")
        self.ax.tick_params(colors="#808080", labelsize=8)

    def points(self, points: np.ndarray, size: float = 0.3):
        """Intensity-colored point cloud (column 3 if present)."""
        c = points[:, 3] if points.shape[1] > 3 else None
        self.ax.scatter(points[:, 0], points[:, 1], s=size, c=c, cmap="viridis", linewidths=0, rasterized=True)
        return self

    def boxes(self, boxes: np.ndarray, color: str, width: float = 1.2, labels=None):
        segs = _box_segments(_box_corners_bev(np.asarray(boxes, np.float32)))
        self.ax.add_collection(LineCollection(segs, colors=color, linewidths=width))
        if labels is not None:
            for b, text in zip(boxes, labels):
                self.ax.annotate(str(text), (b[0], b[1]), color=color, fontsize=6, xytext=(2, 2),
                                 textcoords="offset points")
        return self

    def detections_vs_gt(self, gt_boxes, dt_boxes, scores=None, iou_thresh=0.3):
        """Detections + gt with FP/FN coloring (reference draw_detection +
        get_false_pos_neg, viewer.py:276-340, :667-694)."""
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 7)
        dt_boxes = np.asarray(dt_boxes, np.float32).reshape(-1, 7)
        is_fp, is_fn = match_fp_fn(gt_boxes, dt_boxes, iou_thresh, self.device)
        self.boxes(gt_boxes[~is_fn], GT_COLOR)
        self.boxes(gt_boxes[is_fn], FN_COLOR, width=1.8)
        lab = None if scores is None else [f"{s:.2f}" for s in np.asarray(scores)[~is_fp]]
        self.boxes(dt_boxes[~is_fp], DT_COLOR, labels=lab)
        self.boxes(dt_boxes[is_fp], FP_COLOR, width=1.8)
        return self

    def anchors(self, anchors: np.ndarray, stride: int = 500):
        """Sparse anchor overlay (the reference draws all 1.44M; subsample)."""
        self.boxes(np.asarray(anchors)[::stride], ANCHOR_COLOR, width=0.3)
        return self

    def voxel_grid(self, coors: np.ndarray, voxel_size, offset):
        """Occupied-pillar overlay from integer coords (-1 rows skipped)."""
        coors = np.asarray(coors)
        live = coors[coors[:, 0] >= 0]
        x = live[:, 0] * voxel_size[0] + offset[0] + voxel_size[0] / 2
        y = live[:, 1] * voxel_size[1] + offset[1] + voxel_size[1] / 2
        self.ax.scatter(x, y, s=1.0, c="#e020e0", marker="s", linewidths=0)
        return self

    def title(self, text: str):
        self.ax.set_title(text, color="#c0c0c0", fontsize=10)
        return self

    def save(self, path: str | Path, dpi: int = 120) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self.fig.savefig(path, dpi=dpi, bbox_inches="tight", facecolor=self.fig.get_facecolor())
        plt.close(self.fig)
        return path


_BOX3D_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),   # bottom face
    (4, 5), (5, 6), (6, 7), (7, 4),   # top face
    (0, 4), (1, 5), (2, 6), (3, 7),   # verticals
]


@torch.no_grad()
def project_boxes_to_image(boxes_lidar: np.ndarray, rect: np.ndarray, velo2cam: np.ndarray, p2: np.ndarray,
                           image_shape: tuple[int, int] | None = None, device=None) -> np.ndarray:
    """Lidar boxes (N, 7) [x y z l w h yaw] → (M, 8, 2) image-plane corner
    sets, in float32 on `device`.

    Reproduces the reference viewer's gt-in-image projection
    (viewer.py:457-508 `draw_gt_in_image`): camera transform (rect =
    calib/R0_rect, velo2cam = calib/Tr_velo_to_cam, both 4x4), behind-camera
    cull (z > 0), 3D corners, P2 projection, and the any-corner-inside image
    crop when `image_shape` (h, w) is given."""
    from det3d_tpu_torch.ops import geometry
    from det3d_tpu_torch.utils.device import resolve_device

    boxes_lidar = np.asarray(boxes_lidar, np.float64).reshape(-1, 7)
    if boxes_lidar.size == 0:
        return np.zeros((0, 8, 2))
    device = resolve_device(device)
    boxes = torch.as_tensor(boxes_lidar, dtype=torch.float32, device=device)
    cam = geometry.box_lidar_to_camera(boxes, rect, velo2cam)
    cam = cam[cam[:, 2] > 0]
    if cam.shape[0] == 0:
        return np.zeros((0, 8, 2))
    unit = geometry.unit_corners_3d((0.5, 1.0, 0.5), device, torch.float32)
    corners = geometry.center_to_corner_box3d(cam[:, :3], cam[:, 3:6], cam[:, 6], unit, axis=1)
    pts = geometry.project_to_image(corners.reshape(-1, 3), p2).reshape(-1, 8, 2).cpu().numpy()
    if image_shape is not None:
        h, w = image_shape[:2]
        inside = ((pts[..., 0] > 0) & (pts[..., 0] < w) & (pts[..., 1] > 0) & (pts[..., 1] < h)).any(axis=1)
        pts = pts[inside]
    return pts


def render_image_overlay(image: np.ndarray, calib: dict, gt_boxes: np.ndarray | None = None,
                         dt_boxes: np.ndarray | None = None, out_path: str | Path = "overlay.png",
                         device=None) -> Path:
    """Camera image with projected 3D box wireframes (reference
    viewer.py:230-235 `plot_image` + :457-508 + bbox_plot.draw_3d_bbox_in_ax).

    `calib` keys follow create_info: 'calib/R0_rect', 'calib/Tr_velo_to_cam',
    'calib/P2'. gt drawn green, detections yellow."""
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.imshow(image)
    ax.axis("off")
    for boxes, color in ((gt_boxes, GT_COLOR), (dt_boxes, DT_COLOR)):
        if boxes is None or len(boxes) == 0:
            continue
        pts = project_boxes_to_image(boxes, calib["calib/R0_rect"], calib["calib/Tr_velo_to_cam"],
                                     calib["calib/P2"], image.shape[:2], device)
        segs = [[pts[i, a], pts[i, b]] for i in range(len(pts)) for a, b in _BOX3D_EDGES]
        ax.add_collection(LineCollection(segs, colors=color, linewidths=1.0))
    path = Path(out_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def render_sequence(frames, out_dir: str | Path, detection_range=(-80, -80, 80, 80), device=None) -> list[Path]:
    """Batch/video capture: render an iterable of frame dicts to numbered
    PNGs (reference viewer.py:443-449 `on_saveVideoPressed` walks frames and
    screenshots each).

    Each frame dict: {'points', optional 'gt_boxes', 'dt_boxes', 'scores',
    'title'}."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return [render_scene(f["points"], gt_boxes=f.get("gt_boxes"), dt_boxes=f.get("dt_boxes"),
                         scores=f.get("scores"), out_path=out_dir / f"frame_{i:05d}.png",
                         detection_range=detection_range, title=f.get("title", f"frame {i}"), device=device)
            for i, f in enumerate(frames)]


def render_scene(points: np.ndarray, gt_boxes: np.ndarray | None = None, dt_boxes: np.ndarray | None = None,
                 scores: np.ndarray | None = None, out_path: str | Path = "scene.png",
                 detection_range=(-80, -80, 80, 80), title: str | None = None, device=None) -> Path:
    """One-call scene render (the common screenshot path)."""
    r = BEVRenderer(detection_range, device=device).points(points)
    if gt_boxes is not None and dt_boxes is not None:
        r.detections_vs_gt(gt_boxes, dt_boxes, scores)
    elif gt_boxes is not None:
        r.boxes(np.asarray(gt_boxes).reshape(-1, 7), GT_COLOR)
    elif dt_boxes is not None:
        r.boxes(np.asarray(dt_boxes).reshape(-1, 7), DT_COLOR)
    if title:
        r.title(title)
    return r.save(out_path)
