"""Headless 3D scene rendering: software-projected rotatable views.

The port's copy of the JAX package's `viewer/render3d.py`, the counterpart
of the reference's OpenGL scene navigation (reference:
viewer/glwidget.py:112-160 — the orbit camera is parameterized by
(elevation, azimuth, distance, center) with a perspective projection
`get_C(fov, w, h)`; viewer/glwidget.py:276 `boxes3d` draws 12-edge box
wireframes; bbox_plot.py colors). The same camera model projects to a
matplotlib Agg canvas: points are depth-sorted and size-attenuated, box
wireframes are painter-sorted by center depth, and the FP/FN coloring is
shared with the BEV renderer (its IoUs in torch on `device`). A
"rotatable" scene is a sweep of azimuths (`render_orbit`), as the GL
widget's drag orbit is used for inspection.

Camera convention (glwidget.get_RT): the camera sits on a sphere of
`distance` around `center`; azimuth rotates around +z, elevation lifts off
the xy-plane; the view axis points at the center. Lidar boxes are
[x y z l w h yaw] with z-bottom origin (ops/geometry.center_to_corner_box3d).
"""

from __future__ import annotations

from pathlib import Path

import matplotlib
import numpy as np

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.collections import LineCollection  # noqa: E402

from det3d_tpu_torch.viewer.render import (  # noqa: E402
    DT_COLOR,
    FN_COLOR,
    FP_COLOR,
    GT_COLOR,
    match_fp_fn,
)

_BOX3D_EDGES = np.array(
    [
        (0, 1), (1, 2), (2, 3), (3, 0),   # bottom face
        (4, 5), (5, 6), (6, 7), (7, 4),   # top face
        (0, 4), (1, 5), (2, 6), (3, 7),   # verticals
    ],
    np.int32,
)


def box_corners_3d(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) lidar [x y z l w h yaw] → (N, 8, 3) corners, z-bottom origin,
    yaw about +z (numpy twin of ops/geometry.center_to_corner_box3d's
    default, reference box_torch_ops.py:302-326)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    if boxes.size == 0:
        return np.zeros((0, 8, 3))
    # unit cube corners, bottom face first (matches _BOX3D_EDGES)
    unit = np.array(
        [
            [0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0],
            [0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1],
        ],
        np.float64,
    ) - np.array([0.5, 0.5, 0.0])
    corners = unit[None] * boxes[:, None, 3:6]
    s, c = np.sin(boxes[:, 6]), np.cos(boxes[:, 6])
    rot = np.zeros((len(boxes), 3, 3))
    rot[:, 0, 0], rot[:, 0, 1] = c, s
    rot[:, 1, 0], rot[:, 1, 1] = -s, c
    rot[:, 2, 2] = 1.0
    return np.einsum("npi,nij->npj", corners, rot) + boxes[:, None, :3]


class OrbitCamera:
    """Spherical orbit camera + pinhole projection (glwidget.get_RT/get_C).

    `azimuth`/`elevation` in degrees; `fov` is the vertical field of view."""

    def __init__(
        self,
        azimuth: float = -60.0,
        elevation: float = 35.0,
        distance: float = 90.0,
        center=(0.0, 0.0, 0.0),
        fov: float = 60.0,
    ):
        self.azimuth = float(azimuth)
        self.elevation = float(elevation)
        self.distance = float(distance)
        self.center = np.asarray(center, np.float64)
        self.fov = float(fov)

    @property
    def eye(self) -> np.ndarray:
        az, el = np.deg2rad(self.azimuth), np.deg2rad(self.elevation)
        d = self.distance
        return self.center + d * np.array(
            [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
        )

    def world_to_camera(self, pts: np.ndarray) -> np.ndarray:
        """(N, 3) world → camera frame: +z into the scene (view axis),
        +x right, +y down (image convention)."""
        fwd = self.center - self.eye
        fwd = fwd / np.linalg.norm(fwd)
        # world +z is "up" unless looking straight down
        up = np.array([0.0, 0.0, 1.0])
        if abs(fwd @ up) > 0.999:
            up = np.array([1.0, 0.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)  # completes the right-handed basis
        rot = np.stack([right, down, fwd])  # rows = camera axes
        return (np.asarray(pts, np.float64) - self.eye) @ rot.T

    def project(self, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(N, 3) world → ((N, 2) normalized image coords, (N,) depth).
        Points behind the camera get depth <= 0 (caller culls)."""
        cam = self.world_to_camera(pts)
        z = cam[:, 2]
        f = 1.0 / np.tan(np.deg2rad(self.fov) / 2)
        with np.errstate(divide="ignore", invalid="ignore"):
            xy = cam[:, :2] * (f / np.where(z > 1e-6, z, np.nan))[:, None]
        return xy, z


class Scene3DRenderer:
    """Composable projected-3D figure: points, 3D box wireframes, FP/FN."""

    def __init__(
        self,
        camera: OrbitCamera | None = None,
        figsize: float = 12.0,
        background: str = "#101018",
        device=None,
    ):
        """`device`: where the FP/FN match computes its IoUs."""
        self.camera = camera or OrbitCamera()
        self.device = device
        self.fig, self.ax = plt.subplots(
            figsize=(figsize, figsize * 0.75), facecolor=background
        )
        self.ax.set_facecolor(background)
        # fixed frustum window: x spans ±aspect, y (down) spans ±1
        self.ax.set_xlim(-4.0 / 3.0, 4.0 / 3.0)
        self.ax.set_ylim(1.0, -1.0)  # +y is down in camera coords
        self.ax.set_aspect("equal")
        self.ax.axis("off")

    def points(self, points: np.ndarray, size: float = 2.0):
        """Depth-sorted, size-attenuated point cloud; intensity colormap
        (column 3) like the BEV renderer."""
        points = np.asarray(points)
        xy, z = self.camera.project(points[:, :3])
        keep = np.isfinite(xy).all(axis=1) & (z > 1e-6)
        xy, z = xy[keep], z[keep]
        inten = points[keep, 3] if points.shape[1] > 3 else None
        order = np.argsort(-z)  # far first so near points draw on top
        s = size * np.clip(self.camera.distance / (z[order] + 1e-6), 0.05, 4.0)
        self.ax.scatter(
            xy[order, 0], xy[order, 1],
            s=s, c=None if inten is None else inten[order],
            cmap="viridis", linewidths=0, rasterized=True, alpha=0.8,
        )
        return self

    def boxes(self, boxes: np.ndarray, color: str, width: float = 1.4, labels=None):
        """12-edge wireframes + roofline heading tick, painter-sorted by
        center depth (glwidget.boxes3d's inspection surface)."""
        boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
        if boxes.size == 0:
            return self
        corners = box_corners_3d(boxes)                     # (N, 8, 3)
        # heading tick: top-face center → middle of the front top edge
        top_center = corners[:, 4:8].mean(axis=1)
        front_top = (corners[:, 6] + corners[:, 7]) / 2
        _, zc = self.camera.project(boxes[:, :3])
        segs, seg_z = [], []
        for i in np.argsort(-zc):                            # far boxes first
            if zc[i] <= 1e-6:                                # behind camera
                continue
            pts3 = np.concatenate([corners[i], [top_center[i], front_top[i]]])
            xy, z = self.camera.project(pts3)
            if not np.isfinite(xy).all() or (z <= 1e-6).any():
                continue  # box straddles the camera plane — cull whole box
            for a, b in _BOX3D_EDGES:
                segs.append([xy[a], xy[b]])
            segs.append([xy[8], xy[9]])
            seg_z.append(zc[i])
            if labels is not None:
                self.ax.annotate(
                    str(labels[i]), xy[4], color=color, fontsize=6,
                    xytext=(2, 2), textcoords="offset points",
                )
        if segs:
            self.ax.add_collection(
                LineCollection(segs, colors=color, linewidths=width)
            )
        return self

    def detections_vs_gt(self, gt_boxes, dt_boxes, scores=None, iou_thresh=0.3):
        """Same FP/FN coloring as the BEV renderer (matching is BEV IoU,
        reference viewer.py:667-694) on the projected scene."""
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 7)
        dt_boxes = np.asarray(dt_boxes, np.float32).reshape(-1, 7)
        is_fp, is_fn = match_fp_fn(gt_boxes, dt_boxes, iou_thresh, self.device)
        self.boxes(gt_boxes[~is_fn], GT_COLOR)
        self.boxes(gt_boxes[is_fn], FN_COLOR, width=2.0)
        lab = None if scores is None else [f"{s:.2f}" for s in np.asarray(scores)[~is_fp]]
        self.boxes(dt_boxes[~is_fp], DT_COLOR, labels=lab)
        self.boxes(dt_boxes[is_fp], FP_COLOR, width=2.0)
        return self

    def title(self, text: str):
        cam = self.camera
        self.ax.set_title(
            f"{text}   az {cam.azimuth:.0f}°  el {cam.elevation:.0f}°  "
            f"d {cam.distance:.0f} m",
            color="#c0c0c0", fontsize=10,
        )
        return self

    def save(self, path: str | Path, dpi: int = 120) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self.fig.savefig(
            path, dpi=dpi, bbox_inches="tight",
            facecolor=self.fig.get_facecolor(),
        )
        plt.close(self.fig)
        return path


def render_scene_3d(
    points: np.ndarray,
    gt_boxes: np.ndarray | None = None,
    dt_boxes: np.ndarray | None = None,
    scores: np.ndarray | None = None,
    out_path: str | Path = "scene3d.png",
    camera: OrbitCamera | None = None,
    title: str | None = None,
    device=None,
) -> Path:
    """One-call projected-scene render (the 3D screenshot path)."""
    r = Scene3DRenderer(camera, device=device).points(points)
    if gt_boxes is not None and dt_boxes is not None:
        r.detections_vs_gt(gt_boxes, dt_boxes, scores)
    elif gt_boxes is not None:
        r.boxes(np.asarray(gt_boxes).reshape(-1, 7), GT_COLOR)
    elif dt_boxes is not None:
        r.boxes(np.asarray(dt_boxes).reshape(-1, 7), DT_COLOR)
    if title:
        r.title(title)
    return r.save(out_path)


def render_orbit(
    points: np.ndarray,
    gt_boxes: np.ndarray | None = None,
    dt_boxes: np.ndarray | None = None,
    scores: np.ndarray | None = None,
    out_dir: str | Path = "orbit/",
    n_views: int = 8,
    elevation: float = 35.0,
    distance: float = 90.0,
    center=(0.0, 0.0, 0.0),
    device=None,
) -> list[Path]:
    """Azimuth sweep — the headless equivalent of dragging the GL orbit
    camera around the scene; assemble into a turntable video offline."""
    out_dir = Path(out_dir)
    paths = []
    for i in range(n_views):
        az = 360.0 * i / n_views
        cam = OrbitCamera(az, elevation, distance, center)
        paths.append(
            render_scene_3d(
                points, gt_boxes, dt_boxes, scores,
                out_path=out_dir / f"az{az:05.1f}.png",
                camera=cam, title=f"view {i + 1}/{n_views}", device=device,
            )
        )
    return paths
