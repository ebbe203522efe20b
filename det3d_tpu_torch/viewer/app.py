"""Scene viewer application: browse info + detection pickles, save frames.

The port's copy of the JAX package's `viewer/app.py`, the counterpart of
the reference's `PCViewer` (reference: viewer.py:34-695):
loads a data_info pickle and an optional detection-annos pickle, renders any
frame (points + gt + detections with FP/FN coloring + optional
anchors/voxels), and batch-exports frames — the headless equivalent of the
reference's screenshot/video capture (viewer.py:86-104). The voxel overlay
runs the port's voxelizer on the viewer's device ("cuda" unless the caller
names another), and so do the FP/FN match and the camera projection.
Driven from the CLI:

    python -m det3d_tpu_torch view --config ... --info data_info.pkl \
        --dt dt.pkl --frames 0:10 --out shots/ [--device cpu]
"""

from __future__ import annotations

import pickle
from pathlib import Path

from typing import TYPE_CHECKING

import numpy as np
import torch

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.utils.device import resolve_device

if TYPE_CHECKING:
    from det3d_tpu_torch.viewer.render import BEVRenderer


def _annos_to_boxes(annos: dict) -> tuple[np.ndarray, np.ndarray]:
    if len(annos.get("name", ())) == 0:
        return np.zeros((0, 7), np.float32), np.zeros((0,), np.float32)
    boxes = np.concatenate(
        [annos["location"], annos["dimensions"], annos["rotation_y"][..., None]],
        axis=1,
    ).astype(np.float32)
    scores = np.asarray(annos.get("score", np.zeros(len(boxes))), np.float32)
    return boxes, scores


class SceneViewer:
    def __init__(
        self,
        cfg: Config,
        info_path: str | Path | None = None,
        dt_path: str | Path | None = None,
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.infos: list[dict] = []
        self.dt_annos: list[dict] | None = None
        if info_path:
            root = Path(cfg.data_root)
            full = root / info_path if not Path(info_path).is_absolute() else Path(info_path)
            with open(full, "rb") as f:
                self.infos = pickle.load(f)
            for info in self.infos:
                info.setdefault("_info_dir", str(full.parent))
        if dt_path:
            with open(dt_path, "rb") as f:
                self.dt_annos = pickle.load(f)

    def __len__(self) -> int:
        return len(self.infos)

    def _resolve(self, info: dict, key: str) -> Path:
        """data_root-relative first (reference create_info layout), else
        relative to the info pickle's directory (our split layout) — same
        rule as data/dataset.DetectionDataset.resolve_path."""
        path = Path(self.cfg.data_root) / info[key]
        if not path.exists() and "_info_dir" in info:
            alt = Path(info["_info_dir"]) / info[key]
            if alt.exists():
                return alt
        return path

    def load_points(self, info: dict) -> np.ndarray:
        return np.fromfile(
            self._resolve(info, "velodyne_path"), dtype=np.float32
        ).reshape(-1, self.cfg.num_point_features)

    def build_renderer(
        self,
        idx: int,
        *,
        show_anchors: bool = False,
        show_voxels: bool = False,
        fig_ax=None,
    ) -> BEVRenderer:
        """Compose the BEV scene for frame `idx` (points + gt/dt + optional
        overlays) without saving — shared by the batch exporter
        (`render_frame`) and the interactive viewer."""
        from det3d_tpu_torch.viewer.render import BEVRenderer  # matplotlib, with the figure

        info = self.infos[idx]
        points = self.load_points(info)
        dr = self.cfg.detection_range
        r = BEVRenderer((dr[0], dr[1], dr[3], dr[4]), fig_ax=fig_ax, device=self.device).points(points)

        gt_boxes = np.zeros((0, 7), np.float32)
        if "annos" in info:
            gt_boxes, _ = _annos_to_boxes(info["annos"])
        if self.dt_annos is not None:
            dt_boxes, scores = _annos_to_boxes(self.dt_annos[idx])
            r.detections_vs_gt(gt_boxes, dt_boxes, scores)
        elif len(gt_boxes):
            r.boxes(gt_boxes, "#00d000")

        if show_anchors:
            from det3d_tpu_torch.anchors import build_anchors

            r.anchors(build_anchors(self.cfg).anchors)
        if show_voxels:
            r.voxel_grid(self.voxel_coors(points), self.cfg.voxel_size, self.cfg.detection_offset)

        r.title(f"frame {info.get('image_idx', idx)}")
        return r

    @torch.no_grad()
    def voxel_coors(self, points: np.ndarray) -> np.ndarray:
        """The occupied pillars' (max_voxels, 3) integer coordinates, -1 on
        empty slots: the port's voxelizer on the viewer's device, over the
        cloud padded or cut to `max_points`."""
        from det3d_tpu_torch.ops.voxelize import VoxelizerSpec, grid_tensors, voxelize
        from det3d_tpu_torch.utils.npmath import pad_cloud

        spec = VoxelizerSpec.from_config(self.cfg)
        pts, n = pad_cloud(points, self.cfg.max_points)
        frame = voxelize(torch.from_numpy(pts).to(self.device), int(n), spec, grid_tensors(spec, self.device))
        return frame.coors.cpu().numpy()

    def render_frame(
        self,
        idx: int,
        out_path: str | Path,
        *,
        show_anchors: bool = False,
        show_voxels: bool = False,
    ) -> Path:
        return self.build_renderer(
            idx, show_anchors=show_anchors, show_voxels=show_voxels
        ).save(out_path)

    def render_image_frame(self, idx: int, out_path: str | Path) -> Path:
        """Camera panel: the frame's image with projected 3D gt/detection
        wireframes (the reference viewer shows this panel by default,
        reference viewer.py:230-235). Requires img_path + calib in the info;
        gt annos are already lidar-frame (create_info converts at index
        time), which is what the projection expects."""
        import matplotlib.image as mpimg

        from det3d_tpu_torch.viewer.render import render_image_overlay

        info = self.infos[idx]
        if "img_path" not in info:
            raise ValueError(f"frame {idx}: info has no img_path (lidar-only dataset?)")
        missing = [
            k for k in ("calib/P2", "calib/R0_rect", "calib/Tr_velo_to_cam")
            if k not in info
        ]
        if missing:
            raise ValueError(
                f"frame {idx}: info lacks {missing} — cannot project boxes"
            )
        image = mpimg.imread(str(self._resolve(info, "img_path")))

        gt_boxes = None
        if "annos" in info:
            gt_boxes, _ = _annos_to_boxes(info["annos"])
        dt_boxes = None
        if self.dt_annos is not None:
            dt_boxes, _ = _annos_to_boxes(self.dt_annos[idx])
        return render_image_overlay(
            image, info, gt_boxes=gt_boxes, dt_boxes=dt_boxes, out_path=out_path, device=self.device
        )

    def _frame_scene(self, idx: int):
        """(points, gt_boxes, dt_boxes, scores) for frame `idx`."""
        info = self.infos[idx]
        points = self.load_points(info)
        gt_boxes = np.zeros((0, 7), np.float32)
        if "annos" in info:
            gt_boxes, _ = _annos_to_boxes(info["annos"])
        dt_boxes = scores = None
        if self.dt_annos is not None:
            dt_boxes, scores = _annos_to_boxes(self.dt_annos[idx])
        return points, gt_boxes, dt_boxes, scores

    def render_frame_3d(
        self,
        idx: int,
        out_path: str | Path,
        *,
        camera=None,
        orbit: int = 0,
    ) -> list[Path]:
        """Projected 3D scene render(s) for frame `idx` — the headless
        counterpart of the reference GL widget's rotatable scene
        (viewer/glwidget.py). `orbit=N` renders an N-view azimuth sweep
        into a per-frame directory instead of one PNG."""
        from det3d_tpu_torch.viewer.render3d import render_orbit, render_scene_3d

        points, gt_boxes, dt_boxes, scores = self._frame_scene(idx)
        title = f"frame {self.infos[idx].get('image_idx', idx)}"
        if orbit:
            cam = camera
            return render_orbit(
                points, gt_boxes, dt_boxes, scores,
                out_dir=Path(out_path).with_suffix(""), n_views=orbit,
                elevation=cam.elevation if cam else 35.0,
                distance=cam.distance if cam else 90.0,
                center=cam.center if cam else (0.0, 0.0, 0.0), device=self.device,
            )
        return [
            render_scene_3d(
                points, gt_boxes, dt_boxes, scores,
                out_path=out_path, camera=camera, title=title, device=self.device,
            )
        ]

    def export_frames(
        self, indices, out_dir: str | Path, *, image: bool = False,
        mode: str = "bev", camera=None, orbit: int = 0, **kw
    ) -> list[Path]:
        out_dir = Path(out_dir)
        paths = []
        for i in indices:
            stem = f"{self.infos[i].get('image_idx', i):06d}"
            if mode == "3d":
                paths.extend(
                    self.render_frame_3d(
                        i, out_dir / f"{stem}_3d.png", camera=camera, orbit=orbit
                    )
                )
            else:
                paths.append(self.render_frame(i, out_dir / f"{stem}.png", **kw))
            if image:
                paths.append(self.render_image_frame(i, out_dir / f"{stem}_cam.png"))
        return paths


class InteractiveViewer:
    """Keyboard-driven scene navigation — the headless-compatible counterpart
    of the reference's Qt control panel (reference viewer/control_panel.py:
    frame spin-box/prev/next, anchor + voxel checkboxes, screenshot button).

    Keys: ←/→ (or j/k) step frames, home/end jump, a anchors, v voxels,
    s screenshot to `out_dir`, q close. The handler logic is backend-agnostic
    (testable under Agg); `run()` needs an interactive matplotlib backend and
    raises a clear error when only Agg is available (e.g. no display).
    """

    def __init__(self, viewer: SceneViewer, start: int = 0, out_dir: str | Path = "shots"):
        if len(viewer) == 0:
            raise ValueError("no frames: SceneViewer has an empty info list")
        import matplotlib.pyplot as plt

        self.viewer = viewer
        self.idx = int(np.clip(start, 0, len(viewer) - 1))
        self.out_dir = Path(out_dir)
        self.show_anchors = False
        self.show_voxels = False
        self.fig, self.ax = plt.subplots(figsize=(12.0, 12.0))
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self.redraw()

    def redraw(self) -> None:
        self.viewer.build_renderer(
            self.idx,
            show_anchors=self.show_anchors,
            show_voxels=self.show_voxels,
            fig_ax=(self.fig, self.ax),
        )
        self.fig.canvas.draw_idle()

    def handle_key(self, key: str) -> None:
        n = len(self.viewer)
        if key in ("right", "k"):
            self.idx = (self.idx + 1) % n
        elif key in ("left", "j"):
            self.idx = (self.idx - 1) % n
        elif key == "home":
            self.idx = 0
        elif key == "end":
            self.idx = n - 1
        elif key == "a":
            self.show_anchors = not self.show_anchors
        elif key == "v":
            self.show_voxels = not self.show_voxels
        elif key == "s":
            stem = f"{self.viewer.infos[self.idx].get('image_idx', self.idx):06d}"
            self.out_dir.mkdir(parents=True, exist_ok=True)
            path = self.out_dir / f"{stem}_interactive.png"
            self.fig.savefig(path, dpi=120, facecolor=self.fig.get_facecolor())
            print(f"saved {path}")
            return  # no redraw needed
        elif key == "q":
            import matplotlib.pyplot as plt

            plt.close(self.fig)
            return
        else:
            return
        self.redraw()

    def _on_key(self, event) -> None:
        if event.key:
            self.handle_key(event.key)

    def run(self) -> None:
        import matplotlib
        import matplotlib.pyplot as plt

        backend = matplotlib.get_backend()
        try:
            from matplotlib.backends import backend_registry

            gui = backend_registry.resolve_backend(backend)[1]
            interactive = gui not in (None, "headless")
        except Exception:
            # older matplotlib: fall back to the canvas capability probe
            interactive = self.fig.canvas.manager is not None and hasattr(
                self.fig.canvas.manager, "show"
            )
        if not interactive or backend.lower() == "agg":
            raise RuntimeError(
                f"interactive viewing needs a GUI matplotlib backend "
                f"({backend} is non-interactive) — set MPLBACKEND/DISPLAY, or "
                "use the batch exporter: cli view --frames a:b --out DIR"
            )
        plt.show()
