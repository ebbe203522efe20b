"""Dataset: pickled info lists + .bin point clouds → host samples (numpy).

The port's own copy of the JAX package's data/dataset.py (reference:
GenericDataset / InferData, framework/dataset.py:13-231). `__getitem__`
does host IO and augmentation only; voxelization, the anchor mask and
target assignment run on the device (`pipeline.Detector`, `targets`).
Class remapping as the reference's (dataset.py:45-84): car/truck/bus →
vehicle, person → pedestrian, bicycle/motorbike → cyclist; gt with no lidar
point are dropped. Nothing here imports torch, so that spawned prefetcher
workers start quickly and never touch the card.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.data import augment as agm
from det3d_tpu_torch.utils.npmath import limit_period_np

_CLASS_REMAP = {
    "car": "vehicle",
    "truck": "vehicle",
    "bus": "vehicle",
    "person": "pedestrian",
    "bicycle": "cyclist",
    "motorbike": "cyclist",
}


def remap_class_names(infos: list[dict]) -> list[dict]:
    """In-place raw → detect class remap and zero-point gt drop
    (reference framework/dataset.py:45-84, train.py:165-184 changeInfo)."""
    for info in infos:
        annos = info.get("annos")
        if annos is None or len(annos.get("name", ())) == 0:
            continue
        if "num_points" in annos:
            keep = annos["num_points"] > 0
            for key in annos:
                annos[key] = annos[key][keep]
        names = annos["name"].astype("<U16")
        for raw, mapped in _CLASS_REMAP.items():
            names[names == raw] = mapped
        annos["name"] = names
    return infos


def _filter_gt_outside_range_np(gt_boxes, bv_range):
    """Boxes with at least one BEV corner inside `bv_range` (x0, y0, x1, y1)."""
    corners = agm.box2d_corners_np(gt_boxes[:, [0, 1, 3, 4, 6]].astype(np.float64))
    cx = np.array(
        [[bv_range[0], bv_range[1]], [bv_range[0], bv_range[3]],
         [bv_range[2], bv_range[3]], [bv_range[2], bv_range[1]]]
    )
    inside = agm._points_in_quad(corners.reshape(-1, 2), cx)
    return inside.reshape(-1, 4).any(axis=1)


class DetectionDataset:
    """Map-style dataset over info pickles under `cfg.data_root`."""

    def __init__(self, cfg: Config, info_paths, training: bool = True, augment: bool = True,
                 seed: int | None = None, device_global_augment: bool = False):
        self.cfg = cfg
        self.data_root = Path(cfg.data_root)
        self.training = training
        self.augment = augment and training
        # the trainer applies the global transforms on the device
        # (Trainer(device_global_augment=True)): the host chain keeps only
        # the per-object noise, so nothing is augmented twice
        self.device_global_augment = device_global_augment
        self.rng = np.random.RandomState(seed)
        self.infos: list[dict] = []
        for p in info_paths:
            with open(self.data_root / p, "rb") as f:
                split = pickle.load(f)
            # data paths may be data_root-relative (the reference's
            # create_info layout) or relative to the pickle's own directory
            # ("velodyne/<id>.bin" beside data_info.pkl)
            info_dir = str((self.data_root / p).parent)
            for info in split:
                info.setdefault("_info_dir", info_dir)
            self.infos += split
        remap_class_names(self.infos)

    def __len__(self) -> int:
        return len(self.infos)

    def resolve_path(self, info: dict, key: str = "velodyne_path") -> Path:
        """data_root-relative first (reference layout), else relative to the
        info pickle's own directory."""
        path = self.data_root / info[key]
        if not path.exists() and "_info_dir" in info:
            alt = Path(info["_info_dir"]) / info[key]
            if alt.exists():
                return alt
        return path

    def load_points(self, info: dict) -> np.ndarray:
        return np.fromfile(self.resolve_path(info), dtype=np.float32).reshape(-1, self.cfg.num_point_features)

    def __getitem__(self, idx: int) -> dict:
        info = self.infos[idx]
        points = self.load_points(info)
        sample = {"points": points, "info": info}
        if not self.training:
            return sample

        annos = info["annos"]
        names = annos["name"]
        class_mask = np.array([n in self.cfg.detect_class for n in names], bool)
        gt_classes = np.array([list(self.cfg.detect_class).index(n) + 1 for n in names[class_mask]], np.int32)
        gt_boxes = np.concatenate(
            [annos["location"][class_mask], annos["dimensions"][class_mask],
             annos["rotation_y"][class_mask][..., None]],
            axis=1,
        ).astype(np.float32)

        on_device = self.augment and self.device_global_augment
        if self.augment:
            gt_boxes, points = agm.augment_sample(points, gt_boxes, rng=self.rng, global_transforms=not on_device)

        dr = np.asarray(self.cfg.detection_range)
        if on_device:
            # the reference filters after the transforms, and they run on the
            # device, so the trainer applies the exact range filter and the
            # yaw wrap there. Here only boxes that no transform can bring back
            # into range go, so that they take none of the max_gt_boxes slots:
            # flips and rotations keep a corner's radius, the scale shrinks it
            # by at most GLOBAL_SCALE_MIN and the clipped translation moves it
            # by at most GLOBAL_TRANSLATE_BOUND
            rmax = float(np.hypot(np.abs(dr[[0, 3]]).max(), np.abs(dr[[1, 4]]).max()))
            corners = agm.box2d_corners_np(gt_boxes[:, [0, 1, 3, 4, 6]].astype(np.float64))
            rmin = np.hypot(corners[..., 0], corners[..., 1]).min(axis=1)
            keep = rmin <= (rmax + agm.GLOBAL_TRANSLATE_BOUND) / agm.GLOBAL_SCALE_MIN
            gt_boxes, gt_classes = gt_boxes[keep], gt_classes[keep]
        else:
            # range filter + yaw wrap (reference dataset.py:136-143)
            keep = _filter_gt_outside_range_np(gt_boxes, dr[[0, 1, 3, 4]])
            gt_boxes, gt_classes = gt_boxes[keep], gt_classes[keep]
            gt_boxes[:, 6] = limit_period_np(gt_boxes[:, 6], 0.5, 2 * np.pi)
        # the rows in the order `self.rng.shuffle(points)` leaves them (the
        # same draws), gathered at once instead of swapped one by one
        points = points[self.rng.permutation(len(points))]

        sample.update(points=points, gt_boxes=gt_boxes, gt_classes=gt_classes)
        return sample

    def epoch_order(self, shuffle: bool = True) -> np.ndarray:
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        return order

    def point_reader(self) -> str:
        """Which reader `iter_points_native` uses here: "native" (the C++
        loader's threads) or "numpy" (`numpy.fromfile` in this thread)."""
        from det3d_tpu_torch.data.native_loader import available

        return "native" if available() else "numpy"

    def iter_points_native(self, order: np.ndarray | None = None, num_threads: int = 4):
        """Yield (info, padded_points, n) with the disk reads in the native
        loader's C++ threads, overlapping the consumer's device work
        (inference; training uses __getitem__, whose augmentation needs the
        gt). Where the library is unavailable, `numpy.fromfile` reads in
        this thread (`point_reader()` says which)."""
        from det3d_tpu_torch.data.native_loader import AsyncPointCloudLoader

        idxs = order if order is not None else np.arange(len(self))
        if self.point_reader() == "numpy":
            for i in idxs:
                info = self.infos[i]
                pts = self.load_points(info)
                n = min(len(pts), self.cfg.max_points)
                out = np.zeros((self.cfg.max_points, pts.shape[1]), np.float32)
                out[:n] = pts[:n]
                yield info, out, n
            return
        with AsyncPointCloudLoader(self.cfg.max_points, self.cfg.num_point_features, queue_depth=8,
                                   num_threads=num_threads) as ld:
            for i in idxs:
                ld.submit(self.resolve_path(self.infos[i]))
            ld.finish()
            for i in idxs:
                pts, n = ld.next()
                yield self.infos[i], pts, n
