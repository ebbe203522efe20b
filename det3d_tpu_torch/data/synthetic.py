"""Synthetic LiDAR frames made from a seed (numpy only).

The port's own copy of the JAX package's data/synthetic.py generators, so
that the port can make realistic frames where the JAX package is absent:
`sample_scene` (ground plane plus surface-sampled boxes of the three
classes, with exact ground truth), `scene_to_annos` (that ground truth in
the eval annos format), `write_split` (such scenes as a dataset on disk)
and `synthetic_cloud` (a ~100k-point frame with a real sweep's pillar
occupancy)."""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from det3d_tpu_torch.config import Config

# nominal object dims per class (l, w, h) ~ the anchor priors
_CLASS_DIMS = {
    1: ([4.6, 2.1, 1.8], 0.35),     # vehicle
    2: ([0.95, 0.95, 1.8], 0.1),    # pedestrian
    3: ([2.0, 1.0, 1.7], 0.15),     # cyclist
}


def sample_scene(
    cfg: Config,
    rng: np.random.RandomState,
    num_objects: tuple[int, int] = (3, 10),
    points_per_m2: float = 18.0,
    ground_points: int = 18000,
    max_range: float | None = None,
) -> dict:
    """One scene: returns {points, gt_boxes, gt_classes}."""
    lim = max_range or (min(cfg.detection_range[3], cfg.detection_range[4]) * 0.85)
    n_obj = rng.randint(num_objects[0], num_objects[1] + 1)

    boxes, classes, clouds = [], [], []
    for _ in range(n_obj):
        cid = rng.choice([1, 1, 1, 2, 3])  # vehicle-heavy mix
        dims0, jitter = _CLASS_DIMS[cid]
        dims = np.asarray(dims0) * rng.uniform(1 - jitter, 1 + jitter, 3)
        # place without overlap (grid-ish rejection)
        for _try in range(20):
            center = rng.uniform(-lim, lim, 2)
            if all(np.linalg.norm(center - b[:2]) > (dims[0] + b[3]) for b in boxes):
                break
        else:
            continue
        z0 = rng.uniform(-1.9, -1.5)
        yaw = rng.uniform(-np.pi, np.pi)
        box = np.array([center[0], center[1], z0, dims[0], dims[1], dims[2], yaw], np.float32)

        # surface points: density falls off with range
        dist = np.linalg.norm(center)
        area = 2 * (dims[0] * dims[2] + dims[1] * dims[2]) + dims[0] * dims[1]
        n_pts = int(points_per_m2 * area * min(1.0, (18.0 / max(dist, 1.0)) ** 1.5))
        n_pts = max(n_pts, 6)
        # sample on the two visible-ish vertical faces + top
        u = rng.uniform(-0.5, 0.5, (n_pts, 2))
        face = rng.randint(0, 3, n_pts)
        local = np.zeros((n_pts, 3), np.float32)
        local[face == 0] = np.stack(
            [u[face == 0, 0] * dims[0], np.full((face == 0).sum(), -dims[1] / 2),
             (u[face == 0, 1] + 0.5) * dims[2]], -1)
        local[face == 1] = np.stack(
            [np.full((face == 1).sum(), -dims[0] / 2), u[face == 1, 0] * dims[1],
             (u[face == 1, 1] + 0.5) * dims[2]], -1)
        local[face == 2] = np.stack(
            [u[face == 2, 0] * dims[0], u[face == 2, 1] * dims[1],
             np.full((face == 2).sum(), dims[2])], -1)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, s], [-s, c]], np.float32)
        world = np.zeros((n_pts, 4), np.float32)
        world[:, :2] = local[:, :2] @ rot + box[:2]
        world[:, 2] = local[:, 2] + z0
        world[:, 3] = rng.uniform(0.2, 0.9, n_pts)
        world[:, :3] += rng.normal(0, 0.02, (n_pts, 3))

        boxes.append(box)
        classes.append(cid)
        clouds.append(world)

    # ground plane with radial density falloff
    g_dist = np.abs(rng.randn(ground_points)) * lim * 0.4 + 2.0
    g_theta = rng.uniform(-np.pi, np.pi, ground_points)
    ground = np.zeros((ground_points, 4), np.float32)
    ground[:, 0] = g_dist * np.cos(g_theta)
    ground[:, 1] = g_dist * np.sin(g_theta)
    ground[:, 2] = rng.normal(-2.0, 0.05, ground_points)
    ground[:, 3] = rng.uniform(0, 0.4, ground_points)
    clouds.append(ground)

    points = np.concatenate(clouds, axis=0)
    rng.shuffle(points)
    return {
        "points": points,
        "gt_boxes": np.stack(boxes) if boxes else np.zeros((0, 7), np.float32),
        "gt_classes": np.asarray(classes, np.int32),
    }


def synthetic_cloud(max_points: int, n: int, seed: int = 0) -> np.ndarray:
    """LiDAR-like frame of `n` points padded to `max_points` rows:
    range-decayed radial density, a ground plane and scattered verticals —
    the pillar occupancy of a real sweep."""
    if n > max_points:
        raise ValueError(
            f"synthetic_cloud: n={n} exceeds the buffer max_points={max_points} "
            "— pass n <= max_points (tools default to 100k real points, which "
            "needs a config with max_points >= 100000)")
    r = np.random.RandomState(seed)
    pts = np.zeros((max_points, 4), np.float32)
    dist = np.abs(r.randn(n)) * 25.0 + 2.0
    theta = r.uniform(-np.pi, np.pi, n)
    pts[:n, 0] = dist * np.cos(theta)
    pts[:n, 1] = dist * np.sin(theta)
    pts[:n, 2] = np.where(r.rand(n) < 0.7, r.uniform(-2.0, -1.5, n), r.uniform(-1.5, 4.0, n))
    pts[:n, 3] = r.uniform(0, 1, n)
    return pts


def scene_to_annos(sample: dict, cfg: Config) -> dict:
    """Ground truth of a synthetic scene in the eval annos format."""
    names = np.array([cfg.detect_class[c - 1] for c in sample["gt_classes"]], dtype="<U10")
    boxes = sample["gt_boxes"]
    return {
        "name": names,
        "location": boxes[:, :3],
        "dimensions": boxes[:, 3:6],
        "rotation_y": boxes[:, 6],
        "num_points": np.full(len(names), 100, np.int64),
        "score": np.zeros(len(names)),
    }


def write_split(cfg: Config, root: str | Path, n: int, seed: int, **scene_kw) -> Path:
    """`n` scenes of `sample_scene` written as a split that
    `DetectionDataset` reads: `velodyne/<id>.bin` (float32, C features)
    and `data_info.pkl` (velodyne_path, annos from `scene_to_annos`).
    Returns the pickle's path."""
    root = Path(root)
    (root / "velodyne").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    infos = []
    for i in range(n):
        scene = sample_scene(cfg, rng, **scene_kw)
        rel = f"velodyne/{i:06d}.bin"
        scene["points"].astype(np.float32).tofile(root / rel)
        infos.append({"image_idx": i, "pointcloud_num_features": cfg.num_point_features, "velodyne_path": rel,
                      "annos": scene_to_annos(scene, cfg)})
    with open(root / "data_info.pkl", "wb") as f:
        pickle.dump(infos, f)
    return root / "data_info.pkl"
