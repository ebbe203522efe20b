"""Offline dataset indexer: KITTI-layout directories → info pickles.

The port's own copy of the JAX package's data/create_info.py (numpy
only). Counterpart of reference create_info.py:33-183. Scans `image_2/ velodyne/
calib/ label_2/` (Waymo variant remaps `image_0/ label_all/` and skips the
camera→lidar transform), parses calib matrices and KITTI label files,
converts camera-frame boxes to the lidar frame, counts lidar points per gt
box (`num_points`) plus the enlarged-box count the reference stores as
`difficulty` (create_info.py:159-183 `add_difficulty_to_annos_v2`), and
pickles the list of info dicts as `data_info.pkl`.

Info-dict schema is byte-compatible with the reference loader
(framework/dataset.py:24-32): image_idx, pointcloud_num_features, img_path,
img_shape, velodyne_path, calib/P0..P3, calib/R0_rect,
calib/Tr_velo_to_cam, calib/Tr_imu_to_velo, annos{name, truncated,
occluded, alpha, bbox, dimensions(lwh), location(lidar xyz), rotation_y,
score, index, group_ids, num_points, difficulty}.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np

from det3d_tpu_torch.data.augment import points_in_rbbox_np
from det3d_tpu_torch.utils.npmath import limit_period_np

WAYMO_CALIB_LINES = [0, 1, 2, 3, 5, 6, 7]


def _camera_to_lidar_np(points: np.ndarray, r_rect: np.ndarray, velo2cam: np.ndarray):
    """Camera frame → lidar frame (reference framework/box_np_ops.py:1097-1110)."""
    n = points.shape[0]
    hom = np.concatenate([points, np.ones((n, 1), points.dtype)], axis=1)
    lidar = hom @ np.linalg.inv((r_rect @ velo2cam).T)
    return lidar[:, :3]


def _extend(mat: np.ndarray) -> np.ndarray:
    return np.concatenate([mat, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def _image_shape(path: Path) -> np.ndarray:
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.array([im.height, im.width], np.int32)
    except Exception:
        return np.zeros((2,), np.int32)


def parse_calib(calib_file: Path, waymo: bool = False) -> dict:
    """KITTI calib txt → homogeneous 4x4 matrices (reference
    create_info.py:66-105)."""
    lines = calib_file.read_text().splitlines()
    if waymo:
        lines = [lines[i] for i in WAYMO_CALIB_LINES]

    def mat34(line):
        return np.array([float(v) for v in line.split(" ")[1:13]]).reshape(3, 4)

    out = {}
    for i in range(4):
        out[f"calib/P{i}"] = _extend(mat34(lines[i]))
    r0 = np.array([float(v) for v in lines[4].split(" ")[1:10]]).reshape(3, 3)
    rect = np.zeros((4, 4), r0.dtype)
    rect[3, 3] = 1.0
    rect[:3, :3] = r0
    out["calib/R0_rect"] = rect
    out["calib/Tr_velo_to_cam"] = _extend(mat34(lines[5]))
    out["calib/Tr_imu_to_velo"] = _extend(mat34(lines[6]))
    return out


def get_label_anno(label_file: Path, r_rect, velo2cam, waymo: bool = False) -> dict:
    """KITTI label txt → annos dict in the lidar frame (reference
    create_info.py:115-157): dims hwl→lwh, location camera→lidar,
    rotation_y = limit_period(1.5π − ry)."""
    content = [l.strip().split(" ") for l in label_file.read_text().splitlines() if l.strip()]
    num_objects = len([x[0] for x in content if x[0] != "DontCare"])
    num_gt = len(content)

    anno = {
        "name": np.array([x[0] for x in content], dtype="U15"),
        "truncated": np.array([float(x[1]) for x in content]),
        "occluded": np.array([int(float(x[2])) for x in content]),
        "alpha": np.array([float(x[3]) for x in content]),
        "bbox": np.array([[float(v) for v in x[4:8]] for x in content]).reshape(-1, 4),
        # hwl (KITTI label order) → lwh (lidar convention)
        "dimensions": np.array(
            [[float(v) for v in x[8:11]] for x in content]
        ).reshape(-1, 3)[:, [2, 1, 0]],
    }
    xyz = np.array([[float(v) for v in x[11:14]] for x in content]).reshape(-1, 3)
    if not waymo:
        xyz = _camera_to_lidar_np(xyz, r_rect, velo2cam)
    anno["location"] = xyz
    if waymo:
        anno["rotation_y"] = np.array([float(x[14]) for x in content]).reshape(-1)
    else:
        ry = np.array([1.5 * np.pi - float(x[14]) for x in content]).reshape(-1)
        anno["rotation_y"] = limit_period_np(ry, 0.5, 2.0 * np.pi)
    if num_gt and len(content[0]) == 16:
        anno["score"] = np.array([float(x[15]) for x in content])
    else:
        anno["score"] = np.zeros((num_gt,))
    anno["index"] = np.array(
        list(range(num_objects)) + [-1] * (num_gt - num_objects), np.int32
    )
    anno["group_ids"] = np.arange(num_gt, dtype=np.int32)
    return anno


def add_point_stats(info: dict, data_root: Path) -> None:
    """num_points per gt + enlarged-box count (the reference's 'difficulty',
    create_info.py:159-183)."""
    annos = info["annos"]
    points = np.fromfile(
        data_root / info["velodyne_path"], dtype=np.float32
    ).reshape(-1, info["pointcloud_num_features"])
    boxes = np.concatenate(
        [annos["location"], annos["dimensions"], annos["rotation_y"][..., None]], axis=1
    ).astype(np.float32)
    if len(boxes) == 0:
        annos["num_points"] = np.zeros((0,), np.int64)
        annos["difficulty"] = np.zeros((0,), np.int64)
        return
    annos["num_points"] = points_in_rbbox_np(points, boxes).sum(axis=0)
    enlarged = boxes.copy()
    enlarged[:, 3:6] += np.array([1.2, 0.5, 8.0], np.float32)
    annos["difficulty"] = points_in_rbbox_np(points, enlarged).sum(axis=0)


def create_info(
    root: str | Path,
    *,
    out_path: str | Path | None = None,
    waymo: bool = False,
    num_features: int = 4,
    with_labels: bool = True,
) -> list[dict]:
    """Index one split directory (KITTI layout) into data_info.pkl."""
    root = Path(root)
    images_dir = root / ("image_0" if waymo else "image_2")
    points_dir = root / "velodyne"
    calib_dir = root / "calib"
    label_dir = root / ("label_all" if waymo else "label_2")

    if images_dir.is_dir():
        ids = sorted(os.path.splitext(p)[0] for p in os.listdir(images_dir))
    else:  # lidar-only datasets: index by velodyne files
        ids = sorted(os.path.splitext(p)[0] for p in os.listdir(points_dir))

    infos = []
    for fid in ids:
        info = {
            "image_idx": int(fid),
            "pointcloud_num_features": num_features,
            "velodyne_path": str(Path("velodyne") / f"{fid}.bin"),
        }
        img = next(
            (images_dir / f"{fid}{ext}" for ext in (".jpg", ".png") if (images_dir / f"{fid}{ext}").exists()),
            None,
        )
        if img is not None:
            info["img_path"] = str(img.relative_to(root))
            info["img_shape"] = _image_shape(img)

        calib_file = calib_dir / f"{fid}.txt"
        if calib_file.exists():
            info.update(parse_calib(calib_file, waymo))

        if with_labels and (label_dir / f"{fid}.txt").exists():
            info["annos"] = get_label_anno(
                label_dir / f"{fid}.txt",
                info.get("calib/R0_rect"),
                info.get("calib/Tr_velo_to_cam"),
                waymo,
            )
            add_point_stats(info, root)
        infos.append(info)

    out = Path(out_path) if out_path else root / "data_info.pkl"
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    print(f"indexed {len(infos)} frames → {out}")
    return infos
