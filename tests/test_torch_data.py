"""The port's host data plane against the JAX package's, on the same seeds
and on files the tests write: npmath, `scene_to_annos`, the host
augmentation, `DetectionDataset`, `create_info`, the native loader and the
batch prefetcher.

Tolerance: none. Every function here is numpy (or the shared C++ loader)
on both sides, with the same `RandomState` draws in the same order, so
outputs are compared array-equal.
"""

from __future__ import annotations

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import test_torch_parity_utils as pu
from det3d_tpu.data import augment as jaug
from det3d_tpu.data import create_info as jci
from det3d_tpu.data import dataset as jds
from det3d_tpu.data import native_loader as jnl
from det3d_tpu.data import prefetcher as jpf
from det3d_tpu.data import synthetic as jsyn
from det3d_tpu.utils.npmath import limit_period_np as jax_limit_period_np
from det3d_tpu_torch.data import augment as taug
from det3d_tpu_torch.data import create_info as tci
from det3d_tpu_torch.data import dataset as tds
from det3d_tpu_torch.data import native_loader as tnl
from det3d_tpu_torch.data import prefetcher as tpf
from det3d_tpu_torch.data import synthetic as tsyn
from det3d_tpu_torch.utils.npmath import limit_period_np

REPO = Path(__file__).resolve().parents[1]


def assert_tree_equal(a, b, path="") -> None:
    """Dicts, lists and arrays equal in keys, dtypes and values."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def scene_cfgs():
    jcfg = pu.small_cfg().replace(batch_size=2, max_points=4096)
    return jcfg, pu.to_torch_cfg(jcfg)


# --- npmath, synthetic ------------------------------------------------------


@pytest.mark.parametrize("offset, period", [(0.5, 2 * np.pi), (0.5, np.pi), (0.0, np.pi), (1.0, 2 * np.pi)])
def test_limit_period_np_equals_jax(offset, period):
    val = np.random.RandomState(0).uniform(-20, 20, 1000)
    np.testing.assert_array_equal(limit_period_np(val, offset, period), jax_limit_period_np(val, offset, period))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scene_to_annos_equals_jax(seed):
    jcfg, tcfg = scene_cfgs()
    jscene = jsyn.sample_scene(jcfg, np.random.RandomState(seed))
    tscene = tsyn.sample_scene(tcfg, np.random.RandomState(seed))
    assert_tree_equal(tscene, jscene)
    assert_tree_equal(tsyn.scene_to_annos(tscene, tcfg), jsyn.scene_to_annos(jscene, jcfg))


# --- augmentation -------------------------------------------------------------


def scene(seed, n_obj=(6, 12)):
    jcfg, _ = scene_cfgs()
    s = jsyn.sample_scene(jcfg, np.random.RandomState(seed), n_obj, ground_points=1500)
    return s["points"], s["gt_boxes"]


def test_augment_constants_equal_jax():
    assert taug.GLOBAL_SCALE_MIN == jaug.GLOBAL_SCALE_MIN
    assert taug.GLOBAL_TRANSLATE_BOUND == jaug.GLOBAL_TRANSLATE_BOUND


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_rotation_points_single_angle_equals_jax(axis):
    pts = np.random.RandomState(axis + 5).randn(50, 3).astype(np.float32)
    np.testing.assert_array_equal(taug.rotation_points_single_angle_np(pts, 0.3, axis),
                                  jaug.rotation_points_single_angle_np(pts, 0.3, axis))


@pytest.mark.parametrize("seed", [0, 1])
def test_box_geometry_equals_jax(seed):
    points, boxes = scene(seed)
    bev = boxes[:, [0, 1, 3, 4, 6]].astype(np.float64)
    corners = taug.box2d_corners_np(bev)
    np.testing.assert_array_equal(corners, jaug.box2d_corners_np(bev))
    np.testing.assert_array_equal(taug._points_in_quad(points[:, :2], corners[0]),
                                  jaug._points_in_quad(points[:, :2], corners[0]))
    shifted = corners + np.random.RandomState(seed).uniform(-2, 2, (1, 1, 2))
    np.testing.assert_array_equal(taug.box_collision_test_np(corners, shifted),
                                  jaug.box_collision_test_np(corners, shifted))
    np.testing.assert_array_equal(taug.points_in_rbbox_np(points, boxes), jaug.points_in_rbbox_np(points, boxes))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_collision_and_membership_edge_cases_equal_jax(seed):
    """The port tests only standup-overlapping pairs and the points inside
    each box's widened standup rectangle; on crowded, nested and touching
    boxes and on points on the edges and corners the result must equal
    the JAX package's test of everything."""
    r = np.random.RandomState(seed)
    n = 60
    bev = np.zeros((n, 5))
    bev[:, :2] = r.uniform(-6, 6, (n, 2))
    bev[:, 2:4] = r.uniform(0.2, 5, (n, 2))
    bev[:, 4] = r.choice([0.0, np.pi / 2, r.uniform(-np.pi, np.pi)], n)
    bev[n // 2:, :2] = bev[: n // 2, :2] + r.choice([0.0, 0.5], (n // 2, 1))  # nested and touching
    bev[n // 2:, 2:4] = bev[: n // 2, 2:4] * r.choice([0.5, 1.0, 2.0], (n // 2, 1))
    corners = taug.box2d_corners_np(bev)
    np.testing.assert_array_equal(taug.box_collision_test_np(corners, corners[::-1]),
                                  jaug.box_collision_test_np(corners, corners[::-1]))
    boxes = np.concatenate([bev[:, :2], r.uniform(-2, 0, (n, 1)), bev[:, 2:4], r.uniform(0.5, 2, (n, 1)),
                            bev[:, 4:]], 1).astype(np.float32)
    on_edges = (corners[:, :, None] + (np.roll(corners, -1, 1) - corners)[:, :, None] * np.linspace(0, 1, 5)[:, None])
    pts = np.concatenate([r.uniform(-9, 9, (4000, 3)), np.concatenate(
        [on_edges.reshape(-1, 2), np.repeat(boxes[:, 2:3], 20, 0)], 1)]).astype(np.float32)
    got = taug.points_in_rbbox_np(pts, boxes)
    np.testing.assert_array_equal(got, jaug.points_in_rbbox_np(pts, boxes))
    assert got.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_noise_per_object_equals_jax(seed):
    points, boxes = scene(seed)
    valid = np.random.RandomState(seed).rand(len(boxes)) > 0.2
    tp, tb, jp, jb = points.copy(), boxes.copy(), points.copy(), boxes.copy()
    taug.noise_per_object(tb, tp, valid, rng=np.random.RandomState(seed + 10))
    jaug.noise_per_object(jb, jp, valid, rng=np.random.RandomState(seed + 10))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tb, jb)
    assert not np.array_equal(tb, boxes)


@pytest.mark.parametrize("name", ["random_flip", "global_rotation", "global_scaling", "global_translate"])
@pytest.mark.parametrize("seed", [0, 3])
def test_global_transform_equals_jax(name, seed):
    points, boxes = scene(seed)
    tb, tp = getattr(taug, name)(boxes.copy(), points.copy(), np.random.RandomState(seed))
    jb, jp = getattr(jaug, name)(boxes.copy(), points.copy(), np.random.RandomState(seed))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_sample_equals_jax(seed):
    points, boxes = scene(seed)
    tb, tp = taug.augment_sample(points.copy(), boxes.copy(), rng=np.random.RandomState(seed))
    jb, jp = jaug.augment_sample(points.copy(), boxes.copy(), rng=np.random.RandomState(seed))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tb, jb)


# --- dataset, native loader, prefetcher ---------------------------------------


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Eight scenes written by the port's `write_split`; two frames also
    carry raw class names and a zero-point gt, which the remap must map
    and drop."""
    root = tmp_path_factory.mktemp("split")
    jcfg, tcfg = scene_cfgs()
    info_path = tsyn.write_split(tcfg, root, 8, seed=7, num_objects=(4, 8), ground_points=1500)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    for info in infos[:2]:
        annos = info["annos"]
        annos["name"] = np.where(annos["name"] == "vehicle", "car", annos["name"]).astype("<U10")
        annos["num_points"][0] = 0
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    jcfg = jcfg.replace(data_root=str(root), train_info=("data_info.pkl",), eval_info=("data_info.pkl",))
    return jcfg, pu.to_torch_cfg(jcfg)


def datasets(split, training, seed=3):
    jcfg, tcfg = split
    return (tds.DetectionDataset(tcfg, tcfg.train_info, training=training, seed=seed),
            jds.DetectionDataset(jcfg, jcfg.train_info, training=training, seed=seed))


def test_write_split_reads_back_as_written(split):
    tdsx, _ = datasets(split, training=False)
    jcfg, tcfg = split
    rng = np.random.RandomState(7)
    for i in range(3):
        want = jsyn.sample_scene(jcfg, rng, (4, 8), ground_points=1500)
        np.testing.assert_array_equal(tdsx[i]["points"], want["points"])


def test_remap_class_names_equals_jax(split):
    with open(Path(split[1].data_root) / "data_info.pkl", "rb") as f:
        infos = pickle.load(f)
    want = jds.remap_class_names(pickle.loads(pickle.dumps(infos)))
    got = tds.remap_class_names(infos)
    assert_tree_equal(got, want)
    assert "car" not in got[0]["annos"]["name"]


@pytest.mark.parametrize("training", [True, False])
def test_dataset_items_equal_jax(split, training):
    tdsx, jdsx = datasets(split, training)
    assert len(tdsx) == len(jdsx) == 8
    assert_tree_equal(tdsx.infos, jdsx.infos)
    for i in (0, 1, 5):
        got, want = tdsx[i], jdsx[i]
        assert list(got) == list(want)
        for key in ("points", "gt_boxes", "gt_classes"):
            if key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(tdsx.epoch_order(), jdsx.epoch_order())


def test_filter_gt_outside_range_equals_jax():
    _, boxes = scene(4)
    boxes = np.concatenate([boxes, boxes + np.array([30, 0, 0, 0, 0, 0, 0], np.float32)])
    bv = np.array([-16.0, -16.0, 16.0, 16.0])
    got = tds._filter_gt_outside_range_np(boxes, bv)
    np.testing.assert_array_equal(got, jds._filter_gt_outside_range_np(boxes, bv))
    assert got.any() and not got.all()


def test_device_global_augment_not_ported(split):
    """Now ported: `DetectionDataset(device_global_augment=True)` at one
    seed (the per-object noise only, the radius pre-filter, no range filter
    or yaw wrap on the host) equals JAX's, array for array, also through
    two spawned workers, which get the flag with the pickled dataset."""
    jcfg, tcfg = split
    tdsx = tds.DetectionDataset(tcfg, tcfg.train_info, training=True, seed=3, device_global_augment=True)
    jdsx = jds.DetectionDataset(jcfg, jcfg.train_info, training=True, seed=3, device_global_augment=True)
    for i in (0, 1, 5):
        got, want = tdsx[i], jdsx[i]
        for key in ("points", "gt_boxes", "gt_classes"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    plain = datasets(split, training=True)[0][0]
    assert not np.array_equal(plain["points"], tdsx[0]["points"])  # the global transforms are gone
    for g, w in zip(batches(tpf, tdsx, tcfg, 2, n=3), batches(jpf, jdsx, jcfg, 0, n=3)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("reader", ["native", "numpy"])
def test_iter_points_native_equals_jax(split, reader, monkeypatch):
    tdsx, jdsx = datasets(split, training=False)
    if reader == "numpy":
        monkeypatch.setattr(tnl, "available", lambda: False)
    assert tdsx.point_reader() == reader
    order = np.array([3, 0, 7, 1])
    got = list(tdsx.iter_points_native(order, num_threads=2))
    want = list(jdsx.iter_points_native(order, num_threads=2))
    assert len(got) == len(want) == 4
    for (gi, gp, gn), (wi, wp, wn) in zip(got, want):
        assert gi["velodyne_path"] == wi["velodyne_path"]
        assert gn == wn
        np.testing.assert_array_equal(gp, wp)


@pytest.fixture(scope="module")
def bin_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bins")
    rng = np.random.RandomState(0)
    refs = []
    for i in range(6):
        a = rng.randn(rng.randint(100, 3000), 4).astype(np.float32)
        a.tofile(tmp / f"{i}.bin")
        refs.append(a)
    return tmp, refs


def test_native_loader_builds_into_the_port_build_dir():
    from det3d_tpu_torch.kernels import build

    assert tnl.available()
    path = build._library_path("pointcloud_loader")
    assert path.parent == build.BUILD_DIR and path.exists()
    assert build.HOST_SOURCES["pointcloud_loader"] == REPO / "runtime" / "pointcloud_loader.cc"


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_loader_equals_jax(bin_dir, shuffle):
    tmp, refs = bin_dir

    def read(mod):
        with mod.AsyncPointCloudLoader(2000, 4, queue_depth=2, num_threads=3, shuffle=shuffle, seed=5) as ld:
            for i in range(len(refs)):
                ld.submit(tmp / f"{i}.bin")
            ld.finish()
            out = [ld.next() for _ in refs]
            assert ld.next() is None
            return out

    got, want = read(tnl), read(jnl)
    for (gp, gn), (wp, wn), ref in zip(got, want, refs):
        assert gn == wn == min(len(ref), 2000)
        np.testing.assert_array_equal(gp, wp)
        if not shuffle:
            np.testing.assert_array_equal(gp[:gn], ref[:gn])


def test_native_loader_missing_file(bin_dir):
    tmp, _ = bin_dir
    with tnl.AsyncPointCloudLoader(1000, 4) as ld:
        ld.submit(tmp / "does_not_exist.bin")
        ld.finish()
        with pytest.raises(FileNotFoundError, match="does_not_exist"):
            ld.next()
    with tnl.AsyncPointCloudLoader(1000, 4) as ld:
        ld.submit(tmp / "does_not_exist.bin")
        ld.finish()
        pts, n = ld.next(missing_ok=True)
        assert n == 0 and not pts.any()


def batches(mod, dataset, cfg, workers, n=5, seed=2):
    with mod.BatchPrefetcher(dataset, cfg, workers, seed=seed) as pf:
        it = pf.epochs()
        return [next(it) for _ in range(n)]


@pytest.mark.parametrize("workers", [0, 2])
def test_prefetcher_batches_equal_jax(split, workers):
    """Five batches of two (one epoch and a reshuffled one) with the
    augmentation on, against the JAX prefetcher with no worker."""
    jcfg, tcfg = split
    tdsx, jdsx = datasets(split, training=True)
    got = batches(tpf, tdsx, tcfg, workers)
    want = batches(jpf, jdsx, jcfg, 0)
    for g, w in zip(got, want):
        assert type(g).__name__ == "TrainBatch" and isinstance(g.points, np.ndarray)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_prefetcher_workers_import_no_torch(split):
    _, tcfg = split
    tdsx, _ = datasets(split, training=True)
    with tpf.BatchPrefetcher(tdsx, tcfg, 1) as pf:
        loaded = pf._pool.apply(eval, ("sorted({m.split('.')[0] for m in __import__('sys').modules})",))
    assert "torch" not in loaded and "jax" not in loaded, loaded


def test_prefetcher_too_small_dataset_raises(split):
    _, tcfg = split
    tdsx, _ = datasets(split, training=True)
    with tpf.BatchPrefetcher(tdsx, tcfg.replace(batch_size=9), 0) as pf:
        with pytest.raises(ValueError, match="no full batches"):
            next(pf.epochs())


# --- create_info --------------------------------------------------------------

VELO2CAM_34 = "0 -1 0 0 0 0 -1 0 1 0 0 0"
IDENT_34 = "1 0 0 0 0 1 0 0 0 0 1 0"
IDENT_33 = "1 0 0 0 1 0 0 0 1"


def kitti_split(root: Path, waymo: bool) -> Path:
    """Three frames of a KITTI (or Waymo) layout: clouds, calib, labels."""
    labels = "label_all" if waymo else "label_2"
    for d in ("velodyne", "calib", labels):
        (root / d).mkdir(parents=True)
    rng = np.random.RandomState(int(waymo))
    for i in range(3):
        pts = rng.uniform(-20, 20, (400, 4)).astype(np.float32)
        pts[:60, :3] = np.array([10.0, 0.0, -1.0]) + rng.uniform(-0.6, 0.6, (60, 3))
        pts.tofile(root / "velodyne" / f"{i:06d}.bin")
        extra = ["SKIPPED: 0"] if waymo else []
        calib = [f"P{k}: {IDENT_34}" for k in range(4)] + extra + [
            f"R0_rect: {IDENT_33}", f"Tr_velo_to_cam: {IDENT_34 if waymo else VELO2CAM_34}",
            f"Tr_imu_to_velo: {IDENT_34}"]
        (root / "calib" / f"{i:06d}.txt").write_text("\n".join(calib) + "\n")
        if waymo:
            lines = ["vehicle 0.0 0 0.0 0 0 0 0 1.5 1.6 4.0 10.0 0.0 -1.0 0.3",
                     f"pedestrian 0.0 0 0.0 0 0 0 0 1.7 0.8 0.9 {i}.5 2.0 -1.2 -1.1"]
        else:
            lines = ["Car 0.0 0 0.0 100 100 200 200 1.5 1.6 4.0 0.0 1.0 10.0 0.0",
                     f"Pedestrian 0.1 1 0.2 10 10 20 20 1.7 0.8 0.9 2.0 1.2 {i}.5 0.7",
                     "DontCare -1 -1 -10 0 0 1 1 -1 -1 -1 -1000 -1000 -1000 -10"]
        (root / labels / f"{i:06d}.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize("waymo", [False, True], ids=["kitti", "waymo"])
def test_create_info_equals_jax(tmp_path, waymo):
    root = kitti_split(tmp_path / "split", waymo)
    got = tci.create_info(root, out_path=tmp_path / "port.pkl", waymo=waymo)
    want = jci.create_info(root, out_path=tmp_path / "jax.pkl", waymo=waymo)
    assert_tree_equal(got, want)
    with open(tmp_path / "port.pkl", "rb") as f:
        assert_tree_equal(pickle.load(f), want)
    assert int(got[0]["annos"]["num_points"][0]) > 0


def test_create_info_cli(tmp_path):
    root = kitti_split(tmp_path / "split", waymo=False)
    out = subprocess.run([sys.executable, "-m", "det3d_tpu_torch", "create-info", "--root", str(root)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    with open(root / "data_info.pkl", "rb") as f:
        assert_tree_equal(pickle.load(f), jci.create_info(root, out_path=tmp_path / "jax.pkl"))
