"""The port's viewer (`det3d_tpu_torch/viewer/`) and its `view` command
against the JAX package's, on the CPU (`device="cpu"`), on the pattern of
tests/test_apps.py's viewer tests: PNGs of the JAX viewer's pixel size,
the 3D corners and the orbit camera equal (1e-6; both numpy), the camera
panel's projected corners and a frame's drawn segments equal (1e-4 px, and
for the projected corners 2 float32 spacings of the coordinate beside it,
rtol 2.5e-7: the projection is float32 in both, in torch here and in XLA
there, and a corner ~1000 px off the principal point has a spacing of
6.1e-5 px, measured 1 spacing apart in 2 of 272 coordinates), the
FP/FN flags equal, the voxel overlay's pillar coordinates equal to the JAX
voxelizer's, `view --image` writing both panels, and the interactive
viewer's keys and its refusal without a GUI backend.
"""

from __future__ import annotations

import pickle

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch
from matplotlib.collections import LineCollection, PathCollection

from det3d_tpu.config import load_config as jax_load_config
from det3d_tpu.viewer import app as japp
from det3d_tpu.viewer import render as jrender
from det3d_tpu.viewer import render3d as jrender3d
from det3d_tpu_torch import cli
from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.viewer import app as tapp
from det3d_tpu_torch.viewer import render as trender
from det3d_tpu_torch.viewer import render3d as trender3d

torch.set_num_threads(1)

CPU = "cpu"
GEOMETRY = {"detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5], "voxel_size": [1.0, 1.0, 11.0],
            "max_voxels": 256, "max_num_points": 5, "max_points": 2048}


def calib():
    """tests/test_apps.py's camera: the lidar x axis is the optical axis."""
    velo2cam = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1.0]])
    p2 = np.array([[500, 0, 320, 0], [0, 500, 240, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    return {"calib/R0_rect": np.eye(4), "calib/Tr_velo_to_cam": velo2cam, "calib/P2": p2}


def boxes(n, seed):
    r = np.random.RandomState(seed)
    return np.concatenate([r.uniform(-12, 12, (n, 2)), r.uniform(-2, 0, (n, 1)), r.uniform(1, 5, (n, 1)),
                           r.uniform(0.8, 2.5, (n, 1)), r.uniform(1.2, 2, (n, 1)), r.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def write_dataset(root, frames=3, image=False):
    """A data root with `frames` velodyne frames, their infos (gt annos,
    with the camera image and calibration when `image`) and a detection
    pickle; → the port's and the JAX package's config for it."""
    (root / "velodyne").mkdir(parents=True)
    infos, dts = [], []
    for i in range(frames):
        rng = np.random.RandomState(i)
        (rng.rand(600, 4).astype(np.float32) * 28 - 14).tofile(root / "velodyne" / f"{i:06d}.bin")
        gt = boxes(3, 10 + i)
        gt[:, 0] = np.abs(gt[:, 0]) + 4  # in front of the camera
        dt = np.concatenate([gt[:2] + [0.2, 0, 0, 0, 0, 0, 0.05], boxes(2, 20 + i)])
        annos = lambda b, s: {"name": np.array(["vehicle"] * len(b)), "location": b[:, :3],  # noqa: E731
                              "dimensions": b[:, 3:6], "rotation_y": b[:, 6], "score": s}
        info = {"image_idx": i, "velodyne_path": f"velodyne/{i:06d}.bin", "annos": annos(gt, np.zeros(3))}
        if image:
            (root / "image_2").mkdir(exist_ok=True)
            mpimg.imsave(root / "image_2" / f"{i:06d}.png", np.zeros((480, 640, 3), np.uint8))
            info.update(img_path=f"image_2/{i:06d}.png", img_shape=(480, 640), **calib())
        infos.append(info)
        dts.append(annos(dt, np.linspace(0.9, 0.5, len(dt))))
    with open(root / "data_info.pkl", "wb") as f:
        pickle.dump(infos, f)
    with open(root / "dt.pkl", "wb") as f:
        pickle.dump(dts, f)
    raw = dict(GEOMETRY, data_root=str(root))
    return load_config(raw), jax_load_config(raw)


def png_shape(path):
    return mpimg.imread(str(path)).shape


# --- renders: the JAX viewer's pixel size ---------------------------------------------------


def test_render_scene_and_3d_png_sizes_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-10, 10, (1000, 4)).astype(np.float32)
    gt = np.array([[0, 0, -1.5, 4, 2, 1.6, 0.3]], np.float32)
    dt = np.array([[0.2, 0, -1.5, 4, 2, 1.6, 0.35], [8, 8, -1.5, 4, 2, 1.6, 0.0]], np.float32)
    scores = np.array([0.9, 0.7])
    got = trender.render_scene(pts, gt, dt, scores, tmp_path / "t.png", (-12, -12, 12, 12), device=CPU)
    want = jrender.render_scene(pts, gt, dt, scores, tmp_path / "j.png", (-12, -12, 12, 12))
    assert got.stat().st_size > 10_000 and png_shape(got) == png_shape(want)
    got = trender3d.render_scene_3d(pts, gt, dt, scores, tmp_path / "t3.png", title="t", device=CPU)
    want = jrender3d.render_scene_3d(pts, gt, dt, scores, tmp_path / "j3.png", title="t")
    assert got.stat().st_size > 10_000 and png_shape(got) == png_shape(want)


def test_orbit_sequence_and_overlay_png_sizes_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    pts = rng.uniform(-10, 10, (500, 4)).astype(np.float32)
    got = trender3d.render_orbit(pts, out_dir=tmp_path / "t_orbit", n_views=4, device=CPU)
    want = jrender3d.render_orbit(pts, out_dir=tmp_path / "j_orbit", n_views=4)
    assert [p.name for p in got] == [p.name for p in want] and len({p.name for p in got}) == 4
    assert [png_shape(p) for p in got] == [png_shape(p) for p in want]
    frames = [{"points": rng.rand(100, 4) * 20 - 10, "gt_boxes": np.array([[1.0, 2, 0, 4, 2, 1.6, 0.1]])}
              for _ in range(3)]
    got = trender.render_sequence(frames, tmp_path / "t_seq", detection_range=(-20, -20, 20, 20), device=CPU)
    want = jrender.render_sequence(frames, tmp_path / "j_seq", detection_range=(-20, -20, 20, 20))
    assert [png_shape(p) for p in got] == [png_shape(p) for p in want] and len(got) == 3
    img = np.zeros((480, 640, 3), np.uint8)
    kw = dict(gt_boxes=np.array([[10.0, 0, -1, 4, 2, 1.6, 0.0]]), dt_boxes=np.array([[12.0, 1, -1, 4, 2, 1.6, 0.2]]))
    got = trender.render_image_overlay(img, calib(), out_path=tmp_path / "t_ov.png", device=CPU, **kw)
    want = jrender.render_image_overlay(img, calib(), out_path=tmp_path / "j_ov.png", **kw)
    assert png_shape(got) == png_shape(want)


# --- geometry of the renders ----------------------------------------------------------------


def test_box_corners_3d_and_orbit_camera_equal_jax():
    b = boxes(32, 3).astype(np.float64)
    np.testing.assert_allclose(trender3d.box_corners_3d(b), jrender3d.box_corners_3d(b), rtol=0, atol=1e-6)
    pts = np.random.RandomState(4).uniform(-40, 40, (64, 3))
    for az, el, d in [(30.0, 40.0, 50.0), (-60.0, 35.0, 90.0), (0.0, 89.9, 50.0), (200.0, 10.0, 20.0)]:
        center = (1.0, -2.0, 0.5)
        tcam, jcam = trender3d.OrbitCamera(az, el, d, center), jrender3d.OrbitCamera(az, el, d, center)
        np.testing.assert_allclose(tcam.eye, jcam.eye, atol=1e-6)
        (txy, tz), (jxy, jz) = tcam.project(pts), jcam.project(pts)
        np.testing.assert_allclose(tz, jz, atol=1e-6)
        np.testing.assert_allclose(txy, jxy, atol=1e-6)  # NaN where behind, in both


def test_project_boxes_to_image_equals_jax():
    c = calib()
    b = boxes(24, 5)
    b[:12, 0] = np.abs(b[:12, 0]) + 3  # half in front of the camera
    args = (c["calib/R0_rect"], c["calib/Tr_velo_to_cam"], c["calib/P2"])
    for shape in (None, (480, 640)):
        got = trender.project_boxes_to_image(b, *args, image_shape=shape, device=CPU)
        want = jrender.project_boxes_to_image(b, *args, image_shape=shape)
        assert got.shape == want.shape and len(got) > 0
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-4)
    behind = np.array([[-10.0, 0.0, -1.0, 4.0, 2.0, 1.6, 0.0]])
    assert trender.project_boxes_to_image(behind, *args, device=CPU).shape == (0, 8, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_fp_fn_flags_equal_jax(seed):
    gt = boxes(6, seed)
    dt = np.concatenate([gt[:4] + np.random.RandomState(seed).uniform(-0.6, 0.6, (4, 7)).astype(np.float32) *
                         [1, 1, 0, 0.2, 0.2, 0, 0.3], boxes(3, 50 + seed)])
    got, want = trender.match_fp_fn(gt, dt, device=CPU), jrender.match_fp_fn(gt, dt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].any() and not got[0].all()
    for g, w in zip(trender.match_fp_fn(gt[:0], dt, device=CPU), jrender.match_fp_fn(gt[:0], dt)):
        np.testing.assert_array_equal(g, w)


def drawn(renderer):
    """The segments of every line collection and the offsets of every
    scatter of a figure, in drawing order."""
    out = []
    for c in renderer.ax.collections:
        if isinstance(c, LineCollection):
            out.append(("lines", np.asarray(c.get_segments(), np.float64)))
        elif isinstance(c, PathCollection):
            out.append(("points", np.asarray(c.get_offsets(), np.float64)))
    return out


def test_frame_drawing_and_voxel_overlay_equal_jax(tmp_path):
    tcfg, jcfg = write_dataset(tmp_path / "data")
    tview = tapp.SceneViewer(tcfg, info_path="data_info.pkl", dt_path=str(tmp_path / "data" / "dt.pkl"), device=CPU)
    jview = japp.SceneViewer(jcfg, info_path="data_info.pkl", dt_path=str(tmp_path / "data" / "dt.pkl"))
    for idx in range(len(jview)):
        got = drawn(tview.build_renderer(idx, show_anchors=True, show_voxels=True))
        want = drawn(jview.build_renderer(idx, show_anchors=True, show_voxels=True))
        assert [k for k, _ in got] == [k for k, _ in want] and len(got) > 4
        for (_, g), (_, w) in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    # the voxel overlay's pillars: the port's voxelizer against the JAX one
    import jax

    from det3d_tpu.ops.voxelize import VoxelizerSpec, voxelize

    points = tview.load_points(tview.infos[0])
    pts = np.zeros((jcfg.max_points, 4), np.float32)
    pts[:len(points)] = points
    want = jax.device_get(voxelize(pts, np.int32(len(points)), VoxelizerSpec.from_config(jcfg))).coors
    got = tview.voxel_coors(points)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[:, 0] >= 0).sum() > 50


def test_view_image_renders_bev_and_camera_panels(tmp_path):
    write_dataset(tmp_path / "data", frames=1, image=True)
    cfg_path = tmp_path / "cfg.json"
    import json

    cfg_path.write_text(json.dumps(dict(GEOMETRY, data_root=str(tmp_path / "data"))))
    common = ["--config", str(cfg_path), "--info", "data_info.pkl", "--frames", "0:1", "--device", "cpu"]
    out = tmp_path / "shots"
    cli.main(["view", *common, "--out", str(out), "--image", "--voxels", "--anchors"])
    assert (out / "000000.png").stat().st_size > 10_000
    assert (out / "000000_cam.png").stat().st_size > 0
    out3d = tmp_path / "shots3d"
    cli.main(["view", *common, "--out", str(out3d), "--mode", "3d", "--azimuth", "45", "--distance", "40"])
    assert (out3d / "000000_3d.png").stat().st_size > 10_000
    orbit = tmp_path / "orbit"
    cli.main(["view", *common, "--out", str(orbit), "--mode", "3d", "--orbit", "3"])
    assert len(list((orbit / "000000_3d").glob("az*.png"))) == 3
    with pytest.raises(SystemExit, match="BEV-only"):
        cli.main(["view", *common, "--out", str(out), "--interactive", "--mode", "3d"])


# --- the interactive viewer ---------------------------------------------------------------


def test_interactive_navigation_toggles_and_screenshot(tmp_path):
    tcfg, _ = write_dataset(tmp_path / "data")
    iv = tapp.InteractiveViewer(tapp.SceneViewer(tcfg, info_path="data_info.pkl", device=CPU),
                                out_dir=tmp_path / "shots")
    assert iv.idx == 0
    for key, want in [("right", 1), ("j", 0), ("left", 2), ("home", 0), ("end", 2), ("k", 0)]:
        iv.handle_key(key)
        assert iv.idx == want, key
    assert len(iv.ax.collections) > 0
    iv.handle_key("v")
    assert iv.show_voxels and any(isinstance(c, PathCollection) and len(c.get_offsets()) > 50
                                  for c in iv.ax.collections)
    iv.handle_key("v")
    iv.handle_key("a")
    assert not iv.show_voxels and iv.show_anchors
    iv.handle_key("x")  # an unbound key changes nothing
    assert (iv.idx, iv.show_anchors) == (0, True)
    iv.handle_key("s")
    assert (tmp_path / "shots" / "000000_interactive.png").exists()
    iv.handle_key("q")


def test_interactive_refuses_a_headless_backend_and_an_empty_list(tmp_path):
    tcfg, _ = write_dataset(tmp_path / "data", frames=1)
    iv = tapp.InteractiveViewer(tapp.SceneViewer(tcfg, info_path="data_info.pkl", device=CPU), out_dir=tmp_path)
    with pytest.raises(RuntimeError, match="GUI matplotlib backend"):
        iv.run()
    with pytest.raises(ValueError, match="no frames"):
        tapp.InteractiveViewer(tapp.SceneViewer(tcfg, device=CPU))
