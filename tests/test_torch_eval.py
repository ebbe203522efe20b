"""The port's rotated IoU and official mAP against the JAX package's.

Tolerances, each with its reason:
  * IoU (criterion -1, what the evaluation uses) and 3-D IoU against the
    JAX package's jitted wrappers: 1e-6 abs. The same float32 formulas in
    the same order; the sums over the 24 vertices and 22 triangles may be
    taken in another order, and XLA contracts multiply-adds under jit
    (~4.5e-7 seen);
  * inter/area1 and inter/area2 (criteria 0, 1) and the raw area
    (criterion 2): 1e-6 abs (rtol 1e-6 for areas up to ~40 m²) against the
    JAX functions run op by op (`jax.disable_jit`, ~3.6e-7 seen), and 2e-6
    against the jitted wrapper, whose contracted corners (4.8e-7 off)
    move a ratio near 1 by up to 1.4e-6;
  * the overlap matrices of the evaluation (boxes up to ~30 m from the
    origin): 1e-6 abs against the JAX functions run op by op, 2e-5 against
    the jitted JAX wrappers (far from the origin the corners cancel, and
    XLA's contracted multiply-adds move an IoU by up to 1.4e-5; the port
    reproduces the op-by-op values to ~1e-7);
  * `get_official_eval_result`: the string equal character for character,
    the mAP numbers within 1e-9 (both are numpy on overlaps equal up to the
    above, which no threshold of this data sits within).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu.data.synthetic import sample_scene, scene_to_annos
from det3d_tpu.eval import ap as jap
from det3d_tpu.ops import rotated_iou as jri
from det3d_tpu_torch.eval import ap as tap
from det3d_tpu_torch.ops import rotated_iou as tri

torch.set_num_threads(1)
CPU = "cpu"


def random_rboxes(n, seed, spread=10.0):
    r = np.random.RandomState(seed)
    out = np.zeros((n, 5), np.float32)
    out[:, :2] = r.uniform(-spread, spread, (n, 2))
    out[:, 2:4] = r.uniform(1.0, 6.0, (n, 2))
    out[:, 4] = r.uniform(-np.pi, np.pi, n)
    return out


def adversarial_pairs():
    """(a, b) of boxes that touch, nest, coincide or turn by 90°."""
    base = np.array([[0, 0, 4, 2, 0.3]], np.float32)
    cases = {
        "identical": (base, base.copy()),
        "touching edge": (np.array([[0, 0, 2, 2, 0]], np.float32), np.array([[2, 0, 2, 2, 0]], np.float32)),
        "touching corner": (np.array([[0, 0, 2, 2, 0]], np.float32), np.array([[2, 2, 2, 2, 0]], np.float32)),
        "nested": (np.array([[0, 0, 6, 4, 0.7]], np.float32), np.array([[0.2, 0.1, 2, 1, 0.7]], np.float32)),
        "nested rotated": (np.array([[0, 0, 6, 6, 0]], np.float32), np.array([[0, 0, 2, 1, 1.1]], np.float32)),
        "turned 90°": (base, base + np.array([[0, 0, 0, 0, np.pi / 2]], np.float32)),
        "square turned 90°": (np.array([[1, 1, 3, 3, 0]], np.float32),
                              np.array([[1, 1, 3, 3, np.pi / 2]], np.float32)),
        "cross": (np.array([[0, 0, 8, 1, 0]], np.float32), np.array([[0, 0, 8, 1, np.pi / 2]], np.float32)),
        "disjoint": (base, base + np.array([[50, 50, 0, 0, 0]], np.float32)),
        "zero size": (np.array([[0, 0, 0, 0, 0]], np.float32), base),
    }
    return cases


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotated_iou_random_equals_jax(seed, criterion):
    a, b = random_rboxes(30, seed), random_rboxes(25, seed + 100)
    got = tri.rotate_iou_eval_np(a, b, criterion, device=CPU)
    jitted = jri.rotate_iou_eval_np(a, b, criterion)
    with jax.disable_jit():
        op_by_op = np.asarray(jri.rotated_iou(jnp.asarray(a), jnp.asarray(b), criterion))
    assert got.dtype == np.float32 and got.shape == (30, 25)
    if criterion == -1:
        np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-6)
    elif criterion == 2:
        np.testing.assert_allclose(got, op_by_op, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, jitted, rtol=2e-6, atol=2e-6)
    else:
        np.testing.assert_allclose(got, op_by_op, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, jitted, rtol=0, atol=2e-6)
    assert (jitted > 0).any()


@pytest.mark.parametrize("name", list(adversarial_pairs()))
def test_rotated_iou_adversarial_equals_jax(name):
    a, b = adversarial_pairs()[name]
    for x, y in ((a, b), (b, a)):
        np.testing.assert_allclose(tri.rotate_iou_eval_np(x, y, device=CPU), jri.rotate_iou_eval_np(x, y),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_rotated_iou_functions_equal_jax():
    a, b = random_rboxes(12, 3), random_rboxes(9, 4)
    np.testing.assert_allclose(tri.rbbox_corners(torch.from_numpy(a)).numpy(),
                               np.asarray(jri.rbbox_corners(a)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tri.rotated_intersection_area(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jri.rotated_intersection_area(a, b)), rtol=1e-6, atol=1e-6)
    assert tri.rotate_iou_eval_np(a[:0], b, device=CPU).shape == (0, 9)


def boxes7(n, seed):
    r = np.random.RandomState(seed)
    out = np.zeros((n, 7), np.float32)
    out[:, :2] = r.uniform(-8, 8, (n, 2))
    out[:, 2] = r.uniform(-2, 0, n)
    out[:, 3:6] = r.uniform(0.5, 5, (n, 3))
    out[:, 6] = r.uniform(-np.pi, np.pi, n)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_stacks_equal_jax(seed):
    a = np.stack([random_rboxes(32, seed + f, 6.0) for f in range(3)])
    b = np.stack([random_rboxes(16, seed + 10 + f, 6.0) for f in range(3)])
    np.testing.assert_allclose(tri.rotate_iou_frames_np(a, b, device=CPU), jri.rotate_iou_frames_np(a, b),
                               rtol=0, atol=1e-6)
    a7 = np.stack([boxes7(32, seed + f) for f in range(3)])
    b7 = np.stack([boxes7(16, seed + 5 + f) for f in range(3)])
    got = tri.d3_iou_frames_np(a7, b7, device=CPU)
    np.testing.assert_allclose(got, jri.d3_iou_frames_np(a7, b7), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tri.d3_iou_lidar(torch.from_numpy(a7[0]), torch.from_numpy(b7[0])).numpy(),
                               np.asarray(jri.d3_iou_lidar(a7[0], b7[0])), rtol=0, atol=1e-6)
    assert (got > 0).any()


def test_wrappers_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = random_rboxes(2, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tri.rotate_iou_eval_np(a, a)


# --- official mAP ---------------------------------------------------------------


def eval_annos(n_frames=6, seed=0):
    """Ground truth of synthetic scenes, and detections made from it: each
    gt jittered (some far enough to miss at 0.7 or 0.5), some dropped,
    some duplicated, false positives added, random scores; two frames with
    no detection, one with no gt."""
    cfg = pu.small_cfg().replace(max_points=4096)
    r = np.random.RandomState(seed)
    gts, dts = [], []
    for f in range(n_frames):
        gt = scene_to_annos(sample_scene(cfg, r, (4, 10), ground_points=100, max_range=30.0), cfg)
        gt["num_points"] = r.choice([0, 3, 50, 200], len(gt["name"]), p=[0.1, 0.2, 0.3, 0.4])
        if f == 5:
            gt = {k: v[:0] for k, v in gt.items()}
        keep = r.rand(len(gt["name"])) > 0.15
        dup = r.rand(len(gt["name"])) > 0.8
        idx = np.concatenate([np.nonzero(keep)[0], np.nonzero(dup)[0]])
        n = len(idx)
        loc = gt["location"][idx] + r.normal(0, 0.25, (n, 3)).astype(np.float32)
        dims = gt["dimensions"][idx] * r.uniform(0.8, 1.2, (n, 3)).astype(np.float32)
        rot = gt["rotation_y"][idx] + r.normal(0, 0.15, n).astype(np.float32)
        names = gt["name"][idx]
        nfp = r.randint(2, 6)
        fp_loc = r.uniform(-30, 30, (nfp, 3)).astype(np.float32)
        fp_dims = r.uniform(0.8, 5, (nfp, 3)).astype(np.float32)
        dt = {
            "name": np.concatenate([names, r.choice(["vehicle", "pedestrian", "cyclist"], nfp)]),
            "location": np.concatenate([loc, fp_loc]),
            "dimensions": np.concatenate([dims, fp_dims]),
            "rotation_y": np.concatenate([rot, r.uniform(-3, 3, nfp).astype(np.float32)]),
            "score": r.uniform(0.05, 1.0, n + nfp).astype(np.float32),
        }
        if f in (2, 4):
            dt = {k: v[:0] for k, v in dt.items()}
        gts.append(gt)
        dts.append(dt)
    return cfg, gts, dts


@pytest.mark.parametrize("range_thresh", [80.0, 20.0])
def test_official_eval_result_equals_jax(range_thresh):
    cfg, gts, dts = eval_annos()
    classes = list(cfg.detect_class)
    got_num, got_str = tap.get_official_eval_result(gts, dts, classes, range_thresh, device=CPU)
    want_num, want_str = jap.get_official_eval_result(gts, dts, classes, range_thresh)
    assert got_str == want_str
    for g, w in zip(got_num, want_num):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    assert max(float(np.max(w)) for w in want_num) > 0


def test_official_eval_range_sweep_with_cache_equals_jax():
    cfg, gts, dts = eval_annos(seed=3)
    classes = list(cfg.detect_class)
    tcache, jcache = {}, {}
    for rt in (80.0, 25.0, 15.0):
        got = tap.get_official_eval_result(gts, dts, classes, rt, overlaps_cache=tcache, device=CPU)[1]
        assert got == jap.get_official_eval_result(gts, dts, classes, rt, overlaps_cache=jcache)[1]
    for metric in ("bev", "3d"):
        with jax.disable_jit():
            op_by_op = jap._frame_overlaps(gts, dts, metric)
        for g, w, e in zip(tcache[metric], jcache[metric], op_by_op):
            np.testing.assert_allclose(g, e, rtol=0, atol=1e-6)
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="different annos"):
        tap.get_official_eval_result(list(gts), dts, classes, 80.0, overlaps_cache=tcache, device=CPU)


def test_frame_overlaps_chunks_like_jax(monkeypatch):
    """Several chunks per metric (a small chunk budget) give the same
    matrices as one."""
    cfg, gts, dts = eval_annos(seed=5)
    whole = tap._frame_overlaps(gts, dts, "3d", CPU)
    monkeypatch.setattr(tap, "_CHUNK_ELEMS", 1)
    for g, w in zip(tap._frame_overlaps(gts, dts, "3d", CPU), whole):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tap._frame_overlaps(gts, dts, "2d", CPU)
