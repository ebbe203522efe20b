"""Parity of the port's target assignment (targets.py, ops/geometry.py) with
the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions and
the port's plain versions (the CUDA matcher's twin):
  * geometry: `rbbox2d_to_near_bbox`, `iou_matrix` and
    `box_encode_transposed` — allclose 1e-6 (the same float32 operations
    in the same order; torch and XLA may vectorise `log` and `sqrt`
    differently);
  * `_assign_one_class` against JAX's `assign_class_pallas(...,
    interpret=True)` per class, and the whole batch assigner against JAX's
    `make_target_assigner(..., use_pallas=False)` per sample, at the small
    and mid geometries, with the no-gt and every-anchor-masked cases:
    labels, weights and dir equal; targets within 1e-6 (rtol and atol).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu.anchors import build_anchors as jax_build_anchors
from det3d_tpu.kernels.matcher_pallas import assign_class_pallas
from det3d_tpu.ops import geometry as jgeo
from det3d_tpu.targets import make_target_assigner as jax_make_target_assigner
from det3d_tpu.targets import pad_gt as jax_pad_gt
from det3d_tpu_torch.anchors import build_anchors
from det3d_tpu_torch.kernels import matcher_cuda
from det3d_tpu_torch.ops import geometry as tgeo
from det3d_tpu_torch.targets import _assign_one_class, make_target_assigner, pad_gt

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
CONFIGS = {"small": pu.small_cfg, "mid": pu.mid_cfg}


def random_boxes(n, seed, spread=40.0):
    r = np.random.RandomState(seed)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = r.uniform(-spread, spread, (n, 2))
    boxes[:, 2] = r.uniform(-3, 1, n)
    boxes[:, 3:6] = r.uniform(0.5, 8, (n, 3))
    boxes[:, 6] = r.uniform(-2 * np.pi, 2 * np.pi, n)
    return boxes


class TestGeometry:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_rbbox2d_to_near_bbox(self, seed):
        rb = random_boxes(300, seed)[:, [0, 1, 3, 4, 6]]
        rb[:10, 4] = np.float32(np.pi / 4)  # on the swap boundary
        want = np.asarray(jgeo.rbbox2d_to_near_bbox(jnp.asarray(rb)))
        got = tgeo.rbbox2d_to_near_bbox(torch.from_numpy(rb)).numpy()
        np.testing.assert_allclose(got, want, **TOL)

    @pytest.mark.parametrize("eps", [0.0, 1.0])
    def test_iou_matrix(self, eps):
        a = jgeo.rbbox2d_to_near_bbox(jnp.asarray(random_boxes(60, 2, spread=10.0)[:, [0, 1, 3, 4, 6]]))
        b = jgeo.rbbox2d_to_near_bbox(jnp.asarray(random_boxes(80, 3, spread=10.0)[:, [0, 1, 3, 4, 6]]))
        a, b = np.asarray(a), np.asarray(b)
        want = np.asarray(jgeo.iou_matrix(jnp.asarray(a), jnp.asarray(b), eps=eps))
        got = tgeo.iou_matrix(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()), eps=eps).numpy()
        assert (want > 0).sum() > 50  # the boxes overlap often enough to test the maths
        np.testing.assert_array_equal(got, want)

    def test_box_encode_transposed(self):
        g, a = random_boxes(500, 4), random_boxes(500, 5)
        want = np.asarray(jgeo.box_encode_transposed(jnp.asarray(g.T), jnp.asarray(a.T)))
        got = tgeo.box_encode_transposed(torch.from_numpy(g.T.copy()), torch.from_numpy(a.T.copy())).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def gt_case(cfg, aset, seed, n_gt):
    """Padded gt of random classes placed on anchor centres (so that IoUs
    reach the thresholds and force-matching ties happen), and a random
    anchor mask; numpy."""
    r = np.random.RandomState(seed)
    n_gt = min(n_gt, cfg.max_gt_boxes)
    classes = r.randint(1, len(cfg.class_specs) + 1, n_gt).astype(np.int32)
    boxes = np.zeros((n_gt, 7), np.float32)
    for i, c in enumerate(classes):
        spec = cfg.class_specs[c - 1]
        anchors = aset.anchors_by_class[spec.name]
        boxes[i] = anchors[r.randint(len(anchors))]
        boxes[i, :2] += r.uniform(-0.6, 0.6, 2)
        boxes[i, 3:6] *= r.uniform(0.6, 1.4, 3)
        boxes[i, 6] = r.uniform(-np.pi, np.pi)
    boxes[0, 3:5] = (0.3, 0.2)  # a tiny gt: matched by force only
    mask = r.rand(aset.num_anchors) > 0.3
    return boxes, classes, mask


def cases(cfg, aset, seed):
    """(name, padded boxes, classes, valid, flat mask) cases."""
    boxes, classes, mask = gt_case(cfg, aset, seed, n_gt=cfg.max_gt_boxes - 2)  # two padding rows
    pb, pc, pv = pad_gt(cfg, boxes, classes)
    return [
        ("random", pb, pc, pv, mask),
        ("no valid gt", pb, pc, np.zeros_like(pv), mask),
        ("every anchor masked", pb, pc, pv, np.zeros_like(mask)),
    ]


@pytest.fixture(scope="module", params=list(CONFIGS))
def geometry(request):
    jcfg = CONFIGS[request.param]()
    return request.param, jcfg, pu.to_torch_cfg(jcfg), jax_build_anchors(jcfg), build_anchors(pu.to_torch_cfg(jcfg))


def test_pad_gt_equals_jax(geometry):
    _, jcfg, tcfg, jset, _ = geometry
    boxes, classes, _ = gt_case(jcfg, jset, 7, n_gt=5)
    for a, b in zip(pad_gt(tcfg, boxes, classes), jax_pad_gt(jcfg, boxes, classes)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_one_class_matches_pallas_interpret(geometry, seed):
    _, jcfg, tcfg, jset, tset = geometry
    fx, fy = tset.grid_hw
    for name, boxes, classes, valid, mask in cases(jcfg, jset, seed):
        mask_ch = mask.reshape(tset.num_channels, fx * fy)
        for ci, spec in enumerate(jcfg.class_specs):
            c0, c1 = tset.class_channels[spec.name]
            cls_valid = valid & (classes == ci + 1)
            args = (tset.anchors_by_class[spec.name], tset.anchors_bv_by_class[spec.name],
                    mask_ch[c0:c1].reshape(-1), boxes, cls_valid)
            thr = (spec.matched_threshold, spec.unmatched_threshold)
            want = assign_class_pallas(*(jnp.asarray(a) for a in args), *thr, interpret=True)
            got = _assign_one_class(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), *thr)
            msg = f"{name}, class {spec.name}"
            for k in (0, 2, 3):  # labels, weights, dir
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=msg)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), err_msg=msg, **TOL)
            if name == "random" and cls_valid.any():
                assert (got[0] > 0).any(), msg  # force-matching gives every class a positive


def test_batch_assigner_matches_jax_dense(geometry):
    which, jcfg, tcfg, jset, tset = geometry
    fms = jcfg.feature_map_size
    jassign = jax.jit(jax_make_target_assigner(jcfg, jset, use_pallas=False))
    assigner = make_target_assigner(tcfg, tset, "cpu")
    for (name, *a), (_, *b) in zip(cases(jcfg, jset, 2), cases(jcfg, jset, 3)):
        # a batch of two samples, one from each seed
        boxes, classes, valid, mask = (np.stack(x) for x in zip(a, b))
        spatial = mask.reshape(2, tset.num_channels, fms[0], fms[1])
        before = (matcher_cuda.gt_max_counter.launches, matcher_cuda.assign_counter.launches)
        got = assigner(*(torch.from_numpy(a) for a in (boxes, classes, valid, spatial)))
        assert (matcher_cuda.gt_max_counter.launches, matcher_cuda.assign_counter.launches) == before
        for i in range(2):
            want = jassign(*(jnp.asarray(a[i]) for a in (boxes, classes, valid, spatial)))
            msg = f"{which} {name} sample {i}"
            np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want.labels), err_msg=msg)
            np.testing.assert_array_equal(got.bbox_outside_weights[i].numpy(),
                                          np.asarray(want.bbox_outside_weights), err_msg=msg)
            np.testing.assert_array_equal(got.dir_targets[i].numpy(), np.asarray(want.dir_targets), err_msg=msg)
            np.testing.assert_allclose(got.bbox_targets[i].numpy(), np.asarray(want.bbox_targets),
                                       err_msg=msg, **TOL)


def test_no_gt_and_all_masked_semantics(geometry):
    _, jcfg, tcfg, jset, tset = geometry
    fms = jcfg.feature_map_size
    assigner = make_target_assigner(tcfg, tset, "cpu")
    _, (_, b1, c1, v1, m1), (_, b2, c2, v2, m2) = cases(jcfg, jset, 4)
    spatial = np.stack([m1, m2]).reshape(2, tset.num_channels, fms[0], fms[1])
    out = assigner(*(torch.from_numpy(np.stack(x)) for x in ((b1, b2), (c1, c2), (v1, v2))),
                   torch.from_numpy(spatial))
    labels = out.labels.numpy()
    # no valid gt: included anchors are background, excluded ones ignored
    np.testing.assert_array_equal(labels[0], np.where(spatial[0], 0, -1))
    # every anchor masked: all ignored, zero targets and weights
    assert (labels[1] == -1).all() and not out.bbox_targets[1].any() and not out.bbox_outside_weights[1].any()
    # dir comes from the zero target + anchor yaw for every anchor
    yaw = tset.anchors[:, 6].reshape(tset.num_channels, fms[0], fms[1])
    np.testing.assert_array_equal(out.dir_targets[1].numpy(), (yaw > 0).astype(np.int32))


def test_gt_max_plain_matches_dense_jax(geometry):
    """The plain twin of the matcher's pass 1: each gt's best IoU over its
    class's included anchors, -1 where there is none."""
    _, jcfg, tcfg, jset, tset = geometry
    fms = jcfg.feature_map_size
    assigner = make_target_assigner(tcfg, tset, "cpu")
    _, boxes, classes, valid, mask = cases(jcfg, jset, 5)[0]
    valid[-1] = True  # a padding-class row marked valid matches no class
    spatial = mask.reshape(1, tset.num_channels, fms[0], fms[1])
    got = assigner.gt_max_plain(*(torch.from_numpy(a[None]) for a in (boxes, classes, valid)),
                                torch.from_numpy(spatial))[0].numpy()
    gt_bv = jgeo.rbbox2d_to_near_bbox(jnp.asarray(boxes[:, [0, 1, 3, 4, 6]]))
    want = np.full(len(boxes), -1.0, np.float32)
    hw = fms[0] * fms[1]
    for ci, spec in enumerate(jcfg.class_specs):
        c0, c1 = jset.class_channels[spec.name]
        iou = np.asarray(jgeo.iou_matrix(gt_bv, jnp.asarray(jset.anchors_bv[c0 * hw : c1 * hw])))
        cls_valid = valid & (classes == ci + 1)
        iou = np.where(cls_valid[:, None] & mask[None, c0 * hw : c1 * hw], iou, -1.0)
        want = np.where(cls_valid, iou.max(axis=1), want)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == -1.0 and (got[:-1] > 0).any()
