"""The algorithm of `det3d_tpu_torch/kernels/csrc/matcher.cu`, emulated in numpy.

The CUDA kernels run only on a card; this file runs their algorithm as
designed on the CPU:

  * `chunk_boxes` (targets.py): one standup bounding box per chunk of
    consecutive anchors;
  * `candidates`: per chunk, the valid gt rows of the chunk's classes whose
    standup box is not disjoint from the chunk's box, in ascending order;
  * `emulate_gt_max` (pass 1): the maximum over the candidates' IoUs only,
    plus IoU 0 for every valid gt whose class has an included anchor;
  * `emulate_assign` (pass 2): every included anchor starts from the result
    of a row of zeros (max 0 and the class's first valid row, or -1 and row
    0) and walks its chunk's candidates with the strict `>` and the
    force-match test.

and holds the results against the port's plain dense versions
(`TargetAssigner.plain`, `gt_max_plain`) and the JAX package's
`assign_class_pallas(interpret=True)` per class. Tolerance: labels, weights,
dir and gt-max are equal (every version evaluates the same float32 IoU
expression in the same order); targets agree within rtol = atol = 1e-6
(numpy, torch and XLA may round `log` and `sqrt` differently).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu.kernels.matcher_pallas import assign_class_pallas
from det3d_tpu_torch.anchors import build_anchors
from det3d_tpu_torch.kernels import matcher_cuda
from det3d_tpu_torch.targets import chunk_boxes, gt_standup, make_target_assigner, pad_gt

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
CASES = [
    "random scene",
    "no valid gt",
    "every anchor masked",
    "class with valid gt and no included anchor",
    "class with included anchors and no valid gt",
    "gt outside the range",
    "zero-size gt",
    "two gt with one standup box",
    "boxes that only touch",
    "matched threshold 0",
    "G = 256",
    "chunk divides neither the class range nor A",
]


# --- the kernels' algorithm ------------------------------------------------


def iou_rows(b: np.ndarray, q: np.ndarray) -> np.ndarray:
    """IoU of one gt standup box b (4,) with anchor standup boxes q (n, 4) in
    float32, in `iou`'s order of operations; 0 for a disjoint pair."""
    iw = np.minimum(b[2], q[:, 2]) - np.maximum(b[0], q[:, 0])
    ih = np.minimum(b[3], q[:, 3]) - np.maximum(b[1], q[:, 1])
    overlap = (iw > 0) & (ih > 0)
    inter = np.where(overlap, iw * ih, np.float32(0))
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    area_q = (q[:, 2] - q[:, 0]) * (q[:, 3] - q[:, 1])
    uni = area_b + area_q - inter
    assert uni.dtype == np.float32
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(inter > 0, inter / uni, np.float32(0)).astype(np.float32)


class Sample:
    """One sample's gt tables as a block keeps them in shared memory."""

    def __init__(self, gt_bv, gt_classes, gt_valid, ncls):
        cls = np.where(gt_valid, gt_classes.astype(np.int64) - 1, -1)
        self.cls = np.where(cls >= ncls, -1, cls)
        self.bv = gt_bv
        valid_rows = np.flatnonzero(self.cls >= 0)
        self.rows = int(valid_rows[-1]) + 1 if valid_rows.size else 0
        self.first = [next((int(g) for g in valid_rows if self.cls[g] == c), None) for c in range(ncls)]


def anchor_classes(class_start: np.ndarray, a: int) -> np.ndarray:
    return np.searchsorted(class_start[1:-1], np.arange(a), side="right")


def candidates(sample: Sample, box: np.ndarray, c_lo: int, c_hi: int) -> list[int]:
    """Ascending rows the chunk keeps: its classes' valid gt that are not
    surely disjoint from the chunk's box."""
    keep = []
    for g in range(sample.rows):
        b = sample.bv[g]
        if c_lo <= sample.cls[g] <= c_hi and not (b[2] <= box[0]) and not (box[2] <= b[0]) \
                and not (b[3] <= box[1]) and not (box[3] <= b[1]):
            keep.append(g)
    return keep


def chunks_of(tables, chunk: int):
    """(a0, a1, box, c_lo, c_hi) of every chunk."""
    a = tables["anchors_bv"].shape[0]
    acls = anchor_classes(tables["class_start"], a)
    boxes = chunk_boxes(tables["anchors_bv"], chunk)
    assert boxes.shape == (-(-a // chunk), 4) and boxes.dtype == np.float32
    for i, box in enumerate(boxes):
        a0, a1 = i * chunk, min((i + 1) * chunk, a)
        yield a0, a1, box, int(acls[a0]), int(acls[a1 - 1])


def emulate_gt_max(tables, mask, gt_bv, gt_classes, gt_valid, chunk: int):
    """Pass 1 for one sample: (G,) float32 and the number of (chunk,
    candidate) pairs it visited."""
    ncls = len(tables["class_start"]) - 1
    sample = Sample(gt_bv, gt_classes, gt_valid, ncls)
    acls = anchor_classes(tables["class_start"], mask.shape[0])
    best = np.full(len(gt_bv), -1.0, np.float32)
    seen = set(np.unique(acls[mask]).tolist())  # classes with an included anchor
    visited = 0
    for a0, a1, box, c_lo, c_hi in chunks_of(tables, chunk):
        for g in candidates(sample, box, c_lo, c_hi):
            visited += 1
            rows = mask[a0:a1] & (acls[a0:a1] == sample.cls[g])
            if rows.any():
                v = iou_rows(gt_bv[g], tables["anchors_bv"][a0:a1][rows]).max()
                if v > 0:
                    best[g] = max(best[g], v)
    for g in range(len(gt_bv)):
        if sample.cls[g] in seen:
            best[g] = max(best[g], np.float32(0))  # its disjoint pairs contribute IoU 0
    return best, visited


def emulate_assign(tables, mask, gt_boxes, gt_bv, gt_classes, gt_valid, gmax, chunk: int):
    """Pass 2 for one sample: labels (A,), targets (7, A), weights (A,), dirs (A,)."""
    ncls = len(tables["class_start"]) - 1
    sample = Sample(gt_bv, gt_classes, gt_valid, ncls)
    a = mask.shape[0]
    acls = anchor_classes(tables["class_start"], a)
    anchors_t = tables["anchors_t"]
    thr = tables["thresholds"]
    labels = np.empty(a, np.int32)
    targets = np.zeros((7, a), np.float32)
    for a0, a1, box, c_lo, c_hi in chunks_of(tables, chunk):
        n = a1 - a0
        cls = acls[a0:a1]
        has = np.array([sample.first[c] is not None for c in cls])
        amax = np.where(has, np.float32(0), np.float32(-1)).astype(np.float32)
        arg = np.array([sample.first[c] if sample.first[c] is not None else 0 for c in cls])
        force = np.zeros(n, bool)
        for g in candidates(sample, box, c_lo, c_hi):  # ascending: the first maximum wins
            rows = mask[a0:a1] & (cls == sample.cls[g])
            ov = iou_rows(gt_bv[g], tables["anchors_bv"][a0:a1])
            better = rows & (ov > amax)
            amax = np.where(better, ov, amax)
            arg = np.where(better, g, arg)
            force |= rows & (ov == gmax[g]) & (gmax[g] > 0)
        pos = force | (amax >= thr[cls, 0])
        bg = amax < thr[cls, 1]
        lab = np.where(pos, 1, np.where(bg, 0, -1))
        labels[a0:a1] = np.where(mask[a0:a1], lab, -1)
        for j in np.flatnonzero(labels[a0:a1] > 0):
            gb = gt_boxes[arg[j]]
            xa, ya, za, la, wa, ha, ra = anchors_t[:, a0 + j]
            diagonal = np.sqrt(la * la + wa * wa)
            with np.errstate(divide="ignore"):
                targets[:, a0 + j] = [(gb[0] - xa) / diagonal, (gb[1] - ya) / diagonal, (gb[2] - za) / ha,
                                      np.log(gb[3] / la), np.log(gb[4] / wa), np.log(gb[5] / ha), gb[6] - ra]
    weights = (labels > 0).astype(np.float32)
    dirs = ((targets[6] + anchors_t[6]) > 0).astype(np.int32)
    return labels, targets, weights, dirs


# --- the cases -------------------------------------------------------------


def scene(cfg, aset, seed, n_gt, classes=None):
    """gt of random classes on anchor centres (IoUs reach the thresholds and
    force-matching ties happen), one tiny gt, and a random anchor mask."""
    r = np.random.RandomState(seed)
    if classes is None:
        classes = r.randint(1, len(cfg.class_specs) + 1, n_gt)
    classes = np.asarray(classes, np.int32)
    boxes = np.zeros((len(classes), 7), np.float32)
    for i, c in enumerate(classes):
        anchors = aset.anchors_by_class[cfg.class_specs[c - 1].name]
        boxes[i] = anchors[r.randint(len(anchors))]
        boxes[i, :2] += r.uniform(-0.6, 0.6, 2)
        boxes[i, 3:6] *= r.uniform(0.6, 1.4, 3)
        boxes[i, 6] = r.uniform(-np.pi, np.pi)
    boxes[0, 3:5] = (0.3, 0.2)  # a tiny gt: matched by force only
    return boxes, classes, r.rand(aset.num_anchors) > 0.3


def touching_gt(aset, cls_name: str) -> np.ndarray:
    """A gt of the class whose standup box starts exactly where an anchor's
    ends: x1 of the gt == x2 of the anchor in float32."""
    anchors = aset.anchors_by_class[cls_name]
    bvs = aset.anchors_bv_by_class[cls_name]
    one = np.float32(1.0)
    for anchor, bv in zip(anchors, bvs):
        x = np.float32(bv[2] + one)
        if np.float32(x - one) == bv[2]:
            gt = anchor.copy()
            gt[0], gt[3], gt[4], gt[6] = x, 2.0, 2.0, 0.0
            return gt
    raise AssertionError("no anchor edge survives + 1 - 1 in float32")


def build_case(name: str):
    """(cfg, anchor set, gt_boxes (2, G, 7), gt_classes, gt_valid, mask (2, A), chunk)."""
    cfg = pu.to_torch_cfg(pu.small_cfg())
    chunk = matcher_cuda.CHUNK
    if name == "G = 256":
        cfg = cfg.replace(max_gt_boxes=256)
    if name == "matched threshold 0":
        cfg = cfg.replace(class_specs=tuple(
            dataclasses.replace(s, matched_threshold=0.0, unmatched_threshold=0.0) for s in cfg.class_specs))
    if name == "chunk divides neither the class range nor A":
        chunk = 100
    aset = build_anchors(cfg)
    ncls = len(cfg.class_specs)
    hw = aset.grid_hw[0] * aset.grid_hw[1]
    n_gt = 200 if name == "G = 256" else cfg.max_gt_boxes - 2
    classes = None
    if name == "class with included anchors and no valid gt":
        classes = np.random.RandomState(5).randint(2, ncls + 1, n_gt)  # none of class 1
    boxes, classes, mask = scene(cfg, aset, 11, n_gt, classes)
    c0, c1 = aset.class_channels[cfg.class_specs[1].name]
    if name == "every anchor masked":
        mask[:] = False
    elif name == "class with valid gt and no included anchor":
        classes[1] = 2
        mask[c0 * hw : c1 * hw] = False
    elif name == "gt outside the range":
        boxes[:, :2] += 100.0
    elif name == "zero-size gt":
        boxes[1, 3:5] = 0.0
        boxes[2, 3] = 0.0
    elif name == "two gt with one standup box":
        # equal IoU with every anchor, other z and height: the first row must be matched
        classes[2] = classes[1]
        boxes[2] = boxes[1]
        boxes[2, 2] += 1.0
        boxes[2, 5] *= 1.2
    elif name == "boxes that only touch":
        boxes[1] = touching_gt(aset, cfg.class_specs[classes[1] - 1].name)
    samples = [pad_gt(cfg, boxes, classes), pad_gt(cfg, *scene(cfg, aset, 12, 3)[:2])]
    gt_boxes, gt_classes, gt_valid = (np.stack(x) for x in zip(*samples))
    if name == "no valid gt":
        gt_valid[0] = False
    masks = np.stack([mask, np.random.RandomState(13).rand(aset.num_anchors) > 0.5])
    return cfg, aset, gt_boxes, gt_classes, gt_valid, masks, chunk


@pytest.fixture(scope="module", params=CASES)
def case(request):
    cfg, aset, gt_boxes, gt_classes, gt_valid, masks, chunk = build_case(request.param)
    assigner = make_target_assigner(cfg, aset, "cpu")
    tables = {k: v.numpy() for k, v in assigner.tables._asdict().items()}
    gt_bv = gt_standup(torch.from_numpy(gt_boxes)).numpy()
    emulated = []
    for b in range(2):
        gmax, visited = emulate_gt_max(tables, masks[b], gt_bv[b], gt_classes[b], gt_valid[b], chunk)
        out = emulate_assign(tables, masks[b], gt_boxes[b], gt_bv[b], gt_classes[b], gt_valid[b], gmax, chunk)
        emulated.append((gmax, visited, out))
    return dict(name=request.param, cfg=cfg, aset=aset, assigner=assigner, tables=tables, gt_boxes=gt_boxes,
                gt_bv=gt_bv, gt_classes=gt_classes, gt_valid=gt_valid, masks=masks, chunk=chunk, emulated=emulated)


def spatial(case, masks):
    fx, fy = case["aset"].grid_hw
    return torch.from_numpy(masks.reshape(len(masks), -1, fx, fy))


# --- tests -----------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 7, 128, 5000])
def test_chunk_boxes_bound_their_anchors(chunk):
    r = np.random.RandomState(chunk)
    lo = r.uniform(-50, 50, (1000, 2)).astype(np.float32)
    bv = np.concatenate([lo, lo + r.uniform(0.1, 9, (1000, 2)).astype(np.float32)], axis=1)
    got = chunk_boxes(bv, chunk)
    assert got.shape == (-(-1000 // chunk), 4) and got.dtype == np.float32 and got.flags.c_contiguous
    for i, box in enumerate(got):
        rows = bv[i * chunk : (i + 1) * chunk]
        np.testing.assert_array_equal(box, np.concatenate([rows[:, :2].min(0), rows[:, 2:].max(0)]))
    assert chunk_boxes(bv[:0], chunk).shape == (0, 4)


def test_tables_hold_the_planar_anchors_and_chunk_boxes():
    cfg = pu.to_torch_cfg(pu.small_cfg())
    aset = build_anchors(cfg)
    t = make_target_assigner(cfg, aset, "cpu").tables
    assert t.anchors_t.is_contiguous() and torch.equal(t.anchors_t, t.anchors.T)
    np.testing.assert_array_equal(t.chunk_bv.numpy(), chunk_boxes(aset.anchors_bv, matcher_cuda.CHUNK))
    assert t.chunk_bv.shape == (-(-aset.num_anchors // matcher_cuda.CHUNK), 4)


def test_cull_never_drops_an_overlapping_pair(case):
    """Every (gt, anchor) pair of one class with a positive IoU has its gt on
    its chunk's candidate list, and the list ascends."""
    tables = case["tables"]
    ncls = len(tables["class_start"]) - 1
    acls = anchor_classes(tables["class_start"], tables["anchors_bv"].shape[0])
    for b in range(2):
        sample = Sample(case["gt_bv"][b], case["gt_classes"][b], case["gt_valid"][b], ncls)
        for a0, a1, box, c_lo, c_hi in chunks_of(tables, case["chunk"]):
            cand = candidates(sample, box, c_lo, c_hi)
            assert cand == sorted(cand)
            for g in np.flatnonzero(sample.cls >= 0):
                ov = iou_rows(case["gt_bv"][b][g], tables["anchors_bv"][a0:a1])
                if ((ov > 0) & (acls[a0:a1] == sample.cls[g])).any():
                    assert g in cand, (b, a0, g)


def test_emulated_gt_max_equals_plain(case):
    want = case["assigner"].gt_max_plain(
        *(torch.from_numpy(case[k]) for k in ("gt_boxes", "gt_classes", "gt_valid")), spatial(case, case["masks"]))
    for b in range(2):
        np.testing.assert_array_equal(case["emulated"][b][0], want[b].numpy(), err_msg=f"sample {b}")
    name, gmax, visited = case["name"], case["emulated"][0][0], case["emulated"][0][1]
    valid = case["gt_valid"][0]
    if name in ("no valid gt", "every anchor masked"):
        assert (gmax == -1).all()
    elif name == "class with valid gt and no included anchor":
        cls2 = valid & (case["gt_classes"][0] == 2)
        assert cls2.any() and (gmax[cls2] == -1).all() and (gmax[valid & ~cls2] >= 0).all()
    elif name == "gt outside the range":
        assert visited == 0 and (gmax[valid] == 0).all()
    elif name == "zero-size gt":
        assert gmax[1] == 0 and gmax[2] == 0
    elif name == "boxes that only touch":
        assert visited > 0
    else:
        assert (gmax[valid] >= 0).all() and (gmax[valid] > 0).any()


def test_emulated_assignment_equals_plain(case):
    want = case["assigner"].plain(
        *(torch.from_numpy(case[k]) for k in ("gt_boxes", "gt_classes", "gt_valid")), spatial(case, case["masks"]))
    for b in range(2):
        labels, targets, weights, dirs = case["emulated"][b][2]
        msg = f"sample {b}"
        np.testing.assert_array_equal(labels, want.labels[b].reshape(-1).numpy(), err_msg=msg)
        np.testing.assert_array_equal(weights, want.bbox_outside_weights[b].reshape(-1).numpy(), err_msg=msg)
        np.testing.assert_array_equal(dirs, want.dir_targets[b].reshape(-1).numpy(), err_msg=msg)
        np.testing.assert_allclose(targets, want.bbox_targets[b].reshape(7, -1).numpy(), err_msg=msg, **TOL)
    labels, targets = case["emulated"][0][2][:2]
    name = case["name"]
    if name in ("no valid gt", "every anchor masked", "gt outside the range"):
        assert not (labels > 0).any()
    elif name == "matched threshold 0":
        # every included anchor of a class with a valid gt is positive, most on a row of zeros
        acls = anchor_classes(case["tables"]["class_start"], len(labels))
        present = np.isin(acls + 1, case["gt_classes"][0][case["gt_valid"][0]])
        np.testing.assert_array_equal(labels > 0, case["masks"][0] & present)
    elif name == "two gt with one standup box":
        # the second row ties with the first everywhere and is never matched:
        # no positive anchor carries its z target
        anchors_t = case["tables"]["anchors_t"]
        pos = np.flatnonzero(labels > 0)
        z2 = (case["gt_boxes"][0, 2, 2] - anchors_t[2, pos]) / anchors_t[5, pos]
        z1 = (case["gt_boxes"][0, 1, 2] - anchors_t[2, pos]) / anchors_t[5, pos]
        assert np.isclose(targets[2, pos], z1, atol=1e-5).any()
        assert not np.isclose(targets[2, pos], z2, atol=1e-5).any()
    else:
        assert (labels > 0).any()


def test_emulated_assignment_equals_pallas_interpret(case):
    """Sample 0 of every case against the JAX package's matcher kernels."""
    cfg, aset = case["cfg"], case["aset"]
    hw = aset.grid_hw[0] * aset.grid_hw[1]
    labels, targets, weights, dirs = case["emulated"][0][2]
    mask, boxes = case["masks"][0], case["gt_boxes"][0]
    for ci, spec in enumerate(cfg.class_specs):
        c0, c1 = aset.class_channels[spec.name]
        rows = slice(c0 * hw, c1 * hw)
        cls_valid = case["gt_valid"][0] & (case["gt_classes"][0] == ci + 1)
        args = (aset.anchors_by_class[spec.name], aset.anchors_bv_by_class[spec.name], mask[rows], boxes, cls_valid)
        want = assign_class_pallas(*(jnp.asarray(a) for a in args), spec.matched_threshold,
                                   spec.unmatched_threshold, interpret=True)
        msg = f"class {spec.name}"
        np.testing.assert_array_equal(labels[rows], np.asarray(want[0]), err_msg=msg)
        np.testing.assert_array_equal(weights[rows], np.asarray(want[2]), err_msg=msg)
        np.testing.assert_array_equal(dirs[rows], np.asarray(want[3]), err_msg=msg)
        np.testing.assert_allclose(targets[:, rows], np.asarray(want[1]), err_msg=msg, **TOL)


def test_wrapper_rejects_tables_of_another_chunk():
    """The kernels index `chunk_bv` by warp chunk: a table made for another
    chunk size is refused before any launch (the shape check runs ahead of
    the device check)."""
    cfg = pu.to_torch_cfg(pu.small_cfg())
    aset = build_anchors(cfg)
    assigner = make_target_assigner(cfg, aset, "cpu")
    bad = assigner.tables._replace(chunk_bv=torch.from_numpy(chunk_boxes(aset.anchors_bv, 100)))
    boxes, classes, mask = scene(cfg, aset, 0, 4)
    gt_boxes, gt_classes, gt_valid = (torch.from_numpy(x[None]) for x in pad_gt(cfg, boxes, classes))
    with pytest.raises(ValueError, match="chunk_bv"):
        matcher_cuda.match_cuda(bad, torch.from_numpy(mask[None]), gt_boxes, gt_standup(gt_boxes), gt_classes,
                                gt_valid)
