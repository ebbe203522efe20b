"""KITTI-protocol average precision (AP@41 recall points), BEV + 3D, lidar
frame.

The port's own copy of the JAX package's eval/ap.py (reference:
eval/eval.py): numpy bookkeeping, with the rotated-IoU matrices computed by
the port's `ops/rotated_iou.py` on `device` ("cuda" unless the caller
names another):

  * per-class ignore logic by num_points (> 5) and range (clean_data,
    eval/eval.py:10-39);
  * adaptive score thresholds targeting 41 recall samples (get_thresholds,
    :42-59);
  * greedy TP/FP/FN matching (compute_statistics_jit, :62-118), and the
    same matching for all thresholds in one pass;
  * 11-point-style mAP sum over every 4th recall position (get_mAP,
    :443-447);
  * class min-overlaps vehicle 0.7/0.5, pedestrian & cyclist 0.5/0.25
    (:461-464).

`clean_data`, `get_thresholds` and `compute_statistics` mirror the
reference's bookkeeping loop for loop, so that the official result string
is the reference's (and the JAX package's) character for character.
"""

from __future__ import annotations

import numpy as np


N_SAMPLE_PTS = 41
MIN_OVERLAPS = {
    "vehicle": [0.7, 0.5],
    "pedestrian": [0.5, 0.25],
    "cyclist": [0.5, 0.25],
}
NO_DETECTION = -10000000


def clean_data(gt_anno, dt_anno, current_class, num_points_thresh, range_thresh):
    """Ignore flags: -1 skip entirely, 0 count, 1 match-but-don't-count.
    Reference eval/eval.py:10-39."""
    cls = current_class.lower()
    ignored_gt, ignored_dt = [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        if gt_anno["name"][i].lower() != cls:
            ignored_gt.append(-1)
        elif gt_anno["num_points"][i] == 0:
            ignored_gt.append(-1)
        elif not np.hypot(gt_anno["location"][i][0], gt_anno["location"][i][1]) < range_thresh:
            ignored_gt.append(-1)
        elif gt_anno["num_points"][i] > num_points_thresh:
            ignored_gt.append(0)
            num_valid_gt += 1
        else:
            ignored_gt.append(1)
    for i in range(len(dt_anno["name"])):
        if dt_anno["name"][i].lower() == cls and np.hypot(
            dt_anno["location"][i][0], dt_anno["location"][i][1]
        ) < range_thresh:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, np.array(ignored_gt, np.int64), np.array(ignored_dt, np.int64)


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts: int = N_SAMPLE_PTS):
    """Adaptive recall-spaced score thresholds (reference eval/eval.py:42-59)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def compute_statistics(overlaps, ignored_gt, ignored_det, dt_scores,
                       min_overlap, thresh=0.0, compute_fp=False):
    """Greedy per-frame matching (reference eval/eval.py:62-118).

    overlaps: (num_dt, num_gt)."""
    det_size = len(ignored_det)
    gt_size = len(ignored_gt)
    assigned = np.zeros(det_size, bool)
    ignored_threshold = (dt_scores < thresh) if compute_fp else np.zeros(det_size, bool)

    tp = fp = fn = 0
    thresholds = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            if not compute_fp and overlap > min_overlap and dt_scores[j] > valid_detection:
                det_idx = j
                valid_detection = dt_scores[j]
            elif compute_fp and overlap > min_overlap and overlap > max_overlap:
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and ignored_gt[i] == 1:
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        fp = int(np.sum(~assigned & (ignored_det != -1) & ~ignored_threshold))
    return tp, fp, fn, np.array(thresholds)


def compute_statistics_all_thresholds(
    overlaps, ignored_gt, ignored_det, dt_scores, min_overlap, thresholds
):
    """compute_statistics(compute_fp=True) for ALL thresholds in one pass.

    Bit-identical greedy semantics to the per-threshold loop (reference
    eval/eval.py:62-118, numba-jitted there as fused_compute_statistics
    :121-146): detections below a threshold are ignored, candidates must
    exceed min_overlap, each gt greedily takes the max-overlap unassigned
    candidate (first-max tie-break), matched ignored-gt consume their
    detection without counting. The threshold axis is vectorized — the
    python loop is over gt only, so a 1000-frame eval stays minutes even
    without numba.

    Returns (tp, fp, fn) arrays of shape (T,)."""
    t = len(thresholds)
    d = len(ignored_det)
    if t == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    avail = (ignored_det != -1)[None, :] & (
        dt_scores[None, :] >= np.asarray(thresholds)[:, None]
    )  # (T, D)
    assigned = np.zeros((t, d), bool)
    tp = np.zeros(t, np.int64)
    fn = np.zeros(t, np.int64)
    for i in range(len(ignored_gt)):
        state = ignored_gt[i]
        if state == -1:
            continue
        ov = overlaps[:, i] if d else np.zeros(0)
        cand = avail & ~assigned & (ov[None, :] > min_overlap)
        has = cand.any(axis=1)
        if d:
            j = np.where(cand, ov[None, :], -np.inf).argmax(axis=1)
            rows = np.nonzero(has)[0]
            assigned[rows, j[rows]] = True
        if state == 0:
            tp += has
            fn += ~has
    fp = (avail & ~assigned).sum(axis=1)
    return tp, fp, fn


def _boxes_of(anno, three_d: bool) -> np.ndarray:
    """Annos → lidar eval boxes, -yaw convention as the reference
    (eval/eval.py:252, :262)."""
    loc = anno["location"]
    dims = anno["dimensions"]
    rots = anno["rotation_y"]
    if three_d:
        return np.concatenate([loc, dims, -rots[..., None]], 1)
    return np.concatenate([loc[:, :2], dims[:, :2], -rots[..., None]], 1)


# pad-bucket granularity of the frame stacks (the JAX package's, so that
# both pad alike)
_PAD_D, _PAD_G = 32, 16
# frames per call are capped so that the (F, Dmax, Gmax, 24, 2) vertex
# intermediates stay under ~1 GB each
_CHUNK_ELEMS = 4_000_000  # Dmax*Gmax budget per chunk ~ (300x64 → ~200 frames)


def _frame_overlaps(gt_annos, dt_annos, metric, device=None):
    """Per-frame (num_dt, num_gt) rotated overlap matrices, computed on
    `device`. All frames are padded to one (F, Dmax, Gmax) stack and
    computed in a few chunked calls per metric (the reference batches its
    CUDA kernel over 50 parts, calculate_iou_partly_lidar,
    eval/eval.py:238-287)."""
    from det3d_tpu_torch.ops.rotated_iou import d3_iou_frames_np, rotate_iou_frames_np

    three_d = metric == "3d"
    if metric not in ("bev", "3d"):
        raise ValueError(metric)
    nd = [len(dt["name"]) for dt in dt_annos]
    ng = [len(gt["name"]) for gt in gt_annos]
    code = 7 if three_d else 5
    overlaps: list[np.ndarray | None] = [None] * len(gt_annos)

    # frames where either side is empty need no device work
    live = [i for i in range(len(gt_annos)) if nd[i] > 0 and ng[i] > 0]
    live_set = set(live)  # membership per frame: O(F), not O(F^2)
    for i in range(len(gt_annos)):
        if i not in live_set:
            overlaps[i] = np.zeros((nd[i], ng[i]), np.float64)
    if not live:
        return overlaps

    def pad_to(n, mult):
        return ((n + mult - 1) // mult) * mult

    dmax = pad_to(max(nd[i] for i in live), _PAD_D)
    gmax = pad_to(max(ng[i] for i in live), _PAD_G)
    chunk = max(1, _CHUNK_ELEMS // (dmax * gmax))

    for s in range(0, len(live), chunk):
        idxs = live[s : s + chunk]
        dt_stack = np.zeros((len(idxs), dmax, code), np.float32)
        gt_stack = np.zeros((len(idxs), gmax, code), np.float32)
        for r, i in enumerate(idxs):
            dt_stack[r, : nd[i]] = _boxes_of(dt_annos[i], three_d)
            gt_stack[r, : ng[i]] = _boxes_of(gt_annos[i], three_d)
        if three_d:
            ov = d3_iou_frames_np(dt_stack, gt_stack, device=device)
        else:
            ov = rotate_iou_frames_np(dt_stack, gt_stack, -1, device=device)
        for r, i in enumerate(idxs):
            overlaps[i] = ov[r, : nd[i], : ng[i]].astype(np.float64)
    return overlaps


def eval_class_ap(gt_annos, dt_annos, class_names, metric,
                  num_points_thresh, range_thresh, overlaps=None, device=None):
    assert len(gt_annos) == len(dt_annos)
    if overlaps is None:
        overlaps = _frame_overlaps(gt_annos, dt_annos, metric, device)

    num_class = len(class_names)
    num_overlap = len(next(iter(MIN_OVERLAPS.values())))
    precision = np.zeros([num_class, num_overlap, N_SAMPLE_PTS])
    recall = np.zeros([num_class, num_overlap, N_SAMPLE_PTS])

    for m, current_class in enumerate(class_names):
        ignored_gts, ignored_dets, dt_score_list = [], [], []
        total_num_valid_gt = 0
        for gt, dt in zip(gt_annos, dt_annos):
            nv, ig, idt = clean_data(gt, dt, current_class, num_points_thresh, range_thresh)
            ignored_gts.append(ig)
            ignored_dets.append(idt)
            dt_score_list.append(dt["score"].astype(np.float32))
            total_num_valid_gt += nv

        for k, min_overlap in enumerate(MIN_OVERLAPS[current_class]):
            if total_num_valid_gt == 0:
                continue  # known before any per-frame work (clean_data only)
            all_thresholds = []
            for i in range(len(gt_annos)):
                *_, th = compute_statistics(
                    overlaps[i], ignored_gts[i], ignored_dets[i], dt_score_list[i],
                    min_overlap, thresh=0.0, compute_fp=False,
                )
                all_thresholds += th.tolist()
            thresholds = get_thresholds(np.array(all_thresholds), total_num_valid_gt)
            pr = np.zeros([len(thresholds), 3])
            for i in range(len(gt_annos)):
                tp, fp, fn = compute_statistics_all_thresholds(
                    overlaps[i], ignored_gts[i], ignored_dets[i], dt_score_list[i],
                    min_overlap, thresholds,
                )
                pr[:, 0] += tp
                pr[:, 1] += fp
                pr[:, 2] += fn
            for i in range(len(thresholds)):
                recall[m, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                precision[m, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
            for i in range(len(thresholds)):
                precision[m, k, i] = np.max(precision[m, k, i:], axis=-1)
    return {"recall": recall, "precision": precision}


def get_map(prec: np.ndarray) -> np.ndarray:
    """Sum precision at every 4th recall position / 11 * 100
    (reference eval/eval.py:443-447)."""
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_official_eval_result(gt_annos, dt_annos, class_names, range_thresh,
                             num_point_threshold: int = 5, overlaps_cache: dict | None = None,
                             device=None):
    """BEV + 3D mAP table with the reference's formatting
    (reference eval/eval.py:461-483); the rotated IoUs on `device`.

    `overlaps_cache`: optional dict reused across calls (e.g. a range
    sweep) to avoid recomputing the rotated-IoU matrices — the device-heavy
    part — per threshold; the reference recomputes them every call
    (train.py:260-270)."""
    results = []
    eval_str = ""
    for metric in ("bev", "3d"):
        eval_str += "\n#### Metric: %s, num_points > %d and range < %.2f\n" % (
            metric, num_point_threshold, range_thresh,
        )
        overlaps = None
        if overlaps_cache is not None:
            # the cache is only valid for ONE (gt_annos, dt_annos) pair —
            # guard against reuse across different annos sets
            key = (len(gt_annos), id(gt_annos), id(dt_annos))
            cached_key = overlaps_cache.setdefault("_annos_key", key)
            if cached_key != key:
                raise ValueError(
                    "overlaps_cache was built for a different annos set; "
                    "use a fresh dict per (gt_annos, dt_annos) pair"
                )
            if metric not in overlaps_cache:
                overlaps_cache[metric] = _frame_overlaps(gt_annos, dt_annos, metric, device)
            overlaps = overlaps_cache[metric]
        ret = eval_class_ap(
            gt_annos, dt_annos, class_names, metric, num_point_threshold,
            range_thresh, overlaps=overlaps, device=device,
        )
        m_ap = get_map(ret["precision"])
        results.append(m_ap)
        for i, cls in enumerate(class_names):
            eval_str += cls + ":\t"
            for j, iou in enumerate(MIN_OVERLAPS[cls]):
                eval_str += "@%.2f %.4f\t" % (iou, m_ap[i][j])
            eval_str += "\n"
    return results, eval_str
