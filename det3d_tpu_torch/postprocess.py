"""Inference post-processing: mask → score gate → top-k → decode → NMS →
compaction, on the device with static shapes.

Counterpart of the JAX package's postprocess.py (reference:
framework/inference.py:26-138), with the same two stages:

  * `decode_stage`: per class, gate the logits by the anchor mask and the
    score threshold, take the top k, decode those k boxes, flip their yaw by
    the direction classifier and test the centre limit; the predictions may
    be one map each or, from the split head, a pair of column-parity maps;
  * `finalize_stage`: NMS for all classes at once (`kernels.nms_cuda`, one
    kernel call per frame on the card), the `post_max_size` rank cap, the
    range filter, and compaction into (post_max, …) blocks in score order;
    `finalize_frames` does the same for several frames with one NMS call.

NMS hyper-parameters are the reference's hard-coded values
(framework/inference.py:13-19).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from det3d_tpu_torch.anchors import AnchorSet
from det3d_tpu_torch.config import Config
from det3d_tpu_torch.kernels.nms_cuda import nms_keep
from det3d_tpu_torch.ops import geometry
from det3d_tpu_torch.ops.nms import rank_cap
from det3d_tpu_torch.utils import timing


class PostProcessParams(NamedTuple):
    """Reference inference hyper-parameters (framework/inference.py:13-19).

    `approx_topk`: True selects the bucketed approximate pre-NMS top-k
    (`_bucketed_topk`, recall ~97% on the candidate tail, which the score
    sort, NMS and post_max cap discard anyway); None or False is the exact
    `torch.topk`."""

    nms_pre_max_size: int = 1000
    nms_post_max_size: int = 300
    nms_iou_threshold: float = 0.1
    score_threshold: float = 0.05
    approx_topk: bool | None = None


class Detections(NamedTuple):
    """Fixed-shape per-frame detections, stacked over classes."""

    boxes: torch.Tensor   # (num_classes, post_max, 7)
    scores: torch.Tensor  # (num_classes, post_max)
    valid: torch.Tensor   # (num_classes, post_max) bool


class Candidates(NamedTuple):
    """One class's k decoded top-k candidates in descending score order."""

    boxes: torch.Tensor     # (k, 7) decoded, direction-flipped
    scores: torch.Tensor    # (k,) sigmoid scores, -1.0 where not valid
    standup: torch.Tensor   # (k, 4) axis-aligned minmax boxes for NMS
    valid: torch.Tensor     # (k,) bool: passed the gate
    range_ok: torch.Tensor  # (k,) bool: passed the centre-limit test


def _row_bucket_size(fy: int, n: int, k: int) -> int:
    """Largest bucket size ≤ n/(16k) that divides the row length fy."""
    bsz = max(1, min(n // (16 * k), fy))
    while fy % bsz != 0:
        bsz -= 1
    return bsz


def _bucketed_topk_rows(g: torch.Tensor, k: int):
    """Approximate top-k over a (…, fy) map, returning flat row-major
    indices: each row-aligned bucket's max and first argmax, then the exact
    top k of the bucket maxima (B ≈ 16k buckets, ~97% recall)."""
    fy = g.shape[-1]
    n = g.numel()
    bsz = _row_bucket_size(fy, n, k)
    b = n // bsz
    if b <= k:
        return torch.topk(g.reshape(-1), k)
    bmax, barg = _bucket_reduce(g, b, bsz)
    top, bidx = torch.topk(bmax, k)
    return top, bidx * bsz + barg[bidx]


def _bucket_reduce(g: torch.Tensor, b: int, bsz: int):
    """Per-bucket (max, first argmax) of a map viewed as (b, bsz)."""
    s2 = g.reshape(b, bsz)
    barg = torch.argmax(s2, dim=1)
    return torch.gather(s2, 1, barg[:, None])[:, 0], barg


def _bucketed_topk_pair(g0: torch.Tensor, g1: torch.Tensor, k: int):
    """Approximate top-k over a column-parity pair of maps (each (…, w2)),
    returning flat indices into their parity-major stack (the JAX
    package's `_bucketed_topk_pair`, postprocess.py:123-147): row buckets of
    each parity's own map, and the exact top k of the 2b bucket maxima."""
    n = g0.numel()
    bsz = _row_bucket_size(g0.shape[-1], 2 * n, k)
    b = n // bsz
    if 2 * b <= k:
        return torch.topk(torch.cat([g0.reshape(-1), g1.reshape(-1)]), k)
    (m0, a0), (m1, a1) = _bucket_reduce(g0, b, bsz), _bucket_reduce(g1, b, bsz)
    bmax, barg = torch.cat([m0, m1]), torch.cat([a0, a1])
    top, bidx = torch.topk(bmax, k)
    return top, bidx * bsz + barg[bidx]


def _bucketed_topk(g: torch.Tensor, k: int):
    """Approximate top-k over a class's (cch, fx, fy) map with the bucket
    geometry of the JAX package's default inference path, returning flat
    row-major indices into the map.

    Where fy is even, that path holds every map as a pair of column-parity
    maps (its split head), so a bucket is `bsz` same-parity columns of one
    row and the bucket maxima are ranked in parity-major order
    (`_bucketed_topk_pair`). A merged map is viewed in that order here, so
    the dense network selects what the split head selects; an odd fy keeps
    plain row buckets. Predictions that come as a pair take
    `_bucketed_topk_pair` itself."""
    cch, fx, fy = g.shape
    if fy % 2:
        return _bucketed_topk_rows(g, k)
    w2 = fy // 2
    parity_major = g.reshape(cch, fx, w2, 2).permute(3, 0, 1, 2)   # (2, cch, fx, w2)
    top, sidx = _bucketed_topk_rows(parity_major, k)
    p, rem = sidx // (cch * fx * w2), sidx % (cch * fx * w2)
    return top, rem // w2 * fy + 2 * (rem % w2) + p


def _decode_candidates(top_logits, box_k, dir_labels, anchors_k, center_limit, unit_corners) -> Candidates:
    """Post top-k: decode → direction flip → standup boxes + range test."""
    valid = top_logits > -math.inf
    # sigmoid only on the k winners; invalid slots report -1.0
    top_scores = torch.where(valid, torch.sigmoid(top_logits.float()), -1.0)

    boxes = geometry.box_decode(box_k, anchors_k)                       # (k, 7)
    corners = geometry.center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5], boxes[:, 6], unit=unit_corners)
    standup = geometry.corner_to_standup(corners)                       # (k, 4)

    # +π where the direction classifier disagrees with sign(yaw)
    # (reference framework/inference.py:101-104)
    opp = (boxes[:, 6] > 0) ^ dir_labels
    yaw = boxes[:, 6] + torch.where(opp, math.pi, 0.0)
    boxes = torch.cat([boxes[:, :6], geometry.limit_period(yaw, period=2 * math.pi)[:, None]], dim=1)

    # centre-limit filter, verbatim incl. the dims-vs-max quirk of the
    # reference (framework/inference.py:106-109 compares dims to limit[3:])
    min_mask = (boxes[:, :3] > center_limit[:3]).any(dim=1)
    max_mask = (boxes[:, 3:6] < center_limit[3:]).any(dim=1)
    return Candidates(boxes, top_scores, standup, valid, min_mask & max_mask)


def frame_preds(preds: dict, i: int) -> dict:
    """Frame i of batched predictions; a column-parity pair stays a pair."""
    return {k: tuple(t[i] for t in v) if isinstance(v, tuple) else v[i] for k, v in preds.items()}


class PostProcessor(nn.Module):
    """`decode_stage(preds, anchors_mask)` and `finalize_stage(candidates)`
    over the static anchor set, on one device. preds are single-frame;
    `finalize_frames` takes several frames' candidates through one NMS call.

    Its device constants (the centre limit, each class's anchors, the logit
    threshold, the unit corners of the standup boxes) are buffers, made
    once, so no frame copies a constant to the card, and an exported
    program holds them as buffers; none is persistent, so no state_dict
    carries them.

    `nms_keep` is the keep-mask function, `kernels.nms_cuda.nms_keep` by
    default (the CUDA kernel on the card); a caller may set the plain
    version in its place to compare the two end to end."""

    def __init__(self, cfg: Config, anchor_set: AnchorSet, params: PostProcessParams | None, device):
        super().__init__()
        self.params = params or PostProcessParams()
        device = torch.device(device)
        self.channels = [anchor_set.class_channels[s.name] for s in cfg.class_specs]
        self.fx, self.fy = (int(s) for s in cfg.feature_map_size[:2])
        p = self.params
        constants = {
            "center_limit": torch.tensor(cfg.center_limit, dtype=torch.float32),
            "logit_thr": torch.tensor(float(np.log(p.score_threshold / (1.0 - p.score_threshold))),
                                      dtype=torch.float32),
            "unit_corners": geometry.unit_corners(0.5, torch.device("cpu"), torch.float32),
        }
        for i, s in enumerate(cfg.class_specs):
            constants[f"anchors_{i}"] = torch.from_numpy(np.array(anchor_set.anchors_by_class[s.name]))
        for name, t in constants.items():
            self.register_buffer(name, t.to(device), persistent=False)
        self.nms_keep = nms_keep

    @property
    def device(self) -> torch.device:
        return self.center_limit.device

    @property
    def class_anchors(self) -> list[torch.Tensor]:
        return [getattr(self, f"anchors_{i}") for i in range(len(self.channels))]

    def _gate(self, logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return torch.where(mask & (logits.float() >= self.logit_thr), logits,
                           torch.full((), -math.inf, dtype=logits.dtype, device=logits.device))

    def decode_stage(self, preds: dict, anchors_mask: torch.Tensor) -> list[Candidates]:
        """preds: cls (1, nch, fx, fy), box (7, nch, fx, fy), dir (2, nch,
        fx, fy), or from the split head a column-parity pair of each with
        fy/2 columns (`_decode_pair`); anchors_mask (nch, fx, fy) bool.
        Scores stay logits: the gate compares in float32 logit space (-inf
        marks "none") and the top-k order on logits is the order on
        sigmoids."""
        if isinstance(preds["cls_preds"], tuple):
            return self._decode_pair(preds, anchors_mask)
        p = self.params
        hw = self.fx * self.fy
        gated = self._gate(preds["cls_preds"][0], anchors_mask)
        box_all, dir_all = preds["box_preds"], preds["dir_preds"]

        out = []
        for (c0, c1), anchors in zip(self.channels, self.class_anchors):
            n_class = (c1 - c0) * hw
            k = min(p.nms_pre_max_size, n_class)
            g = gated[c0:c1]
            if p.approx_topk and k < n_class:
                top_logits, idx = _bucketed_topk(g, k)
            else:
                top_logits, idx = torch.topk(g.reshape(-1), k)
            ch = idx // hw
            rem = idx - ch * hw
            xx = rem // self.fy
            yy = rem - xx * self.fy
            chg = ch + c0
            box_k = box_all[:, chg, xx, yy].float().T                   # (k, 7)
            dir_k = dir_all[:, chg, xx, yy]                              # (2, k)
            out.append(_decode_candidates(top_logits, box_k, dir_k[1] > dir_k[0], anchors[idx],
                                          self.center_limit, self.unit_corners))
        return out

    def _decode_pair(self, preds: dict, anchors_mask: torch.Tensor) -> list[Candidates]:
        """The decode of a column-parity pair (the JAX package's parity path,
        postprocess.py:281-337): each parity gated by its columns of the
        mask, the top k over the parity-major stack of a class's two maps
        (exact, or `_bucketed_topk_pair`), the stacked index unravelled to
        (p, ch, x, y2) and to the class-flat index with y = 2·y2 + p, and the
        winners' box and dir read by two gathers and a select."""
        p = self.params
        hw, w2 = self.fx * self.fy, self.fy // 2
        gated = [self._gate(cls[0], anchors_mask[:, :, par::2]) for par, cls in enumerate(preds["cls_preds"])]
        box_pair, dir_pair = preds["box_preds"], preds["dir_preds"]
        out = []
        for (c0, c1), anchors in zip(self.channels, self.class_anchors):
            cch = c1 - c0
            n_class = cch * hw
            k = min(p.nms_pre_max_size, n_class)
            g0, g1 = gated[0][c0:c1], gated[1][c0:c1]                    # (cch, fx, w2)
            if p.approx_topk and k < n_class:
                top_logits, sidx = _bucketed_topk_pair(g0, g1, k)
            else:
                top_logits, sidx = torch.topk(torch.cat([g0.reshape(-1), g1.reshape(-1)]), k)
            half = cch * self.fx * w2
            par = sidx // half
            rem = sidx - par * half
            ch = rem // (self.fx * w2)
            rem = rem - ch * (self.fx * w2)
            xx = rem // w2
            y2 = rem - xx * w2
            idx = ch * hw + xx * self.fy + 2 * y2 + par                  # class-flat anchor order
            chg = ch + c0
            odd = par == 1
            box_k = torch.where(odd, box_pair[1][:, chg, xx, y2], box_pair[0][:, chg, xx, y2]).float().T
            dir_k = torch.where(odd, dir_pair[1][:, chg, xx, y2], dir_pair[0][:, chg, xx, y2])
            out.append(_decode_candidates(top_logits, box_k, dir_k[1] > dir_k[0], anchors[idx],
                                          self.center_limit, self.unit_corners))
        return out

    def finalize_stage(self, candidates: list[Candidates]) -> Detections:
        """One frame's NMS for every class in one call, then rank cap, range
        filter and compaction (`finalize_frames` of that one frame)."""
        return Detections(*(t[0] for t in self.finalize_frames([candidates])))

    def finalize_frames(self, frames: list[list[Candidates]]) -> Detections:
        """NMS for every class of every frame in one call over (B·ncls,
        kmax, 4), then per frame the rank cap, range filter and compaction
        → Detections with a leading frame axis. Classes with fewer than the
        largest k candidates are padded with invalid rows, which neither
        keep nor suppress."""
        p = self.params
        ncls = len(frames[0])
        kmax = max(c.valid.shape[0] for c in frames[0])
        standup = torch.zeros((len(frames) * ncls, kmax, 4), dtype=torch.float32, device=self.device)
        valid = torch.zeros((len(frames) * ncls, kmax), dtype=torch.bool, device=self.device)
        for fi, candidates in enumerate(frames):
            for ci, c in enumerate(candidates):
                k = c.valid.shape[0]
                standup[fi * ncls + ci, :k] = c.standup
                valid[fi * ncls + ci, :k] = c.valid
        keep_all = rank_cap(self.nms_keep(standup, valid, p.nms_iou_threshold), p.nms_post_max_size)
        per_frame = [self._compact(c, keep_all[fi * ncls:(fi + 1) * ncls]) for fi, c in enumerate(frames)]
        return Detections(*(torch.stack(parts) for parts in zip(*per_frame)))

    def _compact(self, candidates: list[Candidates], keep_all: torch.Tensor) -> Detections:
        """One frame's kept rows, in score order, into (post_max, …) blocks."""
        post = self.params.nms_post_max_size
        boxes_l, scores_l, valid_l = [], [], []
        for ci, c in enumerate(candidates):
            keep = keep_all[ci, : c.valid.shape[0]] & c.range_ok
            # kept rows go to their rank among the kept, the rest to row `post`
            slot = torch.where(keep, torch.cumsum(keep.to(torch.int64), 0) - 1, post)
            out_boxes = torch.zeros((post + 1, 7), dtype=torch.float32, device=self.device)
            out_scores = torch.zeros((post + 1,), dtype=torch.float32, device=self.device)
            out_valid = torch.zeros((post + 1,), dtype=torch.bool, device=self.device)
            out_boxes.index_put_((slot,), c.boxes)
            out_scores.index_put_((slot,), c.scores)
            out_valid.index_put_((slot,), keep)
            boxes_l.append(out_boxes[:post])
            scores_l.append(out_scores[:post])
            valid_l.append(out_valid[:post])
        return Detections(torch.stack(boxes_l), torch.stack(scores_l), torch.stack(valid_l))


def to_annos(cfg: Config, det: Detections) -> dict:
    """Fixed-shape detections → the reference's annos dict on the host
    (framework/inference.py:129-137, get_start_result_anno:724-737). Spans
    (`utils.timing`): `annos.fetch`, the copies to the host, in which the
    host waits for the card to finish the detections; `annos.format`."""
    with timing.span("annos.fetch"):
        boxes = det.boxes.detach().cpu().numpy()
        scores = det.scores.detach().cpu().numpy()
        valid = det.valid.detach().cpu().numpy()
    with timing.span("annos.format"):
        return _annos(cfg, boxes, scores, valid)


def _annos(cfg: Config, boxes: np.ndarray, scores: np.ndarray, valid: np.ndarray) -> dict:
    names, locs, dims, yaws, scs = [], [], [], [], []
    for ci, spec in enumerate(cfg.class_specs):
        m = valid[ci]
        n = int(m.sum())
        if n == 0:
            continue
        names.append(np.full(n, spec.name, dtype="<U10"))
        locs.append(boxes[ci][m][:, :3])
        dims.append(boxes[ci][m][:, 3:6])
        yaws.append(boxes[ci][m][:, 6])
        scs.append(scores[ci][m])

    anno = {
        "name": np.array([]),
        "truncated": np.array([]),
        "occluded": np.array([]),
        "alpha": np.array([]),
        "bbox": np.zeros([0, 4]),
        "dimensions": np.zeros([0, 3]),
        "location": np.zeros([0, 3]),
        "rotation_y": np.array([]),
        "score": np.array([]),
    }
    if names:
        anno["name"] = np.concatenate(names)
        anno["location"] = np.concatenate(locs)
        anno["dimensions"] = np.concatenate(dims)
        anno["rotation_y"] = np.concatenate(yaws)
        anno["score"] = np.concatenate(scs)
    return anno
