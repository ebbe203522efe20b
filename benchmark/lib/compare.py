"""The comparison that decides `correct` for the detector cells.

The program's answer for a frame is its annos: per class the kept boxes
[x, y, z, l, w, h, yaw] and their scores. The reference (plain float32,
`benchmark/reference/pointpillars.py`) computes the frame again from the
same points and weights and judges every answer by what it says, in one
number, `det_gap`, the largest of three terms:

- each kept box is explained by one of the reference's best anchors of
  its class under the anchor mask (`n_judge` of them, four times the
  pre-NMS top k, whether or not they clear the score threshold): the
  smallest, over those anchors, of the largest of the offsets in the
  anchor's regression space (centre over its diagonal, z at the box
  middle over its height, log sizes), the yaw offset in radians (a heading off by pi costs the
  reference's own doubt about it: its direction-logit margin or its yaw
  before the flip, whichever is smaller) and the logit offset;
- no two kept boxes of a class overlap by more than NMS allows: the excess
  of their IoU (pixel convention) over the threshold, times 10;
- each of the reference's pre-NMS top k (the best anchors that clear the
  score threshold) that clears the centre limit and is isolated (no other
  candidate within LOGIT_SLACK below it or anywhere above it overlaps it
  at all, so greedy NMS keeps it whatever the order and rounding of the
  others) is kept, or excused: matched by a kept box (as above), near a
  boundary (its logit over the k-th, or over the score threshold), or
  below the last kept box when the program's rank cap is full.

Every term is a min or max of finite offsets, and a term with nothing to
measure against (a kept box of a class where the reference gates no
anchor, an anchor with no kept box to excuse it and no boundary near)
reads UNEXPLAINED; so `det_gap` is finite, in [0, UNEXPLAINED]. A
kept box or score of the program that is not finite, or a score outside
[0, 1], is reported by name, frame, class and slot and makes the run not
correct; it is never turned into a number.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import pointpillars as ref

SCORE_CLAMP = 1e-7
UNEXPLAINED = 100.0
SIZE_FLOOR = 1e-6
LOGIT_SLACK = 0.25   # how far below a candidate a neighbour may sit and still outrank it in the program
EXCESS_SCALE = 1.0 / ref.NMS_IOU


class BadOutput(Exception):
    """An output of the program that no number can be made of."""


def logit(s: torch.Tensor) -> torch.Tensor:
    s = s.clamp(SCORE_CLAMP, 1.0 - SCORE_CLAMP)
    return torch.log(s) - torch.log1p(-s)


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return a - torch.floor(a / (2 * math.pi) + 0.5) * (2 * math.pi)


def _encode(boxes: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Boxes (..., n, 7) in the regression space of anchors (n, 7), yaw
    left out: centre over the anchor's diagonal (z at the box middle over
    its height), log sizes over the anchor's."""
    diag = torch.sqrt(a[:, 3] ** 2 + a[:, 4] ** 2)
    zmid = boxes[..., 2] + boxes[..., 5] / 2
    size = torch.log(boxes[..., 3:6].clamp(min=SIZE_FLOOR) / a[:, 3:6])
    return torch.cat([((boxes[..., 0] - a[:, 0]) / diag)[..., None], ((boxes[..., 1] - a[:, 1]) / diag)[..., None],
                      ((zmid - a[:, 2] - a[:, 5] / 2) / a[:, 5])[..., None], size], dim=-1)


def pair_distance(boxes: torch.Tensor, logits: torch.Tensor, c: ref.ClassCandidates) -> torch.Tensor:
    """(m, 7) kept boxes and their logits against the n candidates → (m, n):
    the largest of the regression-space offsets (each box encoded against
    the candidate's anchor), the yaw offset and the logit offset."""
    d = (_encode(boxes[:, None, :].expand(-1, c.anchors.shape[0], -1), c.anchors)
         - _encode(c.boxes, c.anchors)[None]).abs().amax(dim=2)
    dyaw = _wrap(boxes[:, None, 6] - c.boxes[None, :, 6]).abs()
    doubt = torch.minimum(c.dir_margin, c.yaw_pre.abs())[None, :]
    yaw = torch.where(dyaw <= math.pi / 2, dyaw, (math.pi - dyaw) + doubt)
    return torch.maximum(torch.maximum(d, yaw), (logits[:, None] - c.logits[None, :]).abs())


def isolated(c: ref.ClassCandidates, k: int) -> torch.Tensor:
    """(k,) bool: the top-k candidates that no other of the `n_judge`
    candidates with a logit above theirs less LOGIT_SLACK overlaps at all
    (pixel-convention IoU 0). Greedy NMS keeps such a box whatever the
    order of the others and the rounding of their boxes."""
    iou = ref.pixel_iou(c.standup[:k], c.standup)                              # (k, n)
    above = c.logits[None, :] >= c.logits[:k, None] - LOGIT_SLACK
    above[:, :k].fill_diagonal_(False)
    return ~((iou > 0) & above).any(dim=1)


def judge_class(boxes: torch.Tensor, scores: torch.Tensor, c: ref.ClassCandidates) -> dict:
    """One class of one frame → its three terms."""
    m = boxes.shape[0]
    lp = logit(scores)
    k = c.top_k
    top = slice(0, k)
    far = torch.tensor(UNEXPLAINED, device=boxes.device)
    zero = torch.zeros((), device=boxes.device)
    if m:
        dist = torch.cat([pair_distance(boxes, lp, c), far.expand(m, 1)], dim=1)   # (m, n + 1)
        explain = dist.amin(dim=1).amax()
        std = ref.standup(boxes)
        iou = ref.pixel_iou(std, std)
        iou.fill_diagonal_(0.0)
        excess = ((iou - ref.NMS_IOU).clamp(min=0) * EXCESS_SCALE).amax().clamp(max=UNEXPLAINED)
        match = dist[:, top].amin(dim=0)                                           # (k,)
        cap = (c.logits[top] - lp.min()).clamp(min=0) if m >= ref.NMS_POST_MAX else far.expand(k)
    else:
        explain = excess = zero
        match = cap = far.expand(k)
    if k:
        boundary = (c.logits[top] - max(c.kth_logit, ref.logit_threshold())).clamp(max=UNEXPLAINED)
        uncovered = torch.minimum(torch.minimum(match, boundary), cap)
        judged = isolated(c, k) & c.range_ok[top]
        cover = torch.where(judged, uncovered, torch.zeros_like(uncovered)).amax()
    else:
        cover = zero
    return {"explain": float(explain), "overlap": float(excess), "cover": float(cover), "kept": m}


def annos_tensors(annos: dict, class_names, device, where: str):
    """The program's annos of one frame → per class (boxes (m, 7), scores
    (m,)), after the finiteness and range checks."""
    names = np.asarray(annos["name"])
    boxes = np.concatenate([np.asarray(annos["location"], np.float64).reshape(-1, 3),
                            np.asarray(annos["dimensions"], np.float64).reshape(-1, 3),
                            np.asarray(annos["rotation_y"], np.float64).reshape(-1, 1)], axis=1)
    scores = np.asarray(annos["score"], np.float64).reshape(-1)
    out = []
    for ci, name in enumerate(class_names):
        sel = np.nonzero(names == name)[0]
        for field, arr in (("box", boxes[sel]), ("score", scores[sel, None])):
            bad = np.argwhere(~np.isfinite(arr))
            if len(bad):
                raise BadOutput(f"{where}: {field} of class {name} not finite at slot {int(bad[0][0])} "
                                f"({arr[bad[0][0]].tolist()})")
        s = scores[sel]
        bad = np.nonzero((s < 0.0) | (s > 1.0))[0]
        if len(bad):
            raise BadOutput(f"{where}: score of class {name} outside [0, 1] at slot {int(bad[0])} ({s[bad[0]]})")
        out.append((torch.as_tensor(boxes[sel], dtype=torch.float32, device=device),
                    torch.as_tensor(s, dtype=torch.float32, device=device)))
    unknown = set(names.tolist()) - set(class_names)
    if unknown:
        raise BadOutput(f"{where}: class names {sorted(unknown)} are not the configuration's")
    return out


def judge_frame(annos: dict, cands: list[ref.ClassCandidates], where: str) -> dict:
    """One frame → {det_gap and its three terms, kept boxes}."""
    names = [c[0] for c in ref.CLASSES]
    per_class = annos_tensors(annos, names, cands[0].logits.device, where)
    parts = [judge_class(b, s, c) for (b, s), c in zip(per_class, cands)]
    terms = {k: max(p[k] for p in parts) for k in ("explain", "overlap", "cover")}
    return dict(terms, det_gap=max(terms.values()), kept=sum(p["kept"] for p in parts))


def reference_annos(dets: list[dict]) -> dict:
    """The reference's (or the control's) detections of one frame as annos."""
    names, boxes, scores = [], [], []
    for (name, *_), d in zip(ref.CLASSES, dets):
        n = d["boxes"].shape[0]
        names += [name] * n
        boxes.append(d["boxes"].double().cpu().numpy())
        scores.append(d["scores"].double().cpu().numpy())
    b = np.concatenate(boxes) if boxes else np.zeros((0, 7))
    return {"name": np.asarray(names, dtype="<U10"), "location": b[:, :3], "dimensions": b[:, 3:6],
            "rotation_y": b[:, 6], "score": np.concatenate(scores) if scores else np.zeros(0)}
