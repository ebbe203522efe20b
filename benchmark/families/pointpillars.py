"""The PointPillars family: the upstream network of `configs/*.json`
(pillar layer, BEV scatter, the InstanceNorm residual RPN, 1x1 anchor
heads, anchor decode, NMS), as `benchmark/reference/pointpillars.py`
states it in plain float32.

The comparison. The program's answer for a frame is its annos: per class
the kept boxes [x, y, z, l, w, h, yaw] and their scores. The reference
computes the frame again from the same points and weights and judges
every answer by what it says, in one number, `det_gap`, the largest of
three terms:

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
reads UNEXPLAINED; so `det_gap` is finite, in [0, UNEXPLAINED].

The weights: one normal draw on the device fills every kernel
(`benchmark/lib/weights.py`); the classification bias sits at the
focal-loss prior of 0.01, as detection heads are initialised, so that the
score gate binds as in a trained head.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.lib import compare, counts, weights
from benchmark.reference import pointpillars as ref

geometry = ref.geometry

CLS_PRIOR = 0.01
UNEXPLAINED = 100.0
SIZE_FLOOR = 1e-6
LOGIT_SLACK = 0.25   # how far below a candidate a neighbour may sit and still outrank it in the program
EXCESS_SCALE = 1.0 / ref.NMS_IOU

KERNELS = ("scatter", "nms")
NMS_RANK_CAP = ref.NMS_PRE_MAX


# --- weights and sweeps ----------------------------------------------------

def fan_in(name: str, shape) -> int:
    # kernels are (out, in, ...), transposed ones (in, out, ...)
    return (shape[0] if ".deconv" in name else shape[1]) * math.prod(shape[2:])


def make_weights(seed: int, geo: ref.Geometry, device) -> dict[str, torch.Tensor]:
    """The reference's state_dict keys (`ref.Network`), filled from the seed."""
    out = weights.draw(seed, ref.Network(geo.num_channels).state_dict(), device, fan_in)
    out["heads.conv_cls.bias"] = torch.full_like(out["heads.conv_cls.bias"], -math.log((1 - CLS_PRIOR) / CLS_PRIOR))
    return out


def reference_network(w: dict[str, torch.Tensor], geo: ref.Geometry, device) -> ref.Network:
    return weights.load(ref.Network(geo.num_channels), w, device)


def point_cloud(n: int, r: np.random.Generator) -> np.ndarray:
    """An n-point LiDAR-like sweep (N, 4): range-decayed radial density, a
    ground plane and scattered verticals. A frozen copy of the program's
    synthetic generator (`det3d_tpu_torch/data/synthetic.py`:
    `synthetic_cloud`), drawn from numpy's PCG64 so that any whole-number
    seed works."""
    pts = np.zeros((n, 4), np.float32)
    dist = np.abs(r.standard_normal(n)) * 25.0 + 2.0
    theta = r.uniform(-np.pi, np.pi, n)
    pts[:, 0] = dist * np.cos(theta)
    pts[:, 1] = dist * np.sin(theta)
    pts[:, 2] = np.where(r.random(n) < 0.7, r.uniform(-2.0, -1.5, n), r.uniform(-1.5, 4.0, n))
    pts[:, 3] = r.uniform(0, 1, n)
    return pts


# --- the comparison ----------------------------------------------------------

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
    lp = compare.logit(scores)
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


def judge_frame(annos: dict, cands: list[ref.ClassCandidates], where: str) -> dict:
    """One frame → {det_gap and its three terms, kept boxes}."""
    names = [c[0] for c in ref.CLASSES]
    per_class = compare.annos_tensors(annos, names, cands[0].logits.device, where)
    parts = [judge_class(b, s, c) for (b, s), c in zip(per_class, cands)]
    terms = {k: max(p[k] for p in parts) for k in ("explain", "overlap", "cover")}
    return dict(terms, det_gap=max(terms.values()), kept=sum(p["kept"] for p in parts))


def reference_frame(net: ref.Network, points: np.ndarray, geo: ref.Geometry, device) -> list[ref.ClassCandidates]:
    return ref.frame(net, points, len(points), geo, device)


def check_frame(cands: list[ref.ClassCandidates], annos: dict, where: str) -> compare.Checked:
    got = judge_frame(annos, cands, where)
    note = (f"det_gap {got['det_gap']:.6g} (explain {got['explain']:.6g}, overlap {got['overlap']:.6g}, "
            f"cover {got['cover']:.6g}), {got['kept']} boxes kept")
    return compare.Checked({"det_gap": got["det_gap"]}, [c.top_k for c in cands], note)


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


def control_annos(net: ref.Network, points: np.ndarray, geo: ref.Geometry, device) -> dict:
    """The control: the reference with every convolution's input and weight
    rounded to float8 e4m3, the precision below the configuration's
    bfloat16, finished as the reference finishes a frame."""
    return reference_annos(ref.finalize(ref.frame(net, points, len(points), geo, device, prec="fp8")))


# --- the eager stage pass -----------------------------------------------------

def stage_calls(mod, points: list[torch.Tensor], num_points: list[torch.Tensor], stage, post) -> None:
    """Voxelize and mask each frame, the network over the group stacked,
    then decode each frame and finalize the group in one NMS call."""
    with stage("preprocess"):
        pre = [mod.preprocess(p, n) for p, n in zip(points, num_points)]
    with stage("network"):
        preds = mod.model(*(torch.stack([getattr(f, k) for f, _ in pre])
                            for k in ("voxels", "num_points_per_voxel", "coors")))
    with stage("postprocess"):
        cands = [mod.postprocess.decode_stage(post.frame_preds(preds, i), m) for i, (_, m) in enumerate(pre)]
        mod.postprocess.finalize_frames(cands)


# --- the yardstick --------------------------------------------------------------

def network_flops(geo: ref.Geometry) -> float:
    """One frame's forward pass: the pillar layer, the RPN's convolutions
    and deconvolutions and the three heads."""
    nx, ny = geo.grid[0], geo.grid[1]
    flops = 2.0 * geo.max_voxels * geo.max_points_per_voxel * ref.PFN_IN * ref.PFN_OUT
    cin, h, w = ref.PFN_OUT, nx, ny
    fx, fy = geo.feature
    for depth, width, stride, up in zip(ref.RPN_LAYERS, ref.RPN_FILTERS, ref.RPN_UP_STRIDES, ref.RPN_UP_FILTERS):
        h, w = (h + 1) // 2, (w + 1) // 2
        flops += 2.0 * h * w * width * cin * 9                        # the stride-2 entry conv
        flops += 2.0 * h * w * width * width * 9 * rpn_convs(depth)   # the residual units
        flops += 2.0 * (h * stride) * (w * stride) * up * width      # the upsample branch
        cin = width
    a = geo.num_channels
    flops += 2.0 * fx * fy * sum(ref.RPN_UP_FILTERS) * a * (1 + ref.BOX_CODE + 2)
    return flops


def rpn_convs(depth: int) -> int:
    """3x3 convolutions of a block's residual units: two per pair of layers, one more."""
    return 2 * (depth // 2) + 1


def scatter_bytes(geo: ref.Geometry, batch: int) -> float:
    """One launch at `batch` over the pillar buffer's rows of PFN_OUT features."""
    return counts.scatter_bytes(geo.max_voxels, ref.PFN_OUT, batch)
