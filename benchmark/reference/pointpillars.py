"""Plain PointPillars inference in PyTorch and NumPy: the benchmark's
reference for the detector cells.

A frozen, self-contained restatement of the reference algorithm
(1005088h/3d_object_detection: framework/voxel_generator.py,
framework/box_np_ops.py, networks/pointpillars8_shared.py,
framework/inference.py, framework/nms.py) with no kernels, no caching, no
batching and no layout tricks. It imports nothing of the program under
test: it makes its own voxels, anchors, anchor mask, features, canvas,
network outputs, decoded boxes and NMS from the raw points and the weights
the benchmark made.

`precision="float32"` is the reference (TF32 off); `precision="fp8"` is the
control: every convolution and the pillar linear layer see their input
and weight rounded to float8 e4m3 (one scale per tensor, amax / 448), the
arithmetic otherwise float32.
"""

from __future__ import annotations

import contextlib
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The three classes the reference hard-codes whatever the JSON says
# (framework/anchor_assigner.py:222-245): sizes (l, w, h), rotations,
# matched / unmatched IoU thresholds.
CLASSES = (
    ("vehicle", ((4.6, 2.10, 1.8), (7.5, 2.6, 2.9), (12.6, 2.9, 3.8)), (0.0, 1.5707963267948966), 0.6, 0.45),
    ("pedestrian", ((0.96874749, 0.9645992, 1.81212425),), (0.0,), 0.45, 0.25),
    ("cyclist", ((2.02032733, 0.98075615, 1.72027404),), (0.0, 1.5707963267948966), 0.5, 0.25),
)
# framework/inference.py:13-19
NMS_PRE_MAX = 1000
NMS_POST_MAX = 300
NMS_IOU = 0.1
SCORE_THRESHOLD = 0.05
BOX_CODE = 7
RPN_LAYERS = (2, 4, 4)
RPN_FILTERS = (64, 128, 256)
RPN_UP_STRIDES = (1, 2, 4)
RPN_UP_FILTERS = (64, 128, 128)
PFN_OUT = 64
PFN_IN = 9
IN_EPS = 1e-3
BN_EPS = 1e-5
FP8_MAX = 448.0


@dataclass(frozen=True)
class Geometry:
    """The grid and anchors of one configuration file."""

    voxel_size: tuple
    offset: tuple
    grid: tuple          # (nx, ny, nz)
    feature: tuple       # (fx, fy)
    max_voxels: int
    max_points_per_voxel: int
    center_limit: tuple
    channels: tuple      # per class (c0, c1)
    anchors: np.ndarray  # (nch * fx * fy, 7) [x, y, z, l, w, h, yaw], anchor-major

    @property
    def num_channels(self) -> int:
        return self.channels[-1][1]


def geometry(cfg_path: str | Path) -> Geometry:
    """The voxel grid snapped as framework/voxel_generator.py:7-15 does (in
    float32), the feature map at half the grid, and every anchor."""
    raw = json.loads(Path(cfg_path).read_text())
    rng = np.asarray(raw["detection_range"], np.float32)
    vs = np.asarray(raw["voxel_size"], np.float32)
    center = (rng[3:] + rng[:3]) / 2
    grid = ((rng[3:] - rng[:3]) / vs).astype(np.int32)
    diff = grid.astype(np.float32) * vs
    offset = center - diff / 2
    fx, fy = int(grid[0]) // 2, int(grid[1]) // 2
    strides = diff / np.asarray([fx, fy, 1], np.float32)
    grids, channels = [], []
    for _, sizes, rots, _, _ in CLASSES:
        c0 = len(grids)
        for size in sizes:
            for rot in rots:
                xs = np.arange(fx, dtype=np.float32) * strides[0] + (float(offset[0]) + float(strides[0]) / 2)
                ys = np.arange(fy, dtype=np.float32) * strides[1] + (float(offset[1]) + float(strides[1]) / 2)
                a = np.empty((fx, fy, 7), np.float32)
                a[..., 0] = xs[:, None]
                a[..., 1] = ys[None, :]
                a[..., 2] = float(size[2]) / 2
                a[..., 3:6] = np.asarray(size, np.float32)
                a[..., 6] = float(rot)
                grids.append(a.reshape(-1, 7))
        channels.append((c0, len(grids)))
    return Geometry(tuple(float(v) for v in vs), tuple(float(v) for v in offset), tuple(int(g) for g in grid),
                    (fx, fy), int(raw.get("max_voxels", 16000)), int(raw.get("max_num_points", 15)),
                    tuple(float(v) for v in raw["center_limit"]), tuple(channels), np.concatenate(grids))


# --- voxels and the anchor mask (numpy) --------------------------------------

def voxelize(points: np.ndarray, n: int, geo: Geometry):
    """The first `max_voxels` occupied pillars in order of first occurrence,
    each with its first `max_points_per_voxel` points in arrival order →
    voxels (V, P, C), coors (V, 3) (-1 on empty slots), counts (V,)."""
    vs = np.asarray(geo.voxel_size, np.float32)
    off = np.asarray(geo.offset, np.float32)
    pts = np.asarray(points[:n], np.float32)
    cell = np.floor((pts[:, :3] - off) / vs).astype(np.int64)
    grid = np.asarray(geo.grid)
    inside = ((cell >= 0) & (cell < grid)).all(axis=1)
    idx = np.nonzero(inside)[0]
    cid = cell[idx, 0] * (grid[1] * grid[2]) + cell[idx, 1] * grid[2] + cell[idx, 2]
    order = np.argsort(cid, kind="stable")
    sid = cid[order]
    head = np.ones(len(sid), bool)
    head[1:] = sid[1:] != sid[:-1]
    seg = np.cumsum(head) - 1                        # pillar of each sorted point
    starts = np.nonzero(head)[0]
    place = np.arange(len(sid)) - starts[seg]        # arrival rank inside the pillar
    first = idx[order[starts]]                       # first arrival of each pillar
    rank = np.empty(len(starts), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(starts))
    V, P = geo.max_voxels, geo.max_points_per_voxel
    slot = rank[seg]
    keep = (slot < V) & (place < P)
    voxels = np.zeros((V, P, pts.shape[1]), np.float32)
    voxels[slot[keep], place[keep]] = pts[idx[order[keep]]]
    counts = np.zeros(V, np.int32)
    np.add.at(counts, slot[keep], 1)
    coors = np.full((V, 3), -1, np.int32)
    kept = rank < V
    coors[rank[kept]] = cell[first[kept]]
    return voxels, coors, counts


def anchor_mask(coors: np.ndarray, geo: Geometry) -> np.ndarray:
    """Anchors whose nearest-axis BEV box covers an occupied pillar, by the
    reference's inclusive summed-area expression ID - IB - IC + IA > 0
    (framework/box_np_ops.py:159-305) → (nch, fx, fy) bool."""
    nx, ny = geo.grid[0], geo.grid[1]
    occ = np.zeros((nx, ny), np.float64)
    used = coors[:, 0] >= 0
    np.add.at(occ, (coors[used, 0], coors[used, 1]), 1.0)
    sat = occ.cumsum(0).cumsum(1)
    a = geo.anchors
    rot = a[:, 6]
    near = np.abs(rot - np.floor(rot / np.pi + 0.5) * np.pi) > np.pi / 4
    dims = np.where(near[:, None], a[:, [4, 3]], a[:, [3, 4]])
    bv = np.concatenate([a[:, :2] - dims / 2, a[:, :2] + dims / 2], axis=1).astype(np.float32)
    vs = np.asarray(geo.voxel_size, np.float32)
    off = np.asarray(geo.offset, np.float32)
    lo = np.floor((bv[:, :2] - off[:2]) / vs[:2]).astype(np.int64)
    hi = np.floor((bv[:, 2:] - off[:2]) / vs[:2]).astype(np.int64)
    lo = np.maximum(lo, 0)
    hi = np.minimum(hi, np.asarray([nx - 1, ny - 1]))
    val = sat[hi[:, 0], hi[:, 1]] - sat[hi[:, 0], lo[:, 1]] - sat[lo[:, 0], hi[:, 1]] + sat[lo[:, 0], lo[:, 1]]
    return (val > 0).reshape(geo.num_channels, *geo.feature)


# --- the network (plain torch, the reference's module names) ------------------

def _round8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Rounding:
    """A convolution's operand rounded to float8 e4m3 (one scale for the
    tensor) under the control's precision; unchanged otherwise."""

    precision = "float32"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _round8(x, torch.float8_e4m3fn, FP8_MAX) if self.precision == "fp8" else x


ROUND = _Rounding()


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + IN_EPS)


class Conv(nn.Conv2d):
    def forward(self, x):
        b = None if self.bias is None else self.bias
        return F.conv2d(ROUND(x), ROUND(self.weight), b, self.stride, self.padding)


class Deconv(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(ROUND(x), ROUND(self.weight), None, self.stride)


class Norm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class Residual(nn.Module):
    """x + (IN → ReLU → 3x3 conv) x n; the convs at conv_block indices 2, 5."""

    def __init__(self, dim: int, n: int):
        super().__init__()
        layers = []
        for _ in range(n):
            layers += [Norm(), nn.ReLU(), Conv(dim, dim, 3, padding=1, bias=False)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv_block(x)


class RPN(nn.Module):
    def __init__(self):
        super().__init__()
        cin = PFN_OUT
        for b, (depth, width, stride, up) in enumerate(zip(RPN_LAYERS, RPN_FILTERS, RPN_UP_STRIDES, RPN_UP_FILTERS), 1):
            layers = [Conv(cin, width, 3, stride=2, padding=1, bias=False), Norm(), nn.ReLU()]
            layers += [Residual(width, n) for n in [2] * (depth // 2) + [1]]
            self.add_module(f"block{b}", nn.Sequential(*layers))
            self.add_module(f"deconv{b}", nn.Sequential(Deconv(width, up, stride, stride=stride, bias=False),
                                                        Norm(), nn.ReLU()))
            cin = width

    def forward(self, x):
        ups = []
        for b in range(1, len(RPN_LAYERS) + 1):
            x = getattr(self, f"block{b}")(x)
            ups.append(getattr(self, f"deconv{b}")(x))
        return torch.cat(ups, dim=1)


class Head(nn.Module):
    def __init__(self, cin: int, a: int):
        super().__init__()
        self.conv_cls = Conv(cin, a, 1)
        self.conv_box = Conv(cin, a * BOX_CODE, 1)
        self.conv_dir = Conv(cin, a * 2, 1)


class PFN(nn.Module):
    def __init__(self):
        super().__init__()
        self.pfn_layers = nn.ModuleList([nn.Conv1d(PFN_IN, PFN_OUT, 1, bias=False), nn.BatchNorm1d(PFN_OUT)])


class Network(nn.Module):
    """Parameters and buffers under the reference's state_dict keys."""

    def __init__(self, num_anchor_channels: int):
        super().__init__()
        self.pillar_point_net = PFN()
        self.rpn = RPN()
        self.heads = Head(sum(RPN_UP_FILTERS), num_anchor_channels)


def pillar_features(net: Network, voxels, counts, coors, geo: Geometry):
    """Decorate → linear → batch norm → ReLU → max over the point slots
    (padding slots included), empty pillars zeroed (reference :11-60);
    voxels (B, V, P, 4)."""
    vx, vy = geo.voxel_size[0], geo.voxel_size[1]
    n = torch.clamp(counts, min=1).to(voxels.dtype)[..., None, None]
    mean = voxels[..., :3].sum(dim=-2, keepdim=True) / n
    cx = coors[..., 0:1].to(voxels.dtype) * vx + (vx / 2 + geo.offset[0])
    cy = coors[..., 1:2].to(voxels.dtype) * vy + (vy / 2 + geo.offset[1])
    feats = torch.cat([voxels, voxels[..., :3] - mean,
                       torch.stack([voxels[..., 0] - cx, voxels[..., 1] - cy], dim=-1)], dim=-1)
    slot = torch.arange(voxels.shape[-2], device=voxels.device)
    valid = slot < counts[..., None]
    feats = feats * valid[..., None].to(feats.dtype)
    conv, bn = net.pillar_point_net.pfn_layers
    x = ROUND(feats) @ ROUND(conv.weight[:, :, 0]).T
    x = torch.relu((x - bn.running_mean) / torch.sqrt(bn.running_var + BN_EPS) * bn.weight + bn.bias)
    x = x.amax(dim=-2)
    return torch.where((counts > 0)[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def canvas(features: torch.Tensor, coors: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """Pillar features (B, V, C) → the BEV map (B, C, nx, ny)."""
    b, v, c = features.shape
    out = torch.zeros((b, geo.grid[0], geo.grid[1], c), dtype=features.dtype, device=features.device)
    for i in range(b):
        used = coors[i, :, 0] >= 0
        out[i, coors[i, used, 0].long(), coors[i, used, 1].long()] = features[i, used]
    return out.permute(0, 3, 1, 2)


def head_outputs(net: Network, x: torch.Tensor):
    """The 1x1 heads over the 320-channel map, their channels in the
    reference's [anchor][k] order → cls (B, a, fx, fy), box (B, 7, a, fx, fy),
    dir (B, 2, a, fx, fy)."""
    h = net.heads
    b, _, fx, fy = x.shape
    a = h.conv_cls.out_channels
    cls = h.conv_cls(x)
    box = h.conv_box(x).reshape(b, a, BOX_CODE, fx, fy).transpose(1, 2)
    dire = h.conv_dir(x).reshape(b, a, 2, fx, fy).transpose(1, 2)
    return cls, box, dire


def network(net: Network, voxels, counts, coors, geo: Geometry):
    feats = pillar_features(net, voxels, counts, coors, geo)
    return head_outputs(net, net.rpn(canvas(feats, coors, geo)))


# --- decode and NMS ----------------------------------------------------------

def box_decode(t: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Regression outputs against anchors, with the reference's z shift
    (za + ha/2 in, zg - hg/2 out)."""
    za = a[:, 2] + a[:, 5] / 2
    diag = torch.sqrt(a[:, 3] ** 2 + a[:, 4] ** 2)
    h = torch.exp(t[:, 5]) * a[:, 5]
    return torch.stack([t[:, 0] * diag + a[:, 0], t[:, 1] * diag + a[:, 1], t[:, 2] * a[:, 5] + za - h / 2,
                        torch.exp(t[:, 3]) * a[:, 3], torch.exp(t[:, 4]) * a[:, 4], h, t[:, 6] + a[:, 6]], dim=1)


def standup(boxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned [xmin, ymin, xmax, ymax] of the rotated BEV rectangles."""
    unit = torch.tensor([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]], dtype=boxes.dtype,
                        device=boxes.device) - 0.5
    corners = boxes[:, None, 3:5] * unit[None]
    c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    pts = torch.stack([x, y], dim=-1) + boxes[:, None, :2]
    return torch.cat([pts.amin(dim=1), pts.amax(dim=1)], dim=1)


def pixel_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of minmax boxes (N, 4) x (M, 4) with the reference's +1 pixel
    convention (framework/nms.py:105-116)."""
    w = (torch.minimum(a[:, None, 2], b[None, :, 2]) - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1).clamp(min=0)
    h = (torch.minimum(a[:, None, 3], b[None, :, 3]) - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1).clamp(min=0)
    inter = w * h
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy keep mask of score-sorted minmax boxes: each box is kept
    unless a kept box before it overlaps it by more than NMS_IOU."""
    k = boxes.shape[0]
    over = (pixel_iou(boxes, boxes) > NMS_IOU) & valid[None, :] & valid[:, None]
    over &= torch.triu(torch.ones((k, k), dtype=torch.bool, device=boxes.device), diagonal=1)
    over_f = over.float()
    kept = torch.zeros_like(valid)
    live = valid.clone()
    while bool(live.any()):
        blocked = (live.float() @ over_f) > 0
        ready = live & ~blocked
        kept |= ready
        live &= ~ready & ~((ready.float() @ over_f) > 0)
    return kept


def logit_threshold() -> float:
    """SCORE_THRESHOLD as a logit, in float32 as the gate compares it."""
    return float(np.float32(np.log(SCORE_THRESHOLD / (1.0 - SCORE_THRESHOLD))))


@dataclass
class ClassCandidates:
    """One class of one frame as the reference sees it: its `n_judge` best
    anchors under the anchor mask, in logit order (logits, decoded and
    flipped boxes, the yaw before the flip, the direction margin, standup
    boxes, the centre-limit test); `gated` of them clear the score
    threshold, and `kth_logit` is the logit of the NMS_PRE_MAX-th of those
    (-inf where fewer clear it)."""

    logits: torch.Tensor
    boxes: torch.Tensor
    yaw_pre: torch.Tensor
    dir_margin: torch.Tensor
    standup: torch.Tensor
    range_ok: torch.Tensor
    anchors: torch.Tensor
    gated: int
    kth_logit: float

    @property
    def top_k(self) -> int:
        """The pre-NMS candidates: the best NMS_PRE_MAX that clear the threshold."""
        return min(NMS_PRE_MAX, self.gated)


def decode(cls, box, dire, mask: torch.Tensor, geo: Geometry, n_judge: int) -> list[ClassCandidates]:
    """One frame's outputs (a, fx, fy), (7, a, fx, fy), (2, a, fx, fy) →
    per class its best `n_judge` anchors under the mask, decoded."""
    thr = logit_threshold()
    anchors = torch.as_tensor(geo.anchors, device=cls.device)
    hw = geo.feature[0] * geo.feature[1]
    lim = torch.tensor(geo.center_limit, device=cls.device)
    out = []
    for c0, c1 in geo.channels:
        logit = cls[c0:c1].reshape(-1)
        masked = torch.where(mask[c0:c1].reshape(-1), logit, -math.inf)
        top, idx = torch.topk(masked, min(n_judge, masked.numel()))
        ok = top > -math.inf
        top, idx = top[ok], idx[ok]
        gated = int((masked >= thr).sum())
        k = min(NMS_PRE_MAX, gated)
        kth = float(top[k - 1]) if k == NMS_PRE_MAX else -math.inf
        a = anchors[c0 * hw:c1 * hw][idx]
        t = box[:, c0:c1].reshape(BOX_CODE, -1)[:, idx].T
        d = dire[:, c0:c1].reshape(2, -1)[:, idx]
        dec = box_decode(t, a)
        std = standup(dec)
        opp = (dec[:, 6] > 0) ^ (d[1] > d[0])
        yaw = dec[:, 6] + torch.where(opp, math.pi, 0.0)
        yaw = yaw - torch.floor(yaw / (2 * math.pi) + 0.5) * (2 * math.pi)
        boxes = torch.cat([dec[:, :6], yaw[:, None]], dim=1)
        range_ok = (boxes[:, :3] > lim[:3]).any(dim=1) & (boxes[:, 3:6] < lim[3:]).any(dim=1)
        out.append(ClassCandidates(top, boxes, dec[:, 6], (d[1] - d[0]).abs(), std, range_ok, a, gated, kth))
    return out


def finalize(cands: list[ClassCandidates]) -> list[dict]:
    """The reference's detections of one frame from its candidates: the top
    NMS_PRE_MAX, greedy NMS, the NMS_POST_MAX rank cap, the centre-limit
    filter → per class {boxes, scores}, in score order."""
    out = []
    for c in cands:
        k = c.top_k
        valid = torch.ones(k, dtype=torch.bool, device=c.logits.device)
        keep = greedy_nms(c.standup[:k], valid)
        keep &= (torch.cumsum(keep.long(), 0) - 1) < NMS_POST_MAX
        keep &= c.range_ok[:k]
        out.append({"boxes": c.boxes[:k][keep], "scores": torch.sigmoid(c.logits[:k][keep])})
    return out


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the reference's convolutions and products."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def precision(name: str):
    if name not in ("float32", "fp8"):
        raise ValueError(f"precision {name!r}: float32 or fp8")
    saved, ROUND.precision = ROUND.precision, name
    try:
        with exact_float32():
            yield
    finally:
        ROUND.precision = saved


@torch.no_grad()
def frame(net: Network, points: np.ndarray, n: int, geo: Geometry, device, n_judge: int = 4 * NMS_PRE_MAX,
          prec: str = "float32") -> list[ClassCandidates]:
    """One frame through the reference: voxels, mask, network, decode."""
    voxels, coors, counts = voxelize(points, n, geo)
    mask = torch.as_tensor(anchor_mask(coors, geo), device=device)
    with precision(prec):
        cls, box, dire = network(net, torch.as_tensor(voxels, device=device)[None],
                                 torch.as_tensor(counts, device=device)[None],
                                 torch.as_tensor(coors, device=device)[None], geo)
        return decode(cls[0], box[0], dire[0], mask, geo, n_judge)
