"""Plain CenterPoint-PP inference in PyTorch: the benchmark's reference for
the `centerpoint` family, and the tier-1 tests' too.

A frozen, self-contained restatement of tianweiy/CenterPoint's published
forward pass for `configs/nusc/pp/nusc_centerpoint_pp_02voxel_two_pfn_10sweep.py`
(det3d/models/readers/pillar_encoder.py `PillarFeatureNet`,
backbones/scatter.py `PointPillarsScatter`, necks/rpn.py `RPN`,
bbox_heads/center_head.py `CenterHead.predict` / `post_processing`,
core/bbox/box_torch_ops.py `rotate_nms_pcdet`), with no kernels, no
batching, no caching and no layout tricks. It imports nothing of the
program under test: it makes its own pillars, features, canvas, network
outputs, decoded boxes and NMS from the raw points and the weights the
benchmark made, under the module names of the upstream model (`reader`,
`neck`, `bbox_head`), which the program's `state_dict` shares.

`prec="float32"` is the reference: float32 throughout, TF32 off.
`prec="fp8"` is the control: every convolution's and linear layer's input
and weight rounded to float8 e4m3 (one scale a tensor, amax / 448), the
arithmetic otherwise float32. `calibrate=True` runs the float32 network in
batch-statistics mode: each BatchNorm normalises with the statistics of
its input (a pillar layer's over the real points only) and keeps them as
its running statistics, which is how the benchmark's seeded weights get a
trained network's unit-scale activations.

Departures from the upstream code, each of rounding or of bookkeeping:

- pillars: the first `max_voxels` pillars in order of their first point,
  the first `max_num_points` points of each (upstream `points_to_voxel`
  keeps the same when the cap does not bind; when it binds, this keeps
  filling open pillars where upstream's loop may stop);
- the BEV IoU of NMS: an exact Sutherland-Hodgman clip of the two boxes'
  footprints in float64 (upstream: OpenPCDet's `boxes_iou_bev` CUDA kernel
  in float32, whose vertex sort and rounding differ); the footprint is
  upstream's, rectangle (dim0, dim1) turned clockwise by `rot` (upstream
  swaps dim0 and dim1 and turns by -rot - pi/2 counter-clockwise: the same
  rectangle);
- NMS is the greedy sweep in score order, over the top `nms_pre_max_size`
  cells that pass the score gate and the centre range, capped at
  `nms_post_max_size` kept (upstream sorts the gated cells and sweeps the
  first 1000; equal scores may come in another order);
- the score gate is upstream's `sigmoid > score_threshold`, kept also as
  a logit for the comparison.
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

FP8_MAX = 448.0
PFN_EPS = 1e-3
RPN_EPS = 1e-3
HEAD_EPS = 1e-5
HEADS = ("reg", "height", "dim", "rot", "vel")


@dataclass(frozen=True)
class Geometry:
    grid: tuple[int, int, int]          # (nx, ny, nz)
    voxel: tuple[float, float, float]
    offset: tuple[float, float, float]  # the snapped range's low corner
    max_voxels: int
    max_points_per_voxel: int
    num_features: int
    pfn_filters: tuple[int, ...]
    layer_nums: tuple[int, ...]
    strides: tuple[int, ...]
    filters: tuple[int, ...]
    up_strides: tuple[float, ...]
    up_filters: tuple[int, ...]
    tasks: tuple[tuple[str, ...], ...]
    heads: tuple[tuple[str, int], ...]  # common heads, then hm per task
    head_conv: int
    out_size_factor: int
    score_threshold: float
    limit: tuple[float, ...]
    pre: int
    post: int
    iou: float

    @property
    def feature(self) -> tuple[int, int]:
        """(H, W) of the head's maps: (ny, nx) over the output stride."""
        return self.grid[1] // self.out_size_factor, self.grid[0] // self.out_size_factor

    @property
    def class_names(self) -> tuple[str, ...]:
        return tuple(n for t in self.tasks for n in t)

    @property
    def cell(self) -> float:
        """A feature cell's side in metres (x; y is the same in the file)."""
        return self.out_size_factor * self.voxel[0]


def geometry(cfg_path: str | Path) -> Geometry:
    c = json.loads(Path(cfg_path).read_text())
    rng = np.asarray(c["detection_range"], np.float32)
    vox = np.asarray(c["voxel_size"], np.float32)
    grid = ((rng[3:] - rng[:3]) / vox).astype(np.int32)
    center = (rng[3:] + rng[:3]) / 2
    offset = center - grid.astype(np.float32) * vox / 2
    strides, ups = tuple(int(s) for s in c["rpn_strides"]), tuple(float(u) for u in c["rpn_up_strides"])
    factor = int(round(strides[0] / ups[0]))
    return Geometry(
        grid=tuple(int(g) for g in grid), voxel=tuple(float(v) for v in vox),
        offset=tuple(float(o) for o in offset), max_voxels=int(c["max_voxels"]),
        max_points_per_voxel=int(c["max_num_points"]), num_features=int(c["num_point_features"]),
        pfn_filters=tuple(int(f) for f in c["pfn_filters"]), layer_nums=tuple(int(n) for n in c["rpn_layer_nums"]),
        strides=strides, filters=tuple(int(f) for f in c["rpn_filters"]), up_strides=ups,
        up_filters=tuple(int(f) for f in c["rpn_up_filters"]), tasks=tuple(tuple(t) for t in c["tasks"]),
        heads=tuple((k, int(v)) for k, v in c["common_heads"].items()), head_conv=int(c["head_conv"]),
        out_size_factor=factor, score_threshold=float(c["score_threshold"]),
        limit=tuple(float(v) for v in c["post_center_limit_range"]), pre=int(c["nms_pre_max_size"]),
        post=int(c["nms_post_max_size"]), iou=float(c["nms_iou_threshold"]))


# --- precision -----------------------------------------------------------------

def _round8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Mode:
    prec = "float32"
    calibrate = False


MODE = _Mode()


def _op(x: torch.Tensor) -> torch.Tensor:
    return _round8(x) if MODE.prec == "fp8" else x


@contextlib.contextmanager
def mode(prec: str = "float32", calibrate: bool = False):
    """The reference's precision (TF32 off) and whether its batch norms
    calibrate themselves."""
    if prec not in ("float32", "fp8"):
        raise ValueError(f"precision {prec!r}: float32 or fp8")
    saved = (MODE.prec, MODE.calibrate, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    MODE.prec, MODE.calibrate = prec, calibrate
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (MODE.prec, MODE.calibrate, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm, dims, valid=None) -> torch.Tensor:
    """Eval batch norm over channel axis `dims`' complement; calibrating,
    the running statistics are first set to the input's (over `valid`
    rows only, where given)."""
    if MODE.calibrate:
        xs = x if valid is None else x[valid]
        bn.running_mean.copy_(xs.mean(dim=dims))
        bn.running_var.copy_(xs.var(dim=dims, unbiased=False))
    shape = [1] * x.dim()
    shape[-1 if dims == (0,) or dims == (0, 1) else 1] = -1
    mean, var = bn.running_mean.view(shape), bn.running_var.view(shape)
    return (x - mean) / torch.sqrt(var + bn.eps) * bn.weight.view(shape) + bn.bias.view(shape)


# --- the network ---------------------------------------------------------------

class PFNLayer(nn.Module):
    def __init__(self, cin: int, cout: int, last: bool):
        super().__init__()
        self.last = last
        units = cout if last else cout // 2
        self.linear = nn.Linear(cin, units, bias=False)
        self.norm = nn.BatchNorm1d(units, eps=PFN_EPS, momentum=0.01)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = F.linear(_op(x), _op(self.linear.weight))
        x = torch.relu(_norm(x, self.norm, (0,), valid=mask))
        top = x.max(dim=1, keepdim=True).values
        return top if self.last else torch.cat([x, top.expand_as(x)], dim=2)


class Reader(nn.Module):
    def __init__(self, geo: Geometry):
        super().__init__()
        f = [geo.num_features + 5, *geo.pfn_filters]
        self.pfn_layers = nn.ModuleList([PFNLayer(f[i], f[i + 1], i == len(f) - 2) for i in range(len(f) - 1)])


def _seq(*mods) -> nn.Sequential:
    return nn.Sequential(*mods)


class Neck(nn.Module):
    def __init__(self, geo: Geometry):
        super().__init__()
        ins = [geo.pfn_filters[-1], *geo.filters[:-1]]
        blocks, deblocks = [], []
        for cin, c, n, s, up, uo in zip(ins, geo.filters, geo.layer_nums, geo.strides, geo.up_strides,
                                        geo.up_filters):
            mods = [nn.ZeroPad2d(1), nn.Conv2d(cin, c, 3, stride=s, bias=False), nn.BatchNorm2d(c, eps=RPN_EPS),
                    nn.ReLU()]
            for _ in range(n):
                mods += [nn.Conv2d(c, c, 3, padding=1, bias=False), nn.BatchNorm2d(c, eps=RPN_EPS), nn.ReLU()]
            blocks.append(_seq(*mods))
            first = (nn.ConvTranspose2d(c, uo, int(round(up)), stride=int(round(up)), bias=False) if up >= 1
                     else nn.Conv2d(c, uo, int(round(1 / up)), stride=int(round(1 / up)), bias=False))
            deblocks.append(_seq(first, nn.BatchNorm2d(uo, eps=RPN_EPS), nn.ReLU()))
        self.blocks = nn.ModuleList(blocks)
        self.deblocks = nn.ModuleList(deblocks)


class SepHead(nn.Module):
    def __init__(self, cin: int, heads: dict[str, int], head_conv: int):
        super().__init__()
        for name, out in heads.items():
            self.add_module(name, _seq(nn.Conv2d(cin, head_conv, 3, padding=1, bias=True),
                                       nn.BatchNorm2d(head_conv, eps=HEAD_EPS), nn.ReLU(),
                                       nn.Conv2d(head_conv, out, 3, padding=1, bias=True)))


class BBoxHead(nn.Module):
    def __init__(self, geo: Geometry):
        super().__init__()
        cin = sum(geo.up_filters)
        self.shared_conv = _seq(nn.Conv2d(cin, geo.head_conv, 3, padding=1, bias=True),
                                nn.BatchNorm2d(geo.head_conv, eps=HEAD_EPS), nn.ReLU())
        self.tasks = nn.ModuleList([SepHead(geo.head_conv, {**dict(geo.heads), "hm": len(t)}, geo.head_conv)
                                    for t in geo.tasks])


class Network(nn.Module):
    def __init__(self, geo: Geometry):
        super().__init__()
        self.reader = Reader(geo)
        self.neck = Neck(geo)
        self.bbox_head = BBoxHead(geo)


def run(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A Sequential of ZeroPad2d / convolutions / BN / ReLU, the operands
    of each convolution through the precision's rounding."""
    for m in seq:
        if isinstance(m, nn.ZeroPad2d):
            x = F.pad(x, (1, 1, 1, 1))
        elif isinstance(m, nn.ConvTranspose2d):
            x = F.conv_transpose2d(_op(x), _op(m.weight), None, m.stride)
        elif isinstance(m, nn.Conv2d):
            x = F.conv2d(_op(x), _op(m.weight), m.bias, m.stride, m.padding)
        elif isinstance(m, nn.BatchNorm2d):
            x = _norm(x, m, (0, 2, 3))
        else:
            x = torch.relu(x)
    return x


# --- pillars, features, canvas -------------------------------------------------

def voxelize(points: torch.Tensor, geo: Geometry):
    """(n, C) points → voxels (V, P, C), counts (V,), coors (V, 3) as
    (x, y, z) cells: the first `max_voxels` pillars to occur, the first
    `max_points_per_voxel` points of each, in arrival order."""
    dev = points.device
    vox = torch.tensor(geo.voxel, dtype=torch.float32, device=dev)
    off = torch.tensor(geo.offset, dtype=torch.float32, device=dev)
    grid = torch.tensor(geo.grid, device=dev)
    coor = torch.floor((points[:, :3] - off) / vox).long()
    keep = ((coor >= 0) & (coor < grid)).all(dim=1)
    pts, coor = points[keep], coor[keep]
    nx, ny, nz = geo.grid
    cell = (coor[:, 0] * ny + coor[:, 1]) * nz + coor[:, 2]
    uniq, inv = torch.unique(cell, return_inverse=True)
    arrival = torch.arange(len(cell), device=dev)
    first = torch.full((len(uniq),), len(cell), device=dev).scatter_reduce(0, inv, arrival, "amin")
    slot_of = torch.empty_like(first)
    slot_of[torch.argsort(first)] = torch.arange(len(uniq), device=dev)   # pillars by first arrival
    slot = slot_of[inv]
    order = torch.argsort(cell, stable=True)
    rank = torch.empty_like(order)
    sorted_cell = cell[order]
    starts = torch.ones_like(sorted_cell, dtype=torch.bool)
    starts[1:] = sorted_cell[1:] != sorted_cell[:-1]
    seg = torch.cummax(torch.where(starts, torch.arange(len(order), device=dev), 0), 0).values
    rank[order] = torch.arange(len(order), device=dev) - seg
    v = min(len(uniq), geo.max_voxels)
    take = (slot < v) & (rank < geo.max_points_per_voxel)
    voxels = torch.zeros((v, geo.max_points_per_voxel, points.shape[1]), device=dev)
    voxels[slot[take], rank[take]] = pts[take]
    counts = torch.zeros(v, dtype=torch.long, device=dev).index_add_(0, slot[take], torch.ones_like(slot[take]))
    coors = torch.zeros((v, 3), dtype=torch.long, device=dev)
    coors[slot[take]] = coor[take]
    return voxels, counts, coors


def pillar_features(net: Network, voxels, counts, coors, geo: Geometry) -> torch.Tensor:
    vx, vy = geo.voxel[0], geo.voxel[1]
    x_off, y_off = vx / 2 + geo.offset[0], vy / 2 + geo.offset[1]
    mean = voxels[:, :, :3].sum(dim=1, keepdim=True) / counts.float().view(-1, 1, 1)
    f_cluster = voxels[:, :, :3] - mean
    f_center = torch.stack([voxels[:, :, 0] - (coors[:, 0:1].float() * vx + x_off),
                            voxels[:, :, 1] - (coors[:, 1:2].float() * vy + y_off)], dim=2)
    feats = torch.cat([voxels, f_cluster, f_center], dim=2)
    mask = torch.arange(voxels.shape[1], device=voxels.device)[None, :] < counts[:, None]
    x = feats * mask[:, :, None].float()
    for layer in net.reader.pfn_layers:
        x = layer(x, mask)
    return x[:, 0, :]


def canvas(features: torch.Tensor, coors: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(1, C, ny, nx): upstream's scatter, index y * nx + x."""
    nx, ny, _ = geo.grid
    out = torch.zeros((features.shape[1], nx * ny), device=features.device)
    out[:, coors[:, 1] * nx + coors[:, 0]] = features.t()
    return out.view(1, -1, ny, nx)


def network(net: Network, points: torch.Tensor, geo: Geometry) -> list[dict[str, torch.Tensor]]:
    """One frame's points → each task's maps (ch, H, W)."""
    voxels, counts, coors = voxelize(points, geo)
    x = canvas(pillar_features(net, voxels, counts, coors, geo), coors, geo)
    ups = []
    for block, deblock in zip(net.neck.blocks, net.neck.deblocks):
        x = run(block, x)
        ups.append(run(deblock, x))
    x = run(net.bbox_head.shared_conv, torch.cat(ups, dim=1))
    return [{name: run(getattr(task, name), x)[0] for name in (*HEADS, "hm")} for task in net.bbox_head.tasks]


# --- decode ----------------------------------------------------------------------

def logit_threshold(geo: Geometry) -> float:
    return math.log(geo.score_threshold / (1.0 - geo.score_threshold))


@dataclass
class TaskCandidates:
    """One task's every cell decoded, in the cells' row-major (y, x) order,
    and its top candidates."""

    boxes: torch.Tensor     # (HW, 9) [x, y, z, dim0, dim1, dim2, vx, vy, rot]
    logits: torch.Tensor    # (HW,) the max-class logit
    class_logits: torch.Tensor  # (HW, ncls) every class's logit
    labels: torch.Tensor    # (HW,) the class within the task
    rot_len: torch.Tensor   # (HW,) |(sin, cos)| of the rot branch
    gated: torch.Tensor     # (HW,) bool: sigmoid > score_threshold and the centre in range
    top: torch.Tensor       # (k,) indices of the top-k gated cells, by descending score
    kth_logit: float        # the k-th gated logit when the top k is full, else -inf

    @property
    def top_k(self) -> int:
        return int(self.top.shape[0])


def decode(maps: dict[str, torch.Tensor], geo: Geometry) -> TaskCandidates:
    """upstream `CenterHead.predict` for one task of one frame: every cell
    decoded, the gate and the centre range, the top `pre` gated by score."""
    h, w = maps["hm"].shape[1:]
    hm = maps["hm"].permute(1, 2, 0).reshape(h * w, -1)
    logits, labels = hm.max(dim=1)
    scores = torch.sigmoid(logits)
    ys, xs = torch.meshgrid(torch.arange(h, device=hm.device), torch.arange(w, device=hm.device), indexing="ij")
    reg = maps["reg"].permute(1, 2, 0).reshape(h * w, 2)
    x = (xs.reshape(-1).float() + reg[:, 0]) * geo.out_size_factor * geo.voxel[0] + geo.offset[0]
    y = (ys.reshape(-1).float() + reg[:, 1]) * geo.out_size_factor * geo.voxel[1] + geo.offset[1]
    z = maps["height"].reshape(-1)
    dims = torch.exp(maps["dim"].permute(1, 2, 0).reshape(h * w, 3))
    rot = maps["rot"].permute(1, 2, 0).reshape(h * w, 2)
    yaw = torch.atan2(rot[:, 0], rot[:, 1])
    vel = maps["vel"].permute(1, 2, 0).reshape(h * w, 2)
    boxes = torch.cat([x[:, None], y[:, None], z[:, None], dims, vel, yaw[:, None]], dim=1)
    lim = torch.tensor(geo.limit, device=hm.device)
    inside = (boxes[:, :3] >= lim[:3]).all(dim=1) & (boxes[:, :3] <= lim[3:]).all(dim=1)
    gated = inside & (scores > geo.score_threshold)
    idx = torch.nonzero(gated)[:, 0]
    order = torch.argsort(scores[idx], descending=True, stable=True)
    top = idx[order][:geo.pre]
    kth = float(logits[top[-1]]) if top.shape[0] == geo.pre else -math.inf
    return TaskCandidates(boxes, logits, hm, labels, rot.norm(dim=1), gated, top, kth)


# --- rotated BEV IoU and NMS ---------------------------------------------------------

def footprint(boxes: torch.Tensor) -> torch.Tensor:
    """(..., >=9) boxes → (..., 4, 2) float64 corners of the BEV rectangle
    (dim0, dim1) turned clockwise by rot."""
    b = boxes.double()
    c, s = torch.cos(b[..., 8]), torch.sin(b[..., 8])
    u = torch.tensor([-0.5, -0.5, 0.5, 0.5], dtype=torch.float64, device=b.device)
    v = torch.tensor([-0.5, 0.5, 0.5, -0.5], dtype=torch.float64, device=b.device)
    px = u * b[..., 3:4]
    py = v * b[..., 4:5]
    x = c[..., None] * px + s[..., None] * py + b[..., 0:1]
    y = -s[..., None] * px + c[..., None] * py + b[..., 1:2]
    return torch.stack([x, y], dim=-1)


def _area(poly: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Shoelace area of (P, M, 2) polygons whose first n vertices count."""
    m = poly.shape[1]
    idx = torch.arange(m, device=poly.device)
    nxt = torch.where(idx[None, :] + 1 < n[:, None], idx[None, :] + 1, 0)
    q = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    cross = poly[..., 0] * q[..., 1] - poly[..., 1] * q[..., 0]
    cross = torch.where(idx[None, :] < n[:, None], cross, 0.0)
    return cross.sum(dim=1).abs() / 2


def clip_area(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, 4, 2) convex quads a and b (float64) → (P,) area of a ∩ b, by
    clipping a with each edge of b (Sutherland-Hodgman), both quads made
    counter-clockwise first."""
    def ccw(q):
        signed = (q[:, :, 0] * q.roll(-1, 1)[:, :, 1] - q[:, :, 1] * q.roll(-1, 1)[:, :, 0]).sum(dim=1)
        return torch.where((signed < 0)[:, None, None], q.flip(1), q)

    a, b = ccw(a), ccw(b)
    p = a.shape[0]
    m = 12
    poly = torch.zeros((p, m, 2), dtype=a.dtype, device=a.device)
    poly[:, :4] = a
    n = torch.full((p,), 4, device=a.device)
    for e in range(4):
        e0, e1 = b[:, e], b[:, (e + 1) % 4]
        d = e1 - e0
        idx = torch.arange(m, device=a.device)
        nxt = torch.where(idx[None, :] + 1 < n[:, None], idx[None, :] + 1, 0)
        cur, q = poly, torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
        side_c = d[:, None, 0] * (cur[..., 1] - e0[:, None, 1]) - d[:, None, 1] * (cur[..., 0] - e0[:, None, 0])
        side_q = d[:, None, 0] * (q[..., 1] - e0[:, None, 1]) - d[:, None, 1] * (q[..., 0] - e0[:, None, 0])
        live = idx[None, :] < n[:, None]
        in_c, in_q = (side_c >= 0) & live, (side_q >= 0) & live
        t = side_c / torch.where(side_c - side_q == 0, 1.0, side_c - side_q)
        cross_pt = cur + t[..., None] * (q - cur)
        emit_c = in_c
        emit_x = live & (in_c != in_q)
        # each edge emits up to two vertices, in order: its start (if inside), then the crossing
        cand = torch.stack([cur, cross_pt], dim=2).reshape(p, 2 * m, 2)
        emit = torch.stack([emit_c, emit_x], dim=2).reshape(p, 2 * m)
        pos = torch.cumsum(emit.long(), 1) - 1
        out = torch.zeros((p, 2 * m + 1, 2), dtype=a.dtype, device=a.device)
        out.scatter_(1, torch.where(emit, pos, 2 * m)[..., None].expand(-1, -1, 2), cand)
        poly = out[:, :m]
        n = emit.sum(dim=1).clamp(max=m)
    return torch.where(n >= 3, _area(poly, n), torch.zeros((), dtype=a.dtype, device=a.device))


def circles_meet(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, >=9) x (M, >=9) boxes → (N, M) bool: their footprints' circumscribed circles meet."""
    ra = torch.sqrt(a[:, 3] ** 2 + a[:, 4] ** 2) / 2
    rb = torch.sqrt(b[:, 3] ** 2 + b[:, 4] ** 2) / 2
    d2 = (a[:, None, 0] - b[None, :, 0]) ** 2 + (a[:, None, 1] - b[None, :, 1]) ** 2
    return d2 <= ((ra[:, None] + rb[None, :]) * 1.0001) ** 2


def bev_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, >=9) x (M, >=9) boxes → (N, M) float64 rotated BEV IoU (0 where
    the circles do not meet)."""
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float64, device=a.device)
    i, j = torch.nonzero(circles_meet(a, b), as_tuple=True)
    if i.numel():
        inter = clip_area(footprint(a[i]), footprint(b[j]))
        area = lambda t: t[:, 3].double() * t[:, 4].double()  # noqa: E731
        union = area(a[i]) + area(b[j]) - inter
        out[i, j] = torch.where(union > 0, inter / union, torch.zeros_like(inter))
    return out


def greedy_nms(boxes: torch.Tensor, iou: float) -> torch.Tensor:
    """Boxes (k, >=9) in descending score order → (k,) bool kept, the
    greedy sweep."""
    over = (bev_iou(boxes, boxes) > iou).cpu().numpy()
    k = boxes.shape[0]
    keep = np.zeros(k, bool)
    removed = np.zeros(k, bool)
    for i in range(k):
        if removed[i]:
            continue
        keep[i] = True
        removed |= over[i]
    return torch.as_tensor(keep, device=boxes.device)


def finalize(cands: list[TaskCandidates], geo: Geometry) -> list[dict]:
    """Each task's NMS over its top-k: kept boxes, scores and labels, the
    first `post` kept."""
    out = []
    for c in cands:
        boxes = c.boxes[c.top]
        keep = greedy_nms(boxes, geo.iou)
        keep &= (torch.cumsum(keep.long(), 0) - 1) < geo.post
        out.append({"boxes": boxes[keep], "scores": torch.sigmoid(c.logits[c.top][keep]),
                    "labels": c.labels[c.top][keep]})
    return out


@torch.no_grad()
def frame(net: Network, points: np.ndarray, geo: Geometry, device, prec: str = "float32") -> list[TaskCandidates]:
    """One frame through the reference: pillars, network, each task decoded."""
    with mode(prec):
        maps = network(net, torch.as_tensor(points, dtype=torch.float32, device=device), geo)
        return [decode(m, geo) for m in maps]


@torch.no_grad()
def calibrate(net: Network, frames: list[np.ndarray], geo: Geometry, device) -> None:
    """Every batch norm's running statistics from the float32 network in
    batch-statistics mode over `frames` stacked as one batch of pillars and
    maps (each layer normalised by what it sees, in order)."""
    with mode("float32", calibrate=True):
        pts = [torch.as_tensor(p, dtype=torch.float32, device=device) for p in frames]
        vox = [voxelize(p, geo) for p in pts]
        feats, canv = [], []
        # the pillar layers see every frame's real points at once
        voxels = torch.cat([v for v, _, _ in vox])
        counts = torch.cat([c for _, c, _ in vox])
        coors = torch.cat([c for _, _, c in vox])
        feats = pillar_features(net, voxels, counts, coors, geo)
        at = 0
        for v, _, c in vox:
            canv.append(canvas(feats[at:at + len(v)], c, geo))
            at += len(v)
        x = torch.cat(canv)
        ups = []
        for block, deblock in zip(net.neck.blocks, net.neck.deblocks):
            x = run(block, x)
            ups.append(run(deblock, x))
        x = run(net.bbox_head.shared_conv, torch.cat(ups, dim=1))
        for task in net.bbox_head.tasks:
            for name in (*HEADS, "hm"):
                run(getattr(task, name), x)
