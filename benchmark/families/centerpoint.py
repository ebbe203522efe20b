"""The CenterPoint family: CenterPoint-PP (tianweiy/CenterPoint, nuScenes,
10 sweeps), as `benchmark/reference/centerpoint.py` states it in plain
float32: a two-layer pillar net, the BN RPN, a CenterHead of six task
groups, the per-task heatmap decode and rotated NMS.

The comparison. The program's answer for a frame is its annos: per class
the kept boxes [x, y, z, dim0, dim1, dim2, yaw], their velocities and
scores. The reference computes the frame again from the same points and
weights and judges every answer by what it says, in one number,
`center_gap`, the largest of three terms:

- each kept box is explained by one of the reference's cells of its task:
  the smallest, over the task's cells, of the largest of the offsets in
  the head's regression space: the centre in feature cells (x and y), the
  height in metres, the log dims, the yaw offset wrapped over 2 pi (times
  the length of the cell's (sin, cos) pair where that is under 1: the
  angle of a short pair is decided by its rounding), the velocity in m/s,
  and the logit of the box's class against the cell's logit of that class,
  or the cell's margin of its own best class over the box's class where
  that is larger (a label the reference would not give costs its margin;
  a near tie, the reference's own doubt about the label, costs little);
- no two kept boxes of a task overlap by more than NMS allows: the excess
  of their rotated BEV IoU (the reference's) over the threshold, times 10;
- each of the reference's top candidates of a task (the top k that pass
  the score gate and the centre range) that is isolated (no other cell
  with a logit above its own less LOGIT_SLACK comes near it: their
  circumscribed circles, widened by REACH_SLACK, do not meet; so greedy
  NMS keeps it whatever the order and rounding of the others, the
  program's bfloat16 logits and sizes included) is kept, or excused:
  matched by a kept box (as above), near a boundary (its logit over the
  k-th, or over the score gate), or below the task's last kept box when
  the rank cap is full.

Every term is a min or max of finite offsets, and a term with nothing to
measure against reads UNEXPLAINED; so `center_gap` lies in [0, UNEXPLAINED].

The weights: one normal draw on the device fills every kernel and linear
layer (LeCun normal, `benchmark/lib/weights.py`); biases are zero except
the heatmaps', at the focal-loss prior 0.01, as detection heads are
initialised, so that the 0.1 score gate binds as in a trained head (the
upstream init, -2.19, would put half of all cells past it); then every
BatchNorm's running statistics are set by the float32 reference in
batch-statistics mode over CALIBRATION_FRAMES seeded sweeps
(`reference.calibrate`), so that activations keep near unit scale along
the ~20 BN layers of the deepest path (58 in all), as a trained network's
do: with running statistics of 0 and 1 the logits collapse onto the bias
and a comparison would say nothing.

The sweeps: `point_cloud` draws a 10-sweep cloud of one vehicle's
32-beam LiDAR at 20 Hz, 5 features a point (x, y, z, intensity 0-255, the
sweep's time lag 0-0.45 s in 0.05 s steps), in the current sweep's frame:
ground rings, parked and moving objects, facades, vegetation and clutter,
each earlier sweep seen from where the vehicle was then. The mix gives the
points a frame (`points`); the sweep layout is this generator's own
(SWEEPS sweeps SWEEP_S apart, the points split evenly between them, so a
240 000-360 000-point frame holds sweeps of 24 000-36 000).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from benchmark.lib import compare, counts, traffic, weights
from benchmark.reference import centerpoint as ref

geometry = ref.geometry

CLS_PRIOR = 0.01
UNEXPLAINED = 100.0
SIZE_FLOOR = 1e-6
LOGIT_SLACK = 1.0           # how far below a candidate a neighbour may sit and still outrank it in the program
REACH_SLACK = 1.5           # how far a neighbour's footprint may reach past the reference's in the program
EXCESS_SCALE = 10.0
CALIBRATION_FRAMES = 2
CALIBRATION_POINTS = 300_000

KERNELS = ("scatter", "nms")
NMS_RANK_CAP = 1000

# The yardstick of the rotated NMS kernel, in float32 operations, as
# `ops/rotated_iou.py`'s formulation states them (every operation of a
# pair counted once, a division, sqrt or atan2 as one): the circle reject
# of a valid pair (centre offsets, squares, sum, the reach's sum and
# square, the compare) and the clip of a pair whose circles meet (8 corner
# tests of 22, 16 edge pairs of 54, the centroid's 48 additions and 2
# divisions, 24 angles of 3, 22 triangles of 11, the IoU's 5).
OPS_CIRCLE = 9
OPS_CLIP = 8 * 22 + 16 * 54 + 50 + 24 * 3 + 22 * 11 + 5
BOX_BYTES = (5 + 8) * 4     # a box and its corners, float32
FLAG_BYTES = 2              # its valid flag read and its keep flag written


# --- weights -----------------------------------------------------------------------

def _transposed(net: nn.Module) -> set[str]:
    return {f"{name}.weight" for name, m in net.named_modules() if isinstance(m, nn.ConvTranspose2d)}


def make_weights(seed: int, geo: ref.Geometry, device) -> dict[str, torch.Tensor]:
    """The reference's state_dict keys, filled from the seed, the heatmap
    biases at the prior, the batch norms calibrated (module docstring)."""
    net = ref.Network(geo)
    state = net.state_dict()
    flat = {k for k, v in state.items() if k.endswith("linear.weight")}
    shaped = {k: (v[..., None] if k in flat else v) for k, v in state.items()}   # a linear layer as a 1-wide kernel
    transposed = _transposed(net)

    def fan_in(name: str, shape) -> int:
        return (shape[0] if name in transposed else shape[1]) * math.prod(shape[2:])

    out = weights.draw(seed, shaped, device, fan_in)
    out = {k: (v[..., 0] if k in flat else v) for k, v in out.items()}
    bias = -math.log((1 - CLS_PRIOR) / CLS_PRIOR)
    for t in range(len(geo.tasks)):
        key = f"bbox_head.tasks.{t}.hm.3.bias"
        out[key] = torch.full_like(out[key], bias)
    calib = reference_network(out, geo, device)
    frames = [point_cloud(CALIBRATION_POINTS, traffic.rng(seed, 11, i)) for i in range(CALIBRATION_FRAMES)]
    ref.calibrate(calib, frames, geo, device)
    for k, v in calib.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            out[k] = v.detach().clone()
    del calib
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()   # the calibration's blocks are not the program's memory
    return out


def reference_network(w: dict[str, torch.Tensor], geo: ref.Geometry, device) -> ref.Network:
    return weights.load(ref.Network(geo), w, device)


# --- sweeps --------------------------------------------------------------------------

SWEEPS = 10
SWEEP_S = 0.05
SENSOR_Z = 1.84                                                  # the ground lies this far below the sensor
ELEVATIONS = np.deg2rad(np.linspace(-30.67, 10.67, 32))          # a 32-beam sensor's beams
GROUND_MAX_M = 60.0
# object kinds: (length, width, height, share, moving)
KINDS = ((4.6, 1.9, 1.7, 0.45, True), (9.0, 2.6, 3.3, 0.08, True), (0.7, 0.7, 1.75, 0.22, True),
         (1.9, 0.7, 1.5, 0.08, True), (0.5, 2.4, 1.0, 0.10, False), (0.4, 0.4, 0.8, 0.07, False))
# the share of each sweep's points: ground, objects, facades, vegetation, clutter
SHARES = (0.55, 0.22, 0.12, 0.09, 0.02)


def _split(n: int, parts) -> list[int]:
    out = [int(n * p) for p in parts]
    out[0] += n - sum(out)
    return out


def point_cloud(n: int, r: np.random.Generator) -> np.ndarray:
    """An n-point 10-sweep cloud (n, 5): x, y, z, intensity, time lag."""
    ring_r = SENSOR_Z / np.tan(-ELEVATIONS[ELEVATIONS < np.deg2rad(-1.0)])
    rings = ring_r[ring_r <= GROUND_MAX_M]
    speed = r.uniform(0.0, 14.0)
    n_obj = int(r.integers(25, 60))
    kind = r.choice(len(KINDS), n_obj, p=np.array([k[3] for k in KINDS]) / sum(k[3] for k in KINDS))
    size = np.array([KINDS[k][:3] for k in kind]) * r.uniform(0.85, 1.15, (n_obj, 1))
    dist = r.uniform(3.0, 50.0, n_obj)
    az = r.uniform(-np.pi, np.pi, n_obj)
    centre = np.stack([dist * np.cos(az), dist * np.sin(az)], 1)
    yaw = r.uniform(-np.pi, np.pi, n_obj)
    vel = np.where(np.array([KINDS[k][4] for k in kind])[:, None] & (r.random((n_obj, 1)) < 0.5),
                   np.stack([np.cos(yaw), np.sin(yaw)], 1) * r.uniform(0.5, 12.0, (n_obj, 1)), 0.0)
    n_wall = int(r.integers(4, 9))
    wall_a = r.uniform(-50.0, 50.0, (n_wall, 2))
    wall_dir = r.uniform(-np.pi, np.pi, n_wall)
    wall_len = r.uniform(10.0, 40.0, n_wall)
    wall_h = r.uniform(3.0, 9.0, n_wall)
    n_veg = int(r.integers(6, 16))
    veg = r.uniform(-45.0, 45.0, (n_veg, 2))
    out = []
    for s, m in enumerate(_split(n, [1.0 / SWEEPS] * SWEEPS)):
        lag = SWEEP_S * s
        origin = np.array([-speed * lag, 0.0])
        ng, no, nw, nv, nc = _split(m, SHARES)
        pts = np.zeros((m, 5), np.float32)
        # ground: points on the rings of the downward beams about the sensor of that sweep
        rad = r.choice(rings, ng) + r.normal(0.0, 0.02, ng)
        a = r.uniform(-np.pi, np.pi, ng)
        g = np.stack([origin[0] + rad * np.cos(a), origin[1] + rad * np.sin(a), -SENSOR_Z + r.normal(0, 0.03, ng),
                      r.uniform(0, 30, ng)], 1)
        # objects: points on the faces of each box, where it was then
        k = r.integers(0, n_obj, no)
        lx, ly = (r.random(no) - 0.5) * size[k, 0], (r.random(no) - 0.5) * size[k, 1]
        face = r.random(no) < 0.5
        lx = np.where(face, np.sign(lx) * size[k, 0] / 2, lx)
        ly = np.where(face, ly, np.sign(ly) * size[k, 1] / 2)
        c, sn = np.cos(yaw[k]), np.sin(yaw[k])
        pos = centre[k] - vel[k] * lag
        o = np.stack([pos[:, 0] + c * lx - sn * ly, pos[:, 1] + sn * lx + c * ly,
                      -SENSOR_Z + r.random(no) * size[k, 2], r.uniform(10, 255, no)], 1)
        # facades
        w = r.integers(0, n_wall, nw)
        t = r.random(nw) * wall_len[w]
        f = np.stack([wall_a[w, 0] + t * np.cos(wall_dir[w]), wall_a[w, 1] + t * np.sin(wall_dir[w]),
                      -SENSOR_Z + r.random(nw) * wall_h[w], r.uniform(5, 120, nw)], 1)
        # vegetation: clusters
        v = r.integers(0, n_veg, nv)
        p = np.stack([veg[v, 0] + r.normal(0, 1.0, nv), veg[v, 1] + r.normal(0, 1.0, nv),
                      -SENSOR_Z + np.abs(r.normal(0, 1.8, nv)), r.uniform(0, 60, nv)], 1)
        # clutter over the whole disc
        cr = np.sqrt(r.random(nc)) * 52.0
        ca = r.uniform(-np.pi, np.pi, nc)
        q = np.stack([cr * np.cos(ca), cr * np.sin(ca), r.uniform(-SENSOR_Z, 2.0, nc), r.uniform(0, 255, nc)], 1)
        pts[:, :4] = np.concatenate([g, o, f, p, q])
        pts[:, 4] = lag
        out.append(pts[r.permutation(m)])
    return np.concatenate(out)


# --- the comparison ----------------------------------------------------------------------

def _wrap(a: torch.Tensor) -> torch.Tensor:
    return a - torch.floor(a / (2 * math.pi) + 0.5) * (2 * math.pi)


def pair_distance(kept: torch.Tensor, labels: torch.Tensor, c: ref.TaskCandidates, cells: torch.Tensor,
                  geo: ref.Geometry) -> torch.Tensor:
    """(m, 10) kept boxes [x, y, z, dims, vx, vy, yaw, logit] with their
    labels against the task's `cells` → (m, n): the largest of the
    regression-space offsets (module docstring)."""
    b = c.boxes[cells]
    cell = geo.cell
    d = [(kept[:, None, 0] - b[None, :, 0]).abs() / cell, (kept[:, None, 1] - b[None, :, 1]).abs() / cell,
         (kept[:, None, 2] - b[None, :, 2]).abs()]
    logd = torch.log(kept[:, 3:6].clamp(min=SIZE_FLOOR))
    d.append((logd[:, None, :] - torch.log(b[None, :, 3:6].clamp(min=SIZE_FLOOR))).abs().amax(dim=2))
    d.append(_wrap(kept[:, None, 8] - b[None, :, 8]).abs() * c.rot_len[cells].clamp(max=1.0)[None, :])
    d.append((kept[:, None, 6:8] - b[None, :, 6:8]).abs().amax(dim=2))
    own = c.class_logits[cells][:, labels].t()                      # (m, n): each cell's logit of the box's class
    d.append((kept[:, None, 9] - own).abs())
    d.append(c.logits[cells][None, :] - own)
    return torch.stack(d).amax(dim=0)


def isolated(c: ref.TaskCandidates) -> torch.Tensor:
    """(k,) bool: the top candidates that no other cell with a logit above
    theirs less LOGIT_SLACK comes near (module docstring)."""
    k = c.top_k
    if not k:
        return torch.zeros(0, dtype=torch.bool, device=c.logits.device)
    lo = float(c.logits[c.top].min()) - LOGIT_SLACK
    others = torch.nonzero(c.logits >= lo)[:, 0]
    a, b = c.boxes[c.top], c.boxes[others]
    ra = torch.sqrt(a[:, 3] ** 2 + a[:, 4] ** 2) / 2 * REACH_SLACK
    rb = torch.sqrt(b[:, 3] ** 2 + b[:, 4] ** 2) / 2 * REACH_SLACK
    near = (a[:, None, 0] - b[None, :, 0]) ** 2 + (a[:, None, 1] - b[None, :, 1]) ** 2 <= (ra[:, None] + rb[None, :]) ** 2
    above = c.logits[others][None, :] >= c.logits[c.top][:, None] - LOGIT_SLACK
    above &= others[None, :] != c.top[:, None]
    return ~(near & above).any(dim=1)


def judge_task(kept: torch.Tensor, labels: torch.Tensor, c: ref.TaskCandidates, geo: ref.Geometry) -> dict:
    m, k = kept.shape[0], c.top_k
    dev = c.logits.device
    far = torch.tensor(UNEXPLAINED, device=dev)
    zero = torch.zeros((), device=dev)
    all_cells = torch.arange(c.logits.shape[0], device=dev)
    if m:
        explain = torch.stack([pair_distance(kept[i:i + 1], labels[i:i + 1], c, all_cells, geo).amin()
                               for i in range(m)]).amax()
        iou = ref.bev_iou(kept[:, :9], kept[:, :9]).float()
        iou.fill_diagonal_(0.0)
        excess = ((iou - geo.iou).clamp(min=0) * EXCESS_SCALE).amax().clamp(max=UNEXPLAINED)
    else:
        explain = excess = zero
    if k:
        match = (pair_distance(kept, labels, c, c.top, geo).amin(dim=0) if m else far.expand(k))
        top_logits = c.logits[c.top]
        cap = (top_logits - kept[:, 9].min()).clamp(min=0) if m >= geo.post else far.expand(k)
        boundary = (top_logits - max(c.kth_logit, ref.logit_threshold(geo))).clamp(max=UNEXPLAINED)
        uncovered = torch.minimum(torch.minimum(match, boundary), cap)
        cover = torch.where(isolated(c), uncovered, torch.zeros_like(uncovered)).amax()
    else:
        cover = zero
    return {"explain": float(explain), "overlap": float(excess), "cover": float(cover), "kept": m}


def kept_by_task(annos: dict, geo: ref.Geometry, device, where: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The program's annos of one frame → per task (kept (m, 10), labels (m,))."""
    names = list(geo.class_names)
    per_class = compare.annos_tensors(annos, names, device, where)
    vel = np.asarray(annos.get("velocity", np.zeros((len(annos["name"]), 2))), np.float64).reshape(-1, 2)
    if vel.shape[0] != len(annos["name"]):
        raise compare.BadOutput(f"{where}: {vel.shape[0]} velocities for {len(annos['name'])} boxes")
    bad = np.argwhere(~np.isfinite(vel))
    if len(bad):
        raise compare.BadOutput(f"{where}: velocity not finite at slot {int(bad[0][0])}")
    all_names = np.asarray(annos["name"])
    out, at = [], 0
    for task in geo.tasks:
        rows, labs = [], []
        for local, name in enumerate(task):
            boxes, scores = per_class[at]
            v = torch.as_tensor(vel[all_names == name], dtype=torch.float32, device=device)
            rows.append(torch.cat([boxes[:, :6], v, boxes[:, 6:7], compare.logit(scores)[:, None]], dim=1))
            labs.append(torch.full((boxes.shape[0],), local, dtype=torch.long, device=device))
            at += 1
        out.append((torch.cat(rows), torch.cat(labs)))
    return out


class RowWork(list):
    """The valid candidate count of each NMS row (a list, as every family
    gives it), with `meeting`: each row's valid pairs whose circles meet."""

    meeting: list[int]


def row_work(cands: list[ref.TaskCandidates]) -> RowWork:
    out = RowWork(c.top_k for c in cands)
    out.meeting = []
    for c in cands:
        b = c.boxes[c.top]
        meet = ref.circles_meet(b, b)
        out.meeting.append(int(torch.triu(meet, diagonal=1).sum()))
    return out


def reference_frame(net: ref.Network, points: np.ndarray, geo: ref.Geometry,
                    device) -> tuple[ref.Geometry, list[ref.TaskCandidates]]:
    return geo, ref.frame(net, points, geo, device)


def check_frame(expected: tuple[ref.Geometry, list[ref.TaskCandidates]], annos: dict, where: str) -> compare.Checked:
    geo, cands = expected
    dev = cands[0].logits.device
    parts = [judge_task(kept, labels, c, geo) for (kept, labels), c in zip(kept_by_task(annos, geo, dev, where), cands)]
    terms = {k: max(p[k] for p in parts) for k in ("explain", "overlap", "cover")}
    gap = max(terms.values())
    note = (f"center_gap {gap:.6g} (explain {terms['explain']:.6g}, overlap {terms['overlap']:.6g}, "
            f"cover {terms['cover']:.6g}), {sum(p['kept'] for p in parts)} boxes kept, "
            f"gated {[c.top_k for c in cands]}")
    return compare.Checked({"center_gap": gap}, row_work(cands), note)


def reference_annos(dets: list[dict], geo: ref.Geometry) -> dict:
    """The reference's (or the control's) detections of one frame as annos."""
    names, boxes, scores = [], [], []
    for task, d in zip(geo.tasks, dets):
        names += [task[int(i)] for i in d["labels"].tolist()]
        boxes.append(d["boxes"].double().cpu().numpy())
        scores.append(d["scores"].double().cpu().numpy())
    b = np.concatenate(boxes) if boxes else np.zeros((0, 9))
    return {"name": np.asarray(names, dtype="<U20"), "location": b[:, :3], "dimensions": b[:, 3:6],
            "velocity": b[:, 6:8], "rotation_y": b[:, 8], "score": np.concatenate(scores) if scores else np.zeros(0)}


def control_annos(net: ref.Network, points: np.ndarray, geo: ref.Geometry, device) -> dict:
    """The control: the reference with every convolution's and linear
    layer's input and weight rounded to float8 e4m3, the precision below
    the configuration's bfloat16, finished as the reference finishes a frame."""
    return reference_annos(ref.finalize(ref.frame(net, points, geo, device, prec="fp8"), geo), geo)


# --- the eager stage pass -----------------------------------------------------

def stage_calls(mod, points: list[torch.Tensor], num_points: list[torch.Tensor], stage, post) -> None:
    """Voxelize each frame, the network over the group stacked, then decode
    each frame and finalize the group in one NMS call."""
    with stage("preprocess"):
        pre = [mod.preprocess(p, n)[0] for p, n in zip(points, num_points)]
    with stage("network"):
        preds = mod.model(*(torch.stack([getattr(f, k) for f in pre]) for k in ("voxels", "num_points_per_voxel",
                                                                                 "coors")))
    with stage("postprocess"):
        mod.postprocess.finalize_frames(mod.postprocess.decode_frames(preds, [None] * len(pre)))


# --- the yardstick ------------------------------------------------------------------------

def network_flops(geo: ref.Geometry) -> float:
    """One frame's forward pass at full pillars: the pillar layers, the
    RPN's convolutions and upsample branches, the head's shared and branch
    convolutions; two FLOPs a multiply-add."""
    rows = geo.max_voxels * geo.max_points_per_voxel
    f = [geo.num_features + 5, *geo.pfn_filters]
    flops = sum(2.0 * rows * f[i] * (f[i + 1] if i == len(f) - 2 else f[i + 1] // 2) for i in range(len(f) - 1))
    h, w = geo.grid[1], geo.grid[0]
    cin = geo.pfn_filters[-1]
    for n, c, s, up, uo in zip(geo.layer_nums, geo.filters, geo.strides, geo.up_strides, geo.up_filters):
        h, w = h // s, w // s
        flops += 2.0 * h * w * c * cin * 9 + n * 2.0 * h * w * c * c * 9
        k = int(round(up)) if up >= 1 else int(round(1 / up))
        flops += 2.0 * h * w * c * uo * k * k if up >= 1 else 2.0 * (h // k) * (w // k) * uo * c * k * k
        cin = c
    fh, fw = geo.feature
    flops += 2.0 * fh * fw * geo.head_conv * sum(geo.up_filters) * 9
    for task in geo.tasks:
        for _, out in (*geo.heads, ("hm", len(task))):
            flops += 2.0 * fh * fw * geo.head_conv * (geo.head_conv + out) * 9
    return flops


def scatter_bytes(geo: ref.Geometry, batch: int) -> float:
    """One launch at `batch` over the pillar buffer's rows of the PFN's outputs."""
    return counts.scatter_bytes(geo.max_voxels, geo.pfn_filters[-1], batch)


def nms_row_bound_s(valid: int, meeting: int, k: int = NMS_RANK_CAP) -> float:
    """One rotated NMS row's bound: the circle reject of every valid pair
    and the clip of every pair whose circles meet at the float32 rate, or
    its boxes and flags at the HBM rate, whichever is longer."""
    ops = valid * (valid - 1) / 2 * OPS_CIRCLE + meeting * OPS_CLIP
    return max(ops / counts.F32_OPS_PER_S, k * (BOX_BYTES + FLAG_BYTES) / counts.HBM_BYTES_PER_S)
