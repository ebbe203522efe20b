"""Training-time point-cloud augmentation on the host (numpy).

The port's own copy of the host part of the JAX package's
data/augment.py (reference: framework/augmentation.py): per-object pose
noise with collision rejection, global flip / rotation / anisotropic
scaling / translation, with the same `RandomState` draws in the same
order, so that a seed gives the same sample. The 100-candidate collision
search is vectorised over tries and boxes; only the accept/update loop over
gt boxes stays in Python.

The global transforms also run on the device, inside the train step
(`Trainer(device_global_augment=True)`): `sample_global_augment_params`
draws them with a `torch.Generator` and `apply_global_augment` applies
them with the host chain's order and math (the JAX package's on-device
pair, data/augment.py:300-396). Those two import torch when called, so
that this module imports none and spawned prefetcher workers stay light.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# small numpy geometry (host twin of ops/geometry for the augment path)
# ---------------------------------------------------------------------------


def rotation_points_single_angle_np(points, angle, axis=2):
    """Reference framework/box_np_ops.py:629-648 conventions."""
    s, c = np.sin(angle), np.cos(angle)
    if axis == 1:
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], points.dtype)
    elif axis == 2 or axis == -1:
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], points.dtype)
    elif axis == 0:
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], points.dtype)
    else:
        raise ValueError(axis)
    return points @ rot


def box2d_corners_np(boxes):
    """(N, 5=[x,y,dx,dy,yaw]) → (N, 4, 2) corners, reference corner layout
    (framework/box_np_ops.py:659-679)."""
    corners_norm = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], boxes.dtype) - 0.5
    corners = boxes[:, None, 2:4] * corners_norm[None]
    s, c = np.sin(boxes[:, 4]), np.cos(boxes[:, 4])
    rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)  # (N,2,2)
    return np.einsum("npi,nij->npj", corners, rot) + boxes[:, None, :2]


def _points_in_quad(points, quad):
    """points (P, 2) inside clockwise quad (4, 2) → (P,) bool (all edge
    crosses negative, reference convention)."""
    vec = quad - np.roll(quad, 1, axis=0)  # (4, 2)
    cross = vec[None, :, 1] * (quad[None, :, 0] - points[:, None, 0]) - vec[None, :, 0] * (
        quad[None, :, 1] - points[:, None, 1]
    )
    return np.all(cross < 0, axis=1)


def box_collision_test_np(corners_a, corners_b):
    """Pairwise convex-quad collision, (A,4,2) x (B,4,2) → (A,B) bool.

    Vectorized counterpart of the reference's numba kernel
    (framework/augmentation.py:617-697): standup-box gate, 4x4 segment
    intersection tests, then full-containment either way. The segment and
    containment tests run only on the pairs the gate passes (the JAX
    package tests every pair, then masks: the same result)."""
    a, b = corners_a.shape[0], corners_b.shape[0]
    out = np.zeros((a, b), bool)
    if a == 0 or b == 0:
        return out

    # standup gate
    amin, amax = corners_a.min(1), corners_a.max(1)
    bmin, bmax = corners_b.min(1), corners_b.max(1)
    iw = np.minimum(amax[:, None, 0], bmax[None, :, 0]) - np.maximum(amin[:, None, 0], bmin[None, :, 0])
    ih = np.minimum(amax[:, None, 1], bmax[None, :, 1]) - np.maximum(amin[:, None, 1], bmin[None, :, 1])
    ia, ib = np.nonzero((iw > 0) & (ih > 0))
    ca, cb = corners_a[ia], corners_b[ib]  # (M,4,2) each, one gated pair per row

    def ccw(p, q, r):
        # > 0 test of (r-p) x (q-p), broadcast over (M,4,4)
        return (r[..., 1] - p[..., 1]) * (q[..., 0] - p[..., 0]) > (
            q[..., 1] - p[..., 1]
        ) * (r[..., 0] - p[..., 0])

    # segment intersections: edges of a (M,4,1,2) vs edges of b (M,1,4,2)
    A0 = ca[:, :, None, :]
    A1 = np.roll(ca, -1, axis=1)[:, :, None, :]
    B0 = cb[:, None, :, :]
    B1 = np.roll(cb, -1, axis=1)[:, None, :, :]
    seg_hit = np.any((ccw(A0, B0, B1) != ccw(A1, B0, B1)) & (ccw(A0, A1, B0) != ccw(A0, A1, B1)), axis=(1, 2))

    def contains(host, guest):
        # host (M,4,2) clockwise; guest points (M,4,2) → (M,) all inside
        vec = host - np.roll(host, 1, axis=1)
        cross = vec[:, None, :, 1] * (host[:, None, :, 0] - guest[:, :, None, 0]) - vec[:, None, :, 0] * (
            host[:, None, :, 1] - guest[:, :, None, 1])
        return np.all(cross < 0, axis=(1, 2))

    out[ia, ib] = seg_hit | contains(ca, cb) | contains(cb, ca)
    return out


def points_in_rbbox_np(points, boxes):
    """BEV rotated-rect + z-extent membership, (P, >=3) x (K, 7) → (P, K).

    Matches the reference's LIVE `points_in_rbbox`
    (framework/box_np_ops.py:460-468, origin [0.5, 0.5, 0.5]): the stored z
    is interpreted as the box CENTER, i.e. the z window is
    (z − h/2, z + h/2) with on-plane points excluded — even though
    create_info stores the camera-label z (the box bottom) unshifted. That
    h/2-down-shifted membership window is a reference quirk, but num_points
    / difficulty / augmentation point selection are all calibrated against
    it, so it is reproduced here.

    The quad test runs only on the points inside each box's standup
    rectangle widened by `_STANDUP_MARGIN` (a point strictly inside the quad
    lies inside it, and rounding moves a cross product by far less than
    the margin), so the result equals the JAX package's test of every
    point against every box, at a small fraction of its cost on ~100k-point
    frames."""
    corners = box2d_corners_np(boxes[:, [0, 1, 3, 4, 6]].astype(np.float64))
    half = boxes[:, 5] * 0.5
    z0 = boxes[:, 2] - half
    z1 = boxes[:, 2] + half
    lo = corners.min(axis=1) - _STANDUP_MARGIN
    hi = corners.max(axis=1) + _STANDUP_MARGIN
    x, y = points[:, 0], points[:, 1]
    out = np.zeros((points.shape[0], boxes.shape[0]), bool)
    for k in range(boxes.shape[0]):
        cand = np.nonzero((x >= lo[k, 0]) & (x <= hi[k, 0]) & (y >= lo[k, 1]) & (y <= hi[k, 1]))[0]
        pts = points[cand]
        out[cand, k] = _points_in_quad(pts[:, :2], corners[k]) & (pts[:, 2] > z0[k]) & (pts[:, 2] < z1[k])
    return out


_STANDUP_MARGIN = 1e-3  # metres


# ---------------------------------------------------------------------------
# per-object noise (collision-rejected pose jitter)
# ---------------------------------------------------------------------------


def noise_per_object(
    gt_boxes: np.ndarray,
    points: np.ndarray,
    valid_mask: np.ndarray | None = None,
    rotation_perturb: float = (5.0 / 180) * np.pi,
    center_noise_std: float = 0.15,
    global_random_rot_range: float = (2.0 / 180) * np.pi,
    num_try: int = 100,
    rng: np.random.RandomState | None = None,
) -> None:
    """In-place per-object pose jitter with collision rejection.

    Reference: framework/augmentation.py:177-212 (noise_per_object). With the
    default 2° `global_random_rot_range` the reference takes the
    `noise_per_box_v2_` path (:122-175): each candidate moves the box along
    its circle around the sensor origin by a global-rotation noise (radius
    preserved, yaw co-rotated), then applies the local rotation + translation
    jitter; on acceptance the circle move is folded into the effective
    transform, which is applied to the box and (around the ORIGINAL center)
    to the points of the first containing box (points_transform_ :400-416).
    The 100-candidate search is vectorized over tries; only the sequential
    accept/update loop over boxes (N ≲ 50) remains in python.
    """
    rng = rng or np.random.RandomState()
    num_boxes = gt_boxes.shape[0]
    if num_boxes == 0:
        return
    if valid_mask is None:
        valid_mask = np.ones((num_boxes,), bool)

    loc_noises = rng.normal(scale=center_noise_std, size=[num_boxes, num_try, 3])
    rot_noises = rng.uniform(-rotation_perturb, rotation_perturb, size=[num_boxes, num_try])
    grot_noises = rng.uniform(
        -global_random_rot_range, global_random_rot_range, size=[num_boxes, num_try]
    )
    enable_grot = global_random_rot_range > (0.01 / 180) * np.pi
    if not enable_grot:
        grot_noises[:] = 0.0

    point_masks = points_in_rbbox_np(points, gt_boxes)

    boxes_bev = gt_boxes[:, [0, 1, 3, 4, 6]]
    box_corners = box2d_corners_np(boxes_bev)  # evolving state, (N,4,2)

    # effective accepted transforms (loc includes the circle move)
    eff_loc = np.zeros((num_boxes, 3))
    eff_rot = np.zeros((num_boxes,))
    success = -np.ones((num_boxes,), np.int64)

    corners_norm = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float64) - 0.5
    for i in range(num_boxes):
        if not valid_mask[i]:
            continue
        # circle move around the origin per candidate (noise_per_box_v2_)
        radius = np.hypot(boxes_bev[i, 0], boxes_bev[i, 1])
        grot0 = np.arctan2(boxes_bev[i, 1], boxes_bev[i, 0])
        dst_grot = grot0 + grot_noises[i]                       # (T,)
        dst_pos = radius * np.stack([np.cos(dst_grot), np.sin(dst_grot)], -1)  # (T,2)

        # candidate corners: dims at yaw + grot + local rot, placed at
        # dst_pos + loc noise (2D rotations compose additively)
        theta = boxes_bev[i, 4] + grot_noises[i] + rot_noises[i]  # (T,)
        s, c = np.sin(theta), np.cos(theta)
        rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)  # (T,2,2)
        base = boxes_bev[i, 2:4] * corners_norm                  # (4,2)
        cand = np.einsum("pi,tij->tpj", base, rot) + (
            dst_pos + loc_noises[i, :, :2]
        )[:, None, :]  # (T,4,2)

        coll = box_collision_test_np(cand, box_corners)  # (T,N)
        coll[:, i] = False
        ok = ~coll.any(axis=1)
        hit = int(np.argmax(ok)) if ok.any() else -1
        if hit >= 0:
            success[i] = hit
            box_corners[i] = cand[hit]
            eff_loc[i] = loc_noises[i, hit]
            eff_loc[i, :2] += dst_pos[hit] - boxes_bev[i, :2]
            eff_rot[i] = rot_noises[i, hit] + grot_noises[i, hit]

    # apply accepted transforms to in-box points (first-containing-box rule
    # over VALID boxes only — reference points_transform_ checks valid_mask[j]
    # before the membership test, augmentation.py:400-416 — rotation about
    # the original box center)
    vmasks = point_masks & valid_mask[None, :]
    first_box = np.where(vmasks.any(1), np.argmax(vmasks, axis=1), -1)
    for i in range(num_boxes):
        if success[i] < 0 or not valid_mask[i]:
            continue
        sel = first_box == i
        if sel.any():
            centered = points[sel, :3] - gt_boxes[i, :3]
            rotated = rotation_points_single_angle_np(centered, eff_rot[i], axis=2)
            points[sel, :3] = rotated + gt_boxes[i, :3] + eff_loc[i]
        gt_boxes[i, :3] += eff_loc[i]
        gt_boxes[i, 6] += eff_rot[i]


# ---------------------------------------------------------------------------
# global transforms (reference framework/augmentation.py:9-89)
# ---------------------------------------------------------------------------


def random_flip(gt_boxes, points, rng):
    if rng.random_sample() > 0.5:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rng):
    """pitch ±4°, roll ±2°, yaw ±30° (reference global_rotation_v2 :29-48)."""
    pitch = rng.uniform(-4, 4) / 180 * np.pi
    points[:, :3] = rotation_points_single_angle_np(points[:, :3], pitch, axis=1)
    gt_boxes[:, :3] = rotation_points_single_angle_np(gt_boxes[:, :3], pitch, axis=1)

    roll = rng.uniform(-2, 2) / 180 * np.pi
    points[:, :3] = rotation_points_single_angle_np(points[:, :3], roll, axis=0)
    gt_boxes[:, :3] = rotation_points_single_angle_np(gt_boxes[:, :3], roll, axis=0)

    yaw = rng.uniform(-30, 30) / 180 * np.pi
    points[:, :3] = rotation_points_single_angle_np(points[:, :3], yaw, axis=2)
    gt_boxes[:, :3] = rotation_points_single_angle_np(gt_boxes[:, :3], yaw, axis=2)
    gt_boxes[:, 6] += yaw
    return gt_boxes, points


def global_scaling(gt_boxes, points, rng):
    """Anisotropic scale (reference global_scaling_v2 :57-71), including the
    dim/yaw re-fit under unequal x/y scaling."""
    x_scale = rng.uniform(0.9, 1.1)
    y_scale = rng.uniform(0.9, 1.1)
    z_scale = rng.uniform(0.95, 1.05)
    scales = np.array([x_scale, y_scale, z_scale])
    points[:, :3] *= scales
    gt_boxes[:, :3] *= scales
    yaw = gt_boxes[:, 6]
    gt_boxes[:, 3] *= np.sqrt((x_scale * np.cos(yaw)) ** 2 + (y_scale * np.sin(yaw)) ** 2)
    gt_boxes[:, 4] *= np.sqrt((x_scale * np.sin(yaw)) ** 2 + (y_scale * np.cos(yaw)) ** 2)
    gt_boxes[:, 5] *= z_scale
    gt_boxes[:, 6] = np.arctan(np.tan(yaw) * (y_scale / x_scale))
    return gt_boxes, points


def global_translate(gt_boxes, points, rng, std=(0.25, 0.25, 0.25)):
    noise = rng.normal(0, std, size=3)
    points[:, :3] += noise
    gt_boxes[:, :3] += noise
    return gt_boxes, points


# ---------------------------------------------------------------------------
# global transforms on the device (torch)
# ---------------------------------------------------------------------------

# Bounds of the global transforms: scales shrink a radius by at most
# GLOBAL_SCALE_MIN, and a translation on the device is clipped to
# ±GLOBAL_TRANSLATE_BOUND (8 sigma of the 0.25 std, so the clip changes the
# distribution by nothing measurable). The dataset's radius pre-filter for
# on-device global augmentation rests on them: the clip makes it exact.
GLOBAL_SCALE_MIN = 0.9
GLOBAL_TRANSLATE_BOUND = 2.0


def sample_global_augment_params(generator, batch: int, device) -> dict:
    """Global-augmentation parameters for `batch` samples, drawn on `device`
    with `generator` (a `torch.Generator` of that device), each a tensor
    with a leading batch axis; nothing is read back to the host. The
    distributions of the host chain and the reference
    (framework/augmentation.py:9-89): flip with p = 0.5; pitch ±4°, roll ±2°,
    yaw ±30°; scale x, y ~ U(0.9, 1.1), z ~ U(0.95, 1.05); translate
    N(0, 0.25) per axis, clipped to ±GLOBAL_TRANSLATE_BOUND."""
    import torch

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((batch, *shape), generator=generator, device=device)

    deg = np.pi / 180.0
    return {
        "flip": torch.rand((batch,), generator=generator, device=device) < 0.5,
        "pitch": uniform(-4 * deg, 4 * deg),
        "roll": uniform(-2 * deg, 2 * deg),
        "yaw": uniform(-30 * deg, 30 * deg),
        "scale": torch.cat([uniform(0.9, 1.1, 2), uniform(0.95, 1.05, 1)], dim=1),
        "translate": torch.clamp(0.25 * torch.randn((batch, 3), generator=generator, device=device),
                                 -GLOBAL_TRANSLATE_BOUND, GLOBAL_TRANSLATE_BOUND),
    }


def apply_global_augment(points, gt_boxes, params: dict):
    """The global transforms on the device (the JAX package's
    `apply_global_augment`): flip over y → pitch, roll, yaw rotations →
    anisotropic scale with the dims' re-fit and yaw = atan(tan(yaw)·sy/sx)
    → translate, the host chain's order and math. One sample: `points`
    (P, >= 3) (padded rows transform too, harmlessly: the voxelizer reads
    the true count), `gt_boxes` (G, 7) and `params` of one sample (0-dim
    tensors, scale and translate (3,)); or a batch of them with a leading
    batch axis everywhere, as `sample_global_augment_params` draws them,
    in one set of launches. The points and the box centres go through
    each step as one point set. → (points, gt_boxes)."""
    import torch

    from det3d_tpu_torch.ops.geometry import rotation_points_single_angle

    n = points.shape[-2]
    xyz = torch.cat([points[..., :3], gt_boxes[..., :3]], dim=-2)      # the points, then the centres
    dims, yaw = gt_boxes[..., 3:6], gt_boxes[..., 6]

    sign = torch.where(params["flip"], -1.0, 1.0).to(points.dtype)[..., None]
    xyz = xyz * torch.cat([torch.ones_like(sign), sign, torch.ones_like(sign)], dim=-1)[..., None, :]
    yaw = yaw * sign

    for key, axis in (("pitch", 1), ("roll", 0), ("yaw", 2)):
        xyz = rotation_points_single_angle(xyz, params[key], axis=axis)
    yaw = yaw + params["yaw"][..., None]

    scale = params["scale"].to(points.dtype)[..., None, :]
    xyz = xyz * scale
    sx, sy, sz = scale[..., 0], scale[..., 1], scale[..., 2]
    dx = dims[..., 0] * torch.sqrt((sx * torch.cos(yaw)) ** 2 + (sy * torch.sin(yaw)) ** 2)
    dy = dims[..., 1] * torch.sqrt((sx * torch.sin(yaw)) ** 2 + (sy * torch.cos(yaw)) ** 2)
    dz = dims[..., 2] * sz
    yaw = torch.atan(torch.tan(yaw) * (sy / sx))

    xyz = xyz + params["translate"].to(points.dtype)[..., None, :]
    points = torch.cat([xyz[..., :n, :], points[..., 3:]], dim=-1)
    gt_boxes = torch.cat([xyz[..., n:, :], torch.stack([dx, dy, dz, yaw], dim=-1)], dim=-1)
    return points, gt_boxes


def augment_sample(points, gt_boxes, gt_valid_mask=None, rng=None, *, global_transforms: bool = True):
    """Full training augmentation chain, reference order
    (framework/dataset.py:122-133): per-object noise → flip → rotation →
    scaling → translation. Mutates and returns (gt_boxes, points).
    `global_transforms=False` keeps only the per-object noise (its collision
    search is sequential and stays on the host), for a trainer that applies
    the global transforms on the device."""
    rng = rng or np.random.RandomState()
    noise_per_object(gt_boxes, points, gt_valid_mask, rng=rng)
    if not global_transforms:
        return gt_boxes, points
    gt_boxes, points = random_flip(gt_boxes, points, rng)
    gt_boxes, points = global_rotation(gt_boxes, points, rng)
    gt_boxes, points = global_scaling(gt_boxes, points, rng)
    gt_boxes, points = global_translate(gt_boxes, points, rng)
    return gt_boxes, points
