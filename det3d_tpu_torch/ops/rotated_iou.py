"""Rotated-box intersection and IoU over box pairs, in PyTorch.

Counterpart of the JAX package's ops/rotated_iou.py (plain `jnp`, no
Pallas; reference: the numba.cuda kernels of eval/iou.py:164-399 and
rotate_iou_kernel_eval :603-638), with the same fixed-vertex formulation
and order of operations in float32, so that IoUs near the 0.5 / 0.7
evaluation thresholds fall on the same side:

  * corners in the reference's clockwise layout (iou.py:355-378);
  * 24 candidate vertices: the corners of each box inside the other
    (inclusive projection test with a relative epsilon, iou.py:308-325) and
    the 16 edge-pair intersections (strict crossing tests, iou.py:221-263);
  * valid vertices sorted (stably) by angle about their centroid, area by
    the fan triangulation with |.| (iou.py:170-218).

Every function broadcasts over leading dimensions, so one call covers a
stack of padded frames. `criterion` as the reference's: -1 IoU, 0
inter/area1, 1 inter/area2, 2 the intersection area.
"""

from __future__ import annotations

import numpy as np
import torch


def rbbox_corners(rbboxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) = [cx, cy, dx, dy, angle] → (..., 4, 2) clockwise corners."""
    angle = rbboxes[..., 4]
    c = torch.cos(angle)
    s = torch.sin(angle)
    dx = rbboxes[..., 2]
    dy = rbboxes[..., 3]
    cx_ = torch.stack([-dx / 2, -dx / 2, dx / 2, dx / 2], dim=-1)
    cy_ = torch.stack([-dy / 2, dy / 2, dy / 2, -dy / 2], dim=-1)
    x = c[..., None] * cx_ + s[..., None] * cy_ + rbboxes[..., None, 0]
    y = -s[..., None] * cx_ + c[..., None] * cy_ + rbboxes[..., None, 1]
    return torch.stack([x, y], dim=-1)


def _point_in_quad(px, py, quad):
    """Inclusive projection test of points (px, py) against quad (..., 4, 2).
    The bounds carry a relative epsilon, so corners on the boundary (two
    identical boxes) test inside, as in the JAX package."""
    a = quad[..., 0, :]
    ab = quad[..., 1, :] - a
    ad = quad[..., 3, :] - a
    apx = px - a[..., 0]
    apy = py - a[..., 1]
    abab = ab[..., 0] ** 2 + ab[..., 1] ** 2
    abap = ab[..., 0] * apx + ab[..., 1] * apy
    adad = ad[..., 0] ** 2 + ad[..., 1] ** 2
    adap = ad[..., 0] * apx + ad[..., 1] * apy
    tol = 1e-6 * (abab + adad)
    return (abap >= -tol) & (abap <= abab + tol) & (adap >= -tol) & (adap <= adad + tol)


def _edge_intersections(ca, cb):
    """All 4 x 4 edge-pair intersections of two quads (..., 4, 2) each →
    points (..., 16, 2) and valid (..., 16), strict crossing tests."""
    a0 = ca[..., :, None, :]                                  # edge i start (..., 4, 1, 2)
    a1 = torch.roll(ca, -1, dims=-2)[..., :, None, :]
    b0 = cb[..., None, :, :]                                  # edge j start (..., 1, 4, 2)
    b1 = torch.roll(cb, -1, dims=-2)[..., None, :, :]

    def gt_cross(p, q, r):
        # (r-p) x (q-p) > 0, elementwise over the broadcast dims
        return (r[..., 1] - p[..., 1]) * (q[..., 0] - p[..., 0]) > (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0])

    acd = gt_cross(a0, b0, b1)
    bcd = gt_cross(a1, b0, b1)
    abc = gt_cross(a0, a1, b0)
    abd = gt_cross(a0, a1, b1)
    valid = (acd != bcd) & (abc != abd)

    ba = a1 - a0
    dc = b1 - b0
    abba = a0[..., 0] * a1[..., 1] - a1[..., 0] * a0[..., 1]
    cddc = b0[..., 0] * b1[..., 1] - b1[..., 0] * b0[..., 1]
    dh = ba[..., 1] * dc[..., 0] - ba[..., 0] * dc[..., 1]
    dh = torch.where(dh == 0, 1e-12, dh)
    px = (abba * dc[..., 0] - ba[..., 0] * cddc) / dh
    py = (abba * dc[..., 1] - ba[..., 1] * cddc) / dh
    pts = torch.stack([px, py], dim=-1)
    shape = valid.shape[:-2] + (16,)
    return pts.reshape(shape + (2,)), valid.reshape(shape)


def rotated_intersection_area(boxes: torch.Tensor, qboxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 5) x (..., K, 5) → (..., N, K) intersection polygon areas."""
    ca = rbbox_corners(boxes)[..., :, None, :, :]   # (..., N, 1, 4, 2)
    cb = rbbox_corners(qboxes)[..., None, :, :, :]  # (..., 1, K, 4, 2)
    shape = torch.broadcast_shapes(ca.shape, cb.shape)
    ca, cb = ca.expand(shape), cb.expand(shape)

    # corners of A inside B and of B inside A
    in_ab = _point_in_quad(ca[..., 0], ca[..., 1], cb[..., None, :, :])
    in_ba = _point_in_quad(cb[..., 0], cb[..., 1], ca[..., None, :, :])
    epts, evalid = _edge_intersections(ca, cb)

    pts = torch.cat([ca, cb, epts], dim=-2)             # (..., N, K, 24, 2)
    valid = torch.cat([in_ab, in_ba, evalid], dim=-1)   # (..., N, K, 24)

    count = valid.sum(dim=-1)
    denom = torch.clamp(count, min=1).to(pts.dtype)
    center = torch.where(valid[..., None], pts, 0.0).sum(dim=-2) / denom[..., None]

    ang = torch.atan2(pts[..., 1] - center[..., None, 1], pts[..., 0] - center[..., None, 0])
    key = torch.where(valid, ang, torch.inf)
    order = torch.argsort(key, dim=-1, stable=True)
    sorted_pts = torch.gather(pts, -2, order[..., None].expand(order.shape + (2,)))
    sorted_valid = torch.gather(valid, -1, order)

    # fan triangulation from the first sorted vertex, |triangle| summed
    p0 = sorted_pts[..., 0:1, :]
    p1 = sorted_pts[..., 1:-1, :]
    p2 = sorted_pts[..., 2:, :]
    tri = torch.abs(
        (p0[..., 0] - p2[..., 0]) * (p1[..., 1] - p2[..., 1])
        - (p0[..., 1] - p2[..., 1]) * (p1[..., 0] - p2[..., 0])
    ) / 2.0
    tri_valid = sorted_valid[..., 2:] & sorted_valid[..., 1:-1] & sorted_valid[..., 0:1]
    return torch.where(tri_valid, tri, 0.0).sum(dim=-1)


def rotated_iou(boxes: torch.Tensor, qboxes: torch.Tensor, criterion: int = -1) -> torch.Tensor:
    """(..., N, 5) x (..., K, 5) rotated overlap with the reference's criterion codes."""
    inter = rotated_intersection_area(boxes, qboxes)
    area1 = (boxes[..., 2] * boxes[..., 3])[..., :, None]
    area2 = (qboxes[..., 2] * qboxes[..., 3])[..., None, :]
    if criterion == -1:
        denom = area1 + area2 - inter
    elif criterion == 0:
        denom = area1 + torch.zeros_like(inter)
    elif criterion == 1:
        denom = area2 + torch.zeros_like(inter)
    else:
        return inter
    return inter / torch.where(denom == 0, 1e-12, denom)


def d3_iou_lidar(boxes: torch.Tensor, qboxes: torch.Tensor) -> torch.Tensor:
    """3-D IoU of lidar [x, y, z, l, w, h, yaw] boxes, z taken as the box
    centre as in the reference's eval (eval/eval.py:149-170, :226-230): BEV
    rotated intersection x z-extent overlap / volume union."""
    bev = [0, 1, 3, 4, 6]
    inter_bev = rotated_intersection_area(boxes[..., bev], qboxes[..., bev])
    z1lo = boxes[..., 2] - boxes[..., 5] / 2
    z1hi = boxes[..., 2] + boxes[..., 5] / 2
    z2lo = qboxes[..., 2] - qboxes[..., 5] / 2
    z2hi = qboxes[..., 2] + qboxes[..., 5] / 2
    iw = torch.minimum(z1hi[..., :, None], z2hi[..., None, :]) - torch.maximum(z1lo[..., :, None], z2lo[..., None, :])
    vol1 = (boxes[..., 3] * boxes[..., 4] * boxes[..., 5])[..., :, None]
    vol2 = (qboxes[..., 3] * qboxes[..., 4] * qboxes[..., 5])[..., None, :]
    inter3d = torch.where(iw > 0, iw * inter_bev, 0.0)
    union = vol1 + vol2 - inter3d
    return torch.where(inter3d > 0, inter3d / union, 0.0)


# numpy in, numpy out, computed on `device` ("cuda" unless the caller names another)


def _on(device, *arrays):
    from det3d_tpu_torch.pipeline import resolve_device

    device = resolve_device(device)
    return [torch.as_tensor(np.asarray(a, np.float32), device=device) for a in arrays]


@torch.no_grad()
def rotate_iou_eval_np(boxes: np.ndarray, qboxes: np.ndarray, criterion: int = -1, device=None) -> np.ndarray:
    """(N, 5) x (K, 5) → (N, K): the reference's rotate_iou_gpu_eval host
    API (eval/iou.py:603-638)."""
    if boxes.shape[0] == 0 or qboxes.shape[0] == 0:
        return np.zeros((boxes.shape[0], qboxes.shape[0]), np.float32)
    return rotated_iou(*_on(device, boxes, qboxes), criterion).cpu().numpy()


@torch.no_grad()
def rotate_iou_frames_np(boxes: np.ndarray, qboxes: np.ndarray, criterion: int = -1, device=None) -> np.ndarray:
    """(F, Dmax, 5) x (F, Gmax, 5) padded frame stacks → (F, Dmax, Gmax)."""
    return rotated_iou(*_on(device, boxes, qboxes), criterion).cpu().numpy()


@torch.no_grad()
def d3_iou_frames_np(boxes: np.ndarray, qboxes: np.ndarray, device=None) -> np.ndarray:
    """(F, Dmax, 7) x (F, Gmax, 7) padded frame stacks → (F, Dmax, Gmax)."""
    return d3_iou_lidar(*_on(device, boxes, qboxes)).cpu().numpy()
