"""Box geometry used by decoding, target assignment and the on-device
global augmentation (PyTorch).

Counterpart of the decode, encode and augmentation surface of the JAX
package's `ops/geometry.py` (reference: framework/box_np_ops.py). Box convention:
``[x, y, z, l, w, h, yaw]`` with z the bottom of the box; decode shifts to
and from the z-center internally (reference: framework/box_np_ops.py:406-423).
The float32 operations keep the JAX functions' order, so the target
assigner's IoUs, and with them its labels, are the JAX package's exactly.
"""

from __future__ import annotations

import math

import torch

# clockwise 2D unit-corner layout (reference: framework/box_np_ops.py:122-153)
_CORNERS2D = ((0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0))


def limit_period(val: torch.Tensor, offset: float = 0.5, period: float = math.pi) -> torch.Tensor:
    """Wrap angles into ``[-offset*period, (1-offset)*period)``
    (reference: framework/box_np_ops.py:102-103)."""
    return val - torch.floor(val / period + offset) * period


def rotation_2d(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate 2D point sets clockwise for positive angles.

    points: (N, P, 2); angles: (N,). Row-major application p @ R_T with
    R_T = [[cos, sin], [-sin, cos]] (reference box_np_ops.py:64-78)."""
    rot_sin = torch.sin(angles)
    rot_cos = torch.cos(angles)
    rot = torch.stack(
        [torch.stack([rot_cos, rot_sin], -1), torch.stack([-rot_sin, rot_cos], -1)],
        dim=-2,
    )  # (N, 2, 2)
    return torch.einsum("npi,nij->npj", points, rot)


def rotation_3d_in_axis(points: torch.Tensor, angles: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """Rotate 3D point sets (..., P, 3) by `angles` (...) about one axis
    (reference: framework/box_torch_ops.py:243-271 semantics)."""
    s, c = torch.sin(angles), torch.cos(angles)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 1:
        rot = [c, zero, -s, zero, one, zero, s, zero, c]
    elif axis in (2, -1):
        rot = [c, s, zero, -s, c, zero, zero, zero, one]
    elif axis == 0:
        rot = [one, zero, zero, zero, c, s, zero, -s, c]
    else:
        raise ValueError(f"axis must be 0/1/2, got {axis}")
    rot = torch.stack(rot, dim=-1).reshape(angles.shape + (3, 3))
    return torch.einsum("...pi,...ij->...pj", points, rot)


def rotation_points_single_angle(points: torch.Tensor, angle: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """Rotate a point set (N, 3) by one angle (a 0-dim tensor) about `axis`,
    with the reference's augmentation convention (framework/box_np_ops.py:
    629-648): its axis-0 and axis-1 matrices are the transposes of
    `rotation_3d_in_axis`'s, as in the JAX package. Batched: point sets
    (..., N, 3) and their angles (...) take one matmul."""
    s, c = torch.sin(angle), torch.cos(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 1:  # pitch
        rot = [c, zero, s, zero, one, zero, -s, zero, c]
    elif axis in (2, -1):  # yaw
        rot = [c, s, zero, -s, c, zero, zero, zero, one]
    elif axis == 0:  # roll
        rot = [one, zero, zero, zero, c, -s, zero, s, c]
    else:
        raise ValueError(f"axis must be 0/1/2, got {axis}")
    return points @ torch.stack(rot, dim=-1).reshape(angle.shape + (3, 3)).to(points.dtype)


def points_in_convex_polygon(points: torch.Tensor, polygon: torch.Tensor) -> torch.Tensor:
    """points (N, 2) against clockwise convex polygons (K, P, 2) → (N, K)
    bool: inside iff every directed edge's cross product is negative
    (reference framework/box_np_ops.py:21-54)."""
    vec = polygon - torch.roll(polygon, 1, dims=1)                     # (K, P, 2)
    px = points[:, None, None, 0]
    py = points[:, None, None, 1]
    cross = vec[None, :, :, 1] * (polygon[None, :, :, 0] - px) - vec[None, :, :, 0] * (polygon[None, :, :, 1] - py)
    return (cross < 0).all(dim=-1)


def filter_gt_box_outside_range(gt_boxes: torch.Tensor, limit_range: torch.Tensor,
                                unit: torch.Tensor) -> torch.Tensor:
    """(N,) bool: a BEV corner of the gt box lies inside `limit_range`
    (4,) = [xmin, ymin, xmax, ymax] (reference framework/box_np_ops.py:6-16).
    `unit` is `unit_corners(0.5, …)`; the range's rectangle takes the
    origin-0 corners, which are `unit + 0.5`, exactly."""
    corners = center_to_corner_box2d(gt_boxes[:, :2], gt_boxes[:, 3:5], gt_boxes[:, 6], unit)  # (N, 4, 2)
    center = limit_range[:2]
    bbox = center_to_corner_box2d(center[None], (limit_range[2:] - center)[None], None, unit + 0.5)
    inside = points_in_convex_polygon(corners.reshape(-1, 2), bbox)    # (N·4, 1)
    return inside.reshape(-1, 4).any(dim=1)


def unit_corners(origin: float, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The (4, 2) unit corners less `origin` on `device`, for the caller to
    make once and hold (`PostProcessor` keeps them as a buffer): a tensor
    made from a Python list copies to the card and waits for it, which
    would stall every frame."""
    return torch.tensor(_CORNERS2D, dtype=dtype, device=device) - origin


def corners_nd(dims: torch.Tensor, unit: torch.Tensor) -> torch.Tensor:
    """(N, 2) box dims → (N, 4, 2) relative corner offsets, clockwise;
    `unit` is `unit_corners(origin, dims.device, dims.dtype)`."""
    return dims[..., None, :] * unit


def center_to_corner_box2d(centers, dims, angles, unit: torch.Tensor) -> torch.Tensor:
    """(N,2) centers + (N,2) dims (+ yaw, or None) → (N,4,2) corners
    (reference: framework/box_np_ops.py:81-99); `unit` as in `corners_nd`."""
    corners = corners_nd(dims, unit)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers[..., None, :]


def corner_to_standup(boxes_corner: torch.Tensor) -> torch.Tensor:
    """(N,P,2) corners → (N,4) axis-aligned [xmin, ymin, xmax, ymax]."""
    return torch.cat(
        [boxes_corner.amin(dim=-2), boxes_corner.amax(dim=-2)], dim=-1
    )


def center_to_minmax_2d(centers: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """Axis-aligned center/dims → [xmin, ymin, xmax, ymax]
    (reference: framework/box_np_ops.py:323-331, origin 0.5 path)."""
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1)


def rbbox2d_to_near_bbox(rbboxes: torch.Tensor) -> torch.Tensor:
    """Rotated BEV box (..., 5) = [x, y, xdim, ydim, yaw] → nearest
    axis-aligned minmax box (..., 4): boxes within 45° of a quarter-turn swap
    their dims (reference: framework/box_np_ops.py:308-320)."""
    rots = torch.abs(limit_period(rbboxes[..., -1], 0.5, math.pi))
    cond = (rots > math.pi / 4)[..., None]
    dims = rbboxes[..., 2:4]  # slices, not list indices: no host-to-card index copy
    dims = torch.where(cond, dims.flip(-1), dims)
    return center_to_minmax_2d(rbboxes[..., :2], dims)


def iou_matrix(boxes: torch.Tensor, query_boxes: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Pairwise IoU of axis-aligned minmax boxes, (N, 4) x (K, 4) → (N, K),
    with the reference's `eps` pixel convention and iw/ih > 0 gating
    (framework/box_np_ops.py:334-363)."""
    b = boxes[:, None, :]
    q = query_boxes[None, :, :]
    iw = torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0]) + eps
    ih = torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1]) + eps
    inter = torch.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_b = (b[..., 2] - b[..., 0] + eps) * (b[..., 3] - b[..., 1] + eps)
    area_q = (q[..., 2] - q[..., 0] + eps) * (q[..., 3] - q[..., 1] + eps)
    union = area_b + area_q - inter
    return torch.where(inter > 0, inter / union, 0.0)


def box_encode_transposed(boxes_t: torch.Tensor, anchors_t: torch.Tensor) -> torch.Tensor:
    """Regression targets of gt boxes against anchors, both (7, N) → (7, N)
    (reference framework/box_np_ops.py:366-382): xy over the anchor's BEV
    diagonal, z over its height, log-ratio dims, Δyaw."""
    xa, ya, za, la, wa, ha, ra = anchors_t
    xg, yg, zg, lg, wg, hg, rg = boxes_t
    diagonal = torch.sqrt(la * la + wa * wa)
    return torch.stack([
        (xg - xa) / diagonal,
        (yg - ya) / diagonal,
        (zg - za) / ha,
        torch.log(lg / la),
        torch.log(wg / wa),
        torch.log(hg / ha),
        rg - ra,
    ])


def box_decode(box_encodings: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Decode 7-dim regression outputs against anchors, including the
    z-center shift asymmetry of the reference (za+ha/2 in, zg-hg/2 out)."""
    xa, ya, za, la, wa, ha, ra = torch.split(anchors, 1, dim=-1)
    xt, yt, zt, lt, wt, ht, rt = torch.split(box_encodings, 1, dim=-1)
    za = za + ha / 2
    diagonal = torch.sqrt(la**2 + wa**2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    lg = torch.exp(lt) * la
    wg = torch.exp(wt) * wa
    hg = torch.exp(ht) * ha
    rg = rt + ra
    zg = zg - hg / 2
    return torch.cat([xg, yg, zg, lg, wg, hg, rg], dim=-1)
