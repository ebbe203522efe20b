"""Box geometry used by decoding and target assignment (PyTorch).

Counterpart of the decode and encode surface of the JAX package's
`ops/geometry.py` (reference: framework/box_np_ops.py). Box convention:
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


def corners_nd(dims: torch.Tensor, origin: float = 0.5) -> torch.Tensor:
    """(N, 2) box dims → (N, 4, 2) relative corner offsets, clockwise."""
    norm = torch.tensor(_CORNERS2D, dtype=dims.dtype, device=dims.device) - origin
    return dims[..., None, :] * norm


def center_to_corner_box2d(centers, dims, angles=None, origin: float = 0.5) -> torch.Tensor:
    """(N,2) centers + (N,2) dims (+ yaw) → (N,4,2) corners
    (reference: framework/box_np_ops.py:81-99)."""
    corners = corners_nd(dims, origin=origin)
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
