"""Box geometry used by decoding (PyTorch).

Counterpart of the decode surface of the JAX package's `ops/geometry.py`
(reference: framework/box_np_ops.py). Box convention: ``[x, y, z, l, w, h,
yaw]`` with z the bottom of the box; decode shifts to and from the z-center
internally (reference: framework/box_np_ops.py:406-423).
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
