"""Numpy math shared by the host-side modules (no torch: the data plane
and create_info run in plain CPU processes, spawned workers included)."""

from __future__ import annotations

import numpy as np


def limit_period_np(val, offset: float, period: float):
    """Wrap `val` into [-offset·period, (1-offset)·period).

    No defaults on purpose: the code uses both period=π (rotation-class
    folding, anchors) and period=2π (yaw wrapping, labels, augmentation),
    and the wrong one aliases headings that differ by π. Reference
    box_np_ops.limit_period; the JAX package's utils/npmath.py."""
    return val - np.floor(val / period + offset) * period


def pad_cloud(points: np.ndarray, max_points: int) -> tuple[np.ndarray, np.int32]:
    """Pad/truncate a host point cloud (N, C) to the static (max_points, C)
    float32 → (padded, n)."""
    n = min(points.shape[0], max_points)
    out = np.zeros((max_points, points.shape[1]), np.float32)
    out[:n] = points[:n]
    return out, np.int32(n)
