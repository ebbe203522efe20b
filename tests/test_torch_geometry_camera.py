"""The port's 3D-box and camera geometry (`det3d_tpu_torch/ops/geometry.py`:
`center_to_corner_box3d`, `box_lidar_to_camera`, `project_to_image`,
`lidar_to_camera`, `camera_to_lidar`, `box_camera_to_lidar`, `box_encode`,
`points_in_rbbox`, `corners_to_frustum_mask`) against the JAX package's, on
numpy inputs seeded as in tests/test_geometry.py and a KITTI calibration
(frame 000000's R0_rect, Tr_velo_to_cam and P2), in float32.

Tolerances: rtol 1e-5 / atol 1e-4; `camera_to_lidar` and
`box_camera_to_lidar` atol 1e-3, as they invert a float32 matrix, whose
last bits differ between LAPACK builds; `points_in_rbbox` bit-equal, points
on the faces included (excluded by both: the tests are strict).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from det3d_tpu.ops import geometry as G
from det3d_tpu_torch.ops import geometry as T

torch.set_num_threads(1)

R0_RECT = np.eye(4)
R0_RECT[:3, :3] = [[9.999239e-01, 9.837760e-03, -7.445048e-03],
                   [-9.869795e-03, 9.999421e-01, -4.278459e-03],
                   [7.402527e-03, 4.351614e-03, 9.999631e-01]]
VELO2CAM = np.array([[7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
                     [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
                     [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01],
                     [0.0, 0.0, 0.0, 1.0]])
P2 = np.array([[7.215377e+02, 0.0, 6.095593e+02, 4.485728e+01],
               [0.0, 7.215377e+02, 1.728540e+02, 2.163791e-01],
               [0.0, 0.0, 1.0, 2.745884e-03],
               [0.0, 0.0, 0.0, 1.0]])
IMAGE_BOX = [0.0, 0.0, 1242.0, 375.0]


def random_boxes(n, r):
    """tests/test_geometry.random_boxes."""
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = r.uniform(-50, 50, (n, 2))
    boxes[:, 2] = r.uniform(-2, 2, n)
    boxes[:, 3:6] = r.uniform(0.5, 8.0, (n, 3))
    boxes[:, 6] = r.uniform(-np.pi, np.pi, n)
    return boxes


def front_points(n, r):
    """Lidar points in front of the camera, some beside and behind it."""
    return np.concatenate([r.uniform(-10, 60, (n, 1)), r.uniform(-30, 30, (n, 1)), r.uniform(-3, 2, (n, 1)),
                           r.uniform(0, 1, (n, 1))], 1).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("origin,axis", [((0.5, 0.5, 0.0), 2), ((0.5, 1.0, 0.5), 1), (0.5, 0)])
def test_center_to_corner_box3d(origin, axis):
    b = random_boxes(64, np.random.RandomState(0))
    want = G.center_to_corner_box3d(b[:, :3], b[:, 3:6], b[:, 6], origin=origin, axis=axis)
    unit = T.unit_corners_3d(origin, torch.device("cpu"), torch.float32)
    close(T.center_to_corner_box3d(t(b[:, :3]), t(b[:, 3:6]), t(b[:, 6]), unit, axis=axis), want)
    close(T.center_to_corner_box3d(t(b[:, :3]), t(b[:, 3:6]), None, unit),
          G.center_to_corner_box3d(b[:, :3], b[:, 3:6], None, origin=origin))


def test_box_lidar_to_camera():
    b = random_boxes(64, np.random.RandomState(1))
    close(T.box_lidar_to_camera(t(b), R0_RECT, VELO2CAM), G.box_lidar_to_camera(b, R0_RECT, VELO2CAM))


@pytest.mark.parametrize("rows", [3, 4])
def test_project_to_image(rows):
    r = np.random.RandomState(2)
    cam = np.concatenate([r.uniform(-20, 20, (64, 2)), r.uniform(2, 70, (64, 1))], 1).astype(np.float32)
    close(T.project_to_image(t(cam), P2[:rows]), G.project_to_image(cam, P2[:rows]))
    corners = cam[:48].reshape(6, 8, 3)  # leading axes pass through
    close(T.project_to_image(t(corners), P2[:rows]), G.project_to_image(corners, P2[:rows]))


@pytest.mark.parametrize("width", [3, 4])
def test_lidar_to_camera(width):
    pts = front_points(128, np.random.RandomState(3))
    pts[:, 3] = 1.0
    close(T.lidar_to_camera(t(pts[:, :width]), R0_RECT, VELO2CAM), G.lidar_to_camera(pts[:, :width], R0_RECT, VELO2CAM))


def test_camera_to_lidar():
    cam = np.asarray(G.lidar_to_camera(front_points(128, np.random.RandomState(4)), R0_RECT, VELO2CAM))
    close(T.camera_to_lidar(t(cam), R0_RECT, VELO2CAM), G.camera_to_lidar(cam, R0_RECT, VELO2CAM), atol=1e-3)


def test_box_camera_to_lidar():
    cam = np.asarray(G.box_lidar_to_camera(random_boxes(64, np.random.RandomState(5)), R0_RECT, VELO2CAM))
    close(T.box_camera_to_lidar(t(cam), R0_RECT, VELO2CAM), G.box_camera_to_lidar(cam, R0_RECT, VELO2CAM),
          atol=1e-3)


def test_box_encode():
    r = np.random.RandomState(6)
    boxes, anchors = random_boxes(256, r), random_boxes(256, r)
    close(T.box_encode(t(boxes), t(anchors)), G.box_encode(boxes, anchors))
    close(T.box_encode(t(boxes), t(anchors)), T.box_encode_transposed(t(boxes).T, t(anchors).T).T)


def face_points(boxes):
    """For axis-aligned boxes with dyadic centers and dims: each box's
    center, the centers of its six faces, its corners and points just
    inside each face."""
    pts = []
    for x, y, z, l, w, h, _ in boxes:
        for dx, dy, dz in [(0, 0, 0), (l / 2, 0, 0), (-l / 2, 0, 0), (0, w / 2, 0), (0, -w / 2, 0), (0, 0, h / 2),
                           (0, 0, -h / 2), (l / 2, w / 2, h / 2), (-l / 2, -w / 2, -h / 2),
                           (l / 2 - 1 / 64, 0, 0), (0, w / 2 - 1 / 64, 0), (0, 0, h / 2 - 1 / 64)]:
            pts.append([x + dx, y + dy, z + dz, 0.5])
    return np.array(pts, np.float32)


@pytest.mark.parametrize("origin", [(0.5, 0.5, 0.5), (0.5, 0.5, 0.0)])
def test_points_in_rbbox_bit_equal(origin):
    r = np.random.RandomState(7)
    rotated = random_boxes(48, r)
    rotated[:, :2] = r.uniform(-8, 8, (48, 2))
    aligned = np.array([[0, 0, 0, 4, 2, 2, 0], [3.5, -2.25, -1.5, 1.5, 0.75, 1.25, 0],
                        [-6, 4, 0.5, 2.5, 4.5, 3, 0], [0, 0, 0.25, 1, 1, 1, 0]], np.float32)
    boxes = np.concatenate([rotated, aligned])
    pts = np.concatenate([front_points(2000, r) * [0.2, 0.4, 1, 1], face_points(aligned)]).astype(np.float32)
    want = np.asarray(G.points_in_rbbox(pts, boxes, origin=origin))
    got = T.points_in_rbbox(t(pts), t(boxes), origin=origin).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and (~want).any()
    # the faces: no point on a face is inside its box
    faces = face_points(aligned[:1])
    inside = T.points_in_rbbox(t(faces), t(aligned[:1])).numpy()[:, 0]
    np.testing.assert_array_equal(inside, [True] + [False] * 8 + [True] * 3)


def test_corners_to_frustum_mask():
    pts = front_points(2000, np.random.RandomState(8))
    want = np.asarray(G.corners_to_frustum_mask(pts, IMAGE_BOX, P2, R0_RECT, VELO2CAM))
    got = T.corners_to_frustum_mask(t(pts), IMAGE_BOX, P2, R0_RECT, VELO2CAM).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and (~want).any()
