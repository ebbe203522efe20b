"""The deploy path on the card: the kernel ops against their plain
versions, the exported program replayed as a CUDA graph against the same
program run op by op, and a capture that fails.

Every test needs a CUDA card and skips without one (decided in the `cuda`
fixture). This file imports nothing of JAX: `python -m pytest --noconftest
-p no:cacheprovider -m gpu tests/test_torch_deploy_gpu.py`.

Tolerances: none. The ops move or compare the same float32 values as their
plain versions (bit-equal), and the graph replays the very kernels that the
program launches op by op, on the same inputs (bit-equal).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.deploy.export import export_detector
from det3d_tpu_torch.deploy.runtime import ExportedDetector
from det3d_tpu_torch.kernels import nms_cuda, scatter_cuda
from det3d_tpu_torch.pipeline import Detector

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m gpu)")
    return torch.device("cuda")


def small_cfg():
    return load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5,
        "max_points": 4096, "compute_dtype": "float32",
    })


def cloud(rng, k: int) -> np.ndarray:
    return np.concatenate([rng.uniform(-15, 15, (k, 2)), rng.uniform(-2, 6, (k, 1)),
                           rng.uniform(0, 1, (k, 1))], 1).astype(np.float32)


def scatter_inputs(device, b=2, v=300, c=64, grid=(32, 32), n_valid=200, seed=0):
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.randn(b, v, c).astype(np.float32))
    coors = torch.full((b, v, 3), -1, dtype=torch.int32)
    for i in range(b):
        cells = rng.permutation(grid[0] * grid[1])[:n_valid]
        coors[i, :n_valid, 0] = torch.from_numpy(cells // grid[1])
        coors[i, :n_valid, 1] = torch.from_numpy(cells % grid[1])
        coors[i, :n_valid, 2] = 0
    return feats.to(device), coors.to(device)


@pytest.mark.gpu
def test_ops_on_the_card_equal_their_plain_versions(cuda):
    feats, coors = scatter_inputs(cuda)
    ops = torch.ops.det3d
    cases = [
        (ops.scatter_to_bev, (feats, coors, 32, 32), lambda: scatter_cuda.scatter_to_bev_plain(feats, coors, (32, 32)),
         scatter_cuda.counter),
        (ops.scatter_to_bev_s2d, (feats, coors, 32, 32, True),
         lambda: scatter_cuda.scatter_to_bev_s2d_plain(feats, coors, (32, 32), True), scatter_cuda.s2d_counter),
        (ops.scatter_to_bev_s2d_blocked, (feats, coors, 32, 32, 2, 4, 3),
         lambda: scatter_cuda.scatter_to_bev_s2d_blocked_plain(feats, coors, (32, 32), 2, (4, 3)),
         scatter_cuda.blocked_counter),
    ]
    rng = np.random.RandomState(1)
    xy = torch.from_numpy(rng.rand(3, 500, 2).astype(np.float32) * 40)
    boxes = torch.cat([xy, xy + torch.from_numpy(rng.rand(3, 500, 2).astype(np.float32) * 4 + 1)], -1).to(cuda)
    valid = torch.from_numpy(rng.rand(3, 500) > 0.2).to(cuda)
    cases.append((ops.nms_keep, (boxes, valid, 0.1), lambda: nms_cuda.nms_keep_plain(boxes, valid, 0.1),
                  nms_cuda.counter))
    for op, args, plain, counter in cases:
        before = counter.launches
        got = op(*args)
        torch.cuda.synchronize()
        assert counter.launches == before + 1, op
        want = plain()
        assert got.stride() == want.stride() and torch.equal(got, want), op


@pytest.mark.gpu
def test_scatter_op_backward_launches_its_kernel(cuda):
    feats, coors = scatter_inputs(cuda)
    feats.requires_grad_(True)
    before = scatter_cuda.bwd_counter.launches
    canvas = scatter_cuda.scatter_to_bev(feats, coors, (32, 32))
    g = torch.randn_like(canvas)
    (got,) = torch.autograd.grad((canvas * g).sum(), feats)
    assert scatter_cuda.bwd_counter.launches == before + 1
    assert torch.equal(got, scatter_cuda.scatter_to_bev_bwd_plain(g, coors))


@pytest.fixture
def artifact(cuda, tmp_path):
    cfg = small_cfg()
    return cfg, export_detector(cfg, out_dir=tmp_path / "art", device=cuda)


@pytest.mark.gpu
def test_graph_replay_equals_the_program_op_by_op(artifact, cuda):
    cfg, art = artifact
    graph = ExportedDetector(art, cuda)
    eager = ExportedDetector(art, cuda, cuda_graph=False)
    live = Detector(cfg, cuda).init_weights(0)
    assert graph.graph is not None and eager.graph is None
    rng = np.random.RandomState(0)
    for k in (3000, 800, 0, 4096, 5000, 1500):
        points = cloud(rng, k)
        got, want, live_annos = graph.detect(points), eager.detect(points), live.detect(points)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{k} points: {key}")
            np.testing.assert_array_equal(want[key], live_annos[key], err_msg=f"{k} points: {key}")


@pytest.mark.gpu
def test_graph_replays_launch_no_wrapper(artifact, cuda):
    """A replay runs the captured kernels without the ops' Python: the
    launch counters move in the capture and never after it."""
    _, art = artifact
    before = scatter_cuda.counter.launches, nms_cuda.counter.launches
    runner = ExportedDetector(art, cuda)
    captured = scatter_cuda.counter.launches, nms_cuda.counter.launches
    assert captured == (before[0] + 3, before[1] + 3)  # two warm-up calls and the capture
    runner.detect(cloud(np.random.RandomState(1), 2000))
    assert (scatter_cuda.counter.launches, nms_cuda.counter.launches) == captured


@pytest.mark.gpu
def test_capture_that_fails_raises(artifact, cuda):
    """A program that reads a value back to the host cannot be captured:
    `_capture` raises and leaves no graph. In a process of its own, since a
    capture torn down by an error leaves the card's random generator in
    capture mode for the rest of the process."""
    _, art = artifact
    code = (
        "import sys\n"
        "from det3d_tpu_torch.deploy.runtime import ExportedDetector\n"
        f"runner = ExportedDetector({str(art)!r}, 'cuda', cuda_graph=False)\n"
        "program = runner.module\n"
        "def syncs(points, count):\n"
        "    count.item()  # a host read: not capturable\n"
        "    return program(points, count)\n"
        "runner.module = syncs\n"
        "try:\n"
        "    runner._capture()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', str(e).splitlines()[0])\n"
        "    sys.exit(0 if runner.graph is None else 3)\n"
        "sys.exit(4)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised:" in out.stdout
