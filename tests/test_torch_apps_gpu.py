"""The application layer on the card: checkpoints, the rotated IoU, the
in-training eval and both apps, each against the same work on the CPU or
on the plain path.

Every test needs a CUDA card and skips without one (decided in the `cuda`
fixture). This file imports nothing of JAX, so it runs where JAX is not
installed: `python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_apps_gpu.py`.

Tolerances: the checkpoint round trip bit-equal (it only moves float32),
and the step after it within 2·lr of the live trainer's (cuDNN's backward
is not bit-reproducible from call to call);
the rotated IoU on the card against the CPU within 1e-6 abs: the same
float32 operations, with the card's own `atan2`, `sin`/`cos` and
summation order; raw areas (up to ~40 m²) within rtol 1e-5 (3.5e-6 seen
on an H100); `eval_step` against `Detector.infer` on
the same weights equal (the same kernels on the same inputs).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.data.synthetic import sample_scene
from det3d_tpu_torch.ops import rotated_iou as tri
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.train import checkpoint as ck
from det3d_tpu_torch.train.trainer import Trainer, host_batch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m gpu)")
    return torch.device("cuda")


def small_cfg(**kw):
    return load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5,
        "max_points": 4096, "max_gt_boxes": 8, "compute_dtype": "float32", "batch_size": 2, **kw,
    })


def batch(cfg, seed):
    rng = np.random.RandomState(seed)
    return host_batch(cfg, [sample_scene(cfg, rng, (2, 5), ground_points=1500) for _ in range(cfg.batch_size)])


def rboxes(shape, seed, spread=10.0):
    r = np.random.RandomState(seed)
    out = np.zeros(shape + (5,), np.float32)
    out[..., :2] = r.uniform(-spread, spread, shape + (2,))
    out[..., 2:4] = r.uniform(1.0, 6.0, shape + (2,))
    out[..., 4] = r.uniform(-np.pi, np.pi, shape)
    return out


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    cfg = small_cfg()
    live = Trainer(cfg, device=cuda)
    state = live.init_state(0)
    for seed in (0, 1):
        state, _, _ = live.train_step(state, batch(cfg, seed))
    ck.CheckpointManager(tmp_path).save(state, live.model)
    for device in (cuda, torch.device("cpu")):
        other = Trainer(cfg, device=device)
        other.init_state(3)
        restored = ck.CheckpointManager(tmp_path).restore_latest(other)
        assert (restored.step, restored.lr) == (state.step, state.lr)
        for k, v in live.model.state_dict().items():
            got = other.model.state_dict()[k]
            assert got.device.type == device.type and torch.equal(got.cpu(), v.cpu()), k
        for a, b in zip(restored.mu + restored.nu, state.mu + state.nu):
            assert a.device.type == device.type and a.dtype == torch.float32 and torch.equal(a.cpu(), b.cpu())
    other = Trainer(cfg, device=cuda)
    restored = ck.CheckpointManager(tmp_path).restore_latest(other)
    b = batch(cfg, 2)
    state, _, _ = live.train_step(state, b)
    restored, _, _ = other.train_step(restored, b)
    # cuDNN's backward may sum in another order from call to call, and
    # Adam's update of a gradient within rounding of 0 is about ±lr
    for k, v in live.model.state_dict().items():
        assert (other.model.state_dict()[k] - v).abs().max() <= 2 * state.lr, k


@pytest.mark.gpu
@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotated_iou_on_the_card_equals_cpu(cuda, criterion):
    a, b = rboxes((40,), 0), rboxes((30,), 1)
    got = tri.rotate_iou_eval_np(a, b, criterion, device=cuda)
    want = tri.rotate_iou_eval_np(a, b, criterion, device="cpu")
    tol = dict(rtol=1e-5, atol=1e-5) if criterion == 2 else dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, **tol)
    fa, fb = rboxes((4, 64), 2, 6.0), rboxes((4, 32), 3, 6.0)
    np.testing.assert_allclose(tri.rotate_iou_frames_np(fa, fb, criterion, device=cuda),
                               tri.rotate_iou_frames_np(fa, fb, criterion, device="cpu"), **tol)


@pytest.mark.gpu
def test_d3_iou_on_the_card_equals_cpu(cuda):
    r = np.random.RandomState(4)
    a = np.concatenate([rboxes((3, 48), 5, 8.0)[..., :2], r.uniform(-2, 0, (3, 48, 1)),
                        r.uniform(0.5, 5, (3, 48, 3)), r.uniform(-3, 3, (3, 48, 1))], -1).astype(np.float32)
    b = a[:, ::3] + r.normal(0, 0.3, a[:, ::3].shape).astype(np.float32)
    got = tri.d3_iou_frames_np(a, b, device=cuda)
    np.testing.assert_allclose(got, tri.d3_iou_frames_np(a, b, device="cpu"), rtol=0, atol=1e-6)
    assert (got > 0.3).any()


@pytest.mark.gpu
def test_eval_step_equals_detector_infer(cuda):
    cfg = small_cfg()
    trainer = Trainer(cfg, device=cuda)
    state = trainer.init_state(0)
    state, _, _ = trainer.train_step(state, batch(cfg, 0))
    det = Detector(cfg, device=cuda).load_state_dict(trainer.model.state_dict())
    pts, n = det.pad_points(sample_scene(cfg, np.random.RandomState(9), (2, 5), ground_points=1500)["points"])
    got = trainer.eval_step(pts, n)
    want = det.infer(torch.from_numpy(pts).to(cuda), int(n))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got.valid.any()


@pytest.mark.gpu
def test_apps_run_on_the_card(cuda, tmp_path, monkeypatch):
    """Train, save and evaluate on the card, then infer its checkpoint on
    the card and on the CPU (TF32 off): the same detections per class and
    the same mAP strings."""
    from det3d_tpu_torch.apps.infer_app import infer
    from det3d_tpu_torch.apps.train_app import train

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = small_cfg()
    summary = train(cfg, max_steps=3, display_step=1, save_step=3, eval_step=3, eval_frames=2, synthetic=True,
                    model_dir=str(tmp_path))
    assert summary["steps"] == 3 and summary["trainer"].device.type == "cuda"
    assert "Metric: 3d" in summary["eval_strs"][0]
    out = infer(cfg, checkpoint=str(tmp_path), synthetic=True, num_frames=3, breakdown=True)
    cpu = infer(cfg, checkpoint=str(tmp_path), synthetic=True, num_frames=3, device="cpu")
    assert out["eval_strs"] == cpu["eval_strs"]
    for g, w in zip(out["dt_annos"], cpu["dt_annos"]):
        assert sorted(g["name"].tolist()) == sorted(w["name"].tolist())
