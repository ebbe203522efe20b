"""The compiled sharded entry points on the card: a world-1 NCCL group in
this process (`make_mesh` with no rendezvous), each captured form held bit
for bit against its eager form under cuDNN deterministic, with the same
collectives per call; the CPU side is tests/test_torch_sharded_jit.py.
Every test is `gpu`-marked and skips without a card. No JAX: run on the
card machine with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sharded_jit_gpu.py
"""

from __future__ import annotations

import functools
import gc

import numpy as np
import pytest
import torch

from det3d_tpu_torch.parallel import mesh as pm
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.train.trainer import Trainer
from test_torch_jit import batches, frames, small_cfg
from test_torch_sharded_jit import delta, differing, group_delta

STEPS = 3


@pytest.fixture(scope="module")
def nccl():
    """A world-1 NCCL group on cuda:0 for the module, its graphs gone
    before the group is destroyed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m gpu)")
    import torch.distributed as dist

    mesh = pm.make_mesh(device="cuda:0", rank=0, world_size=1)
    yield mesh
    gc.collect()
    torch.cuda.synchronize()
    dist.destroy_process_group()


@pytest.fixture
def deterministic(nccl, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return nccl


def steps_in_lockstep(mesh, counted, eager_trainer, eager_step, captured_trainer, captured_step, data):
    """The eager and the captured step from init_weights(0) over `data`:
    what differed after each step, and each form's collectives a step."""
    se = pm.replicated(mesh, eager_trainer, eager_trainer.init_state(0))
    sc = pm.replicated(mesh, captured_trainer, captured_trainer.init_state(0))
    diffs, eager, captured = [], [], []
    for b in data:
        before = pm.collective_counts(counted)
        se, le, ce = eager_step(se, b)
        middle = pm.collective_counts(counted)
        sc, lc, cc = captured_step(sc, b)
        eager.append(group_delta(before, middle))
        captured.append(group_delta(middle, pm.collective_counts(counted)))
        diffs.append(differing(eager_trainer, se, le, ce, captured_trainer, sc, lc, cc))
    return diffs, eager, captured


@pytest.mark.gpu
def test_captured_dp_step_is_the_eager_step_bit_for_bit(deterministic):
    mesh = deterministic
    cfg = small_cfg()
    eager, captured = Trainer(cfg, mesh.device), Trainer(cfg, mesh.device)
    diffs, ce, cc = steps_in_lockstep(mesh, mesh, eager, functools.partial(eager.train_step, mesh=mesh), captured,
                                      pm.make_sharded_train_step(captured, mesh), batches(cfg, STEPS))
    assert captured.train_step_jit.captures == 1
    assert diffs == [[]] * STEPS
    assert ce == cc == [{"all_reduce": 7}] * STEPS


@pytest.mark.gpu
def test_captured_hybrid_step_is_the_eager_step_bit_for_bit(deterministic):
    hybrid = pm.make_hybrid_mesh(1, 1, device="cuda:0")
    cfg = small_cfg()
    eager, _ = pm.make_spatial_train(cfg, hybrid)
    captured, step = pm.make_spatial_train(cfg, hybrid)
    diffs, ce, cc = steps_in_lockstep(hybrid.world, hybrid, eager, functools.partial(eager.train_step, mesh=hybrid),
                                      captured, step, batches(cfg, STEPS))
    assert captured.train_step_jit.captures == 1
    assert diffs == [[]] * STEPS
    assert ce == cc == [{"spatial": {"all_gather": 33, "all_reduce": 38}, "data": {"all_reduce": 6},
                         "world": {"all_reduce": 1}}] * STEPS


@pytest.mark.gpu
def test_captured_spatial_frame_is_the_eager_frame_bit_for_bit(deterministic):
    mesh = deterministic
    det, infer = pm.make_spatial_infer(small_cfg(), mesh)
    det.init_weights(0)
    for pts, n in frames(small_cfg(), 3):
        before = pm.collective_counts(mesh)
        want = det.infer(torch.from_numpy(pts).to(mesh.device), int(n))
        middle = pm.collective_counts(mesh)
        got = infer(pts, n)
        assert delta(before, middle) == delta(middle, pm.collective_counts(mesh)) == {"all_gather": 17,
                                                                                    "all_reduce": 19}
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert det.infer_jit.captures == 1


@pytest.mark.gpu
def test_captured_sharded_infer_is_infer_batch_bit_for_bit(deterministic):
    mesh = deterministic
    det = Detector(small_cfg(), mesh.device).init_weights(0)
    pads = frames(small_cfg(), 4)
    points = np.stack([p for p, _ in pads])
    counts = np.array([n for _, n in pads], np.int32)
    infer = pm.make_sharded_infer(det, mesh)
    for shift in (0.0, 0.25):
        pts = points + np.float32(shift)
        want = det.infer_batch(torch.from_numpy(pts).to(mesh.device), torch.from_numpy(counts).to(mesh.device))
        before = pm.collective_counts(mesh)
        got = infer(pts, counts)
        assert delta(before, pm.collective_counts(mesh)) == {"all_gather": 3}
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert [c.captures for c in infer.captured.values()] == [1]
