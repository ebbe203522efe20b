"""The port's compiled entry points: `Detector.infer_jit`,
`Detector.infer_batch_jit`, `Trainer.train_step_jit` and
`Trainer.eval_step_jit` (`utils/graphs.CapturedCall`).

On the CPU each runs its function op by op over its static buffers, so
these tests hold the buffer hand-off: bit-equal to the eager methods, the
JAX package's `*_jit` at the stated tolerances, the owned moments, the
overwritten outputs, parameters updated in place. The `gpu`-marked tests
capture and replay on the card and skip here (decided in the `cuda`
fixture); JAX is imported inside the two tests that compare with it, so
that the card machine, which has no JAX, can run this file with
`python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_jit.py`.

Tolerances, each with its reason:
  * the `*_jit` callables against the eager methods: bit-equal (the same
    ops on the same values; the copies into and out of the static buffers
    are exact);
  * two f32 steps of `train_step_jit` against JAX's `train_step_jit`
    from the same weights and batches, step 2 from JAX's step-1 weights
    and the port's own moments: at both steps loss terms rtol 1e-5, metric
    counts equal, running statistics rtol 1e-5, and Adam's moments within
    1e-3 of their tensor's largest (the two gradients differ by up to
    1.5e-4 of it: f32 sums in another order); step 1's weights at
    tests/test_torch_train.py's rules (within 1e-6 where the port's
    gradient is above 1e-3 of its tensor's largest and within 2·lr
    elsewhere: Adam's first update is about lr·sign(g), so a gradient
    within rounding of 0 can flip its sign); step 2's weights within
    0.05·lr (0.018·lr seen: the second update is a ratio of the moments,
    so their difference shows in it, where a skipped, reversed or
    uncarried second update is off by lr/2 or more);
  * `infer_jit` against JAX's `infer_jit` on the `e2e_mid` golden frame 0:
    tests/test_golden_e2e.py's tolerances (valid sets equal, boxes 1e-4,
    scores 1e-5) after tests/test_torch_pipeline.py's near-tie swap
    (`NEAR_TIES`);
  * on the card, the captured step and frame against the eager ones with
    cuDNN deterministic: bit-equal.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.data.synthetic import sample_scene
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.train.checkpoint import CheckpointManager
from det3d_tpu_torch.train.trainer import Trainer, TrainState, host_batch
from det3d_tpu_torch.utils.graphs import CapturedCall
from det3d_tpu_torch.utils.npmath import pad_cloud
from test_torch_tmpdirs import tmp_path  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "e2e_mid.npz"


def small_cfg(**kw):
    """The 32x32-grid geometry of chip_smoke.small_config, batch 2."""
    return load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5,
        "max_points": 4096, "max_gt_boxes": 8, "compute_dtype": "float32", "batch_size": 2, **kw,
    })


def batches(cfg, n, seed=0):
    rng = np.random.RandomState(seed)
    return [host_batch(cfg, [sample_scene(cfg, rng, (2, 5), ground_points=1500) for _ in range(cfg.batch_size)])
            for _ in range(n)]


def frames(cfg, n, seed=1):
    rng = np.random.RandomState(seed)
    return [pad_cloud(sample_scene(cfg, rng, (2, 5), ground_points=1500)["points"], cfg.max_points)
            for _ in range(n)]


def run_steps(trainer, state, batch_list, jit: bool):
    """(state, [(loss dict, counts) cloned per step]) of the eager or the
    captured step over `batch_list`."""
    fn = trainer.train_step_jit if jit else trainer.train_step
    out = []
    for b in batch_list:
        state, loss, counts = fn(state, b)
        out.append(({k: v.clone() for k, v in loss.items()}, {k: v.clone() for k, v in counts.items()}))
    return state, out


def assert_same_step_results(a, b):
    for (la, ca), (lb, cb) in zip(a, b):
        assert la.keys() == lb.keys() and ca.keys() == cb.keys()
        for k in la:
            assert torch.equal(la[k], lb[k]), k
        for k in ca:
            assert torch.equal(ca[k], cb[k]), k


def assert_same_model(ta: Trainer, tb: Trainer, sa: TrainState, sb: TrainState):
    for (name, x), y in zip(ta.model.state_dict().items(), tb.model.state_dict().values()):
        assert torch.equal(x, y), name
    assert sa.step == sb.step and sa.lr == sb.lr
    for x, y in zip(sa.mu + sa.nu, sb.mu + sb.nu):
        assert torch.equal(x, y)


def assert_same_detections(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- op by op over the static buffers: bit-equal to the eager methods ---------------


@pytest.mark.parametrize("device_augment", [False, True], ids=["plain", "device_augment"])
def test_train_step_jit_equals_train_step(device_augment):
    cfg = small_cfg()
    data = batches(cfg, 3)
    runs = []
    for jit in (False, True):
        trainer = Trainer(cfg, CPU, device_global_augment=device_augment, aug_seed=3)
        state, out = run_steps(trainer, trainer.init_state(0), data, jit)
        runs.append((trainer, state, out))
    (te, se, oe), (tj, sj, oj) = runs
    assert_same_step_results(oe, oj)
    assert_same_model(te, tj, se, sj)
    assert se.step == 3 and tj.train_step_jit.captures == 0  # the CPU captures nothing
    assert oe[0][0]["loss"] != oe[1][0]["loss"]


def test_infer_jit_and_batch_jit_equal_the_eager_methods():
    cfg = small_cfg()
    det = Detector(cfg, CPU).init_weights(0)
    pads = frames(cfg, 2)
    found = 0
    for pts, n in pads:
        want = det.infer(torch.from_numpy(pts), int(n))
        assert_same_detections(det.infer_jit(pts, n), want)
        found += int(want.valid.sum())
    assert found > 0
    points = np.stack([p for p, _ in pads])
    counts = np.array([n for _, n in pads], np.int32)
    want = det.infer_batch(torch.from_numpy(points), torch.from_numpy(counts))
    assert_same_detections(det.infer_batch_jit(points, counts), want)
    pts, n = pads[0]
    assert len(det.detect(pts[:n])["score"]) == int(det.infer(torch.from_numpy(pts), int(n)).valid.sum())


# --- against the JAX package's *_jit ------------------------------------------------


def test_train_step_jit_matches_jax_train_step_jit():
    """Both from the port's `init_weights(0)`, carried to JAX by
    `deploy/torch_interop.state_dict_to_variables` (no JAX init to
    compile). Step 2 starts from JAX's step-1 weights, loaded into the
    port's model in place; the port's moments are its own, carried by the
    graph from step 1."""
    import test_torch_parity_utils as pu
    from det3d_tpu.deploy.torch_interop import state_dict_to_variables
    from det3d_tpu.train.trainer import Trainer as JaxTrainer
    from det3d_tpu.train.trainer import TrainState as JaxTrainState
    from det3d_tpu.train.trainer import host_batch as jax_host_batch
    from det3d_tpu_torch.weights import variables_to_state_dict

    jcfg = pu.small_cfg().replace(batch_size=2)
    tcfg = pu.to_torch_cfg(jcfg)
    rng = np.random.RandomState(0)
    samples = [[sample_scene(tcfg, rng, (2, 4), ground_points=800) for _ in range(2)] for _ in range(2)]
    trainer = Trainer(tcfg, CPU)
    state = trainer.init_state(0)
    owned = state.mu + state.nu
    variables = state_dict_to_variables({k: v.numpy() for k, v in trainer.model.state_dict().items()})
    jtrainer = JaxTrainer(jcfg)
    jstate = JaxTrainState(step=np.zeros((), np.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=jtrainer.optimizer.init(variables["params"]))
    lr = tcfg.learning_rate

    def as_state_dict(params):  # a tree shaped like the params → the port's names and layouts
        return variables_to_state_dict(pu.numpy_variables({"params": params, "batch_stats": jstate.batch_stats}))

    after = None
    for k, s in enumerate(samples):
        if after is not None:
            trainer.detector.load_state_dict(pu.to_tensors(after))
        jstate, jloss, jcounts = jtrainer.train_step_jit(jstate, jax_host_batch(jcfg, s))
        state, loss, counts = trainer.train_step_jit(state, host_batch(tcfg, s))
        assert all(a is b for a, b in zip(state.mu + state.nu, owned))
        for key, want in jloss.items():
            np.testing.assert_allclose(float(loss[key]), float(want), rtol=1e-5, err_msg=f"step {k + 1} {key}")
        for key, want in jcounts.items():
            np.testing.assert_array_equal(counts[key].numpy(), np.asarray(want), err_msg=f"step {k + 1} {key}")
        after = as_state_dict(jstate.params)
        adam = jstate.opt_state[1].inner_state[0]
        jmu, jnu = as_state_dict(adam.mu), as_state_dict(adam.nu)
        sd = trainer.model.state_dict()
        n_big = 0
        for (name, p), mu, nu in zip(trainer.model.named_parameters(), state.mu, state.nu):
            got, want = sd[name].numpy(), after[name]
            for moment, jax_moment in ((mu, jmu[name]), (nu, jnu[name])):
                np.testing.assert_allclose(moment.numpy(), jax_moment, rtol=0, atol=1e-3 * np.abs(jax_moment).max(),
                                           err_msg=f"step {k + 1} moment of {name}")
            if k == 0:
                assert np.abs(got - want).max() <= 2 * lr, f"step 1 {name}"
                g = p.grad.abs()
                big = (g > 1e-3 * g.max()).numpy()
                n_big += int(big.sum())
                np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=0.05 * lr, err_msg=f"step 2 {name}")
        assert k > 0 or n_big > 0.9 * sum(p.numel() for p in trainer.params)
        for name in ("running_mean", "running_var"):
            key = f"pillar_point_net.pfn_layers.1.{name}"
            np.testing.assert_allclose(sd[key].numpy(), after[key], rtol=1e-5, atol=1e-6, err_msg=f"step {k + 1} {key}")
    assert state.step == 2 and int(jstate.step) == 2


def test_infer_jit_matches_jax_infer_jit_on_the_mid_golden_frame():
    import test_torch_parity_utils as pu
    from test_torch_pipeline import NEAR_TIES, assert_detections_match

    jdet, variables, tdet = pu.golden_detectors("mid")
    golden = np.load(GOLDEN)
    pts, n = golden["points_0"], golden["num_0"]
    want = jdet.infer_jit(variables, pts, np.int32(n))
    valid = np.asarray(want.valid, bool)
    boxes, scores = np.asarray(want.boxes).copy(), np.asarray(want.scores).copy()
    np.testing.assert_array_equal(valid, golden["valid_0"])
    for c, a, b in NEAR_TIES[("mid", 0)]:
        assert valid[c, a] and valid[c, b]
        np.testing.assert_allclose(scores[c, a], scores[c, b], rtol=0, atol=1e-6)
        boxes[c, [a, b]], scores[c, [a, b]] = boxes[c, [b, a]], scores[c, [b, a]]
    got = tdet.infer_jit(pts, n)
    assert valid.sum() > 0
    assert_detections_match(got, valid, boxes, scores, "mid frame 0")


# --- the state and the buffers ------------------------------------------------------


def test_a_foreign_state_is_copied_into_the_owned_moments():
    cfg = small_cfg()
    data = batches(cfg, 3)
    trainer = Trainer(cfg, CPU)
    state = trainer.init_state(0)
    owned = state.mu + state.nu
    state, _, _ = trainer.train_step_jit(state, data[0])
    assert all(a is b for a, b in zip(state.mu + state.nu, owned))
    # a restored-like state: other tensors, other values
    foreign = TrainState(step=state.step, mu=[m.clone() * 0.5 for m in state.mu],
                         nu=[v.clone() * 0.5 for v in state.nu], lr=state.lr)
    values = [t.clone() for t in foreign.mu + foreign.nu]
    reference = Trainer(cfg, CPU)
    reference.model.load_state_dict(trainer.model.state_dict())
    ref_state = TrainState(step=foreign.step, mu=[t.clone() for t in foreign.mu],
                           nu=[t.clone() for t in foreign.nu], lr=foreign.lr)
    new, loss, _ = trainer.train_step_jit(foreign, data[1])
    ref_state, ref_loss, _ = reference.train_step(ref_state, data[1])
    assert new is not foreign and foreign.step == 1 and new.step == 2
    assert all(a is b for a, b in zip(new.mu + new.nu, owned))
    assert all(torch.equal(a, b) for a, b in zip(foreign.mu + foreign.nu, values))  # left as it was
    assert torch.equal(loss["loss"], ref_loss["loss"])
    assert_same_model(trainer, reference, new, ref_state)


def test_override_lr_is_seen_by_the_next_call():
    cfg = small_cfg()
    data = batches(cfg, 2)
    runs = []
    for jit in (False, True):
        trainer = Trainer(cfg, CPU)
        state = trainer.init_state(0)
        fn = trainer.train_step_jit if jit else trainer.train_step
        state, _, _ = fn(state, data[0])
        state = Trainer.override_lr(state, 10 * cfg.learning_rate)
        before = [p.detach().clone() for p in trainer.params]
        state, _, _ = fn(state, data[1])
        runs.append((trainer, state, before))
    (te, se, be), (tj, sj, bj) = runs
    assert sj.lr == 10 * cfg.learning_rate
    assert_same_model(te, tj, se, sj)
    moved = max((p - b).abs().max().item() for p, b in zip(tj.params, bj))
    assert moved > 5 * cfg.learning_rate  # more than the first lr can move a weight in one step


def test_outputs_are_overwritten_by_the_next_call():
    cfg = small_cfg()
    det = Detector(cfg, CPU).init_weights(0)
    (p0, n0), (p1, n1) = frames(cfg, 2)
    first = det.infer_jit(p0, n0)
    kept = [t.clone() for t in first]
    second = det.infer_jit(p1, n1)
    assert all(a is b for a, b in zip(first, second))
    assert_same_detections(second, det.infer(torch.from_numpy(p1), int(n1)))
    assert not all(torch.equal(a, b) for a, b in zip(kept, second))

    trainer = Trainer(cfg, CPU)
    state = trainer.init_state(0)
    data = batches(cfg, 2)
    state, loss0, counts0 = trainer.train_step_jit(state, data[0])
    kept = loss0["loss"].clone()
    state, loss1, counts1 = trainer.train_step_jit(state, data[1])
    assert loss0["loss"] is loss1["loss"] and counts0["tp"] is counts1["tp"]
    assert not torch.equal(kept, loss1["loss"])


def test_the_train_apps_counts_are_clones(monkeypatch, tmp_path):
    """Each step's metric counts reach the display window as they were
    after that step, not as the next step overwrote them."""
    from det3d_tpu_torch.apps import train_app
    from det3d_tpu_torch.train import metrics

    cfg = small_cfg()
    seen = []
    update = metrics.RunningMetrics.update
    monkeypatch.setattr(metrics.RunningMetrics, "update",
                        lambda self, c: (seen.append({k: np.asarray(v).copy() for k, v in c.items()}), update(self, c)))
    train_app.train(cfg, max_steps=2, display_step=2, save_step=10, eval_step=10, synthetic=True,
                    model_dir=str(tmp_path), device="cpu")
    trainer = Trainer(cfg, CPU)
    state = trainer.init_state(0)
    data = train_app._batch_iterator(cfg, True, 0)
    want = []
    for _ in range(2):
        state, _, counts = trainer.train_step(state, next(data))
        want.append({k: v.numpy() for k, v in counts.items()})
    data.close()
    assert len(seen) == 2
    for got, w in zip(seen, want):
        for k in w:
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)
    assert any(not np.array_equal(seen[0][k], seen[1][k]) for k in want[0])


def test_weights_are_updated_in_place(tmp_path):
    """`init_weights`, `load_state_dict`, `init_state(seed)` and
    `restore_latest` keep every parameter and buffer tensor (the captured
    graphs read them by address), and the jit callables see what they
    load."""
    cfg = small_cfg()
    trainer = Trainer(cfg, CPU)
    state = trainer.init_state(0)
    tensors = list(trainer.model.parameters()) + list(trainer.model.buffers())
    addresses = [t.data_ptr() for t in tensors]
    pts, n = frames(cfg, 1)[0]
    state, _, _ = trainer.train_step_jit(state, batches(cfg, 1)[0])
    CheckpointManager(tmp_path).save(state, trainer.model)
    other = Trainer(cfg, CPU)
    other.init_state(5)
    trainer.detector.init_weights(7)
    trainer.init_state(8)
    trainer.detector.load_state_dict(other.model.state_dict())
    assert_same_detections(trainer.eval_step_jit(pts, n), other.detector.infer(torch.from_numpy(pts), int(n)))
    restored = CheckpointManager(tmp_path).restore_latest(trainer)
    assert restored.step == 1
    now = list(trainer.model.parameters()) + list(trainer.model.buffers())
    assert all(a is b for a, b in zip(now, tensors)) and [t.data_ptr() for t in now] == addresses
    assert_same_detections(trainer.eval_step_jit(pts, n), trainer.eval_step(pts, n))


def test_a_dropped_trainer_or_detector_goes_with_its_graphs():
    """A trainer and a detector go, with their captured callables (and on
    the card the graphs' pools), as soon as their last reference does,
    without the cycle collector. torch's first custom-op call in a process
    imports lazily and keeps the frames of that call in a cycle once: an
    eager step pays that first."""
    cfg = small_cfg()
    data = batches(cfg, 1)
    pts, n = frames(cfg, 1)[0]
    warm = Trainer(cfg, CPU)
    warm.train_step(warm.init_state(0), data[0])
    del warm
    gc.collect()
    gc.disable()
    try:
        trainer = Trainer(cfg, CPU)
        trainer.train_step_jit(trainer.init_state(0), data[0])
        trainer.eval_step_jit(pts, n)
        det = Detector(cfg, CPU).init_weights(0)
        det.infer_jit(pts, n)
        det.infer_batch_jit(pts[None], np.array([n], np.int32))
        refs = [weakref.ref(x) for x in (trainer, trainer.train_step_jit.call, trainer.detector.infer_jit.call,
                                          det, det.infer_jit.call, det._batch_jits[1].call)]
        del trainer, det
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()


def test_train_step_jit_with_a_mesh_equals_the_eager_step(tmp_path):
    """A world-1 gloo group in this process: `train_step_jit(mesh=...)` over
    3 steps bit-equal to `train_step(mesh=...)`, with the same collectives
    per step (tests/test_torch_sharded_jit.py holds worlds 2 and 4)."""
    import torch.distributed as dist

    from det3d_tpu_torch.parallel import mesh as pm

    cfg = small_cfg()
    data = batches(cfg, 3)
    mesh = pm.make_mesh(device="cpu", rank=0, world_size=1, init_method=f"file://{tmp_path}/rendezvous")
    try:
        runs = []
        for jit in (False, True):
            trainer = Trainer(cfg, CPU)
            state = pm.replicated(mesh, trainer, trainer.init_state(0))
            before = pm.collective_counts(mesh)
            fn = trainer.train_step_jit if jit else trainer.train_step
            out = []
            for b in data:
                state, loss, counts = fn(state, b, mesh=mesh)
                out.append(({k: v.clone() for k, v in loss.items()}, {k: v.clone() for k, v in counts.items()}))
            after = pm.collective_counts(mesh)
            runs.append((trainer, state, out, {k: n - before.get(k, 0) for k, n in after.items()}))
    finally:
        dist.destroy_process_group()
    (te, se, oe, ce), (tj, sj, oj, cj) = runs
    assert tj.train_step_jit.mesh is mesh
    assert_same_step_results(oe, oj)
    assert_same_model(te, tj, se, sj)
    assert ce == cj == {"all_reduce": 7 * len(data), "broadcast": 0}


def test_a_mesh_raises_by_name():
    """A trainer's captured step serves the mesh of its first call, and a
    gloo group on a CUDA device is never captured (gloo stages CUDA tensors
    through the host): both raise before the step runs."""
    from det3d_tpu_torch.parallel import mesh as pm

    data = batches(small_cfg(), 2)
    trainer = Trainer(small_cfg(), CPU)
    state, _, _ = trainer.train_step_jit(trainer.init_state(0), data[0])
    with pytest.raises(ValueError, match="captured for another mesh"):
        trainer.train_step_jit(state, data[1], mesh=pm.DataMesh(None, 0, 1, CPU, "gloo"))
    assert state.step == 1
    trainer = Trainer(small_cfg(), CPU)
    card_gloo = pm.DataMesh(None, 0, 1, torch.device("cuda", 0), "gloo")
    with pytest.raises(ValueError, match="a gloo group on cuda:0 cannot be captured in a CUDA graph"):
        trainer.train_step_jit(trainer.init_state(0), data[0], mesh=card_gloo)
    assert trainer.train_step_jit.captures == 0


def test_a_captured_call_keeps_its_first_shapes():
    call = CapturedCall(lambda x, y: (x + y, {"s": (x * y).sum()}), CPU)
    out = call(np.ones((2, 3), np.float32), torch.full((2, 3), 2.0))
    assert torch.equal(out[0], torch.full((2, 3), 3.0)) and float(out[1]["s"]) == 12.0
    again = call(np.zeros((2, 3), np.float32), torch.ones(2, 3))
    assert again[0] is out[0] and float(out[1]["s"]) == 0.0
    with pytest.raises(ValueError, match="shapes of its first call"):
        call(np.ones((3, 3), np.float32), torch.ones(3, 3))


# --- on the card --------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m gpu)")
    return torch.device("cuda")


@pytest.fixture
def deterministic(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return cuda


@pytest.mark.gpu
@pytest.mark.parametrize("device_augment", [False, True], ids=["plain", "device_augment"])
def test_captured_train_step_is_one_graph_bit_equal_to_the_eager_step(deterministic, device_augment):
    cfg = small_cfg()
    data = batches(cfg, 3)
    runs = []
    for jit in (False, True):
        trainer = Trainer(cfg, deterministic, device_global_augment=device_augment, aug_seed=3)
        state, out = run_steps(trainer, trainer.init_state(0), data, jit)
        runs.append((trainer, state, out))
    (te, se, oe), (tj, sj, oj) = runs
    assert tj.train_step_jit.captures == 1
    assert_same_step_results(oe, oj)
    assert_same_model(te, tj, se, sj)


@pytest.mark.gpu
def test_captured_frames_are_one_graph_bit_equal_to_infer(deterministic):
    from det3d_tpu_torch.kernels import nms_cuda, scatter_cuda

    cfg = small_cfg()
    det = Detector(cfg, deterministic).init_weights(0)
    pads = frames(cfg, 3)
    det.infer_jit(*pads[0])
    captured = scatter_cuda.counter.launches, nms_cuda.counter.launches
    for pts, n in pads:
        assert_same_detections(det.infer_jit(pts, n), det.infer(torch.from_numpy(pts).to(deterministic), int(n)))
    assert det.infer_jit.captures == 1
    assert scatter_cuda.counter.launches - captured[0] == len(pads)  # the eager calls only
    points = np.stack([p for p, _ in pads[:2]])
    counts = np.array([n for _, n in pads[:2]], np.int32)
    want = det.infer_batch(torch.from_numpy(points).to(deterministic), torch.from_numpy(counts).to(deterministic))
    assert_same_detections(det.infer_batch_jit(points, counts), want)


@pytest.mark.gpu
def test_a_dropped_trainer_frees_its_graph_pool(cuda):
    cfg = small_cfg()
    data = batches(cfg, 1)
    warm = Trainer(cfg, cuda)
    warm.train_step_jit(warm.init_state(0), data[0])
    del warm
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_reserved()
    gc.disable()
    try:
        trainer = Trainer(cfg, cuda)
        trainer.train_step_jit(trainer.init_state(0), data[0])
        torch.cuda.synchronize()
        held = torch.cuda.memory_reserved()
        del trainer
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert held > start and torch.cuda.memory_reserved() <= start, (start, held, torch.cuda.memory_reserved())
    finally:
        gc.enable()


@pytest.mark.gpu
def test_a_failed_capture_raises(cuda):
    """A function that reads a value back to the host cannot be captured:
    the call raises and keeps no graph. In a process of its own, since a
    capture torn down by an error leaves the card's random generator in
    capture mode for the rest of the process."""
    code = ("import sys, torch\n"
            "from det3d_tpu_torch.utils.graphs import CapturedCall\n"
            "call = CapturedCall(lambda x: x * float(x.sum()), 'cuda')  # a host read\n"
            "try:\n"
            "    call(torch.ones(4, device='cuda'))\n"
            "except RuntimeError as e:\n"
            "    print('raised:', str(e).splitlines()[0])\n"
            "    sys.exit(0 if call.graph is None and call.captures == 0 else 3)\n"
            "sys.exit(4)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised:" in out.stdout
