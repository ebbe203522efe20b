"""The port's on-device global augmentation against the JAX package, on the
CPU, in float32: the geometry it needs, the transform given the same
parameters, the parameter draws, the trainer's range filter and yaw wrap,
and `train --device-augment` end to end (the dataset's host chain under
`device_global_augment` is tests/test_torch_data.py's).

Tolerances, each with its reason:
  * geometry and the transform given the same parameters: rtol 1e-6 and
    an atol of 1e-6 of the inputs' largest magnitude — the same float32
    formulas; a coordinate rotated to near 0 keeps only the absolute error
    of its two large terms (the sin and cos of the two frameworks may
    differ by an ulp);
  * membership (`points_in_convex_polygon`, the range filter, `gt_valid`):
    equal;
  * a device-augmented step whose transform is the identity against a
    plain step: equal, bit for bit (the same operations on the same values).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu.data import augment as jaug
from det3d_tpu.data.synthetic import sample_scene
from det3d_tpu.ops import geometry as jgeo
from det3d_tpu_torch import cli
from det3d_tpu_torch.data import augment as taug
from det3d_tpu_torch.ops import geometry as tgeo
from det3d_tpu_torch.train.trainer import Trainer, augment_seed, host_batch
from test_torch_tmpdirs import tmp_path  # noqa: F401

torch.set_num_threads(1)


def close(got: torch.Tensor, want, scale: float | None = None) -> None:
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * max(scale, 1.0))


def boxes_and_points(seed: int, n: int = 12):
    """Boxes across and beyond a 32 m range, with yaws at ±π/2 and π among
    them, and a cloud."""
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([rng.uniform(-22, 22, (n, 2)), rng.uniform(-2, 1, (n, 1)),
                            rng.uniform(0.5, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    boxes[:4, 6] = [np.pi / 2, -np.pi / 2, np.pi, -np.pi]
    points = np.concatenate([rng.uniform(-30, 30, (300, 2)), rng.uniform(-3, 3, (300, 1)),
                             rng.uniform(0, 1, (300, 1))], 1)
    return boxes.astype(np.float32), points.astype(np.float32)


# --- geometry ---------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_rotations_equal_jax(axis):
    rng = np.random.RandomState(axis + 3)
    pts = rng.randn(4, 9, 3).astype(np.float32) * 10
    angles = rng.uniform(-np.pi, np.pi, 4).astype(np.float32)
    close(tgeo.rotation_3d_in_axis(torch.from_numpy(pts), torch.from_numpy(angles), axis),
          jgeo.rotation_3d_in_axis(jnp.asarray(pts), jnp.asarray(angles), axis))
    for angle in (0.3, -2.0, np.pi):
        a = np.float32(angle)
        close(tgeo.rotation_points_single_angle(torch.from_numpy(pts[0]), torch.tensor(a), axis),
              jgeo.rotation_points_single_angle(jnp.asarray(pts[0]), jnp.asarray(a), axis))
    with pytest.raises(ValueError):
        tgeo.rotation_3d_in_axis(torch.from_numpy(pts), torch.from_numpy(angles), 3)


def test_points_in_convex_polygon_and_range_filter_equal_jax():
    boxes, points = boxes_and_points(0)
    unit = tgeo.unit_corners(0.5, torch.device("cpu"), torch.float32)
    corners = tgeo.center_to_corner_box2d(torch.from_numpy(boxes[:, :2]), torch.from_numpy(boxes[:, 3:5]),
                                          torch.from_numpy(boxes[:, 6]), unit)
    got = tgeo.points_in_convex_polygon(torch.from_numpy(points[:, :2]), corners)
    jcorners = jgeo.center_to_corner_box2d(jnp.asarray(boxes[:, :2]), jnp.asarray(boxes[:, 3:5]),
                                           jnp.asarray(boxes[:, 6]))
    close(corners, jcorners)
    want = np.asarray(jgeo.points_in_convex_polygon(jnp.asarray(points[:, :2]), jcorners))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
    for rng_box in ((-16.0, -16.0, 16.0, 16.0), (-10.0, -20.0, 4.0, 8.0)):  # ranges that cut boxes
        keep = tgeo.filter_gt_box_outside_range(torch.from_numpy(boxes), torch.tensor(rng_box), unit)
        want = np.asarray(jgeo.filter_gt_box_outside_range(jnp.asarray(boxes), rng_box))
        np.testing.assert_array_equal(keep.numpy(), want)
        assert want.any() and not want.all()


@pytest.mark.parametrize("offset", [0.5, 0.0])
def test_limit_period_two_pi_equals_jax(offset):
    yaw = np.array([-7.0, -np.pi, -np.pi / 2, 0.0, np.pi / 2, np.pi, 2.5, 7.0], np.float32)
    close(tgeo.limit_period(torch.from_numpy(yaw), offset, 2 * math.pi),
          jgeo.limit_period(jnp.asarray(yaw), offset, 2 * np.pi))


# --- the transform and its parameters ------------------------------------------


def params_for(flip: bool, yaw: float, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {"flip": np.bool_(flip), "pitch": np.float32(rng.uniform(-0.07, 0.07)),
            "roll": np.float32(rng.uniform(-0.035, 0.035)), "yaw": np.float32(yaw),
            "scale": rng.uniform([0.9, 0.9, 0.95], [1.1, 1.1, 1.05]).astype(np.float32),
            "translate": np.clip(0.25 * rng.randn(3), -2, 2).astype(np.float32)}


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("yaw", [0.4, np.pi / 2, -np.pi / 2, np.pi])
def test_apply_global_augment_equals_jax(flip, yaw):
    """The same parameters through both transforms; the boxes' own yaws
    include ±π/2 and π, where atan(tan(yaw)·sy/sx) folds."""
    boxes, points = boxes_and_points(1)
    p = params_for(flip, yaw, seed=int(flip) + 7)
    tp, tb = taug.apply_global_augment(torch.from_numpy(points), torch.from_numpy(boxes),
                                       {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()})
    jp, jb = jaug.apply_global_augment(jnp.asarray(points), jnp.asarray(boxes),
                                       {k: jnp.asarray(v) for k, v in p.items()})
    close(tp, jp)
    close(tb[:, :6], np.asarray(jb)[:, :6])
    close(tb[:, 6], np.asarray(jb)[:, 6], scale=np.pi)
    assert np.abs(tb[:, 6].numpy()).max() <= np.pi / 2 + 1e-6  # the re-fit folds yaw


def test_sample_global_augment_params_bounds_and_clip(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    p = taug.sample_global_augment_params(gen, 20_000, "cpu")
    deg = np.pi / 180
    assert p["flip"].dtype == torch.bool and 0.48 < p["flip"].float().mean() < 0.52
    for key, bound in (("pitch", 4 * deg), ("roll", 2 * deg), ("yaw", 30 * deg)):
        v = p[key].numpy()
        assert v.shape == (20_000,) and np.abs(v).max() <= bound and np.abs(v).max() > 0.99 * bound, key
    s = p["scale"].numpy()
    assert s.shape == (20_000, 3)
    assert s[:, :2].min() >= 0.9 and s[:, :2].max() <= 1.1 and s[:, 2].min() >= 0.95 and s[:, 2].max() <= 1.05
    assert s.min() >= taug.GLOBAL_SCALE_MIN
    t = p["translate"].numpy()
    np.testing.assert_allclose(t.std(), 0.25, rtol=0.03)
    assert np.abs(t).max() <= taug.GLOBAL_TRANSLATE_BOUND
    # per sample, not per batch; the same generator state draws the same
    assert len(set(p["yaw"][:100].tolist())) == 100
    again = taug.sample_global_augment_params(torch.Generator().manual_seed(0), 20_000, "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    # the clip holds where the normal draw goes past it (40 sigma and more)
    randn = torch.randn
    monkeypatch.setattr(torch, "randn", lambda *a, **kw: randn(*a, **kw).sign() * 160.0)
    t = taug.sample_global_augment_params(gen, 100, "cpu")["translate"]
    assert set(t.abs().flatten().tolist()) == {taug.GLOBAL_TRANSLATE_BOUND}


def test_augment_seed_depends_on_seed_and_step_only():
    assert augment_seed(0, 5) == augment_seed(0, 5)
    assert len({augment_seed(s, t) for s in (0, 1) for t in range(50)}) == 100


# --- the trainer -------------------------------------------------------------------------


def small_trainers():
    jcfg = pu.small_cfg().replace(batch_size=2)
    return jcfg, pu.to_torch_cfg(jcfg)


def test_device_augment_gt_valid_equals_jax(monkeypatch):
    """`Trainer.device_augment` against the JAX trainer's
    `_device_augment_one` with the same parameters: boxes, points and the
    `gt_valid` update (a padded slot stays invalid; boxes the transform
    carries out of range become invalid); one sample, and a batch of two
    samples with their own parameters in one call."""
    from det3d_tpu.train.trainer import Trainer as JaxTrainer

    jcfg, tcfg = small_trainers()
    jtrainer = JaxTrainer(jcfg, device_global_augment=True)
    trainer = Trainer(tcfg, device="cpu", device_global_augment=True)
    samples, want = [], []
    for seed, flip, yaw in ((2, True, 0.5), (5, False, -1.0)):
        boxes, points = boxes_and_points(seed)
        valid = np.ones(len(boxes), bool)
        valid[-1] = False
        p = params_for(flip, yaw, seed=seed + 1)
        monkeypatch.setattr(jaug, "global_augment_device", lambda pts, b, key, p=p: jaug.apply_global_augment(
            pts, b, {k: jnp.asarray(v) for k, v in p.items()}))
        want.append([np.asarray(a) for a in jtrainer._device_augment_one(
            jnp.asarray(points), jnp.asarray(boxes), jnp.asarray(valid), jax.random.PRNGKey(0))])
        samples.append((points, boxes, valid, p))
        got = trainer.device_augment(torch.from_numpy(points), torch.from_numpy(boxes), torch.from_numpy(valid),
                                     {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()})
        close(got[0], want[-1][0])
        close(got[1], want[-1][1])
        np.testing.assert_array_equal(got[2].numpy(), want[-1][2])
        assert not want[-1][2][-1] and want[-1][2].any() and not want[-1][2][:-1].all()
    stack = lambda i: torch.from_numpy(np.stack([s[i] for s in samples]))  # noqa: E731
    params = {k: torch.from_numpy(np.stack([np.asarray(s[3][k]) for s in samples])) for k in samples[0][3]}
    batched = trainer.device_augment(stack(0), stack(1), stack(2), params)
    for i, w in enumerate(want):
        close(batched[0][i], w[0])
        close(batched[1][i], w[1])
        np.testing.assert_array_equal(batched[2][i].numpy(), w[2])


def test_identity_transform_step_equals_plain_step(monkeypatch):
    """With the transform replaced by the identity, a device-augmented step
    is a plain step, bit for bit: the range filter keeps every in-range box
    and the 2π wrap leaves yaws in [-π, π) as they are (a π period would
    move the yaw 2.5 below; the JAX trainer's test,
    tests/test_augment.py:178-196)."""
    _, tcfg = small_trainers()
    rng = np.random.RandomState(4)
    samples = [sample_scene(tcfg, rng, (2, 4), ground_points=800) for _ in range(2)]
    samples[0]["gt_boxes"][0, 6] = 2.5
    batch = host_batch(tcfg, samples)
    monkeypatch.setattr(taug, "apply_global_augment", lambda pts, b, params: (pts, b))
    runs = []
    for flag in (False, True):
        trainer = Trainer(tcfg, device="cpu", device_global_augment=flag)
        state = trainer.init_state(0)
        state, loss, counts = trainer.train_step(state, batch)
        runs.append((trainer, loss, counts))
    (plain, lp, cp), (aug, la, ca) = runs
    for k in lp:
        assert torch.equal(lp[k], la[k]), k
    for k in cp:
        assert torch.equal(cp[k], ca[k]), k
    for (name, a), b in zip(plain.model.named_parameters(), aug.model.parameters()):
        assert torch.equal(a, b), name
    frames, tgt = aug.prepare(aug.to_device(batch), 0)
    assert float(tgt.bbox_targets.abs().max()) > 0


def test_device_augmented_steps_draw_per_step_and_resume():
    """Each step draws its own parameters from (aug_seed, step): a trainer
    resumed at step 1 draws step 1's, and the two samples of a step differ."""
    _, tcfg = small_trainers()
    a, b = (Trainer(tcfg, device="cpu", device_global_augment=True, aug_seed=5) for _ in range(2))
    p1, again = a.augment_params(1, 2), b.augment_params(1, 2)
    assert all(torch.equal(p1[k], again[k]) for k in p1)
    p0 = a.augment_params(0, 2)
    assert not torch.equal(p0["yaw"], p1["yaw"]) and p1["yaw"][0] != p1["yaw"][1]


# --- the app ---------------------------------------------------------------


def test_cli_train_device_augment_on_cpu(tmp_path, capsys):
    import json

    raw = {"detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
           "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0], "voxel_size": [1.0, 1.0, 11.0],
           "max_voxels": 128, "max_num_points": 5, "max_points": 2048, "batch_size": 2}
    (tmp_path / "tiny.json").write_text(json.dumps(raw))
    cli.main(["train", "--config", str(tmp_path / "tiny.json"), "--synthetic", "--device-augment", "--device", "cpu",
              "--steps", "2", "--display-step", "1", "--save-step", "2", "--eval-step", "100",
              "--model-dir", str(tmp_path / "run")])
    out = capsys.readouterr().out
    assert "step 2  loss" in out and (tmp_path / "run" / "latest.pth").exists()
