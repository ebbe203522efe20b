"""The port's checkpoints (`train/checkpoint.py`) and `Trainer.eval_step`,
against the JAX package's checkpoints through its `.pth` interop.

Tolerances, each with its reason:
  * a checkpoint crossing between the two packages: weights, batch
    statistics, moments, step and lr equal (the `.pth` holds float32 and
    both sides only move them);
  * the port's step from a JAX checkpoint against JAX's step from the same
    state: those of tests/test_torch_train.py — loss terms rtol 1e-5;
    gradients within 1e-4 of each tensor's largest magnitude; updated
    parameters within 1e-6 where |g_jax| is above 1e-3 of its tensor's
    largest, within 2·lr elsewhere (Adam's update of a gradient within
    rounding of 0 is not determined by it); running statistics rtol 1e-5;
  * the port's own save → restore, and the steps after it: bit-equal.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu.data.synthetic import sample_scene
from det3d_tpu.deploy.torch_interop import export_torch_checkpoint, import_torch_checkpoint
from det3d_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from det3d_tpu.train.checkpoint import load_latest_state as jax_load_latest_state
from det3d_tpu.train.trainer import Trainer as JaxTrainer
from det3d_tpu.train.trainer import host_batch as jax_host_batch
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.train import checkpoint as ck
from det3d_tpu_torch.train.trainer import Trainer, host_batch
from det3d_tpu_torch.weights import variables_to_state_dict
from test_torch_tmpdirs import removed, tmp_path  # noqa: F401

torch.set_num_threads(1)


def scenes(cfg, seed):
    rng = np.random.RandomState(seed)
    return [sample_scene(cfg, rng, (2, 4), ground_points=800) for _ in range(2)]


@pytest.fixture(scope="module")
def cfgs():
    jcfg = pu.small_cfg().replace(batch_size=2)
    return jcfg, pu.to_torch_cfg(jcfg)


def port_trainer(tcfg, steps, seed=0):
    """The port's CPU trainer after `steps` steps on seeded scenes."""
    trainer = Trainer(tcfg, device="cpu")
    state = trainer.init_state(seed)
    for i in range(steps):
        state, _, _ = trainer.train_step(state, host_batch(tcfg, scenes(tcfg, i)))
    return trainer, state


def assert_same_run(a: Trainer, sa, b: Trainer, sb) -> None:
    """Weights, batch statistics, moments, step and lr bit-equal."""
    da, db = a.model.state_dict(), b.model.state_dict()
    assert list(da) == list(db)
    for k in da:
        assert torch.equal(da[k], db[k]), k
    assert (sa.step, sa.lr) == (sb.step, sb.lr)
    for x, y in zip(sa.mu + sa.nu, sb.mu + sb.nu):
        assert x.dtype == y.dtype == torch.float32 and torch.equal(x, y)


# --- JAX → .pth → the port -----------------------------------------------------


@pytest.fixture(scope="module")
def jax_run(cfgs, tmp_path_factory):
    """JAX's f32 trainer after one step, saved with orbax and exported to
    `.pth`; and its next step from that state, gradients captured."""
    jcfg, _ = cfgs
    tmp = tmp_path_factory.mktemp("jax_run")
    trainer = JaxTrainer(jcfg)
    state0 = trainer.init_state(jax.random.PRNGKey(0))
    state1, _, _ = jax.jit(trainer.train_step)(state0, jax_host_batch(jcfg, scenes(jcfg, 0)))
    JaxCheckpointManager(tmp / "jax").save(jax.device_get(state1))
    pth = tmp / "exported.pth"
    assert export_torch_checkpoint(tmp / "jax", jcfg, pth) == 1
    yield dict(state1=state1, pth=pth, step2=pu.jax_train_step(jcfg, scenes(jcfg, 1), state=state1))
    removed(tmp)


def test_jax_checkpoint_restores_in_the_port(cfgs, jax_run):
    jcfg, tcfg = cfgs
    trainer = Trainer(tcfg, device="cpu")
    trainer.init_state(5)  # other weights, all overwritten
    state = ck.restore(jax_run["pth"], trainer.model, default_lr=1.0)
    want = variables_to_state_dict(jax_run["step2"]["before"])
    got = trainer.model.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    adam = jax_run["state1"].opt_state[1].inner_state[0]
    zeros = jax.tree.map(np.zeros_like, pu.numpy_variables(jax_run["state1"].batch_stats))
    mu = variables_to_state_dict({"params": pu.numpy_variables(adam.mu), "batch_stats": zeros})
    nu = variables_to_state_dict({"params": pu.numpy_variables(adam.nu), "batch_stats": zeros})
    for (name, _), m, v in zip(trainer.model.named_parameters(), state.mu, state.nu):
        np.testing.assert_array_equal(m.numpy(), mu[name], err_msg=name)
        np.testing.assert_array_equal(v.numpy(), nu[name], err_msg=name)
    assert state.step == 1 and state.lr == pytest.approx(jcfg.learning_rate, rel=1e-7)


def test_port_next_step_equals_jax_next_step(cfgs, jax_run):
    jcfg, tcfg = cfgs
    step2 = jax_run["step2"]
    trainer = Trainer(tcfg, device="cpu")
    state = ck.restore(jax_run["pth"], trainer.model, default_lr=1.0)
    state, loss, counts = trainer.train_step(state, host_batch(tcfg, step2["samples"]))
    assert state.step == 2
    for k, want in step2["loss"].items():
        np.testing.assert_allclose(float(loss[k]), want, rtol=1e-5, err_msg=k)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(counts[k].numpy(), step2["counts"][k], err_msg=k)
    lr = jcfg.learning_rate
    sd = trainer.model.state_dict()
    for name, p in trainer.model.named_parameters():
        g = step2["grads"][name]
        scale = np.abs(g).max()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=1e-4 * scale, err_msg=name)
        big = np.abs(g) > 1e-3 * scale
        got, want = sd[name].numpy(), step2["after"][name]
        np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-6, err_msg=name)
        assert np.abs(got - want).max() <= 2 * lr, name
    for name in ("running_mean", "running_var"):
        key = f"pillar_point_net.pfn_layers.1.{name}"
        np.testing.assert_allclose(sd[key].numpy(), step2["after"][key], rtol=1e-5, atol=1e-6, err_msg=key)


# --- the port → .pth → JAX -----------------------------------------------------


def test_port_checkpoint_imports_into_jax(cfgs, tmp_path):
    jcfg, tcfg = cfgs
    trainer, state = port_trainer(tcfg, steps=2)
    ck.CheckpointManager(tmp_path / "port").save(state, trainer.model)
    assert import_torch_checkpoint(tmp_path / "port" / "latest.pth", jcfg, tmp_path / "jax") == 2
    jstate = jax_load_latest_state(jcfg, tmp_path / "jax")
    assert int(jstate.step) == 2
    got = variables_to_state_dict(pu.numpy_variables({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    sd = trainer.model.state_dict()
    for k, v in got.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)
    inj = jstate.opt_state[1]
    adam = inj.inner_state[0]
    assert int(adam.count) == 2
    assert float(inj.hyperparams["learning_rate"]) == np.float32(state.lr)
    zeros = jax.tree.map(np.zeros_like, pu.numpy_variables(jstate.batch_stats))
    mu = variables_to_state_dict({"params": pu.numpy_variables(adam.mu), "batch_stats": zeros})
    nu = variables_to_state_dict({"params": pu.numpy_variables(adam.nu), "batch_stats": zeros})
    for (name, _), m, v in zip(trainer.model.named_parameters(), state.mu, state.nu):
        np.testing.assert_array_equal(mu[name], m.numpy(), err_msg=name)
        np.testing.assert_array_equal(nu[name], v.numpy(), err_msg=name)


# --- the port's own checkpoints ------------------------------------------------


def test_save_restore_is_bit_equal_and_resumes(cfgs, tmp_path):
    _, tcfg = cfgs
    live, state = port_trainer(tcfg, steps=2)
    mgr = ck.CheckpointManager(tmp_path)
    assert not mgr.has_latest()
    mgr.save(state, live.model)
    assert {p.name for p in tmp_path.iterdir()} == {"latest.pth", "2.pth"}
    restored = Trainer(tcfg, device="cpu")
    restored.init_state(9)
    rstate = ck.CheckpointManager(tmp_path).restore_latest(restored)
    assert_same_run(live, state, restored, rstate)
    batch = host_batch(tcfg, scenes(tcfg, 7))
    state, _, _ = live.train_step(state, batch)
    rstate, _, _ = restored.train_step(rstate, batch)
    assert_same_run(live, state, restored, rstate)


def test_lr_override_after_restore(cfgs, tmp_path):
    _, tcfg = cfgs
    trainer, state = port_trainer(tcfg, steps=1)
    ck.CheckpointManager(tmp_path).save(state, trainer.model)
    restored = ck.CheckpointManager(tmp_path).restore_latest(Trainer(tcfg, device="cpu"))
    assert restored.lr == tcfg.learning_rate
    assert Trainer.override_lr(restored, 1e-5).lr == 1e-5


def test_fresh_state_file_is_what_jax_exports(cfgs, tmp_path):
    """Step 0 holds `{"state": {}}`; the file's keys and param group are
    those of the JAX package's `export_torch_checkpoint`."""
    _, tcfg = cfgs
    trainer = Trainer(tcfg, device="cpu")
    state = trainer.init_state(0)
    ck.CheckpointManager(tmp_path).save(state, trainer.model)
    ckpt = torch.load(tmp_path / "0.pth", weights_only=True)
    assert set(ckpt) == {"step", "model_state_dict", "optimizer_state_dict"} and ckpt["step"] == 0
    opt = ckpt["optimizer_state_dict"]
    assert opt["state"] == {}
    assert opt["param_groups"][0]["params"] == list(range(len(trainer.params)))
    # the model and Adam state load into torch.optim.Adam, as the reference's resume does
    adam = torch.optim.Adam(trainer.model.parameters(), lr=1.0)
    adam.load_state_dict(opt)
    assert adam.param_groups[0]["lr"] == tcfg.learning_rate


def test_crash_between_temp_and_rename_keeps_old_latest(cfgs, tmp_path, monkeypatch):
    _, tcfg = cfgs
    trainer, state = port_trainer(tcfg, steps=1)
    mgr = ck.CheckpointManager(tmp_path)
    mgr.save(state, trainer.model)

    def crash(src, dst):
        raise OSError("simulated crash before the rename")

    monkeypatch.setattr(ck.os, "replace", crash)
    state, _, _ = trainer.train_step(state, host_batch(tcfg, scenes(tcfg, 3)))
    with pytest.raises(OSError, match="simulated crash"):
        mgr.save(state, trainer.model)
    monkeypatch.undo()
    assert ck.read_checkpoint(tmp_path / "latest.pth")[1] == 1
    assert not list(tmp_path.glob(".tmp.*"))


def test_readonly_open_has_no_side_effects(cfgs, tmp_path):
    _, tcfg = cfgs
    missing = tmp_path / "typo_dir"
    mgr = ck.CheckpointManager(missing, readonly=True)
    assert not missing.exists()
    with pytest.raises(RuntimeError, match="readonly"):
        mgr.save(None, None)
    with pytest.raises(FileNotFoundError):
        ck.load_latest_state(tcfg, missing, device="cpu")
    live = tmp_path / "live"
    live.mkdir()
    inflight = live / ".tmp.latest.pth.deadbeef"
    inflight.write_bytes(b"")
    ck.CheckpointManager(live, readonly=True)
    assert inflight.exists()  # a reader never sweeps a writer's temp file
    ck.CheckpointManager(live)
    assert not inflight.exists()


def write_stepped(tcfg, path, edit):
    trainer, state = port_trainer(tcfg, steps=1)
    contents = ck.checkpoint_dict(state, trainer.model)
    edit(contents["optimizer_state_dict"]["state"])
    torch.save(contents, path)
    return path


@pytest.mark.parametrize("case", ["divergent steps", "missing entry", "wrong shape"])
def test_unrepresentable_adam_state_is_rejected(cfgs, tmp_path, case):
    _, tcfg = cfgs
    edits = {
        "divergent steps": lambda st: st[3].update(step=torch.tensor(2.0)),
        "missing entry": lambda st: st.pop(4),
        "wrong shape": lambda st: st[0].update(exp_avg=torch.zeros(3)),
    }
    path = write_stepped(tcfg, tmp_path / "bad.pth", edits[case])
    match = {"divergent steps": "step counts differ", "missing entry": "missing", "wrong shape": "shape"}[case]
    with pytest.raises(ValueError, match=match):
        ck.restore(path, Trainer(tcfg, device="cpu").model, tcfg.learning_rate)


@pytest.mark.parametrize("form", ["bare state_dict", "empty optimizer state"])
def test_bare_and_empty_forms_load(cfgs, tmp_path, form):
    _, tcfg = cfgs
    trainer, _ = port_trainer(tcfg, steps=1)
    sd = trainer.model.state_dict()
    if form == "bare state_dict":
        torch.save(sd, tmp_path / "w.pth")
    else:
        torch.save({"step": 7, "model_state_dict": sd,
                    "optimizer_state_dict": {"state": {}, "param_groups": [{"lr": 1e-3}]}}, tmp_path / "w.pth")
    det, state = ck.load_latest_state(tcfg, tmp_path / "w.pth", device="cpu")
    assert state.step == 0 and all(not m.any() for m in state.mu + state.nu)
    assert state.lr == (tcfg.learning_rate if form == "bare state_dict" else 1e-3)
    for k, v in det.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


# --- eval_step ------------------------------------------------------------------


def test_eval_step_between_steps_changes_nothing(cfgs):
    _, tcfg = cfgs
    runs = []
    for with_eval in (False, True):
        trainer, state = port_trainer(tcfg, steps=1)
        if with_eval:
            pts, n = trainer.detector.pad_points(scenes(tcfg, 5)[0]["points"])
            det = trainer.eval_step(pts, n)
            other = Detector(tcfg, device="cpu").load_state_dict(trainer.model.state_dict())
            want = other.infer(torch.from_numpy(pts), int(n))
            for a, b in zip(det, want):
                assert torch.equal(a, b)
            assert det.valid.any()
        state, _, _ = trainer.train_step(state, host_batch(tcfg, scenes(tcfg, 6)))
        runs.append((trainer, state))
    assert_same_run(*runs[0], *runs[1])
    assert not runs[1][0].model.training  # the mode flag is never switched
