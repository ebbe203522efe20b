"""Parity of the port's training step (losses, metrics, masked batch norm,
the instance-norm and scatter backwards, the optimizer, `Trainer`) with the
JAX package, on the CPU, in float32.

Tolerances, each with its reason:
  * loss terms: rtol 1e-5 — the same float32 formulas; sums over ~10^4
    anchors taken in other orders;
  * metric counts: equal (sums of 0/1);
  * masked batch norm output and running statistics: rtol/atol 1e-5;
  * instance-norm and scatter backwards: 1e-5 and equal (the scatter's
    backward only moves values);
  * one whole train step against JAX's `Trainer.train_step` from the same
    weights (through the weight bridge) and batch: every gradient within
    1e-4 of its tensor's largest magnitude (convolutions' data and weight
    gradients summed in other orders; ~1e-5 seen); updated parameters
    within 1e-6 where |g_jax| is above 1e-3 of its tensor's largest, and
    within 2·lr elsewhere — Adam's first update is about lr·sign(g), so a
    gradient within rounding of 0 can flip its sign; running statistics
    rtol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu import losses as jlosses
from det3d_tpu.data.synthetic import sample_scene
from det3d_tpu.models.pointpillars import PFN as JaxPFN
from det3d_tpu.models.pointpillars import _instance_norm
from det3d_tpu.models.pointpillars import scatter_to_bev as jax_scatter_to_bev
from det3d_tpu.train import metrics as jmetrics
from det3d_tpu.train.trainer import host_batch as jax_host_batch
from det3d_tpu_torch import losses
from det3d_tpu_torch.kernels import fence_cuda, scatter_cuda
from det3d_tpu_torch.models.pointpillars import PFN, InstanceNormFn
from det3d_tpu_torch.train import metrics
from det3d_tpu_torch.train.trainer import Trainer, host_batch
from det3d_tpu_torch.weights import to_tensors, variables_to_state_dict

torch.set_num_threads(1)


def loss_inputs(seed, b=2, nch=4, fx=6, fy=5):
    r = np.random.RandomState(seed)
    labels = r.choice([-1, 0, 0, 0, 1], (b, nch, fx, fy)).astype(np.int32)
    labels[-1] = np.where(labels[-1] > 0, 0, labels[-1])  # a sample with no positives
    preds = {
        "cls_preds": (r.randn(b, 1, nch, fx, fy) * 2).astype(np.float32),
        "box_preds": r.randn(b, 7, nch, fx, fy).astype(np.float32),
        "dir_preds": r.randn(b, 2, nch, fx, fy).astype(np.float32),
    }
    targets = (r.randn(b, 7, nch, fx, fy) * 0.5).astype(np.float32)
    dirs = r.randint(0, 2, (b, nch, fx, fy)).astype(np.int32)
    return preds, labels, targets, dirs


class TestLosses:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_detection_loss_matches_jax(self, seed):
        preds, labels, targets, dirs = loss_inputs(seed)
        want = jlosses.detection_loss({k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(labels),
                                      jnp.asarray(targets), jnp.asarray(dirs))
        got = losses.detection_loss({k: torch.from_numpy(v) for k, v in preds.items()}, torch.from_numpy(labels),
                                    torch.from_numpy(targets), torch.from_numpy(dirs))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)

    def test_prepare_loss_weights_matches_jax(self):
        _, labels, _, _ = loss_inputs(2)
        want = jlosses.prepare_loss_weights(jnp.asarray(labels))
        got = losses.prepare_loss_weights(torch.from_numpy(labels))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)

    def test_loss_gradient_is_finite_and_reaches_all_heads(self):
        preds, labels, targets, dirs = loss_inputs(3)
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
        out = losses.detection_loss(tp, torch.from_numpy(labels), torch.from_numpy(targets), torch.from_numpy(dirs))
        out["loss"].backward()
        for k, v in tp.items():
            assert torch.isfinite(v.grad).all() and v.grad.abs().sum() > 0, k


class TestMetrics:
    def test_binary_counts_match_jax(self):
        preds, labels, _, _ = loss_inputs(4)
        want = jmetrics.binary_counts(jnp.asarray(labels), jnp.asarray(preds["cls_preds"]))
        got = metrics.binary_counts(torch.from_numpy(labels), torch.from_numpy(preds["cls_preds"]))
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)

    def test_running_metrics_match_jax(self):
        a, b = jmetrics.RunningMetrics(), metrics.RunningMetrics()
        for seed in (5, 6):
            preds, labels, _, _ = loss_inputs(seed)
            a.update(jmetrics.binary_counts(jnp.asarray(labels), jnp.asarray(preds["cls_preds"])))
            b.update(metrics.binary_counts(torch.from_numpy(labels), torch.from_numpy(preds["cls_preds"])))
        for x, y in zip(b.value, a.value):
            np.testing.assert_allclose(x, y, rtol=1e-12)
        assert str(a) == str(b)


def pfn_inputs(seed, b=2, v=30, p=5):
    r = np.random.RandomState(seed)
    counts = r.randint(0, p + 1, (b, v)).astype(np.int32)
    coors = np.where(counts[..., None] > 0, r.randint(0, 16, (b, v, 3)), -1).astype(np.int32)
    voxels = (r.randn(b, v, p, 4) * 3).astype(np.float32)
    return voxels, counts, coors


class TestTrainModules:
    def test_masked_batch_norm_matches_jax(self):
        cfg = pu.small_cfg()
        pfn_j = JaxPFN(tuple(cfg.voxel_size), tuple(cfg.detection_offset), compute_dtype=jnp.float32)
        inputs = pfn_inputs(0)
        variables = pu.numpy_variables(pfn_j.init(jax.random.PRNGKey(1), *(jnp.asarray(a) for a in inputs)))
        r = np.random.RandomState(2)
        variables["batch_stats"]["pfn_bn"]["mean"] = (r.randn(64) * 0.1).astype(np.float32)
        variables["batch_stats"]["pfn_bn"]["var"] = (r.rand(64) + 0.5).astype(np.float32)
        want, upd = pfn_j.apply(variables, *(jnp.asarray(a) for a in inputs), True, mutable=["batch_stats"])

        pfn = PFN(cfg.voxel_size, cfg.detection_offset, torch.float32)
        conv, bn = pfn.pfn_layers
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(variables["params"]["pfn_dense"]["kernel"].T[..., None].copy()))
            bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["pfn_bn"]["mean"]))
            bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["pfn_bn"]["var"]))
        got = pfn(*(torch.from_numpy(a) for a in inputs), train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        stats = upd["batch_stats"]["pfn_bn"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)
        # eval mode reads the updated running statistics and changes nothing
        before = bn.running_mean.clone()
        pfn(*(torch.from_numpy(a) for a in inputs))
        assert torch.equal(before, bn.running_mean)

    def test_instance_norm_backward_matches_jax_vjp(self):
        r = np.random.RandomState(3)
        x = (r.randn(2, 7, 9, 5) * 2 + 0.5).astype(np.float32)  # NHWC for JAX
        g = r.randn(2, 7, 9, 5).astype(np.float32)
        y_j, vjp = jax.vjp(lambda a: _instance_norm(a, "in"), jnp.asarray(x))
        (dx_j,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        y = InstanceNormFn.apply(xt)
        y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-5)

    def test_scatter_gradient_is_the_plain_gather(self):
        r = np.random.RandomState(4)
        feats = r.randn(2, 40, 6).astype(np.float32)
        coors = np.full((2, 40, 3), -1, np.int32)
        for b in range(2):
            cells = r.choice(12 * 10, 30, replace=False)
            coors[b, :30, 0], coors[b, :30, 1], coors[b, :30, 2] = cells // 10, cells % 10, 0
        coors[0, 3, 0] = 12  # outside the grid: dropped, zero gradient
        g = r.randn(2, 12, 10, 6).astype(np.float32)
        _, vjp = jax.vjp(lambda f: jax_scatter_to_bev(f, jnp.asarray(coors), (12, 10)), jnp.asarray(feats))
        (want,) = vjp(jnp.asarray(g))
        ft = torch.from_numpy(feats).requires_grad_()
        before = scatter_cuda.bwd_counter.launches
        scatter_cuda.scatter_to_bev(ft, torch.from_numpy(coors), (12, 10)).backward(torch.from_numpy(g))
        assert scatter_cuda.bwd_counter.launches == before  # the CPU path takes the plain gather
        np.testing.assert_array_equal(ft.grad.numpy(), np.asarray(want))
        plain = scatter_cuda.scatter_to_bev_bwd_plain(torch.from_numpy(g), torch.from_numpy(coors))
        np.testing.assert_array_equal(ft.grad.numpy(), plain.numpy())
        assert not ft.grad[0, 3].any() and not ft.grad[:, 30:].any()

    def test_fence_is_a_copy_with_identity_gradient(self):
        x = torch.randn(2, 1, 3, 4, 5).transpose(2, 3).requires_grad_()
        before = fence_cuda.counter.launches
        y = fence_cuda.s2b_fence(x)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
        g = torch.randn(y.shape)
        y.backward(g)
        assert torch.equal(x.grad, g)
        assert fence_cuda.counter.launches == before


# --- the optimizer --------------------------------------------------------


class TestOptimizer:
    @pytest.mark.parametrize("scale", [0.01, 100.0], ids=["below_clip", "clipped"])
    def test_clip_and_adam_match_optax(self, scale):
        """Three steps of `Trainer.apply_gradients` on fixed gradients
        against optax's chain(clip_by_global_norm(10), adam(lr))."""
        tcfg = pu.to_torch_cfg(pu.small_cfg())
        trainer = Trainer(tcfg, device="cpu")
        state = trainer.init_state(0)
        params0 = [p.detach().numpy().copy() for p in trainer.params]
        r = np.random.RandomState(7)
        grads = [(r.randn(*p.shape) * scale).astype(np.float32) for p in params0]
        tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(tcfg.learning_rate))
        jp = [jnp.asarray(p) for p in params0]
        opt = tx.init(jp)

        @jax.jit
        def step_fn(g, opt, jp):
            updates, opt = tx.update(g, opt, jp)
            return optax.apply_updates(jp, updates), opt

        for step in range(3):
            jp, opt = step_fn([jnp.asarray(g) * (step + 1) for g in grads], opt, jp)
            for p, g in zip(trainer.params, grads):
                p.grad = torch.from_numpy(g * (step + 1))
            trainer.apply_gradients(state)
        assert state.step == 3
        for p, w in zip(trainer.params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)

    def test_override_lr(self):
        trainer = Trainer(pu.to_torch_cfg(pu.small_cfg()), device="cpu")
        state = trainer.init_state(0)
        assert state.lr == pytest.approx(trainer.cfg.learning_rate)
        assert Trainer.override_lr(state, 1e-3).lr == 1e-3 and state.lr != 1e-3

    def test_trainer_defaults_to_cuda_and_never_falls_back(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(pu.to_torch_cfg(pu.small_cfg()))


# --- one whole train step against JAX's Trainer.train_step ----------------


def _scenes(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return [sample_scene(cfg, rng, (2, 4), ground_points=800) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_step():
    """JAX's f32 train step at the small config, with the gradients that
    reach its optimizer captured in front of it."""
    jcfg = pu.small_cfg().replace(batch_size=2)
    return pu.jax_train_step(jcfg, _scenes(jcfg))


@pytest.fixture(scope="module")
def torch_step(jax_step):
    tcfg = pu.to_torch_cfg(jax_step["cfg"])
    trainer = Trainer(tcfg, device="cpu")
    trainer.detector.load_state_dict(to_tensors(variables_to_state_dict(jax_step["before"])))
    state = trainer.init_state()
    batch = host_batch(tcfg, jax_step["samples"])
    state, loss, counts = trainer.train_step(state, batch)
    return dict(trainer=trainer, state=state, loss=loss, counts=counts, batch=batch)


def test_host_batch_equals_jax(jax_step, torch_step):
    want = jax_host_batch(jax_step["cfg"], jax_step["samples"])
    for a, b in zip(torch_step["batch"], want):
        np.testing.assert_array_equal(a, b)


def test_train_step_loss_and_metrics_match_jax(jax_step, torch_step):
    assert set(torch_step["loss"]) == set(jax_step["loss"])
    for k, want in jax_step["loss"].items():
        np.testing.assert_allclose(float(torch_step["loss"][k]), want, rtol=1e-5, err_msg=k)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(torch_step["counts"][k].numpy(), jax_step["counts"][k], err_msg=k)
    assert torch_step["state"].step == 1


def test_train_step_gradients_match_jax(jax_step, torch_step):
    for name, p in torch_step["trainer"].model.named_parameters():
        want = jax_step["grads"][name]
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=name)


def test_train_step_updates_match_jax(jax_step, torch_step):
    lr = jax_step["cfg"].learning_rate
    sd = torch_step["trainer"].model.state_dict()
    n_big = 0
    for name, g in jax_step["grads"].items():
        if name not in dict(torch_step["trainer"].model.named_parameters()):
            continue
        got, want = sd[name].numpy(), jax_step["after"][name]
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        n_big += int(big.sum())
        np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-6, err_msg=name)
        assert np.abs(got - want).max() <= 2 * lr, name
    assert n_big > 0.9 * sum(p.numel() for p in torch_step["trainer"].params)
    for name in ("running_mean", "running_var"):
        key = f"pillar_point_net.pfn_layers.1.{name}"
        np.testing.assert_allclose(sd[key].numpy(), jax_step["after"][key], rtol=1e-5, atol=1e-6, err_msg=key)
        assert not np.array_equal(jax_step["after"][key], variables_to_state_dict(jax_step["before"])[key])
