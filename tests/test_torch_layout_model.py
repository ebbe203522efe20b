"""Parity of the port's layout paths end to end with the JAX package, on the
CPU, in float32: the packed and the packed + blocked-halo network in eval
mode, one packed + blocked train step, and the rules that select a path.

Tolerances, each with its reason:
  * predictions: rtol/atol 1e-4 — both sides run the packed convolutions
    and the blocked statistics, summed in other orders (both sides with
    `fuse_in_stats` and `split_head` off: the unfused, merged neck; those
    two are tests/test_torch_options.py's);
  * the train step, as tests/test_torch_train.py holds the dense one: loss
    terms rtol 1e-5, metric counts equal, every gradient within 1e-4 of its
    tensor's largest magnitude.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu.config import load_config as jax_load_config
from det3d_tpu.data.synthetic import sample_scene
from det3d_tpu.models.pointpillars import PointPillars as JaxPointPillars
from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.kernels import scatter_cuda
from det3d_tpu_torch.models.pointpillars import Layout, PointPillars
from det3d_tpu_torch.train.trainer import Trainer, host_batch
from test_torch_model import _inputs, _variables, nine_anchor_cfg

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
FLAGS = {"packed": dict(pack_w=True), "packed_blocked": dict(pack_w=True, block0_blocked=True)}


def jax_cfg(flags):
    return nine_anchor_cfg().replace(fuse_in_stats=False, split_head=False, **flags)


@pytest.mark.parametrize("which", list(FLAGS))
def test_preds_match_jax(which):
    cfg = jax_cfg(FLAGS[which])
    variables = _variables(cfg)
    inputs = _inputs(cfg, n_valid=40)
    want = jax.jit(JaxPointPillars(cfg).apply)(variables, *(jnp.asarray(a) for a in inputs))
    model = PointPillars(pu.to_torch_cfg(cfg, layout=True)).eval()
    model.load_state_dict(pu.bridged_state_dict(variables), strict=True)
    assert model.layout(1, False) == Layout(True, which == "packed_blocked", False)
    launches = [c.launches for c in (scatter_cuda.counter, scatter_cuda.s2d_counter, scatter_cuda.blocked_counter)]
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in inputs))
    # CPU tensors take the plain versions: no kernel counter moves
    assert launches == [c.launches for c in (scatter_cuda.counter, scatter_cuda.s2d_counter,
                                             scatter_cuda.blocked_counter)]
    for key in ("cls_preds", "box_preds", "dir_preds"):
        w = np.asarray(want[key])
        assert tuple(got[key].shape) == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, err_msg=key, **TOL)


def test_layouts_share_parameters():
    """Dense, packed and blocked models are the same modules: identical
    state_dict keys, and each loads the bridged JAX weights strictly."""
    cfg = jax_cfg({})
    sd = pu.bridged_state_dict(_variables(cfg))
    models = [PointPillars(pu.to_torch_cfg(cfg.replace(**flags), layout=True)) for flags in
              ({"pack_w": False}, *FLAGS.values(), {"pack_w": True, "block0_blocked_train": True,
                                                     "late_blocked_train": True})]
    keys = [list(m.state_dict()) for m in models]
    assert all(k == keys[0] for k in keys) and set(keys[0]) == set(sd)
    for m in models:
        m.load_state_dict(sd, strict=True)


def test_layout_selection_rules():
    base = load_config("configs/ntusl_20cm.json")
    # the port's default: the shipped train keys are inert on the dense network
    assert base.pack_w is False and base.block0_blocked_train and base.late_blocked_train
    assert PointPillars(base).layout(2, True) == Layout(False, False, False)
    packed = PointPillars(base.replace(pack_w=True))
    assert packed.layout(2, True) == Layout(True, True, True)
    assert packed.layout(3, True) == Layout(True, False, False)  # train flags only at batch <= 2
    assert packed.layout(1, False) == Layout(True, False, False)  # block0_blocked is off at 20 cm
    ten = load_config("configs/ntusl_10cm.json", pack_w=True)
    assert ten.block0_blocked and PointPillars(ten).layout(1, False) == Layout(True, True, False)
    # packing needs ny % 4 == 0; blocking needs more than one block (nx 16: 8 s2d rows)
    odd = pu.to_torch_cfg(pu.small_cfg().replace(detection_range_raw=(-16.0, -16.0, -2.5, 16.0, 14.0, 8.5),
                                                 pack_w=True), layout=True)
    assert odd.grid_size[:2] == (32, 30) and PointPillars(odd).layout(1, False).pack_w is False
    narrow = pu.to_torch_cfg(pu.small_cfg().replace(detection_range_raw=(-8.0, -16.0, -2.5, 8.0, 16.0, 8.5),
                                                    block0_blocked=True), layout=True)
    assert narrow.grid_size[:2] == (16, 32) and PointPillars(narrow).layout(1, False) == Layout(True, False, False)


def test_to_torch_cfg_keeps_the_dense_default():
    cfg = pu.small_cfg()
    assert cfg.pack_w is True  # the JAX package's default
    assert pu.to_torch_cfg(cfg).pack_w is False and pu.to_torch_cfg(cfg, layout=True).pack_w is True


# --- one packed + blocked train step against JAX's -------------------------


@pytest.fixture(scope="module")
def steps():
    """JAX's and the port's f32 train step from the same weights and batch
    of two, packed with the blocked block0 (32x32 grid: 2 blocks)."""
    jcfg = jax_load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5, "batch_size": 2,
        "max_points": 4096, "max_gt_boxes": 8, "compute_dtype": "float32",
        "pack_w": True, "block0_blocked_train": True,
    })
    rng = np.random.RandomState(2)
    jax_step = pu.jax_train_step(jcfg, [sample_scene(jcfg, rng, (2, 4), ground_points=800) for _ in range(2)])
    tcfg = pu.to_torch_cfg(jcfg, layout=True)
    trainer = Trainer(tcfg, device="cpu")
    trainer.detector.load_state_dict(pu.to_tensors(pu.variables_to_state_dict(jax_step["before"])))
    state = trainer.init_state()
    state, loss, counts = trainer.train_step(state, host_batch(tcfg, jax_step["samples"]))
    return jax_step, dict(trainer=trainer, loss=loss, counts=counts)


def test_train_step_takes_the_blocked_path(steps):
    _, port = steps
    assert port["trainer"].model.layout(2, True) == Layout(True, True, False)


def test_train_step_loss_and_metrics_match_jax(steps):
    jax_step, port = steps
    assert set(port["loss"]) == set(jax_step["loss"])
    for k, want in jax_step["loss"].items():
        np.testing.assert_allclose(float(port["loss"][k]), want, rtol=1e-5, err_msg=k)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(port["counts"][k].numpy(), jax_step["counts"][k], err_msg=k)


def test_train_step_gradients_match_jax(steps):
    jax_step, port = steps
    for name, p in port["trainer"].model.named_parameters():
        want = jax_step["grads"][name]
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=name)
