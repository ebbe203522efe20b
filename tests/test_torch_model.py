"""Parity of the port's network (models/pointpillars.py) with the JAX model.

The same weights (JAX init, batch-norm statistics randomised so the eval
path is non-trivial) cross the port's weight bridge; the same pillar inputs
go through JAX `PointPillars.apply` (pack_w on and off) and the port.
Tolerance: atol/rtol 1e-4 in float32 — the JAX packed path runs other
convolutions (w-parity packed kernels, Gram-matrix InstanceNorm statistics)
and both sum in other orders, so values agree to ~1e-5, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu.config import load_config as jax_load_config
from det3d_tpu.models.pointpillars import PFN as JaxPFN
from det3d_tpu.models.pointpillars import PointPillars as JaxPointPillars
from det3d_tpu.models.pointpillars import _instance_norm
from det3d_tpu_torch.models.pointpillars import PointPillars, init_weights, instance_norm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def nine_anchor_cfg():
    """32x32 grid with the default 9-anchor class specs."""
    return jax_load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 48, "max_num_points": 5,
        "max_points": 2048, "compute_dtype": "float32",
    })


CONFIGS = {"small": pu.small_cfg, "nine_anchor": nine_anchor_cfg}


def _variables(cfg, seed=0):
    """JAX init variables with randomised BN affine and running statistics."""
    v = pu.numpy_variables(JaxPointPillars(cfg).init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, cfg.max_voxels, cfg.max_num_points, 4)),
        jnp.zeros((1, cfg.max_voxels), jnp.int32),
        jnp.full((1, cfg.max_voxels, 3), -1, jnp.int32),
    ))
    r = np.random.RandomState(seed)
    bn, stats = v["params"]["pfn"]["pfn_bn"], v["batch_stats"]["pfn"]["pfn_bn"]
    bn["scale"] = (r.rand(64) * 0.5 + 0.75).astype(np.float32)
    bn["bias"] = (r.randn(64) * 0.1).astype(np.float32)
    stats["mean"] = (r.randn(64) * 0.1).astype(np.float32)
    stats["var"] = (r.rand(64) * 0.5 + 0.75).astype(np.float32)
    return v


def _inputs(cfg, n_valid, seed=1):
    """Random pillars on unique cells, padded to max_voxels (numpy)."""
    r = np.random.RandomState(seed)
    nx, ny = cfg.grid_size[:2]
    v, p = cfg.max_voxels, cfg.max_num_points
    cells = r.choice(nx * ny, n_valid, replace=False)
    counts = np.zeros((1, v), np.int32)
    counts[0, :n_valid] = r.randint(1, p + 1, n_valid)
    coors = np.full((1, v, 3), -1, np.int32)
    coors[0, :n_valid, 0], coors[0, :n_valid, 1], coors[0, :n_valid, 2] = cells // ny, cells % ny, 0
    voxels = np.zeros((1, v, p, 4), np.float32)
    for i in range(n_valid):
        c = counts[0, i]
        base = (coors[0, i, :2] + 0.5) * np.asarray(cfg.voxel_size[:2]) + np.asarray(cfg.detection_offset[:2])
        voxels[0, i, :c, :2] = base + r.uniform(-0.5, 0.5, (c, 2))
        voxels[0, i, :c, 2] = r.uniform(-1.0, 2.0, c)
        voxels[0, i, :c, 3] = r.uniform(0.0, 1.0, c)
    return voxels, counts, coors


def _torch_model(cfg, variables):
    model = PointPillars(pu.to_torch_cfg(cfg)).eval()
    model.load_state_dict(pu.bridged_state_dict(variables), strict=True)
    return model


def _merge_parity(x) -> np.ndarray:
    """A JAX split-head column-parity pair → one map (column 2·w2 + p)."""
    if not isinstance(x, tuple):
        return np.asarray(x)
    g0, g1 = (np.asarray(g) for g in x)
    out = np.empty(g0.shape[:-1] + (2 * g0.shape[-1],), g0.dtype)
    out[..., 0::2], out[..., 1::2] = g0, g1
    return out


@pytest.mark.parametrize("pack_w", [False, True])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_preds_match_jax(which, pack_w):
    cfg = CONFIGS[which]().replace(pack_w=pack_w)
    variables = _variables(cfg)
    inputs = _inputs(cfg, n_valid=min(40, cfg.max_voxels - 8))
    want = JaxPointPillars(cfg).apply(variables, *(jnp.asarray(a) for a in inputs), train=False)
    with torch.no_grad():
        got = _torch_model(cfg, variables)(*(torch.from_numpy(a) for a in inputs))
    for key in ("cls_preds", "box_preds", "dir_preds"):
        w = _merge_parity(want[key])
        assert tuple(got[key].shape) == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, err_msg=key, **TOL)


def test_pfn_matches_jax():
    cfg = pu.small_cfg()
    variables = _variables(cfg)
    inputs = _inputs(cfg, n_valid=100)
    pfn_vars = {"params": variables["params"]["pfn"], "batch_stats": variables["batch_stats"]["pfn"]}
    want = JaxPFN(tuple(cfg.voxel_size), tuple(cfg.detection_offset), compute_dtype=jnp.float32).apply(
        pfn_vars, *(jnp.asarray(a) for a in inputs), False
    )
    with torch.no_grad():
        got = _torch_model(cfg, variables).pillar_point_net(*(torch.from_numpy(a) for a in inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got.numpy()[0, 100:] == 0).all()  # empty pillar slots are zeroed


def test_instance_norm_matches_jax():
    x = np.random.RandomState(0).randn(2, 6, 10, 12).astype(np.float32) * 3 + 1  # NHWC for JAX
    want = np.asarray(_instance_norm(jnp.asarray(x), "in"))
    got = instance_norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_parameter_order_is_reference_order():
    from det3d_tpu.deploy.torch_interop import reference_param_key_order

    model = PointPillars(pu.to_torch_cfg(nine_anchor_cfg()))
    assert [k for k, _ in model.named_parameters()] == reference_param_key_order()


def test_init_weights_seeded():
    cfg = pu.to_torch_cfg(pu.small_cfg())
    a, b, c = (init_weights(PointPillars(cfg), s) for s in (3, 3, 4))
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith("weight") and "pfn_layers.1" not in name:
            assert not torch.equal(pa, pc), name
    inputs = _inputs(pu.small_cfg(), n_valid=50)
    with torch.no_grad():
        preds = a.eval()(*(torch.from_numpy(x) for x in inputs))
    assert all(torch.isfinite(v).all() for v in preds.values())


def test_rejects_multi_head():
    """Now ported: `head: "multi"` builds `MultiHead`, whose preds equal the
    JAX MultiHead's (dense network, same weights and pillars); only a head
    that is neither "shared" nor "multi" is rejected."""
    cfg = pu.small_cfg().replace(head="multi")
    variables = _variables(cfg)
    inputs = _inputs(cfg, n_valid=min(40, cfg.max_voxels - 8))
    want = JaxPointPillars(cfg).apply(variables, *(jnp.asarray(a) for a in inputs), train=False)
    with torch.no_grad():
        got = _torch_model(cfg, variables)(*(torch.from_numpy(a) for a in inputs))
    for key in ("cls_preds", "box_preds", "dir_preds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)
    with pytest.raises(ValueError, match="'shared' or 'multi'"):
        PointPillars(dataclasses.replace(pu.to_torch_cfg(pu.small_cfg()), head="triple"))
