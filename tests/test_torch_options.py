"""The port's model options against the JAX package, on the CPU, in float32:
the packed inference neck with Gram-statistic InstanceNorm (`fuse_in_stats`)
and the column-parity split head (`split_head`), the parity-pair decode,
`head: "multi"`, their detectors, train steps and exported programs.

Tolerances, each with its reason:
  * network outputs: rtol/atol 1e-4, as tests/test_torch_model.py — both
    sides run the same convolutions and Gram statistics, summed in other
    orders (~5e-6 seen);
  * the parity-pair decode on the same predictions: valid and range flags
    equal, boxes, scores and standup boxes rtol 1e-6, atol 1e-5 (the same
    float32 formulas; the two frameworks' sin and cos differ by an ulp,
    which a corner sum carries into a coordinate near 0 of a box ~10 m
    across);
  * detections: the goldens' tolerances (valid sets equal, boxes 1e-4,
    scores 1e-5), with the near-tie of ROADMAP.md queue 3
    (`test_torch_pipeline.NEAR_TIES`), the only one the packed network shows;
  * the multi-head train step: tests/test_torch_train.py's (loss terms rtol
    1e-5, counts equal, gradients within 1e-4 of each tensor's largest);
  * an exported program against the live detector: equal, bit for bit (the
    same aten operations in the same order).
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
from det3d_tpu.models import pointpillars as jpp
from det3d_tpu_torch.deploy import export as texport
from det3d_tpu_torch.deploy import runtime as truntime
from det3d_tpu_torch.models import pointpillars as tpp
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.postprocess import PostProcessParams
from det3d_tpu_torch.train.checkpoint import CheckpointManager
from det3d_tpu_torch.train.trainer import Trainer, host_batch
from test_torch_model import _inputs, _variables
from test_torch_pipeline import GOLDEN_DIR, NEAR_TIES, assert_detections_match

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
# (fuse_in_stats, split_head) of the packed network; the unfused, merged
# neck is tests/test_torch_layout_model.py's
NECKS = {"fused+split": (True, True), "fused": (True, False), "split": (False, True)}


def grid_cfg(ny_half: int = 16, **kw):
    """A 32 x 2·ny_half grid of 1 m pillars with the default 9 anchors, f32."""
    return jax_load_config({
        "detection_range": [-16.0, -float(ny_half), -2.5, 16.0, float(ny_half), 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 48, "max_num_points": 5,
        "max_points": 2048, "compute_dtype": "float32", **kw,
    })


def _models(cfg):
    """The JAX model's preds on seeded pillars and the port's model with the
    same (bridged) weights and JAX's layout and neck flags."""
    variables = _variables(cfg)
    inputs = _inputs(cfg, n_valid=40)
    want = jax.jit(jpp.PointPillars(cfg).apply)(variables, *(jnp.asarray(a) for a in inputs))
    model = tpp.PointPillars(pu.to_torch_cfg(cfg, layout=True)).eval()
    model.load_state_dict(pu.bridged_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in inputs))
    return model, got, want


def _assert_preds_close(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert isinstance(g, tuple) == isinstance(w, tuple), key
        for gp, wp in zip(g, w) if isinstance(w, tuple) else [(g, w)]:
            assert tuple(gp.shape) == wp.shape, key
            np.testing.assert_allclose(gp.numpy(), np.asarray(wp), err_msg=key, **TOL)


# --- the packed neck and the head ---------------------------------------------


@pytest.mark.parametrize("neck", list(NECKS))
@pytest.mark.parametrize("ny_half", [16, 24])
def test_packed_neck_preds_match_jax(neck, ny_half):
    """`RPN(fuse_in_stats, split_out)` + `SharedHead` on the packed network:
    with the split head each pred is a column-parity pair (fy/2 = 8 and 12
    columns), compared pair for pair."""
    fuse, split = NECKS[neck]
    cfg = grid_cfg(ny_half, fuse_in_stats=fuse, split_head=split)
    model, got, want = _models(cfg)
    assert model.neck(False) == tpp.Neck(fuse, split)
    assert isinstance(got["cls_preds"], tuple) == split
    _assert_preds_close(got, want)


def test_neck_options_act_only_on_packed_inference():
    cfg = pu.to_torch_cfg(grid_cfg(), layout=True)
    assert cfg.pack_w and cfg.fuse_in_stats and cfg.split_head  # the JAX defaults
    packed = tpp.PointPillars(cfg)
    assert packed.neck(False) == tpp.Neck(True, True) and packed.neck(True) == tpp.Neck(False, False)
    assert tpp.PointPillars(cfg.replace(pack_w=False)).neck(False) == tpp.Neck(False, False)
    assert tpp.PointPillars(cfg.replace(head="multi")).neck(False) == tpp.Neck(True, False)


def _deconv_torch_weight(kernel: np.ndarray) -> torch.Tensor:
    """The JAX DeconvUpsample kernel (S, S, C, O) → the ConvTranspose2d
    kernel (C, O, S, S), as the weight bridge maps it."""
    return torch.from_numpy(np.ascontiguousarray(np.flip(kernel, (0, 1)).transpose(2, 3, 0, 1)))


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("w", [5, 6])
def test_fused_deconv_split_matches_jax(stride, w):
    """The strided fused branch alone, on coarse maps whose output parity
    halves have odd (w = 5, stride 2) and even widths."""
    rng = np.random.RandomState(stride + w)
    x = (rng.randn(2, 4, w, 8) * 2 + 0.5).astype(np.float32)
    mod = jpp.DeconvUpsample(6, stride, jnp.float32, packed_out=True, fuse_in_relu=True, split_parity=True)
    params = mod.init(jax.random.PRNGKey(w), jnp.asarray(x))
    want = mod.apply(params, jnp.asarray(x))
    got = tpp.fused_deconv_split(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 _deconv_torch_weight(np.asarray(params["params"]["kernel"])))
    for g, wp in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(wp), **TOL)
    assert got[0].shape[-1] == w * stride // 2


@pytest.mark.parametrize("w2", [5, 6])
def test_fused_pointwise_split_matches_jax(w2):
    """The stride-1 fused branch on a packed map: the two parity blocks are
    the Gram statistics' phases (odd and even packed widths)."""
    rng = np.random.RandomState(w2)
    x = (rng.randn(2, 6, w2, 2 * 8) + 0.3).astype(np.float32)
    mod = jpp.PackedPointwise(5, 8, jnp.float32, fuse_in_relu=True, split_parity=True)
    params = mod.init(jax.random.PRNGKey(w2), jnp.asarray(x))
    want = mod.apply(params, jnp.asarray(x))
    kernel = np.array(params["params"]["kernel"])                     # (1, 1, C, O)
    got = tpp.fused_pointwise_split(torch.from_numpy(x).permute(0, 3, 1, 2),
                                    torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
    for g, wp in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(wp), **TOL)


def test_gram_moments_equal_the_fine_map_moments():
    """The Gram statistics are the InstanceNorm moments of the map they
    describe (to float32 association), without that map."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(2, 7, 5, 6) * 3 + 2).astype(np.float32)).permute(0, 3, 1, 2)
    kf = torch.from_numpy(rng.randn(6, 4, 3).astype(np.float32))
    mean, inv = tpp.gram_moments(x, kf, 7 * 5 * 4)
    fine = torch.einsum("bchw,cpo->bophw", x, kf).reshape(2, 3, -1)       # every phase's output
    want_mean = fine.mean(dim=-1)
    want_inv = torch.rsqrt(fine.var(dim=-1, unbiased=False) + 1e-3)
    np.testing.assert_allclose(mean.numpy(), want_mean.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inv.numpy(), want_inv.numpy(), rtol=1e-4, atol=1e-6)


# --- the parity-pair decode -----------------------------------------------------


@pytest.mark.parametrize("approx", [None, True])
@pytest.mark.parametrize("ny", [32, 36])
def test_decode_pair_matches_jax(approx, ny):
    """`decode_stage` on a column-parity pair against the JAX parity path,
    on the same random predictions and anchor mask, fy/2 = 8 and 9."""
    from det3d_tpu.anchors import build_anchors as jax_build_anchors
    from det3d_tpu.postprocess import PostProcessParams as JaxParams
    from det3d_tpu.postprocess import make_postprocessor

    jcfg = grid_cfg(ny // 2)
    tdet = Detector(pu.to_torch_cfg(jcfg, layout=True), device="cpu",
                    postprocess_params=PostProcessParams(nms_pre_max_size=60, approx_topk=approx))
    nch, fx, fy = tdet.module.mask_shape
    assert (fx, fy) == (16, ny // 2)
    rng = np.random.RandomState(ny)
    pair = {k: tuple((rng.randn(c, nch, fx, fy // 2) * scale).astype(np.float32) for _ in range(2))
            for k, c, scale in (("cls_preds", 1, 2.0), ("box_preds", 7, 0.5), ("dir_preds", 2, 1.0))}
    mask = rng.rand(nch, fx, fy) < 0.6
    jpost = make_postprocessor(jcfg, jax_build_anchors(jcfg), JaxParams(nms_pre_max_size=60, approx_topk=approx))
    want = jpost.decode_stage({k: tuple(jnp.asarray(a) for a in v) for k, v in pair.items()}, jnp.asarray(mask))
    got = tdet.postprocess.decode_stage({k: tuple(torch.from_numpy(a) for a in v) for k, v in pair.items()},
                                        torch.from_numpy(mask))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for field, a, b in zip(g._fields, g, w):
            b = np.asarray(b)
            if a.dtype == torch.bool:
                np.testing.assert_array_equal(a.numpy(), b, err_msg=field)
            else:
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-5, err_msg=field)


# --- the detector on the JAX default inference network ---------------------------


@pytest.fixture(scope="module", params=["small", "mid"])
def golden_case(request):
    """The JAX golden detector and the port's, both on the packed, fused,
    split network (the JAX default), exact top-k at "small" and the
    bucketed one at "mid", as the goldens were made."""
    from tools.make_golden import make_detector

    which = request.param
    jdet = make_detector(which)
    variables = pu.jax_variables(jdet)
    tdet = Detector(pu.to_torch_cfg(jdet.cfg, layout=True), device="cpu",
                    postprocess_params=PostProcessParams(approx_topk=True if which == "mid" else None))
    tdet.load_state_dict(pu.bridged_state_dict(variables))
    assert tdet.model.layout(1, False).pack_w and tdet.model.neck(False) == tpp.Neck(True, True)
    return which, jdet, variables, tdet


def test_packed_default_reproduces_frozen_golden(golden_case):
    which, _, _, tdet = golden_case
    golden = np.load(GOLDEN_DIR / f"e2e_{which}.npz")
    for i in range({"small": 6, "mid": 4}[which]):
        got = tdet.infer(torch.from_numpy(golden[f"points_{i}"]), int(golden[f"num_{i}"]))
        valid = golden[f"valid_{i}"]
        boxes, scores = golden[f"boxes_{i}"].copy(), golden[f"scores_{i}"].copy()
        for c, a, b in NEAR_TIES.get((which, i), []):
            np.testing.assert_allclose(scores[c, a], scores[c, b], rtol=0, atol=1e-6)
            boxes[c, [a, b]], scores[c, [a, b]] = boxes[c, [b, a]], scores[c, [b, a]]
        assert_detections_match(got, valid, boxes, scores, f"{which} frame {i}")


@pytest.mark.parametrize("approx", [None, True])
def test_packed_default_matches_live_jax_detector(golden_case, approx):
    """A fresh frame through the live JAX `Detector` and the port's packed
    default, with the exact and the bucketed top-k on both sides."""
    from det3d_tpu.pipeline import Detector as JaxDetector
    from det3d_tpu.postprocess import PostProcessParams as JaxParams

    which, jdet, variables, golden_tdet = golden_case
    jdet = JaxDetector(jdet.cfg, postprocess_params=JaxParams(approx_topk=approx))
    tdet = Detector(golden_tdet.cfg, device="cpu", postprocess_params=PostProcessParams(approx_topk=approx))
    tdet.load_state_dict(golden_tdet.model.state_dict())
    kwargs = {"small": dict(num_objects=(2, 6), ground_points=1200),
              "mid": dict(num_objects=(4, 10), ground_points=9000)}[which]
    pts, n = jdet.pad_points(sample_scene(jdet.cfg, np.random.RandomState(321), **kwargs)["points"])
    want = jax.device_get(jdet.infer_jit(variables, pts, np.int32(n)))
    got = tdet.infer(torch.from_numpy(pts), int(n))
    valid = np.asarray(want.valid, bool)
    assert valid.any()
    assert_detections_match(got, valid, np.asarray(want.boxes), np.asarray(want.scores), f"{which} {approx}")


# --- MultiHead ---------------------------------------------------------------------


def test_multi_head_preds_match_jax():
    """`head: "multi"` on the packed network (fused, never split): per-class
    reduce + heads concatenated in the shared contract (the dense network's
    is tests/test_torch_model.py::test_rejects_multi_head)."""
    model, got, want = _models(grid_cfg(head="multi"))
    assert isinstance(model.heads, tpp.MultiHead) and not isinstance(got["cls_preds"], tuple)
    assert model.heads.anchors_per_class == (6, 1, 2)
    assert got["cls_preds"].shape[2] == 9
    _assert_preds_close(got, want)


def test_multi_head_init_weights_cover_every_head():
    model = tpp.init_weights(tpp.PointPillars(pu.to_torch_cfg(grid_cfg(head="multi"))), 0)
    for c, a in enumerate((6, 1, 2)):
        reduce = getattr(model.heads, f"head{c}_reduce")
        assert tuple(reduce.weight.shape) == (64, 320, 1, 1) and not reduce.bias.any()
        np.testing.assert_allclose(float(reduce.weight.detach().std()), 320 ** -0.5, rtol=0.05)
        assert tuple(getattr(model.heads, f"head{c}_box").weight.shape) == (a * 7, 64, 1, 1)


@pytest.fixture(scope="module")
def multi_steps():
    """JAX's and the port's f32 train step of a multi-head model from the
    same weights and batch of two."""
    jcfg = pu.small_cfg().replace(batch_size=2, head="multi")
    rng = np.random.RandomState(0)
    jax_step = pu.jax_train_step(jcfg, [sample_scene(jcfg, rng, (2, 4), ground_points=800) for _ in range(2)])
    tcfg = pu.to_torch_cfg(jcfg)
    trainer = Trainer(tcfg, device="cpu")
    trainer.detector.load_state_dict(pu.to_tensors(pu.variables_to_state_dict(jax_step["before"])))
    state = trainer.init_state()
    state, loss, counts = trainer.train_step(state, host_batch(tcfg, jax_step["samples"]))
    return jax_step, dict(trainer=trainer, state=state, loss=loss, counts=counts)


def test_multi_head_train_step_matches_jax(multi_steps):
    jax_step, port = multi_steps
    for k, want in jax_step["loss"].items():
        np.testing.assert_allclose(float(port["loss"][k]), want, rtol=1e-5, err_msg=k)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(port["counts"][k].numpy(), jax_step["counts"][k], err_msg=k)
    named = dict(port["trainer"].model.named_parameters())
    assert any(k.startswith("heads.head2_") for k in named)
    for name, p in named.items():
        want = jax_step["grads"][name]
        scale = np.abs(want).max()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=name)


def test_multi_head_checkpoint_restores_bit_equal(multi_steps, tmp_path):
    _, port = multi_steps
    trainer, state = port["trainer"], port["state"]
    CheckpointManager(tmp_path).save(state, trainer.model)
    fresh = Trainer(trainer.cfg, device="cpu")
    restored = CheckpointManager(tmp_path).restore_latest(fresh)
    assert restored.step == state.step == 1
    for (name, a), b in zip(trainer.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(state.mu + state.nu, restored.mu + restored.nu):
        assert torch.equal(a, b)


def test_multi_head_reference_weights_are_refused(tmp_path):
    """The reference `.pth` layout has only the shared head: neither
    direction writes a file the JAX package could not import."""
    from det3d_tpu_torch import cli
    from det3d_tpu_torch.deploy.torch_interop import export_torch_checkpoint, import_torch_checkpoint

    cfg = pu.to_torch_cfg(pu.small_cfg()).replace(head="multi")
    det = Detector(cfg, device="cpu").init_weights(0)
    torch.save(det.model.state_dict(), tmp_path / "multi.pth")
    with pytest.raises(ValueError, match="only the shared head"):
        import_torch_checkpoint(tmp_path / "multi.pth", cfg, tmp_path / "run")
    with pytest.raises(ValueError, match="only the shared head"):
        export_torch_checkpoint(tmp_path / "multi.pth", cfg, tmp_path / "out.pth")
    assert not (tmp_path / "run").exists() and not (tmp_path / "out.pth").exists()
    (tmp_path / "multi.json").write_text('{"head": "multi", "compute_dtype": "float32"}')
    with pytest.raises(ValueError, match="only the shared head"):
        cli.main(["export-weights", "--config", str(tmp_path / "multi.json"), "--device", "cpu",
                  "--checkpoint", str(tmp_path / "multi.pth"), "--out", str(tmp_path / "out.pth")])


# --- exported programs ---------------------------------------------------------------


@pytest.mark.parametrize("flags", [dict(pack_w=True), dict(head="multi"), dict(head="multi", pack_w=True)],
                         ids=["packed_fused_split", "multi", "multi_packed"])
def test_export_equals_the_live_detector(flags, tmp_path):
    """The exported program of a packed config (fuse_in_stats and
    split_head on: the parity pair crosses from the head to the decode
    inside the program) and of multi-head configs, against the live
    detector of the same weights, bit for bit."""
    cfg = pu.to_torch_cfg(pu.small_cfg()).replace(**flags)
    live = Detector(cfg, device="cpu").init_weights(0)
    assert live.model.neck(False) == tpp.Neck(cfg.pack_w, cfg.pack_w and cfg.head == "shared")
    art = texport.export_detector(cfg, out_dir=tmp_path / "art", device="cpu")
    runner = truntime.ExportedDetector(art, "cpu")
    rng = np.random.RandomState(6)
    for _ in range(2):
        points = np.concatenate([rng.uniform(-7, 7, (1500, 2)), rng.uniform(-2, 6, (1500, 1)),
                                 rng.uniform(0, 1, (1500, 1))], 1).astype(np.float32)
        got, want = runner.detect(points), live.detect(points)
        assert len(want["name"]) > 0
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("option", [{"head": "multi"}, {"pack_w": True}], ids=["multi", "pack_w"])
def test_cli_train_infer_export_with_the_option_on_cpu(option, tmp_path, capsys):
    """`train`, `infer --breakdown` of its checkpoint and `export` through
    the command line with `head: "multi"` and with `pack_w` (whose
    `fuse_in_stats` and `split_head` are on by default)."""
    import json

    from det3d_tpu_torch import cli

    raw = {"detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
           "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0], "voxel_size": [1.0, 1.0, 11.0],
           "max_voxels": 128, "max_num_points": 5, "max_points": 2048, "max_gt_boxes": 8,
           "compute_dtype": "float32", "batch_size": 2, **option}
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(raw))
    common = ["--config", str(cfg_path), "--device", "cpu"]
    cli.main(["train", *common, "--synthetic", "--steps", "2", "--display-step", "1", "--save-step", "2",
              "--eval-step", "100", "--model-dir", str(tmp_path / "run")])
    cli.main(["infer", *common, "--synthetic", "--frames", "2", "--breakdown", "--checkpoint", str(tmp_path / "run")])
    cli.main(["export", *common, "--checkpoint", str(tmp_path / "run"), "--out", str(tmp_path / "art")])
    out = capsys.readouterr().out
    assert "step 2  loss" in out and "loaded checkpoint @ step 2" in out and "avg end-to-end" in out
    assert (tmp_path / "art" / texport.PROGRAM).exists()
