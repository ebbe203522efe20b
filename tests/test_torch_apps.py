"""The port's applications (`apps/train_app.py`, `apps/infer_app.py`) and
its command line, against the JAX package's apps on the CPU, in float32.

Both apps start from the same step-0 weights: a JAX `CheckpointManager`
save of `init_state(PRNGKey(0))`, exported to the port's `latest.pth`.

Tolerances, each with its reason:
  * after two synthetic train steps of both apps at lr 1e-6, the port's
    `2.pth` against the JAX app's checkpoint exported to `.pth`: Adam's
    moments within 1e-4 of each tensor's largest (the gradient tolerance
    of tests/test_torch_train.py: both steps' gradients enter them; 1.8e-5
    seen); every parameter element within 4·lr (that test's 2·lr for each
    step: Adam's update of a gradient within rounding of 0 is not
    determined by it); running statistics rtol 1e-5. The small lr keeps the
    second step's weights within ~lr of each other: at the config's 5e-4
    the first update of such gradients moves weights by up to 1e-3, and the
    untrained network's second gradients then differ by up to 10 % in
    places. One step from one state at the config's lr is held to that
    test's tolerances in tests/test_torch_checkpoint.py;
  * `infer` of both apps on the same weights (JAX with `exact_topk=True`):
    per frame and class the same detections, matched by location (a pair
    of near-tied scores may swap ranks, as tests/test_torch_pipeline.py's
    NEAR_TIES), boxes within 1e-4, scores within 1e-5 (those of
    tests/test_golden_e2e.py); the mAP strings equal character for
    character.
"""

from __future__ import annotations

import json
import multiprocessing
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu.apps.infer_app import infer as jax_infer
from det3d_tpu.apps.train_app import train as jax_train
from det3d_tpu.deploy.torch_interop import export_torch_checkpoint
from det3d_tpu.eval.ap import get_official_eval_result as jax_official
from det3d_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from det3d_tpu.train.trainer import Trainer as JaxTrainer
from det3d_tpu_torch import cli
from det3d_tpu_torch.apps.infer_app import infer
from det3d_tpu_torch.apps.train_app import train
from det3d_tpu_torch.data.synthetic import write_split
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.train.checkpoint import read_checkpoint
from test_torch_tmpdirs import removed, tmp_path  # noqa: F401

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
LR = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both apps: 2 synthetic steps from shared step-0 weights (no eval in
    the loop), then `infer` of the JAX app's step-2 weights by both."""
    tmp = tmp_path_factory.mktemp("apps")
    jcfg = pu.small_cfg().replace(batch_size=2, learning_rate=LR)
    tcfg = pu.to_torch_cfg(jcfg)
    jdir, tdir = tmp / "jax", tmp / "port"
    JaxCheckpointManager(jdir).save(jax.device_get(JaxTrainer(jcfg).init_state(jax.random.PRNGKey(0))))
    tdir.mkdir()
    export_torch_checkpoint(jdir, jcfg, tdir / "latest.pth")
    kw = dict(max_steps=2, display_step=1, save_step=2, eval_step=100, synthetic=True, seed=0)
    jax_train(jcfg, model_dir=str(jdir), **kw)
    summary = train(tcfg, model_dir=str(tdir), device="cpu", **kw)
    export_torch_checkpoint(jdir, jcfg, tmp / "jax_step2.pth")
    jinf = jax_infer(jcfg, checkpoint=str(jdir), synthetic=True, num_frames=3, exact_topk=True)
    tinf = infer(tcfg, checkpoint=str(tmp / "jax_step2.pth"), synthetic=True, num_frames=3, breakdown=True,
                 out_path=str(tmp / "dt.pkl"), device="cpu")
    yield dict(jcfg=jcfg, tcfg=tcfg, tmp=tmp, summary=summary, jinf=jinf, tinf=tinf)
    removed(tmp)


def test_train_writes_the_checkpoints(runs):
    tdir = runs["tmp"] / "port"
    assert {p.name for p in tdir.iterdir()} >= {"latest.pth", "2.pth"}
    assert runs["summary"]["steps"] == 2 and len(runs["summary"]["ms_per_step"]) == 2
    assert read_checkpoint(tdir / "2.pth")[1] == 2


def test_train_matches_jax_app(runs):
    lr = runs["tcfg"].learning_rate
    got_sd, got_step, got_opt = read_checkpoint(runs["tmp"] / "port" / "2.pth")
    want_sd, want_step, want_opt = read_checkpoint(runs["tmp"] / "jax_step2.pth")
    assert got_step == want_step == 2
    for k, want in want_sd.items():
        got = got_sd[k]
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, msg=k)
            continue
        assert (got - want).abs().max() <= 4 * lr, k
    for i, want in want_opt["state"].items():
        got = got_opt["state"][i]
        assert int(got["step"]) == int(want["step"]) == 2
        for key in ("exp_avg", "exp_avg_sq"):
            scale = want[key].abs().max()
            assert (got[key] - want[key]).abs().max() <= 1e-4 * scale, (i, key)
    assert got_opt["param_groups"][0]["lr"] == pytest.approx(want_opt["param_groups"][0]["lr"], rel=1e-7)


def match_frame(got: dict, want: dict, frame: int) -> None:
    """Each class's detections paired by location (near-tied scores may swap ranks)."""
    assert sorted(got["name"].tolist()) == sorted(want["name"].tolist()), frame
    for cls in set(want["name"].tolist()):
        g, w = got["name"] == cls, want["name"] == cls
        gl, wl = got["location"][g], want["location"][w]
        pair = np.abs(gl[:, None] - wl[None]).sum(-1).argmin(1)
        assert sorted(pair.tolist()) == list(range(len(wl))), (frame, cls)
        for key, tol in (("location", 1e-4), ("dimensions", 1e-4), ("rotation_y", 1e-4), ("score", 1e-5)):
            np.testing.assert_allclose(got[key][g], want[key][w][pair], rtol=tol, atol=tol, err_msg=f"{frame} {key}")


def test_infer_matches_jax_app(runs):
    jinf, tinf = runs["jinf"], runs["tinf"]
    assert len(tinf["dt_annos"]) == len(jinf["dt_annos"]) == 3
    assert sum(len(a["name"]) for a in tinf["dt_annos"]) > 0
    for f, (g, w) in enumerate(zip(tinf["dt_annos"], jinf["dt_annos"])):
        match_frame(g, w, f)
    assert tinf["eval_strs"] == jinf["eval_strs"]
    assert tinf["reader"] == "synthetic"
    assert set(tinf["stages"]) == {"e2e", "pre", "net", "post"}
    with open(runs["tmp"] / "dt.pkl", "rb") as f:
        assert len(pickle.load(f)) == 3


def test_train_and_infer_from_a_dataset(runs, tmp_path):
    """The dataset source: two prefetcher workers, in-training eval into
    log.txt, a checkpoint every step, resume; then `infer` through the
    native reader gives what `Detector.detect` gives on each frame."""
    tcfg = runs["tcfg"]
    write_split(tcfg, tmp_path / "data" / "train", 4, seed=3, num_objects=(2, 4), ground_points=800)
    write_split(tcfg, tmp_path / "data" / "eval", 2, seed=4, num_objects=(2, 4), ground_points=800)
    cfg = tcfg.replace(data_root=str(tmp_path / "data"), train_info=("train/data_info.pkl",),
                       eval_info=("eval/data_info.pkl",), num_workers=2)
    model_dir = tmp_path / "run"
    summary = train(cfg, max_steps=2, display_step=1, save_step=1, eval_step=2, eval_frames=2,
                    model_dir=str(model_dir), device="cpu")
    assert not multiprocessing.active_children()  # the workers are stopped
    assert summary["steps"] == 2 and len(summary["eval_strs"]) == 1
    assert len(summary["batch_wait_s"]) == 2 and sum(summary["batch_wait_s"]) > 0
    assert "Metric: bev" in (model_dir / "log.txt").read_text()
    assert {"1.pth", "2.pth", "latest.pth"} <= {p.name for p in model_dir.iterdir()}
    again = train(cfg.replace(num_workers=0), max_steps=3, display_step=1, save_step=1, eval_step=100,
                  model_dir=str(model_dir), device="cpu")
    assert again["steps"] == 1 and read_checkpoint(model_dir / "latest.pth")[1] == 3

    out = infer(cfg, checkpoint=str(model_dir), num_frames=2, range_thresholds=(80.0,), device="cpu")
    assert out["reader"] == "native"
    det = Detector(cfg, device="cpu").load_state_dict(read_checkpoint(model_dir / "latest.pth")[0])
    from det3d_tpu_torch.data.dataset import DetectionDataset

    ds = DetectionDataset(cfg, cfg.eval_info, training=False)
    for i, got in enumerate(out["dt_annos"]):
        want = det.detect(ds.load_points(ds.infos[i]))
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert out["eval_strs"][0] == jax_official(out["gt_annos"], out["dt_annos"], list(cfg.detect_class), 80.0)[1]


# --- the command line --------------------------------------------------------------


def test_cli_rejects_unknown_command_and_eval_without_annos():
    with pytest.raises(SystemExit):
        cli.main(["frobnicate"])
    with pytest.raises(SystemExit):
        cli.main(["eval", "--config", "configs/ntusl_20cm.json"])


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    anno = {"name": np.array(["vehicle"]), "location": np.array([[5.0, 0, -1.0]]),
            "dimensions": np.array([[4.5, 2.0, 1.8]]), "rotation_y": np.array([0.3]),
            "num_points": np.array([100]), "score": np.array([0.9])}
    for name in ("gt", "dt"):
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump([anno], f)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["eval", "--dt", str(tmp_path / "dt.pkl"), "--gt", str(tmp_path / "gt.pkl")])


def run_cli(*args, timeout=600):
    out = subprocess.run([sys.executable, "-m", "det3d_tpu_torch", *args], cwd=REPO, capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_cli_eval_runs_on_pickled_annos(tmp_path):
    import test_torch_eval

    cfg, gts, dts = test_torch_eval.eval_annos(seed=1)
    for name, annos in (("gt", gts), ("dt", dts)):
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump(annos, f)
    out = run_cli("eval", "--device", "cpu", "--dt", str(tmp_path / "dt.pkl"), "--gt", str(tmp_path / "gt.pkl"),
                  "--range", "50")
    want = jax_official(gts, dts, ["vehicle", "pedestrian", "cyclist"], 50.0)[1]
    assert out.rstrip("\n") == want.rstrip("\n")


def test_cli_train_then_infer_on_cpu(tmp_path):
    """`train --synthetic --device cpu` from a bf16 config (computed in f32
    with a notice), then `infer --checkpoint` of its model directory."""
    raw = {"detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
           "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0], "voxel_size": [1.0, 1.0, 11.0],
           "max_voxels": 128, "max_num_points": 5, "max_points": 2048, "max_gt_boxes": 8,
           "compute_dtype": "bfloat16", "batch_size": 2}
    (tmp_path / "tiny.json").write_text(json.dumps(raw))
    model_dir = tmp_path / "run"
    out = run_cli("train", "--config", str(tmp_path / "tiny.json"), "--synthetic", "--device", "cpu", "--steps", "2",
                  "--display-step", "1", "--save-step", "2", "--eval-step", "2", "--eval-frames", "1",
                  "--model-dir", str(model_dir))
    assert "promoting compute_dtype bfloat16 -> float32" in out and "step 2  loss" in out and "Metric: 3d" in out
    assert read_checkpoint(model_dir / "latest.pth")[1] == 2
    out = run_cli("infer", "--config", str(tmp_path / "tiny.json"), "--synthetic", "--device", "cpu", "--frames", "2",
                  "--checkpoint", str(model_dir), "--out", str(tmp_path / "dt.pkl"))
    assert "loaded checkpoint @ step 2" in out and "avg end-to-end" in out and "range < 90.00" in out
    with open(tmp_path / "dt.pkl", "rb") as f:
        assert len(pickle.load(f)) == 2
