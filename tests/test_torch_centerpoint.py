"""The center model (CenterPoint-PP) against the benchmark's plain reference.

`benchmark/reference/centerpoint.py` states the published forward pass in
plain float32 torch; `benchmark/families/centerpoint.py` makes the seeded
weights (LeCun kernels, the heatmap prior, batch norms calibrated by the
reference) and the 10-sweep clouds. Here, at a 128x128 grid (±12.8 m) with
every published width, in float32 on the CPU: the program's stages (the
scattered pillar features, the RPN, each task's branches), its decoded
candidates, its annos through `Detector.detect` and `infer_batch`, and its
`state_dict` keys against the reference's; the rotated NMS's plain path
against the reference's greedy NMS on crafted rows; a bfloat16 program
under the configuration's `center_gap` limit and the fp8 control above it.
The rotated kernel's keep sets against the plain version's are the
`gpu`-marked test at the end (skips here).

Tolerances, each with its reason:

- stages: float32 on both sides, the same operations but other kernels
  (the program's batch norm is `F.batch_norm`, the reference's written
  out; the pillar mean sums padding slots of zeros): agreement to 1e-4 of
  the map's largest magnitude, the rounding of ~25 layers of float32
  convolution (measured: 6e-7 for the canvas, 1e-5 for the neck and the
  heads);
- candidates and annos: boxes to 1e-3 (metres, log dims through exp,
  radians), logits to 1e-3, the same cells kept; `center_gap` of the
  float32 program under 1e-2 (measured ~4e-5);
- the NMS rows: exact keep sets, for IoUs at least 1e-3 from the
  threshold (the program's float32 IoU and the reference's float64 clip
  differ by at most 7e-7 over 4 000 random pairs).
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from benchmark.families import centerpoint as fam
from benchmark.lib import harness, traffic
from benchmark.reference import centerpoint as ref
from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.kernels import nms_cuda
from det3d_tpu_torch.models import centerpoint as cp
from det3d_tpu_torch.pipeline import Detector

torch.set_num_threads(4)

CONFIG = harness.ROOT / "benchmark" / "configs" / "centerpoint_pp_nusc.json"
SMALL = {"detection_range": [-12.8, -12.8, -5.0, 12.8, 12.8, 3.0], "max_voxels": 4000, "max_points": 40000}
SEED = 2**31 + 21
STAGE_TOL = 1e-4
BOX_TOL = 1e-3
F32_GAP = 1e-2
IOU_MARGIN = 1e-3


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    raw = json.loads(CONFIG.read_text())
    raw.update(SMALL)
    path = tmp_path_factory.mktemp("centerpoint") / "small.json"
    path.write_text(json.dumps(raw))
    geo = fam.geometry(path)
    w = fam.make_weights(SEED, geo, "cpu")
    return path, geo, w


def clouds(n: int, seed: int = 3) -> list[np.ndarray]:
    """10-sweep clouds cut to the small grid's square, under its max_points."""
    out = []
    for i in range(n):
        p = fam.point_cloud(120_000, traffic.rng(seed, 2, i))
        p = p[(np.abs(p[:, 0]) < 13.5) & (np.abs(p[:, 1]) < 13.5)]
        out.append(p[:SMALL["max_points"] - 1000 * i])
    return out


def detector(small, dtype: str = "float32") -> Detector:
    path, _, w = small
    det = Detector(load_config(path, compute_dtype=dtype), device="cpu")
    det.load_state_dict({k: v.clone() for k, v in w.items()})
    return det


def close(a: torch.Tensor, b: torch.Tensor, rel: float) -> bool:
    if a.numel() == 0 or b.numel() == 0:
        return a.shape == b.shape
    return float((a.float() - b.float()).abs().max()) <= rel * max(float(b.abs().max()), 1.0)


def test_the_config_reads_every_published_width():
    cfg = load_config(CONFIG)
    assert cfg.center and cfg.grid_size == (512, 512, 1) and cfg.feature_map_size == (128, 128, 1)
    assert cfg.out_size_factor == 4 and (cfg.max_voxels, cfg.max_num_points) == (60000, 20)
    assert cfg.pfn_filters == (64, 64) and cfg.rpn_layer_nums == (3, 5, 5) and cfg.rpn_filters == (64, 128, 256)
    assert cfg.rpn_up_strides == (0.5, 1.0, 2.0) and cfg.rpn_up_filters == (128, 128, 128)
    assert len(cfg.tasks) == 6 and len(cfg.class_names) == 10
    assert (cfg.nms_pre_max_size, cfg.nms_post_max_size, cfg.nms_iou_threshold) == (1000, 83, 0.2)
    assert json.loads(CONFIG.read_text())["compute_dtype"] == "bfloat16"


def test_state_dict_keys_are_the_reference_s_and_load_strictly(small):
    path, geo, w = small
    det = detector(small)
    assert list(det.model.state_dict()) == list(ref.Network(geo).state_dict())
    assert set(w) == set(det.model.state_dict())
    assert {k: tuple(v.shape) for k, v in det.model.state_dict().items()} == {k: tuple(v.shape) for k, v in w.items()}
    with pytest.raises(RuntimeError):
        det.load_state_dict({k: v for k, v in w.items() if "hm" not in k})


def test_the_calibrated_weights_keep_unit_scale(small):
    """The calibration puts every batch norm's running statistics at its
    input's, so the head's maps stay near unit scale and the gate binds."""
    _, geo, w = small
    net = fam.reference_network(w, geo, "cpu")
    with torch.no_grad(), ref.mode():
        maps = ref.network(net, torch.as_tensor(clouds(1)[0]), geo)
    for task in maps:
        assert 0.2 < float(task["reg"].std()) < 5.0
        assert float(task["hm"].mean()) < -2.0      # the prior holds most cells under the gate
    assert sum(int(ref.decode(m, geo).gated.sum()) for m in maps) > 0


def stages(det: Detector, points: np.ndarray):
    m = det.module
    padded, n = det.pad_points(points)
    with torch.no_grad():
        frame, _ = m.preprocess(torch.as_tensor(padded), torch.tensor(n))
        model = m.model
        feats = model.reader(frame.voxels[None], frame.num_points_per_voxel[None], frame.coors[None])
        canvas = model.canvas(feats, frame.coors[None])
        neck = model.neck(canvas)
        return canvas, neck, model.bbox_head(neck)


def reference_stages(small, points: np.ndarray):
    _, geo, w = small
    net = fam.reference_network(w, geo, "cpu")
    with torch.no_grad(), ref.mode():
        pts = torch.as_tensor(points)
        voxels, counts, coors = ref.voxelize(pts, geo)
        canvas = ref.canvas(ref.pillar_features(net, voxels, counts, coors, geo), coors, geo)
        x, ups = canvas, []
        for block, deblock in zip(net.neck.blocks, net.neck.deblocks):
            x = ref.run(block, x)
            ups.append(ref.run(deblock, x))
        neck = torch.cat(ups, dim=1)
        shared = ref.run(net.bbox_head.shared_conv, neck)
        heads = [{k: ref.run(getattr(t, k), shared) for k in (*ref.HEADS, "hm")} for t in net.bbox_head.tasks]
        return canvas, neck, heads


def test_pfn_rpn_and_head_equal_the_reference_stage_by_stage(small):
    points = clouds(1)[0]
    canvas, neck, heads = stages(detector(small), points)
    want_canvas, want_neck, want_heads = reference_stages(small, points)
    assert close(canvas, want_canvas, STAGE_TOL)
    assert close(neck, want_neck, STAGE_TOL)
    assert len(heads) == len(want_heads) == 6
    for got, want in zip(heads, want_heads):
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == want[k].shape and close(got[k], want[k], STAGE_TOL), k


def test_decoded_candidates_equal_the_reference(small):
    _, geo, w = small
    det = detector(small)
    points = clouds(1)[0]
    padded, n = det.pad_points(points)
    with torch.no_grad():
        got = det.infer_candidates(torch.as_tensor(padded), torch.tensor(n))
    want = ref.frame(fam.reference_network(w, geo, "cpu"), points, geo, "cpu")
    assert sum(c.top_k for c in want) > 0
    for t, c in enumerate(want):
        k = int(got.valid[0, t].sum())
        assert k == c.top_k
        assert torch.equal(got.labels[0, t, :k], c.labels[c.top])
        assert close(got.boxes[0, t, :k], c.boxes[c.top], BOX_TOL)
        assert close(torch.logit(got.scores[0, t, :k].double()), c.logits[c.top], BOX_TOL)
        assert torch.equal(got.rboxes[0, t, :k], got.boxes[0, t, :k][:, [0, 1, 3, 4, 8]])


@pytest.mark.parametrize("entry", ["detect", "infer_batch"])
def test_annos_equal_the_reference(small, entry):
    from det3d_tpu_torch.postprocess import Detections, to_annos

    _, geo, w = small
    det = detector(small)
    frames = clouds(2)
    if entry == "detect":
        annos = [det.detect(f) for f in frames]
    else:
        padded = [det.pad_points(f) for f in frames]
        out = det.infer_batch(torch.as_tensor(np.stack([p for p, _ in padded])),
                              torch.as_tensor([n for _, n in padded]))
        annos = [to_annos(det.cfg, Detections(*(t[i] for t in out))) for i in range(len(frames))]
    net = fam.reference_network(w, geo, "cpu")
    for f, a in zip(frames, annos):
        expected = fam.reference_frame(net, f, geo, "cpu")
        want = fam.reference_annos(ref.finalize(expected[1], geo), geo)
        assert len(a["name"]) > 0 and sorted(a["name"].tolist()) == sorted(want["name"].tolist())
        assert set(a) >= {"name", "location", "dimensions", "rotation_y", "score", "velocity"}
        for name in set(want["name"].tolist()):
            mine, theirs = a["name"] == name, want["name"] == name
            for key in ("location", "dimensions", "velocity", "rotation_y", "score"):
                np.testing.assert_allclose(np.asarray(a[key])[mine], np.asarray(want[key])[theirs], atol=BOX_TOL,
                                           rtol=BOX_TOL, err_msg=f"{name} {key}")
        assert fam.check_frame(expected, a, "f32").numbers["center_gap"] < F32_GAP


def test_bfloat16_reads_under_the_limit_and_the_fp8_control_over_it(small):
    _, geo, w = small
    limit = json.loads(CONFIG.read_text())["compare_limits"]["center_gap"]
    net = fam.reference_network(w, geo, "cpu")
    points = clouds(1, seed=5)[0]
    expected = fam.reference_frame(net, points, geo, "cpu")
    program = fam.check_frame(expected, detector(small, "bfloat16").detect(points), "bf16").numbers["center_gap"]
    control = fam.check_frame(expected, fam.control_annos(net, points, geo, "cpu"), "fp8").numbers["center_gap"]
    assert program < limit < control, (program, limit, control)


def test_a_dropped_branch_reads_over_the_limit(small):
    """A program that leaves out the velocity or the height branch (their
    outputs at zero) reads over the limit."""
    limit = json.loads(CONFIG.read_text())["compare_limits"]["center_gap"]
    _, geo, w = small
    net = fam.reference_network(w, geo, "cpu")
    points = clouds(1, seed=5)[0]
    expected = fam.reference_frame(net, points, geo, "cpu")
    for branch in ("vel", "height"):
        det = detector(small)
        for task in det.model.bbox_head.tasks:
            with torch.no_grad():
                getattr(task, branch)[-1].weight.zero_()
                getattr(task, branch)[-1].bias.zero_()
        got = fam.check_frame(expected, det.detect(points), branch).numbers["center_gap"]
        assert got > limit, (branch, got)


def rows(*boxes):
    return torch.tensor(boxes, dtype=torch.float32)


def crafted_rows() -> dict[str, torch.Tensor]:
    """Rows of [x, y, dim0, dim1, rot], in score order."""
    sq = lambda x, y, r=0.0: [x, y, 2.0, 2.0, r]  # noqa: E731
    # two 2x2 squares offset by d along x: IoU = (2 - d) / (2 + d); 0.2 at d = 4/3
    d_at = 4.0 / 3.0
    return {
        "crossing": rows([0, 0, 4.0, 1.0, 0.0], [0, 0, 4.0, 1.0, math.pi / 2], [0, 0, 4.0, 1.0, math.pi / 4],
                         [5, 5, 1, 1, 0.3]),
        "equal scores, chain": rows(sq(0, 0), sq(1.0, 0), sq(2.0, 0), sq(3.0, 0), sq(0, 0.5, 0.1)),
        "IoU just over 0.2": rows(sq(0, 0), sq(d_at - 0.01, 0)),
        "IoU just under 0.2": rows(sq(0, 0), sq(d_at + 0.01, 0)),
        "rotated just either side": rows(sq(0, 0, 0.4), sq(d_at - 0.02, 0, 0.4), sq(-(d_at + 0.02), 0, 0.4)),
        "disjoint and nested": rows([0, 0, 6, 6, 0], [0, 0, 1, 1, 0.7], [20, 0, 1, 1, 0], [20.4, 0, 1, 1, 0]),
    }


@pytest.mark.parametrize("name", list(crafted_rows()))
def test_rotated_nms_plain_path_equals_the_reference_greedy_nms(name):
    rb = crafted_rows()[name]
    valid = torch.ones(rb.shape[0], dtype=torch.bool)
    boxes9 = torch.zeros((rb.shape[0], 9))
    boxes9[:, [0, 1, 3, 4, 8]] = rb
    iou = ref.bev_iou(boxes9, boxes9)
    off = iou[~torch.eye(rb.shape[0], dtype=torch.bool)]
    assert ((off - 0.2).abs() >= IOU_MARGIN).all()
    got = nms_cuda.nms_keep_rotated(rb, valid, 0.2)
    assert torch.equal(got, ref.greedy_nms(boxes9, 0.2)), name
    batched = nms_cuda.nms_keep_rotated(torch.stack([rb, rb.flip(0)]), torch.stack([valid, valid]), 0.2)
    assert torch.equal(batched[0], got)


def test_rotated_nms_invalid_rows_neither_keep_nor_suppress():
    rb = rows([0, 0, 2, 2, 0], [0.2, 0, 2, 2, 0], [0.4, 0, 2, 2, 0])
    valid = torch.tensor([False, True, True])
    assert nms_cuda.nms_keep_rotated(rb, valid, 0.2).tolist() == [False, True, False]


def cell_run(tmp_path, monkeypatch, trace: bool = False, plant=None, seconds: float = 0.5):
    """The offline cell's loop (`benchmark/run.py`) at a 256x256 grid
    (±25.6 m), with room for whole 10-sweep clouds of 100 000-120 000 points:
    batch 2, a pool of 4 frames. This suite's conftest loads JAX in the test process, which a
    benchmark run refuses; `benchmark/tests` hold that check in a process of
    its own."""
    import time

    from benchmark import run as bench_run

    raw = json.loads(CONFIG.read_text())
    raw.update(detection_range=[-25.6, -25.6, -5.0, 25.6, 25.6, 3.0], max_voxels=16000, max_points=130_000)
    (tmp_path / "cfg.json").write_text(json.dumps(raw))
    (tmp_path / "mix.json").write_text(json.dumps({"kind": "offline", "batch": 2, "pool": 4,
                                                   "points": [100_000, 120_000], "compare_batches": 1,
                                                   "sure_batches": 1}))
    real = harness.load_spec()
    spec = {"configs": [{"name": "small", "file": str(tmp_path / "cfg.json")}],
            "workloads": [{"name": "cppnusc-offline-b4", "config": "small", "traffic": str(tmp_path / "mix"),
                           "chips": 1}],
            "end_to_end": real["end_to_end"], "per_layer": real["per_layer"]}
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    return bench_run.run_cell(spec, "cppnusc-offline-b4", 2**31 + 7, seconds, trace, device="cpu",
                              t_start=time.perf_counter(), plant=plant)


@pytest.mark.parametrize("trace", [False, True])
def test_the_center_cell_reads_correct_on_the_cpu(tmp_path, monkeypatch, trace):
    rc, result = cell_run(tmp_path, monkeypatch, trace)
    assert rc == 0 and result["correct"] is True and list(result["compared"]) == ["center_gap"]
    if trace:
        assert {"cp_head_ms.offline", "cp_decode_ms.offline", "cp_nms_ms.offline"} <= set(result["metrics"])
    else:
        assert {"frames_per_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_empty"])
def test_a_fault_makes_the_center_cell_not_correct(tmp_path, monkeypatch, fault):
    from benchmark import control

    plant = control.FAULTS["offline"][fault]
    rc, result = cell_run(tmp_path, monkeypatch, plant=lambda run: plant(run.det), seconds=0.3)
    got = result["compared"]["center_gap"]
    assert rc == 0 and result["correct"] is False and got["value"] > got["limit"]


def test_the_trainer_refuses_the_center_model():
    from det3d_tpu_torch.train.trainer import Trainer

    with pytest.raises(ValueError, match="inference only"):
        Trainer(load_config(CONFIG, compute_dtype="float32"), device="cpu")


def test_init_weights_puts_the_heatmap_at_the_prior():
    cfg = load_config(CONFIG, **SMALL)
    model = cp.CenterPointPP(cfg)
    cp.init_weights(model, 0)
    for task in model.bbox_head.tasks:
        assert torch.allclose(torch.sigmoid(task.hm[-1].bias), torch.tensor(0.01))


# -- on the card ----------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [6, 24])
@pytest.mark.parametrize("spread", [120.0, 30.0])
def test_rotated_kernel_keep_sets_equal_the_plain_version(n_rows, spread):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m gpu)")
    for seed in range(4):
        g = torch.Generator().manual_seed(seed)
        centre = (torch.rand(n_rows, 1000, 2, generator=g) - 0.5) * spread
        dims = torch.exp(torch.randn(n_rows, 1000, 2, generator=g) * 0.5) * 1.5
        yaw = (torch.rand(n_rows, 1000, 1, generator=g) * 2 - 1) * math.pi
        rb = torch.cat([centre, dims, yaw], -1).cuda().contiguous()
        valid = (torch.rand(n_rows, 1000, generator=g) < 0.8).cuda()
        got = nms_cuda.nms_keep_rotated_cuda(rb, valid, 0.2)
        assert torch.equal(got, nms_cuda.nms_keep_rotated_plain(rb, valid, 0.2)), seed
