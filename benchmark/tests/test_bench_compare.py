"""The comparison that decides `correct`: the reference agrees with the
program at float32, stays finite on the program's sentinels, and the
lower-precision control fails it (at a 64x64 grid on the CPU)."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from benchmark.families import pointpillars as pp
from benchmark.lib import compare, harness, traffic

SMALL = harness.ROOT / "benchmark" / "tests" / "small_config.json"
LIMITS = json.loads((harness.BENCH / "configs" / "ntusl_20cm.json").read_text())["compare_limits"]
SEED = 2**31 + 5


def frame_inputs(seed: int = SEED, frame: int = 0):
    geo = pp.geometry(SMALL)
    w = pp.make_weights(seed, geo, "cpu")
    pts = pp.point_cloud(5000, traffic.rng(seed, 9, frame)) * np.array([0.4, 0.4, 1, 1], np.float32)
    return geo, w, pts


def program_annos(w, pts, dtype: str):
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.pipeline import Detector

    det = Detector(load_config(SMALL, compute_dtype=dtype), device="cpu")
    det.load_state_dict({k: v.clone() for k, v in w.items()})
    return det.detect(pts)


@pytest.fixture(scope="module")
def judged():
    geo, w, pts = frame_inputs()
    net = pp.reference_network(w, geo, "cpu")
    cands = pp.reference_frame(net, pts, geo, "cpu")
    return geo, w, pts, net, cands


def test_reference_agrees_with_program_in_float32(judged):
    _, w, pts, _, cands = judged
    got = pp.check_frame(cands, program_annos(w, pts, "float32"), "f32")
    assert got.numbers["det_gap"] < 1e-3


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_bf16_program_passes_and_fp8_control_fails(seed):
    """Over a run's sample of frames (here 6), the largest gap: the
    program's under the limit, the control's over it."""
    program = low = 0.0
    for frame in range(6):
        geo, w, pts = frame_inputs(seed, frame)
        net = pp.reference_network(w, geo, "cpu")
        cands = pp.reference_frame(net, pts, geo, "cpu")
        program = max(program, pp.check_frame(cands, program_annos(w, pts, "bfloat16"), "bf16").numbers["det_gap"])
        control = pp.control_annos(net, pts, geo, "cpu")
        low = max(low, pp.check_frame(cands, control, "control").numbers["det_gap"])
    assert program < LIMITS["det_gap"] < low


def test_finite_when_a_near_threshold_box_is_gated_out(judged):
    """The program gates one near-threshold anchor to -inf that the
    reference keeps: one box fewer, the gap finite."""
    *_, cands = judged
    annos = pp.reference_annos(pp.ref.finalize(cands))
    lowest = int(np.argmin(annos["score"]))
    keep = np.arange(len(annos["score"])) != lowest
    fewer = {k: v[keep] for k, v in annos.items()}
    got = pp.judge_frame(fewer, cands, "gated")
    assert all(math.isfinite(v) for v in got.values())


def test_finite_with_invalid_slots_and_saturated_scores(judged):
    """Invalid slots carry the score -1.0 and never reach the annos; a kept
    score that rounds to 1.0 has an infinite logit, clamped."""
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.postprocess import Detections, to_annos

    *_, cands = judged
    annos = pp.reference_annos(pp.ref.finalize(cands))
    n = len(annos["score"])
    boxes = torch.zeros((3, 4, 7))
    scores = torch.full((3, 4), -1.0)
    valid = torch.zeros((3, 4), dtype=torch.bool)
    boxes[0, 0] = torch.as_tensor(np.concatenate([annos["location"][0], annos["dimensions"][0],
                                                  [annos["rotation_y"][0]]]))
    scores[0, 0] = 1.0
    valid[0, 0] = True
    out = to_annos(load_config(SMALL), Detections(boxes, scores, valid))
    assert len(out["score"]) == 1 and n >= 1
    got = pp.judge_frame(out, cands, "sentinels")
    assert all(math.isfinite(v) for v in got.values())


def test_finite_when_kept_counts_differ_by_one(judged):
    *_, cands = judged
    annos = pp.reference_annos(pp.ref.finalize(cands))
    more = {k: np.concatenate([v, v[:1]]) for k, v in annos.items()}
    got = pp.judge_frame(more, cands, "one more")
    assert all(math.isfinite(v) for v in got.values())


@pytest.mark.parametrize("field,value", [("location", math.nan), ("score", math.inf), ("score", -1.0)])
def test_unusable_output_is_named_not_numbered(judged, field, value):
    *_, cands = judged
    annos = pp.reference_annos(pp.ref.finalize(cands))
    bad = {k: v.copy() for k, v in annos.items()}
    bad[field][1] = value
    with pytest.raises(compare.BadOutput, match=r"sample 3: .* at slot \d+"):
        pp.judge_frame(bad, cands, "sample 3")
