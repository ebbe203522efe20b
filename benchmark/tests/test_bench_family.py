"""The family seam: a configuration names its detector family, the harness
finds it by name, the PointPillars family reads what the harness read
before it stood behind the seam, and a second family made of new files
only (`toy_family.py`, `toy_config.json`) runs a stream cell and an
offline cell to `correct` true, and to false under a planted fault."""

from __future__ import annotations

import hashlib
import json
import re

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.families import pointpillars as pp
from benchmark.lib import harness, traffic
from benchmark.tests import cells

BIG = 2**31 + 12345
SEED = 2**31 + 5
SMALL = harness.ROOT / cells.SMALL

# Read with the harness as it stood before the seam (`traffic.cloud_pool`,
# `weights.make`, `compare.judge_frame` at the parent commit), on the CPU
# with one thread: lidar_stream cut to 4 sweeps of 2000-5000 points at
# seed BIG; the small configuration's weights at seed SEED; det_gap of one
# 5000-point sweep at seed SEED for the program in float32 and bfloat16 and
# for the fp8 control.
PARENT = {
    "pool0": ("b11f690ab2e3553bf8a1e9056660b3c0c38b860b2c4782dd860157e8537a36a8", (3000, 4)),
    "weights": ("4fbdb54d0be59b376dfcf6594c9609d7b88d87a89f30431d9fdec99fdeb36bab", 31),
    "det_gap": {"float32": 3.874301910400391e-06, "bfloat16": 0.05582726001739502, "control": 0.5052351951599121},
}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_configuration_without_a_family_is_pointpillars():
    assert harness.family({}) is pp
    assert harness.family(json.loads((harness.BENCH / "configs" / "ntusl_20cm.json").read_text())) is pp


def test_a_family_is_found_by_a_relative_name():
    from benchmark.tests import toy_family

    toy = json.loads((harness.ROOT / cells.TOY).read_text())
    assert toy["family"] == "../tests/toy_family" and harness.family(toy) is toy_family


def test_an_unknown_family_stops_the_run_naming_the_file_it_looked_for(tmp_path):
    looked_for = str(harness.BENCH / "families" / "no_such_family.py")
    with pytest.raises(SystemExit, match=re.escape(looked_for)):
        harness.family({"family": "no_such_family"})
    cfg = json.loads(SMALL.read_text())
    cfg["family"] = "no_such_family"
    (tmp_path / "unknown.json").write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match=re.escape(looked_for)):
        cells.run(tmp_path, "s.stream", seconds=0.3, config=str(tmp_path / "unknown.json"))


def _sha(*chunks: bytes) -> str:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()


@pytest.mark.parametrize("what", ["pool0", "weights", "det_gap"])
def test_pointpillars_reads_as_before_the_seam(one_thread, what):
    if what == "pool0":
        mix = dict(traffic.load_mix("lidar_stream"), pool=4, points=[2000, 5000])
        first = traffic.cloud_pool(mix, BIG, pp.point_cloud)[0]
        assert (_sha(first.tobytes()), first.shape) == PARENT["pool0"]
        return
    geo = pp.geometry(SMALL)
    w = pp.make_weights(SEED, geo, "cpu")
    if what == "weights":
        chunks = [b for k, v in w.items() for b in (k.encode(), v.contiguous().numpy().tobytes())]
        assert (_sha(*chunks), len(w)) == PARENT["weights"]
        return
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.pipeline import Detector

    pts = pp.point_cloud(5000, traffic.rng(SEED, 9, 0)) * np.array([0.4, 0.4, 1, 1], np.float32)
    net = pp.reference_network(w, geo, "cpu")
    answers = {"control": pp.control_annos(net, pts, geo, "cpu")}
    for dtype in ("float32", "bfloat16"):
        det = Detector(load_config(SMALL, compute_dtype=dtype), device="cpu")
        det.load_state_dict({k: v.clone() for k, v in w.items()})
        answers[dtype] = det.detect(pts)
    expected = pp.reference_frame(net, pts, geo, "cpu")
    got = {k: pp.check_frame(expected, a, k).numbers["det_gap"] for k, a in answers.items()}
    assert got == PARENT["det_gap"]


@pytest.mark.parametrize("cell", ["s.stream", "s.offline"])
@pytest.mark.parametrize("trace", [False, True])
def test_toy_family_cell_is_correct(tmp_path, cell, trace):
    rc, result = cells.run(tmp_path, cell, seconds=0.5, trace=trace, limits_of=None, config=cells.TOY)
    assert rc == 0 and result["correct"] is True
    assert list(result["compared"]) == ["toy_gap"]


@pytest.mark.parametrize("cell,fault", [("s.stream", "answer_altered"), ("s.offline", "answer_altered"),
                                        ("s.offline", "half_batch_empty")])
def test_toy_family_fault_makes_the_run_not_correct(tmp_path, cell, fault):
    plant = control.FAULTS[cell.split(".")[1]][fault]
    rc, result = cells.run(tmp_path, cell, seconds=0.3, plant=lambda run: plant(run.det), limits_of=None,
                           config=cells.TOY)
    assert rc == 0 and result["correct"] is False
    got = result["compared"]["toy_gap"]
    assert got["value"] > got["limit"]


def test_a_limit_whose_number_the_family_does_not_give_fails(tmp_path):
    """The toy family under the PointPillars limits too: it gives no
    det_gap, so the run is not correct, and says so beside the limit."""
    rc, result = cells.run(tmp_path, "s.stream", seconds=0.3, limits_of=cells.NTUSL, config=cells.TOY)
    assert rc == 0 and result["correct"] is False
    assert result["compared"]["det_gap"]["value"] is None
