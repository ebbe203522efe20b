"""The port's recorder (`utils/timing.py`): host spans, counters and the
stage marks of a captured call, on while a profiler runs.

On the CPU a captured call runs op by op and its marks are host stamps, so
these tests hold the bookkeeping: nothing recorded, no clock read and no
wait without a profiler; one `detect` under `timing.trace()` gives one
root with its children in place and one call id; the marks in order; the
rows staged and real; the profiler's `det3d.*` ranges; the bound on the
buffers; no mark in an exported program; `infer --breakdown` read from
the marks. The `gpu`-marked tests capture on the card and skip here
(decided in the `cuda` fixture); this file imports nothing of JAX:
`python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_tracing.py`.

Tolerances: the stage times of a replay sum to its first-to-last span
within 5 % (they telescope; the slack is the events' own rounding), and
the captured outputs with and without marks are bit-equal (the same
kernels on the same inputs, cuDNN deterministic).
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.data.synthetic import sample_scene
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.utils import timing
from test_torch_tmpdirs import tmp_path  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")
MARKS = ["start", "voxelize", "preprocess", "neck", "network", "decode", "postprocess"]
OLD_MARKS = ["start", "preprocess", "network", "postprocess"]   # the marks before `neck` and `decode` came
CHILDREN = {"pad", "call.stage", "call.launch", "annos.fetch", "annos.format"}


def small_cfg(**kw):
    """The 32x32-grid geometry of chip_smoke.small_config."""
    return load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5,
        "max_points": 4096, "max_gt_boxes": 8, "compute_dtype": "float32", **kw,
    })


def clouds(cfg, n: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [sample_scene(cfg, rng, (2, 5), ground_points=1000 + 300 * i)["points"] for i in range(n)]


@pytest.fixture(scope="module")
def det():
    return Detector(small_cfg(), CPU).init_weights(0)


@pytest.fixture(autouse=True)
def empty_recorder():
    timing.reset()
    yield
    timing.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m gpu)")
    return torch.device("cuda")


def recorded():
    return timing.spans(), timing.counters(), timing.replays()


def test_no_profiler_records_nothing_reads_no_clock_and_waits_for_nothing(det, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("called with the recorder off")

    monkeypatch.setattr(timing, "time", types.SimpleNamespace(perf_counter_ns=refuse))
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "query", refuse)
    assert not timing.recording()
    cfg = det.cfg
    for points in clouds(cfg, 2):
        det.detect(points)
    padded = [det.pad_points(p) for p in clouds(cfg, 4, seed=1)]
    det.infer_batch_jit(np.stack([p for p, _ in padded]), np.asarray([n for _, n in padded], np.int32))
    assert recorded() == ([], {}, [])


def test_one_detect_is_one_root_with_its_children_and_marks(det, tmp_path):  # noqa: F811
    points = clouds(det.cfg, 1)[0]
    det.detect(points)                      # outside the profiler: nothing
    with timing.trace(tmp_path):
        assert timing.recording()
        det.detect(points)
    assert not timing.recording()
    spans, counters, replays = recorded()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["detect"]
    root = roots[0]
    children = [s for s in spans if s.parent is not None]
    assert {s.name for s in children} == CHILDREN and len(children) == len(CHILDREN)
    for s in children:
        assert s.parent == root.id and s.call == root.call, s
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns, s
    order = sorted(children, key=lambda s: s.start_ns)
    assert [s.name for s in order] == ["pad", "call.stage", "call.launch", "annos.fetch", "annos.format"]
    for a, b in zip(order, order[1:]):
        assert a.end_ns <= b.start_ns
    launch = next(s for s in children if s.name == "call.launch")
    (replay,) = replays
    assert replay.call == root.call
    assert [m for m, _ in replay.marks] == MARKS
    ms = [t for _, t in replay.marks]
    assert ms[0] == 0.0 and all(a <= b for a, b in zip(ms, ms[1:]))
    assert ms[-1] <= (launch.end_ns - launch.start_ns) / 1e6
    n = int(det.pad_points(points)[1])
    assert counters == {"call.replays": 1, "call.rows_staged": det.cfg.max_points, "call.rows_real": n,
                        "nms.rows": len(det.cfg.class_specs)}
    assert [m for m, _ in replay.marks if m in OLD_MARKS] == OLD_MARKS


@pytest.mark.parametrize("batch", [1, 4])
def test_rows_staged_and_real_are_what_was_fed(det, batch, tmp_path):  # noqa: F811
    padded = [det.pad_points(p) for p in clouds(det.cfg, batch, seed=batch)]
    points = np.stack([p for p, _ in padded])
    counts = np.asarray([n for _, n in padded], np.int32)
    with timing.trace(tmp_path):
        for _ in range(2):
            det.infer_batch_jit(points, counts)
    spans, counters, replays = recorded()
    assert counters == {"call.replays": 2, "call.rows_staged": 2 * batch * det.cfg.max_points,
                        "call.rows_real": 2 * int(counts.sum()), "nms.rows": 2 * batch * len(det.cfg.class_specs)}
    assert sorted(s.name for s in spans) == ["call.launch"] * 2 + ["call.stage"] * 2
    calls = sorted({s.call for s in spans})
    assert len(calls) == 2 and all(s.parent is None for s in spans)   # no detect: the call's own id
    assert sorted(r.call for r in replays) == calls
    assert all([m for m, _ in r.marks] == MARKS for r in replays)


@pytest.mark.parametrize("batch", [0, 2])
def test_a_center_replay_carries_its_marks_in_order(batch, tmp_path):  # noqa: F811
    """The center model (CenterPoint-PP at every published width on a
    64x64 grid): a captured frame's or batch's replay marks start,
    voxelize, preprocess, neck, network, decode, postprocess in order (no
    anchor mask: voxelize falls next to preprocess), and counts a
    row of NMS a task of each frame."""
    cfg = load_config("benchmark/configs/centerpoint_pp_nusc.json", compute_dtype="float32", max_voxels=256,
                      max_points=4096, detection_range=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0])
    det = Detector(cfg, CPU).init_weights(0)
    rng = np.random.default_rng(batch)
    points = [np.concatenate([rng.uniform(-6, 6, (3000, 2)), rng.uniform(-3, 1, (3000, 1)),
                              rng.uniform(0, 255, (3000, 1)), rng.uniform(0, 0.45, (3000, 1))], 1).astype(np.float32)
              for _ in range(max(batch, 1))]
    with timing.trace(tmp_path):
        if batch:
            padded = [det.pad_points(p) for p in points]
            det.infer_batch_jit(np.stack([p for p, _ in padded]), np.asarray([n for _, n in padded], np.int32))
        else:
            det.detect(points[0])
    (replay,) = timing.replays()
    assert [m for m, _ in replay.marks] == MARKS
    ms = [t for _, t in replay.marks]
    assert all(a <= b for a, b in zip(ms, ms[1:]))
    assert timing.counters()["nms.rows"] == max(batch, 1) * len(cfg.tasks)


@pytest.mark.parametrize("entry", ["detect", "infer_batch_jit"])
def test_voxelize_is_marked_between_start_and_preprocess(det, entry, tmp_path):  # noqa: F811
    """The voxelizer's own mark: right after the op `det3d::voxelize`, before
    the anchor mask, in a frame's replay and in a batch's."""
    points = clouds(det.cfg, 2, seed=5)
    with timing.trace(tmp_path):
        if entry == "detect":
            det.detect(points[0])
        else:
            padded = [det.pad_points(p) for p in points]
            det.infer_batch_jit(np.stack([p for p, _ in padded]), np.asarray([n for _, n in padded], np.int32))
    (replay,) = timing.replays()
    assert [m for m, _ in replay.marks][:3] == ["start", "voxelize", "preprocess"]
    ms = [t for _, t in replay.marks]
    assert ms[0] <= ms[1] <= ms[2]


def test_the_profiler_trace_holds_the_spans_as_ranges(det, tmp_path):  # noqa: F811
    with timing.trace(tmp_path):
        for points in clouds(det.cfg, 2):
            det.detect(points)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = sorted(e["name"] for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith("det3d."))
    assert ranges == sorted(f"det3d.{s.name}" for s in timing.spans())
    assert ranges.count("det3d.detect") == 2 and ranges.count("det3d.annos.fetch") == 2


def test_the_buffers_stay_bounded():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(timing.KEEP + 10):
            with timing.span("s"):
                pass
            timing.count("c", 1)
    spans = timing.spans()
    assert len(spans) == timing.KEEP and timing.counters() == {"c": timing.KEEP}
    assert spans[0].start_ns <= spans[-1].start_ns


def test_spans_on_another_thread_record_nothing(det, tmp_path):  # noqa: F811
    import threading

    points = clouds(det.cfg, 1)[0]
    with timing.trace(tmp_path):
        t = threading.Thread(target=det.detect, args=(points,))
        t.start()
        t.join(timeout=120)
    assert not t.is_alive()
    assert recorded() == ([], {}, [])


def test_the_exported_program_holds_no_mark(tmp_path):  # noqa: F811
    from det3d_tpu_torch.deploy.export import PROGRAM, export_detector

    cfg = small_cfg()
    with timing.trace(tmp_path / "trace"), timing.marking(cuda=False) as marks:
        export_detector(cfg, out_dir=tmp_path / "art", device="cpu")
    assert marks == []
    program = torch.export.load(str(tmp_path / "art" / PROGRAM))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert not [t for t in targets if "record" in t.lower() or "event" in t.lower() or "timing" in t.lower()]
    assert timing.replays() == []


@pytest.mark.parametrize("batch", [1, 2])
def test_infer_breakdown_reads_the_marks(batch, capsys):
    from det3d_tpu_torch.apps.infer_app import BREAKDOWN_CALLS, infer

    out = infer(small_cfg(), synthetic=True, num_frames=2, range_thresholds=(80.0,), breakdown=True,
                device="cpu", batch=batch)
    assert set(out["stages"]) == {"e2e", "pre", "net", "post"}
    assert all(np.isfinite(v) and v > 0 for v in out["stages"].values()), out["stages"]
    assert len(timing.replays()) == BREAKDOWN_CALLS
    printed = capsys.readouterr().out
    assert "breakdown host ms" in printed and "call.launch" in printed and "annos.fetch" in printed


# -- on the card ----------------------------------------------------------
@pytest.mark.gpu
def test_the_captured_frame_times_its_stages(cuda, tmp_path):  # noqa: F811
    det = Detector(small_cfg(), cuda).init_weights(0)
    frames = clouds(det.cfg, 6)
    det.detect(frames[0])                              # warm-ups and the capture
    with timing.trace(tmp_path):
        for points in frames[1:]:
            det.detect(points)
    detects = {s.call: s for s in timing.spans() if s.name == "detect"}
    replays = timing.replays()
    assert len(replays) == len(frames) - 1 and {r.call for r in replays} == set(detects)
    for r in replays:
        assert [m for m, _ in r.marks] == MARKS
        stages = [b - a for (_, a), (_, b) in zip(r.marks, r.marks[1:])]
        assert all(s > 0 for s in stages), r
        span = r.marks[-1][1] - r.marks[0][1]
        assert abs(sum(stages) - span) <= 0.05 * span
        d = detects[r.call]
        assert span <= (d.end_ns - d.start_ns) / 1e6, (r, d)


@pytest.mark.gpu
def test_marks_leave_the_outputs_bit_equal(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = small_cfg()
    marked = Detector(cfg, cuda).init_weights(0)
    plain = Detector(cfg, cuda).init_weights(0)
    frames = [marked.pad_points(p) for p in clouds(cfg, 4, seed=7)]
    got = [[t.clone() for t in marked.infer_jit(p, n)] for p, n in frames]
    with monkeypatch.context() as m:
        m.setattr(timing, "mark", lambda name: None)
        want = [[t.clone() for t in plain.infer_jit(p, n)] for p, n in frames[:1]]
    want += [[t.clone() for t in plain.infer_jit(p, n)] for p, n in frames[1:]]
    assert len(marked.infer_jit.call._marks) == len(MARKS) and plain.infer_jit.call._marks == []
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
