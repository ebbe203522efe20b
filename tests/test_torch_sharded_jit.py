"""The port's compiled sharded entry points (`parallel/mesh.py`:
`make_sharded_train_step`, `make_sharded_infer`, `make_spatial_infer`,
`make_spatial_train`, each a `utils/graphs.CapturedCall` through
`Trainer.train_step_jit` or `Detector.infer_jit`) on the CPU, where a
captured call runs op by op over its static buffers: gloo groups of 1, 2
and 4 spawned ranks (tests/test_torch_spatial.py's `Group`, which imports
this module by name in each rank: no JAX here at import), while the JAX
package's functions run in the test process from the port's seeded
weights. A rank runs each captured form beside its eager form (the same
ops: `Trainer.train_step(state, batch, mesh=...)`, `Detector.infer`,
`Detector.infer_batch` and the gathers) in lockstep, and compares them
there, so no model-sized record leaves a rank; where a check needs JAX's
step, the rank waits for the reference the test process writes.

Tolerances, each with its reason:
  * captured against eager, every step and frame, on every rank: bit for
    bit (the same ops on the same values; the copies into and out of the
    static buffers are exact), and the same collectives per call;
  * the captured data-parallel step's first step against JAX's
    `make_sharded_train_step` on two virtual devices:
    tests/test_torch_parallel.py's `check_jax` (loss rtol 1e-5, metric
    counts equal, parameters atol 2e-3, running statistics rtol 1e-5);
  * the captured spatial frame and hybrid step against JAX's
    `make_spatial_infer` / `make_spatial_train`: tests/test_torch_spatial.py's
    (valid flags equal, scores atol 2e-3, boxes rtol 5e-3 / atol 1e-2;
    loss rtol 1e-4, parameters atol 3e-3, running statistics rtol 1e-5);
  * the captured sharded inference against per-frame `infer`:
    tests/test_torch_parallel.py's (valid flags equal, scores 1e-5, boxes
    1e-4: the network at another batch sums in other orders).
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_parallel as tp
import test_torch_spatial as ts
from det3d_tpu_torch.models.pointpillars import PointPillars, init_weights
from det3d_tpu_torch.parallel import mesh as pm
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.postprocess import Detections
from det3d_tpu_torch.train.trainer import Trainer
from test_torch_tmpdirs import removed

torch.set_num_threads(1)

DP_STEPS = 3
HYBRID_STEPS = 2
INFER_FRAMES = 4
JAX_WAIT_S = 120.0  # a rank that needs JAX's reference waits this long for the test process


# --- what a rank runs ---------------------------------------------------------


def delta(before: dict, after: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def group_delta(before: dict, after: dict) -> dict:
    """`delta` of two `collective_counts` readings, by group for a grid."""
    if after and isinstance(next(iter(after.values())), dict):
        return {g: delta(before.get(g, {}), after[g]) for g in after}
    return delta(before, after)


def differing(te, se, le, ce, tc, sc, lc, cc) -> list[str]:
    """The names of what differs by a bit between an eager step's results
    and trainer and a captured step's."""
    out = [f"loss {k}" for k in le if not torch.equal(le[k], lc[k])]
    out += [f"counts {k}" for k in ce if not torch.equal(ce[k], cc[k])]
    theirs = tc.model.state_dict()
    out += [k for k, v in te.model.state_dict().items() if not torch.equal(v, theirs[k])]
    out += [f"moment {i}" for i, (a, b) in enumerate(zip(se.mu + se.nu, sc.mu + sc.nu)) if not torch.equal(a, b)]
    return out + (["step"] if se.step != sc.step else [])


def wait_for(path: Path):
    """The pickle the test process writes at `path` (None if its JAX side
    failed), waiting for it at most JAX_WAIT_S seconds."""
    deadline = time.monotonic() + JAX_WAIT_S
    while not path.exists():
        assert time.monotonic() < deadline, f"no JAX reference at {path} after {JAX_WAIT_S} s"
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def lockstep(mesh, counted, eager_trainer, eager_step, captured_trainer, captured_step, batches, first_check=None):
    """The eager and the captured step over the same local batches, one of
    each a step: what differed at each step, the collectives of each form
    per step, the captured losses, `first_check(record)`'s failure on the
    captured first step, and digests of the final weights."""
    se = pm.replicated(mesh, eager_trainer, eager_trainer.init_state(0))
    sc = pm.replicated(mesh, captured_trainer, captured_trainer.init_state(0))
    out = {"differ": [], "eager": [], "captured": [], "losses": [], "first_failure": None}
    for i, batch in enumerate(batches):
        before = pm.collective_counts(counted)
        se, le, ce = eager_step(se, batch)
        middle = pm.collective_counts(counted)
        sc, lc, cc = captured_step(sc, batch)
        out["eager"].append(group_delta(before, middle))
        out["captured"].append(group_delta(middle, pm.collective_counts(counted)))
        out["differ"].append(differing(eager_trainer, se, le, ce, captured_trainer, sc, lc, cc))
        out["losses"].append(float(lc["loss"]))
        if i == 0 and first_check is not None:
            record = dict(ts.step_record(captured_trainer, sc, lc), counts={k: v.clone() for k, v in cc.items()})
            out["first_failure"] = tp.failure(first_check, record)
            del record
    out["final"] = tp.digests(captured_trainer.model.state_dict())
    return out


def job_dp(mesh, cfg, global_batches, jax_ref: str | None = None):
    """`make_sharded_train_step` beside `train_step(mesh=...)` over the
    global batches; with `jax_ref`, the first captured step held to JAX's."""
    check = None
    if jax_ref is not None:
        def check(record):
            ref = wait_for(Path(jax_ref))
            assert ref is not None, "the JAX side failed"
            tp.check_jax(ref, dict(record, counts={k: v.numpy() for k, v in record["counts"].items()}))
    eager, captured = Trainer(cfg, device="cpu"), Trainer(cfg, device="cpu")
    out = lockstep(mesh, mesh, eager, lambda s, b: eager.train_step(s, b, mesh=mesh), captured,
                   pm.make_sharded_train_step(captured, mesh), [pm.shard_batch(mesh, b) for b in global_batches],
                   check)
    return out


def job_hybrid(mesh, cfg, dp, sp_, global_batches, jax_ref: str | None = None):
    """`make_spatial_train` beside `train_step(mesh=hybrid)` on a dp x sp
    grid; with `jax_ref`, the first captured step held to JAX's."""
    hybrid = pm.make_hybrid_mesh(dp, sp_, device="cpu")
    check = None
    if jax_ref is not None:
        def check(record):
            ref = wait_for(Path(jax_ref))
            assert ref is not None, "the JAX side failed"
            ts.assert_hybrid_close(record, ref["train_loss"], ref["train_after"], "captured vs JAX")
    eager, _ = pm.make_spatial_train(cfg, hybrid)
    captured, step = pm.make_spatial_train(cfg, hybrid)
    out = lockstep(hybrid.world, hybrid, eager, lambda s, b: eager.train_step(s, b, mesh=hybrid), captured, step,
                   [pm.shard_batch(hybrid.data, b) for b in global_batches], check)
    out["grid"] = (hybrid.data.rank, hybrid.spatial.rank)
    return out


def job_spatial_infer(mesh, cfg, frames):
    """`make_spatial_infer` beside the detector's eager `infer`, frame by
    frame: the captured detections (cloned), what differed and each form's
    collectives per frame."""
    det, infer = pm.make_spatial_infer(cfg, mesh)
    det.init_weights(0)
    out = {"outs": [], "differ": [], "eager": [], "captured": []}
    for pts, n in frames:
        before = pm.collective_counts(mesh)
        want = det.infer(torch.from_numpy(pts), int(n))
        middle = pm.collective_counts(mesh)
        got = infer(pts, n)
        out["eager"].append(delta(before, middle))
        out["captured"].append(delta(middle, pm.collective_counts(mesh)))
        out["differ"].append([f for f, a, b in zip(Detections._fields, got, want) if not torch.equal(a, b)])
        out["outs"].append(Detections(*(t.clone() for t in got)))
    return out


def job_sharded_infer(mesh, cfg, points, num_points):
    """`make_sharded_infer` beside its eager body (`infer_batch` on this
    rank's slice and the three gathers): the captured detections, what
    differed and each form's collectives per call, over two calls."""
    det = Detector(cfg, device="cpu").init_weights(0)
    infer = pm.make_sharded_infer(det, mesh)
    sl = pm.local_slice(mesh, len(points))
    out = {"differ": [], "eager": [], "captured": []}
    for shift in (0.0, 0.25):
        pts = points + np.float32(shift)
        before = pm.collective_counts(mesh)
        local = det.infer_batch(torch.from_numpy(pts[sl]), torch.from_numpy(num_points[sl]))
        want = Detections(mesh.all_gather(local.boxes), mesh.all_gather(local.scores),
                          mesh.all_gather(local.valid.to(torch.uint8)).bool())
        middle = pm.collective_counts(mesh)
        got = infer(pts, num_points)
        out["eager"].append(delta(before, middle))
        out["captured"].append(delta(middle, pm.collective_counts(mesh)))
        out["differ"].append([f for f, a, b in zip(Detections._fields, got, want) if not torch.equal(a, b)])
    out["out"] = Detections(*(t.clone() for t in got))
    return out


# --- the groups ---------------------------------------------------------------


def spatial_frames():
    return ts.frames(ts.small_cfg(), 2)


def dp_batches():
    cfg = tp.small_cfg(batch_size=tp.GLOBAL_BATCH)
    return tp.batches(cfg, DP_STEPS)


def hybrid_batches():
    return ts.hybrid_batches(ts.small_cfg(), tp.GLOBAL_BATCH, HYBRID_STEPS)


def infer_inputs():
    cfg = tp.small_cfg()
    det = Detector(cfg, device="cpu")
    padded = [det.pad_points(s["points"]) for s in tp.samples(INFER_FRAMES, seed=5)]
    return np.stack([p for p, _ in padded]), np.array([n for _, n in padded], np.int32)


def write_atomically(path: Path, obj) -> None:
    part = path.with_suffix(".part")
    with open(part, "wb") as f:
        pickle.dump(obj, f)
    os.replace(part, path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Groups of 1, 2 and 4 ranks, run while JAX's sharded step, spatial
    frame and hybrid step run in this process from the port's seeded
    weights and write the references that the ranks wait for."""
    tmp = tmp_path_factory.mktemp("sharded_jit")
    dp_cfg = tp.small_cfg(batch_size=tp.GLOBAL_BATCH)
    sp_cfg = ts.small_cfg()
    hybrid_cfg = sp_cfg.replace(batch_size=tp.GLOBAL_BATCH)
    points, num_points = infer_inputs()
    dp_ref, hybrid_ref = tmp / "jax_dp.pkl", tmp / "jax_hybrid.pkl"
    one = ts.Group(1, tmp / "one", [
        ("dp", job_dp, dict(cfg=dp_cfg, global_batches=dp_batches())),
        ("hybrid", job_hybrid, dict(cfg=sp_cfg.replace(batch_size=2), dp=1, sp_=1,
                                    global_batches=ts.hybrid_batches(sp_cfg, 2, HYBRID_STEPS))),
        ("spatial_infer", job_spatial_infer, dict(cfg=sp_cfg, frames=spatial_frames())),
        ("sharded_infer", job_sharded_infer, dict(cfg=tp.small_cfg(), points=points, num_points=num_points)),
    ])
    two = ts.Group(2, tmp / "two", [
        ("dp", job_dp, dict(cfg=dp_cfg, global_batches=dp_batches(), jax_ref=str(dp_ref))),
        ("hybrid", job_hybrid, dict(cfg=sp_cfg.replace(batch_size=2), dp=1, sp_=2,
                                    global_batches=ts.hybrid_batches(sp_cfg, 2, HYBRID_STEPS))),
        ("spatial_infer", job_spatial_infer, dict(cfg=sp_cfg, frames=spatial_frames())),
        ("sharded_infer", job_sharded_infer, dict(cfg=tp.small_cfg(), points=points, num_points=num_points)),
    ])
    four = ts.Group(4, tmp / "four", [
        ("dp", job_dp, dict(cfg=dp_cfg, global_batches=dp_batches())),
        ("hybrid", job_hybrid, dict(cfg=hybrid_cfg, dp=2, sp_=2, global_batches=hybrid_batches(),
                                    jax_ref=str(hybrid_ref))),
        ("sharded_infer", job_sharded_infer, dict(cfg=tp.small_cfg(), points=points, num_points=num_points)),
    ])
    import test_torch_parity_utils as pu

    jax_out = {}
    try:
        sd = {k: v.clone() for k, v in init_weights(PointPillars(dp_cfg), 0).state_dict().items()}
        jax_out["dp"] = tp.jax_sharded_step(sd)
        write_atomically(dp_ref, {k: jax_out["dp"][k] for k in ("loss", "counts", "after")})
        jax_out["spatial"] = ts.jax_spatial(pu.small_cfg().replace(pack_w=False), ts.port_state_dict(),
                                            spatial_frames(), ts.scenes(sp_cfg, tp.GLOBAL_BATCH, seed=10), sps=(2,))
        write_atomically(hybrid_ref, {k: jax_out["spatial"][k] for k in ("train_loss", "train_after")})
    finally:
        for path in (dp_ref, hybrid_ref):
            if not path.exists():
                write_atomically(path, None)  # the ranks stop waiting and fail by name
        by_world = {1: one.results(), 2: two.results(), 4: four.results()}
    yield dict(by_world=by_world, jax=jax_out)
    removed(tmp)


JOB_WORLDS = [("dp", 1), ("dp", 2), ("dp", 4), ("hybrid", 1), ("hybrid", 2), ("hybrid", 4), ("spatial_infer", 1),
              ("spatial_infer", 2), ("sharded_infer", 1), ("sharded_infer", 2), ("sharded_infer", 4)]


# --- no process group needed ----------------------------------------------------


def card_gloo(rank=0, world=1) -> pm.DataMesh:
    return pm.DataMesh(None, rank, world, torch.device("cuda", 0), "gloo")


@pytest.mark.parametrize("form", ["make_sharded_train_step", "make_sharded_infer", "make_spatial_infer",
                                  "make_spatial_train"])
def test_a_gloo_group_on_a_card_raises_by_name(form):
    """gloo stages CUDA tensors through the host, which no graph holds: each
    captured form on such a group raises at its first call, before its
    warm-ups (the model runs on the CPU here; the check reads the group)."""
    cfg = tp.small_cfg(batch_size=2)
    match = "a gloo group on cuda:0 cannot be captured in a CUDA graph"
    if form == "make_sharded_train_step":
        trainer = Trainer(cfg, device="cpu")
        with pytest.raises(ValueError, match=match):
            pm.make_sharded_train_step(trainer, card_gloo())(trainer.init_state(0), tp.batches(cfg, 1)[0])
        assert trainer.train_step_jit.captures == 0
    elif form == "make_sharded_infer":
        points, num_points = infer_inputs()
        with pytest.raises(ValueError, match=match):
            pm.make_sharded_infer(Detector(cfg, device="cpu"), card_gloo())(points, num_points)
    elif form == "make_spatial_infer":
        # make_spatial_infer puts its detector on the group's device: its
        # captured frame is the detector's infer_jit
        with pytest.raises(ValueError, match=match):
            Detector(ts.small_cfg(), device="cpu", spatial=card_gloo()).infer_jit
    else:
        grid = pm.HybridMesh(card_gloo(), card_gloo(), card_gloo())
        trainer = Trainer(ts.small_cfg(batch_size=2), device="cpu", spatial=grid.spatial, fence=False)
        with pytest.raises(ValueError, match=match):
            trainer.train_step_jit(trainer.init_state(0), ts.hybrid_batches(ts.small_cfg(), 2, 1)[0], mesh=grid)


# --- one, two and four ranks ---------------------------------------------------------


@pytest.mark.parametrize("job,world", JOB_WORLDS)
def test_captured_forms_are_bit_equal_to_the_eager_forms(job, world, runs):
    """Every step (the chained steps of the data-parallel and the hybrid
    step) and every call, on every rank."""
    results = runs["by_world"][world][job]
    assert len(results) == world
    for r, run in enumerate(results):
        assert all(not d for d in run["differ"]), f"rank {r}: {run['differ']}"
        assert len(run["differ"]) == {"dp": DP_STEPS, "hybrid": HYBRID_STEPS, "spatial_infer": 2,
                                      "sharded_infer": 2}[job]


@pytest.mark.parametrize("job,world", JOB_WORLDS)
def test_collectives_per_call_are_the_eager_forms(job, world, runs):
    """`collective_counts` moves by the same collectives a call in either
    form: the written counts of tests/test_torch_parallel.py and
    tests/test_torch_spatial.py."""
    n_convs, n_norms = ts.N_CONVS, ts.N_NORMS
    want = {"dp": {"all_reduce": tp.STEP_ALL_REDUCES},
            "hybrid": {"spatial": {"all_gather": 2 * n_convs + 1, "all_reduce": 2 * n_norms},
                       "data": {"all_reduce": 6}, "world": {"all_reduce": 1}},
            "spatial_infer": {"all_gather": n_convs + 1, "all_reduce": n_norms},
            "sharded_infer": {"all_gather": 3}}[job]
    for run in runs["by_world"][world][job]:
        assert run["eager"] == run["captured"] == [want] * len(run["differ"])


@pytest.mark.parametrize("job,world", [("dp", 1), ("dp", 2), ("dp", 4), ("hybrid", 1), ("hybrid", 2),
                                       ("hybrid", 4)])
def test_captured_steps_chain_with_equal_weights_on_every_rank(job, world, runs):
    results = runs["by_world"][world][job]
    for run in results:
        assert np.isfinite(run["losses"]).all() and run["losses"] == results[0]["losses"]
        tp.assert_same_digests(run["final"], results[0]["final"], "final weights")
    if job == "hybrid":
        sp_ = min(world, 2)  # the grids (1, 1), (1, 2) and (2, 2)
        assert [run["grid"] for run in results] == [divmod(r, sp_) for r in range(world)]


def test_captured_dp_step_matches_jax_sharded_step(runs):
    """Checked on each rank of the two-rank group (`check_jax`)."""
    assert runs["jax"]["dp"]["tcfg"] == tp.small_cfg(batch_size=tp.GLOBAL_BATCH)
    for r, run in enumerate(runs["by_world"][2]["dp"]):
        assert run["first_failure"] is None, f"rank {r}: {run['first_failure']}"


def test_captured_hybrid_step_matches_jax_make_spatial_train(runs):
    """The (2, 2) grid's first captured step, checked on each rank
    (`assert_hybrid_close`)."""
    for r, run in enumerate(runs["by_world"][4]["hybrid"]):
        assert run["first_failure"] is None, f"rank {r}: {run['first_failure']}"


@pytest.mark.parametrize("world", [1, 2])
def test_captured_spatial_frame_matches_jax_make_spatial_infer(world, runs):
    """At sp 2 against JAX's sp 2; a group of one against it too (the same
    function of the frame)."""
    for r, run in enumerate(runs["by_world"][world]["spatial_infer"]):
        for i, want in enumerate(runs["jax"]["spatial"]["infer"][2]):
            ts.assert_detections_close(run["outs"][i], want, f"rank {r} frame {i}")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_captured_sharded_infer_matches_per_frame_infer(world, runs):
    cfg = tp.small_cfg()
    det = Detector(cfg, device="cpu").init_weights(0)
    points, num_points = infer_inputs()
    results = runs["by_world"][world]["sharded_infer"]
    for run in results:
        for a, b in zip(run["out"], results[0]["out"]):
            assert torch.equal(a, b)
    out = results[0]["out"]
    assert out.boxes.shape[0] == INFER_FRAMES
    for i in range(INFER_FRAMES):
        single = det.infer(torch.from_numpy(points[i] + np.float32(0.25)), int(num_points[i]))
        np.testing.assert_array_equal(out.valid[i].numpy(), single.valid.numpy())
        np.testing.assert_allclose(out.scores[i].numpy(), single.scores.numpy(), atol=1e-5)
        np.testing.assert_allclose(out.boxes[i].numpy(), single.boxes.numpy(), atol=1e-4)
