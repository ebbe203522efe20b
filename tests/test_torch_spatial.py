"""The port's spatial modes (`det3d_tpu_torch/parallel/spatial.py` and the
spatial half of `parallel/mesh.py`) on the CPU: one frame's RPN split
along x over gloo groups of 2 and 4 ranks, each a process started by
`multiprocessing`'s spawn with a `file://` rendezvous under the test's
temporary directory (tests/test_torch_parallel.py's harness). A group runs
every job of its size in one session and imports this module by name,
which imports no JAX; the JAX package's spatial modes run in the test
process, on the conftest's virtual CPU devices.

Configs: the port's copies of `__graft_entry__._small_cfg` (32x32 grid, 4
coarse rows: 2/2 and 1/1/1/1 at sp 2 and 4) and of tools/make_golden's mid
config (200x200, 25 coarse rows: 13/12 and 7/6/6/6, the uneven splits).

Tolerances, each with its reason:
  * the halo exchange and the preds gather only move values: equal, and
    the halo exchange's transpose test in float64 within 1e-12 relative;
  * the spatial RPN (f32) against the one-process RPN: features within
    rtol 1e-5 / atol 2e-5 (the InstanceNorm sums taken per slab and then
    added, and convolutions over slabs with halo rows in place of padding:
    other summation orders; 1.2e-5 measured at the mid config, in 9 of its
    3.2M features, sp 2 and 4, and under 1e-5 at the small one); the input
    gradient, and the weight gradients summed over the ranks, by tests/
    test_torch_layouts.py's norm rule, |Δg| within 1e-2 of |g| per tensor
    (at the mid config the one-process input gradient is the less exact
    one: 7.4e-4 of its norm from a float64 reference, the spatial one
    1.1e-4, as its float32 sums run over half or a quarter of the map);
  * spatial inference against the one-process detector and against JAX's
    `make_spatial_infer`: valid flags equal, scores within atol 2e-3,
    boxes within rtol 5e-3 / atol 1e-2 (tests/test_parallel.py's
    `test_spatially_partitioned_infer_matches_single_device`);
  * the hybrid step against the one-process step and against JAX's
    `make_spatial_train`: loss rtol 1e-4, parameters atol 3e-3
    (tests/test_parallel.py's `test_hybrid_step_matches_single_device`:
    Adam's first update is about lr·sign(g), so a gradient within rounding
    of 0 moves its weight up to 2·lr); running statistics rtol 1e-5 (the
    PFN runs whole on every rank); the gradients by the norm rule above,
    against the one-process step at dp 1 and against the data-parallel
    step (`make_sharded_train_step`) at dp 2: at this batch any split of
    it over two data ranks moves the gradients of block 2 by up to 1.9 %
    of their norm from the one-process step's (the data-parallel step
    alike, and the hybrid step equals it within 1e-5), so at dp 2 the
    one-process step holds the norm rule over all gradients together; the
    metric counts within 1 (a score within rounding of a threshold crosses
    it: one false positive, in the data-parallel step alike);
  * the apps against one process: infer's annos at the inference
    tolerances above; train's weights after 2 steps at lr 1e-6 within
    2 · 2·lr (tests/test_torch_apps.py's reason).
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import pickle
import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_parallel as tp
from det3d_tpu_torch.apps import infer_app, serve_app, train_app
from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.models.pointpillars import PointPillars, init_weights
from det3d_tpu_torch.parallel import mesh as pm
from det3d_tpu_torch.parallel import spatial as sp
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.postprocess import Detections
from det3d_tpu_torch.train.trainer import Trainer, host_batch
from test_torch_tmpdirs import removed, tmp_path  # noqa: F401

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 150.0
N_CONVS, N_NORMS = 16, 19  # the RPN's 3x3 convolutions and InstanceNorms
LR_APP = 1e-6
# the CLI's config: a 32x32 grid with the default anchors, bf16 (computed in
# f32 on the CPU, with a notice), batch 2
CLI_CONFIG = {"detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
              "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0], "voxel_size": [1.0, 1.0, 11.0],
              "max_voxels": 128, "max_num_points": 5, "max_points": 2048, "max_gt_boxes": 8,
              "compute_dtype": "bfloat16", "batch_size": 2}


def small_cfg(**kw):
    """__graft_entry__._small_cfg in the port's own config."""
    cfg = load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5], "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5, "max_points": 2048,
        "max_gt_boxes": 8, "compute_dtype": "float32",
    })
    specs = tuple(dataclasses.replace(s, feature_map_size=(16, 16, 1)) for s in cfg.class_specs)
    specs = (dataclasses.replace(specs[0], sizes=((4.6, 2.10, 1.8),)),) + specs[1:]
    return cfg.replace(class_specs=specs, **kw)


def mid_cfg():
    """tools/make_golden.mid_cfg in the port's own config."""
    return load_config({
        "detection_range": [-50.0, -50.0, -2.5, 50.0, 50.0, 8.5], "center_limit": [-50.0, -50.0, -10.0, 50.0, 50.0, 10.0],
        "voxel_size": [0.5, 0.5, 11.0], "max_voxels": 2000, "max_num_points": 8, "max_points": 20000,
        "max_gt_boxes": 16, "compute_dtype": "float32",
    })


def scenes(cfg, k, seed=0):
    """k scenes over the whole range (every slab gets points): uniform
    points and two cars."""
    rng = np.random.RandomState(seed)
    half = cfg.detection_range[3] - 1.0
    out = []
    for _ in range(k):
        n = 1500
        pts = np.concatenate([rng.uniform(-half, half, (n, 2)), rng.uniform(-2, 6, (n, 1)),
                              rng.uniform(0, 1, (n, 1))], 1).astype(np.float32)
        cx = rng.uniform(-half + 3, half - 3, 2)
        gt = np.array([[cx[0], rng.uniform(-8, 8), -1.5, 4.6, 2.1, 1.8, 0.3],
                       [cx[1], rng.uniform(-8, 8), -1.5, 4.6, 2.1, 1.8, -1.2]], np.float32)
        out.append({"points": pts, "gt_boxes": gt, "gt_classes": np.array([1, 1], np.int32)})
    return out


def frames(cfg, k, seed=3):
    det_pad = Detector(cfg, device="cpu").pad_points
    return [det_pad(s["points"]) for s in scenes(cfg, k, seed)]


# --- what a rank runs ---------------------------------------------------------


def delta(before: dict, after: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def job_rpn(mesh, cfg, x, cot):
    """The spatial RPN on this rank's slab of the canvas x (B, 64, nx, ny),
    forward and backward against the cotangent cot (B, 320, nx/2, ny/2)."""
    model = init_weights(PointPillars(cfg), 0)
    plan = sp.SpatialPlan.of(mesh, cfg.grid_size[0])
    lo, hi = plan.rows(0)
    xs = torch.from_numpy(x[:, :, lo:hi]).contiguous(memory_format=torch.channels_last).requires_grad_()
    before = dict(mesh.collectives)
    out = model.rpn(xs, spatial=plan)
    fwd = delta(before, mesh.collectives)
    lo1, hi1 = plan.rows(1)
    before = dict(mesh.collectives)
    (out * torch.from_numpy(cot[:, :, lo1:hi1])).sum().backward()
    bwd = delta(before, mesh.collectives)
    # the weight gradients summed over the ranks (outside the counted
    # collectives), shipped by rank 0 alone
    grads = {n: p.grad.clone() for n, p in model.rpn.named_parameters()}
    for g in grads.values():
        torch.distributed.all_reduce(g, group=mesh.group)
    return dict(out=out.detach(), dx=xs.grad, rows=(lo, hi), fwd=fwd, bwd=bwd,
                grads_summed=grads if mesh.rank == 0 else None)


def job_collectives(mesh, x, y, preds, cot):
    """The halo exchange (float64) and the preds gather on this rank's
    slabs of global maps."""
    bounds = sp.slab_bounds(x.shape[2], mesh.world)[0]
    lo, hi = bounds[mesh.rank]
    xs = torch.from_numpy(x[:, :, lo:hi]).requires_grad_()
    halo = sp.halo_exchange(xs, mesh)
    ys = torch.from_numpy(y[mesh.rank])
    (halo * ys).sum().backward()
    pbounds = sp.slab_bounds(x.shape[2], mesh.world)[sp.LEVELS]  # the 5 coarse rows
    plo, phi = pbounds[mesh.rank]
    local = {k: torch.from_numpy(v[:, :, :, plo:phi]).requires_grad_() for k, v in preds.items()}
    whole = sp.gather_rows(local, mesh, pbounds)
    torch.stack([(whole[k] * torch.from_numpy(cot[k])).sum() for k in whole]).sum().backward()
    return dict(halo=halo.detach(), rows=(lo, hi), hx_y=float((halo * ys).sum()), x_hty=float((xs * xs.grad).sum()),
                whole={k: v.detach() for k, v in whole.items()}, pgrad={k: v.grad for k, v in local.items()},
                prows=(plo, phi))


def job_infer(mesh, cfg, frames, state_dict=None):
    """`make_spatial_infer` over the frames, counting the scatter and NMS
    calls and the collectives of each frame."""
    det, infer = pm.make_spatial_infer(cfg, mesh)
    if state_dict is None:
        det.init_weights(0)
    else:
        det.load_state_dict(state_dict)
    calls = {"scatter": 0, "nms": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    det.model.scatter = counted("scatter", det.model.scatter)
    det.postprocess.nms_keep = counted("nms", det.postprocess.nms_keep)
    outs, per_frame = [], []
    for pts, n in frames:
        before = dict(mesh.collectives)
        out = infer(pts, n)
        # cloned: the captured call's outputs are its buffers, which the next frame overwrites
        outs.append(Detections(*(t.clone() for t in out)))
        per_frame.append(delta(before, mesh.collectives))
    return dict(outs=outs, calls=calls, collectives=per_frame)


def step_record(trainer, state, loss) -> dict:
    return dict(loss={k: float(v) for k, v in loss.items()},
                sd={k: v.clone() for k, v in trainer.model.state_dict().items()},
                grads={n: p.grad.clone() for n, p in trainer.model.named_parameters()})


def job_hybrid(mesh, cfg, dp, sp_, global_batches, state_dict=None, augment=False, first="record"):
    """`make_spatial_train` on a dp x sp grid of the world, a step per
    global batch: the first step's collectives and, by `first`, its record
    ("record"), its check against the one-process step made here
    ("check", dp 1) or neither (None); the losses and digests of the final
    weights; with `augment`, the device augmentation's draws."""
    hybrid = pm.make_hybrid_mesh(dp, sp_, device="cpu")
    trainer, step = pm.make_spatial_train(cfg, hybrid, device_global_augment=augment, aug_seed=0)
    if state_dict is not None:
        trainer.detector.load_state_dict(state_dict)
    state = pm.replicated(hybrid.world, trainer, trainer.init_state(None if state_dict is not None else 0))
    out = {"losses": [], "data_rank": hybrid.data.rank, "spatial_rank": hybrid.spatial.rank}
    for i, gb in enumerate(global_batches):
        local = pm.shard_batch(hybrid.data, gb)
        if augment and i == 0:
            out["draws"] = trainer.augment_params(state.step, len(local.points), hybrid.data.rank)
        before = pm.collective_counts(hybrid)
        state, loss, counts = step(state, local)
        if i == 0:
            after = pm.collective_counts(hybrid)
            out["collectives"] = {g: delta(before[g], after[g]) for g in after}
            record = dict(step_record(trainer, state, loss), counts={k: v.clone() for k, v in counts.items()})
            if first == "record":
                out["first"] = record
            elif first == "check":
                want = one_process_steps(cfg, global_batches[:1], state_dict)[0]
                out["first_failure"] = tp.failure(check_first_hybrid, record, want)
            del record
        out["losses"].append(float(loss["loss"]))
    out["final"] = tp.digests(trainer.model.state_dict())
    return out


def job_infer_app(mesh, cfg, frames):
    out = infer_app.infer(cfg, synthetic=True, num_frames=frames, range_thresholds=(80.0,), breakdown=True,
                          device="cpu", mesh=mesh, spatial=True)
    return None if out is None else out["dt_annos"]


def job_train_app(mesh, cfg, model_dir):
    summary = train_app.train(cfg, max_steps=2, display_step=1, save_step=2, eval_step=2, eval_frames=2,
                              synthetic=True, seed=0, model_dir=model_dir, device="cpu", mesh=mesh, spatial_shards=2)
    sd = summary["trainer"].model.state_dict()
    return {"sd": sd if mesh.rank == 0 else None, "sd_digests": tp.digests(sd), "steps": summary["steps"],
            "saves": len(summary["save_s"]), "evals": len(summary["eval_strs"])}


def job_serve(mesh, cfg, n_frames, replay_dir):
    """`serve_synthetic`, then `serve_replay` of `replay_dir`, with a
    spatial group: every frame each rank ran, with its points and
    detections."""
    server = serve_app.make_server(cfg, device="cpu", spatial=mesh)
    det = server.detector
    ran = []
    infer = det.infer_jit  # what every rank runs a frame through (`infer_fn`)

    def recording(points, num_points):
        out = infer(points, num_points)
        # cloned: the captured call's outputs are its buffers, which the next frame overwrites
        ran.append((points.clone(), int(num_points), Detections(*(t.clone() for t in out))))
        return out

    det.infer_jit = recording
    stats = serve_app.serve_synthetic(cfg, frames=n_frames, hz=4.0, server=server)
    ran_synthetic = list(ran)
    replay = serve_app.serve_replay(cfg, replay_dir, hz=4.0, server=serve_app.make_server(cfg, device="cpu",
                                                                                          spatial=mesh))
    return {"ran": ran_synthetic, "served": len(stats), "dropped": stats.dropped, "replayed": len(replay)}


JOBS = {"echo": tp.job_echo, "rpn": job_rpn, "collectives": job_collectives, "infer": job_infer, "hybrid": job_hybrid, "dp": tp.job_steps,
        "infer_app": job_infer_app, "train_app": job_train_app, "serve": job_serve}


def rank_session(rank: int, world: int, init: str, out_dir: str, jobs: list, cli: list) -> None:
    """A rank's process: join the group, run the jobs in order, write each
    result to `out_dir`; then leave the group and run each command of `cli`
    ([(MASTER_PORT, argv)]) as `torchrun` would start it."""
    import torch.distributed as dist

    from det3d_tpu_torch import cli as cli_main

    torch.set_num_threads(1)
    mesh = pm.make_mesh(device="cpu", rank=rank, world_size=world, init_method=init)
    try:
        for name, kind, kwargs in jobs:
            result = (kind if callable(kind) else JOBS[kind])(mesh, **kwargs)
            with open(Path(out_dir) / f"{name}-{rank}.pkl", "wb") as f:
                pickle.dump(result, f)
        mesh.barrier()  # no rank leaves while another still works
    finally:
        dist.destroy_process_group()
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1")
    for port, argv in cli:
        os.environ["MASTER_PORT"] = str(port)
        cli_main.main(argv)


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class Group:
    """`world` spawned gloo ranks running `jobs` ([(name, JOBS key or a
    module-level function, kwargs)]), then the `cli` argvs; `results()` joins them → {name:
    [result of rank r]}. A rank that fails or outlives the join timeout
    fails the test."""

    def __init__(self, world: int, tmp: Path, jobs: list, cli: tuple = ()):
        tmp.mkdir(parents=True, exist_ok=True)
        self.world, self.tmp, self.jobs = world, tmp, jobs
        cli = list(zip(free_ports(len(cli)), cli))
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=rank_session, args=(r, world, f"file://{tmp}/rendezvous", str(tmp), jobs, cli))
                      for r in range(world)]
        self.deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in self.procs:
            p.start()

    def results(self) -> dict:
        try:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
            assert not hung, f"ranks {hung} of {self.world} still running after {JOIN_TIMEOUT_S} s"
            codes = [p.exitcode for p in self.procs]
            assert codes == [0] * self.world, f"rank exit codes {codes}"
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return tp.load_results(self.tmp, [name for name, _, _ in self.jobs], self.world)


# --- inputs and the JAX side ---------------------------------------------------


def rpn_inputs(cfg, b=1, seed=0):
    rng = np.random.RandomState(seed)
    nx, ny = cfg.grid_size[:2]
    x = rng.randn(b, 64, nx, ny).astype(np.float32)
    x *= rng.uniform(0, 1, (b, 1, nx, ny)) < 0.3  # a sparse canvas, as the scatter makes
    return x, rng.randn(b, 320, nx // 2, ny // 2).astype(np.float32)


def collective_inputs(world, seed=1):
    """A (2, 3, 40, 5) float64 map (5 coarse rows: uneven at 2 and 4
    ranks), each rank's halo'd cotangent, and preds of 5 rows."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, 40, 5)
    bounds = sp.slab_bounds(40, world)[0]
    y = [rng.randn(2, 3, hi - lo + 2, 5) for lo, hi in bounds]
    preds = {"cls_preds": rng.randn(1, 1, 2, 5, 4), "box_preds": rng.randn(1, 7, 2, 5, 4),
             "dir_preds": rng.randn(1, 2, 2, 5, 4)}
    cot = {k: rng.randn(*v.shape) for k, v in preds.items()}
    return dict(x=x, y=y, preds=preds, cot=cot)


HYBRID_STEPS = 2


def hybrid_batches(cfg, b, n=HYBRID_STEPS):
    return [host_batch(cfg, scenes(cfg, b, seed=10 + i)) for i in range(n)]


def port_state_dict() -> dict:
    """The port's seeded weights (`init_weights(0)`), which every rank and
    the JAX side start from."""
    return {k: v.clone() for k, v in init_weights(PointPillars(small_cfg()), 0).state_dict().items()}


def jax_spatial(jcfg, state_dict, infer_frames, train_batch, sps=(2, 4)) -> dict:
    """JAX's spatial modes on the conftest's virtual devices from the port's
    weights (through `deploy/torch_interop.state_dict_to_variables`):
    `make_spatial_infer` at each sp of `sps` over the frames, and one
    `make_spatial_train` step on `make_hybrid_mesh(2, 2)` at batch 4."""
    import jax

    import test_torch_parity_utils as pu
    from det3d_tpu.deploy.torch_interop import state_dict_to_variables
    from det3d_tpu.parallel.mesh import (make_hybrid_mesh, make_spatial_infer, make_spatial_mesh, make_spatial_train,
                                         replicated, shard_batch)
    from det3d_tpu.train.trainer import TrainState
    from det3d_tpu.train.trainer import host_batch as jax_host_batch
    from det3d_tpu_torch.weights import variables_to_state_dict

    variables = state_dict_to_variables({k: v.numpy() for k, v in state_dict.items()})
    out = {"infer": {}}
    for n in sps:
        _, infer = make_spatial_infer(jcfg, make_spatial_mesh(n))
        out["infer"][n] = [tuple(np.asarray(t) for t in infer(variables, p, c)) for p, c in infer_frames]
    jcfg4 = jcfg.replace(batch_size=4)
    mesh = make_hybrid_mesh(2, 2)
    trainer, step = make_spatial_train(jcfg4, mesh)
    state = TrainState(step=np.zeros((), np.int32), params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=trainer.optimizer.init(variables["params"]))
    new, loss, _ = step(jax.device_put(state, replicated(mesh)), shard_batch(mesh, jax_host_batch(jcfg4, train_batch)))
    out.update(train_after=variables_to_state_dict(pu.numpy_variables({"params": new.params,
                                                                        "batch_stats": new.batch_stats})),
               train_loss={k: float(v) for k, v in loss.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups of ranks, run while JAX's spatial modes compile in this
    process from the same seeded weights: every two-rank job, then the
    CLI's spatial commands under a `torchrun`-like environment; every
    four-rank job."""
    import test_torch_parity_utils as pu

    jcfg = pu.small_cfg().replace(pack_w=False)
    tmp = tmp_path_factory.mktemp("spatial")
    small, mid = small_cfg(), mid_cfg()
    tcfg = small.replace(batch_size=4)
    (tmp / "tiny.json").write_text(json.dumps(CLI_CONFIG))
    replay_dir = tmp / "drive"
    replay_dir.mkdir()
    for i, s_ in enumerate(scenes(small, 2, seed=20)):
        s_["points"].tofile(replay_dir / f"{i:06d}.bin")
    common = ["--config", str(tmp / "tiny.json"), "--synthetic", "--device", "cpu"]
    cli = (["infer", *common, "--spatial", "--frames", "2", "--out", str(tmp / "dt.pkl")],
           ["serve", *common, "--spatial", "--frames", "2", "--hz", "4"],
           ["train", *common, "--spatial-shards", "2", "--steps", "2", "--display-step", "1", "--save-step", "2",
            "--eval-step", "100", "--model-dir", str(tmp / "cli_run")])

    def common_jobs(world):
        return [
            ("rpn_small", "rpn", dict(cfg=small, x=rpn_inputs(small)[0], cot=rpn_inputs(small)[1])),
            ("rpn_mid", "rpn", dict(cfg=mid, x=rpn_inputs(mid)[0], cot=rpn_inputs(mid)[1])),
            ("collectives", "collectives", collective_inputs(world)),
            ("infer_small", "infer", dict(cfg=small, frames=frames(small, 2))),
            ("infer_mid", "infer", dict(cfg=mid, frames=frames(mid, 1))),
        ]

    two = Group(2, tmp / "two", common_jobs(2) + [
        ("hybrid12", "hybrid", dict(cfg=small_cfg(batch_size=2), dp=1, sp_=2, global_batches=hybrid_batches(small, 2),
                                    first="check")),
        ("dp", "dp", dict(cfg=tcfg, global_batches=hybrid_batches(small, 4, 1), check=None, first_grads=True)),
        ("infer_app", "infer_app", dict(cfg=small, frames=2)),
        ("train_app", "train_app", dict(cfg=small_cfg(batch_size=2, learning_rate=LR_APP), model_dir=str(tmp / "app"))),
        ("serve", "serve", dict(cfg=small, n_frames=3, replay_dir=str(replay_dir))),
    ], cli)
    four = Group(4, tmp / "four", common_jobs(4) + [
        ("hybrid14", "hybrid", dict(cfg=small_cfg(batch_size=2), dp=1, sp_=4, global_batches=hybrid_batches(small, 2),
                                    first="check")),
        ("hybrid22", "hybrid", dict(cfg=tcfg, dp=2, sp_=2, global_batches=hybrid_batches(small, 4))),
        ("hybrid_aug", "hybrid", dict(cfg=tcfg, dp=2, sp_=2, global_batches=hybrid_batches(small, 4, 1),
                                      augment=True, first=None)),
    ])
    try:
        jax_out = jax_spatial(jcfg, port_state_dict(), frames(small, 2), scenes(small, 4, seed=10))
    finally:
        by_world = {2: two.results(), 4: four.results()}
    yield dict(by_world=by_world, jax=jax_out, tcfg=jcfg, tmp=tmp)
    removed(tmp)


def fake_mesh(rank, world) -> pm.DataMesh:
    return pm.DataMesh(None, rank, world, torch.device("cpu"), "gloo")


# --- no process group needed ------------------------------------------------------


def test_group_leaves_no_pickles(tmp_path):
    """Each rank's result comes back and its pickle is gone once read."""
    out = Group(2, tmp_path / "group", [("echo", "echo", dict(value=5))]).results()
    assert out == {"echo": [{"rank": r, "world": 2, "value": 5} for r in range(2)]}
    assert not list(tmp_path.rglob("*.pkl"))


def test_configs_are_the_jax_tests_configs():
    import test_torch_parity_utils as pu

    assert pu.to_torch_cfg(pu.small_cfg()) == small_cfg()
    assert pu.to_torch_cfg(pu.mid_cfg()) == mid_cfg()


@pytest.mark.parametrize("nx,sp_,coarse", [(32, 2, [2, 2]), (32, 4, [1, 1, 1, 1]), (200, 2, [13, 12]),
                                           (200, 4, [7, 6, 6, 6]), (800, 4, [25] * 4), (1600, 3, [67, 67, 66])])
def test_slab_bounds_tile_every_level_nested_by_two(nx, sp_, coarse):
    bounds = sp.slab_bounds(nx, sp_)
    assert [hi - lo for lo, hi in bounds[sp.LEVELS]] == coarse
    for level, ranks in enumerate(bounds):
        assert ranks[0][0] == 0 and ranks[-1][1] == nx >> level
        assert all(a[1] == b[0] for a, b in zip(ranks, ranks[1:]))
        if level:
            assert [(2 * lo, 2 * hi) for lo, hi in ranks] == bounds[level - 1]


def test_slab_bounds_refuse_more_ranks_than_coarse_rows():
    """GSPMD pads a map that does not split; the port refuses (a divergence
    by decision): at most nx/8 ranks, and nx a multiple of 8."""
    with pytest.raises(ValueError, match=r"5 spatial ranks for nx=32: at most nx/8 = 4"):
        sp.slab_bounds(32, 5)
    with pytest.raises(ValueError, match="nx divisible by 8"):
        sp.slab_bounds(36, 2)
    with pytest.raises(ValueError, match="at most nx/8 = 4"):
        Detector(small_cfg(), device="cpu", spatial=fake_mesh(0, 5))


@pytest.mark.parametrize("lever", ["block0_blocked", "block0_blocked_train", "late_blocked_train"])
def test_spatial_refuses_the_layout_levers(lever):
    """The spatial path runs the dense network only; JAX drops the blocked
    levers under a canvas sharding and keeps packing (a divergence by
    decision: the port's default is dense). Without pack_w a blocked lever
    is inert and passes (the shipped configs set some)."""
    for cfg, named in ((small_cfg(pack_w=True), "pack_w"), (small_cfg(pack_w=True, **{lever: True}),
                                                            f"pack_w, {lever}")):
        with pytest.raises(ValueError, match=f"{named} with a spatial group: the spatial path runs the dense network"):
            Detector(cfg, device="cpu", spatial=fake_mesh(0, 2))
        with pytest.raises(ValueError, match="runs the dense network"):
            pm.make_spatial_train(cfg, pm.HybridMesh(fake_mesh(0, 2), fake_mesh(0, 1), fake_mesh(0, 2)))
    det = Detector(small_cfg(**{lever: True}), device="cpu", spatial=fake_mesh(0, 2))
    assert det.model.layout(1, False) == (False, False, False)


@pytest.mark.parametrize("sp_", [2, 4])
def test_slab_canvas_is_the_canvas_rows(sp_):
    """`PointPillars.slab_canvas` with the plain scatter (the CPU side of
    tests/test_torch_kernels.py's card test): each rank's slab is the full
    canvas's rows, and its backward zero for the pillars outside it."""
    cfg = mid_cfg()
    model = PointPillars(cfg)
    rng = np.random.RandomState(sp_)
    feats = torch.from_numpy(rng.randn(1, 500, 64).astype(np.float32))
    cells = rng.choice(200 * 200, 400, replace=False)
    coors = np.full((1, 500, 3), -1, np.int32)
    coors[0, :400, 0], coors[0, :400, 1], coors[0, :400, 2] = cells // 200, cells % 200, 0
    coors = torch.from_numpy(coors)
    full = model.scatter(feats, coors, (200, 200)).permute(0, 3, 1, 2)
    for r in range(sp_):
        plan = sp.SpatialPlan.of(fake_mesh(r, sp_), 200)
        lo, hi = plan.rows(0)
        f = feats.clone().requires_grad_()
        slab = model.slab_canvas(f, coors, plan)
        assert torch.equal(slab, full[:, :, lo:hi])
        slab.sum().backward()
        inside = (coors[..., 0] >= lo) & (coors[..., 0] < hi)
        assert torch.equal(f.grad, inside[..., None].float().expand_as(f))


def test_spatial_detector_refuses_a_batch():
    det = Detector(small_cfg(), device="cpu", spatial=fake_mesh(0, 1))
    with pytest.raises(ValueError, match="within one frame: no batch"):
        det.infer_batch(torch.zeros(2, 2048, 4), torch.zeros(2, dtype=torch.int32))


def test_infer_app_refuses_spatial_with_a_batch():
    with pytest.raises(ValueError, match="--spatial partitions within one frame; use it with batch=1"):
        infer_app.infer(small_cfg(), synthetic=True, batch=2, device="cpu", mesh=fake_mesh(0, 2), spatial=True)


def test_train_app_refuses_shards_that_do_not_divide(tmp_path):
    with pytest.raises(ValueError, match="--spatial-shards 3 must divide the 2 ranks"):
        train_app.train(small_cfg(batch_size=2), max_steps=1, synthetic=True, model_dir=str(tmp_path), device="cpu",
                        mesh=fake_mesh(0, 2), spatial_shards=3)
    with pytest.raises(ValueError, match=r"batch_size 3 must be divisible by the data-parallel factor 2 "
                                         r"\(= ranks/spatial_shards\)"):
        train_app.train(small_cfg(batch_size=3), max_steps=1, synthetic=True, model_dir=str(tmp_path), device="cpu",
                        mesh=fake_mesh(0, 4), spatial_shards=2)


def test_cli_refusals_without_torchrun(tmp_path, monkeypatch):
    """Without torchrun, `--spatial` runs in a group of this process alone
    (which refuses a batch) and `--spatial-shards 2` finds one rank."""
    import torch.distributed as dist

    from det3d_tpu_torch import cli

    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    (tmp_path / "tiny.json").write_text(json.dumps(CLI_CONFIG))
    common = ["--config", str(tmp_path / "tiny.json"), "--synthetic", "--device", "cpu"]
    with pytest.raises(ValueError, match="use it with batch=1"):
        cli.main(["infer", *common, "--spatial", "--batch", "2"])
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="--spatial-shards 2 must divide the 1 ranks"):
        cli.main(["train", *common, "--spatial-shards", "2", "--model-dir", str(tmp_path / "m")])


def test_world1_spatial_infer_is_the_plain_detector(tmp_path):
    """A spatial group of one: no halo row but zeros, sums over one slab;
    equal to the plain detector bit for bit on the CPU."""
    import torch.distributed as dist

    cfg = small_cfg()
    plain = Detector(cfg, device="cpu").init_weights(0)
    mesh = pm.make_spatial_mesh(device="cpu", rank=0, world_size=1)
    try:
        det, infer = pm.make_spatial_infer(cfg, mesh)
        det.init_weights(0)
        for pts, n in frames(cfg, 2):
            got, want = infer(pts, n), plain.infer(torch.from_numpy(pts), int(n))
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        assert pm.collective_counts(mesh) == {"all_gather": 2 * (N_CONVS + 1), "all_reduce": 2 * N_NORMS}
    finally:
        dist.destroy_process_group()


# --- two and four ranks ------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchange_rows_are_the_neighbours_and_its_backward_the_transpose(world, runs):
    runs = runs["by_world"][world]["collectives"]
    inp = collective_inputs(world)
    x = np.pad(inp["x"], ((0, 0), (0, 0), (1, 1), (0, 0)))
    for r, run in enumerate(runs):
        lo, hi = run["rows"]
        np.testing.assert_array_equal(run["halo"].numpy(), x[:, :, lo:hi + 2])
    hx_y, x_hty = sum(r["hx_y"] for r in runs), sum(r["x_hty"] for r in runs)
    assert abs(hx_y - x_hty) <= 1e-12 * abs(hx_y)


@pytest.mark.parametrize("world", [2, 4])
def test_gather_rows_gathers_whole_and_its_backward_is_the_own_slice(world, runs):
    """The cotangent of the gathered preds is the same on every rank, so a
    rank's gradient is its own rows of it: a reduce-scatter would give
    `world` times that."""
    inp = collective_inputs(world)
    for run in runs["by_world"][world]["collectives"]:
        lo, hi = run["prows"]
        for k, v in inp["preds"].items():
            np.testing.assert_array_equal(run["whole"][k].numpy(), v)
            np.testing.assert_array_equal(run["pgrad"][k].numpy(), inp["cot"][k][:, :, :, lo:hi])


def one_process_rpn(cfg, x, cot):
    model = init_weights(PointPillars(cfg), 0)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last).requires_grad_()
    out = model.rpn(xt)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), xt.grad, {n: p.grad for n, p in model.rpn.named_parameters()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("which", ["small", "mid"])
def test_spatial_rpn_matches_the_one_process_rpn(which, world, runs):
    cfg = small_cfg() if which == "small" else mid_cfg()
    x, cot = rpn_inputs(cfg)
    out, dx, grads = one_process_rpn(cfg, x, cot)
    runs = runs["by_world"][world][f"rpn_{which}"]
    got_out = torch.cat([r["out"] for r in runs], dim=2)
    torch.testing.assert_close(got_out, out, rtol=1e-5, atol=2e-5)
    got_dx = torch.cat([r["dx"] for r in runs], dim=2)
    assert float((got_dx - dx).norm()) <= 1e-2 * float(dx.norm())
    assert all(r["grads_summed"] is None for r in runs[1:])
    for name, g in grads.items():
        total = runs[0]["grads_summed"][name]
        assert float((total - g).norm()) <= 1e-2 * float(g.norm()), name
    for r in runs:
        assert r["fwd"] == {"all_gather": N_CONVS, "all_reduce": N_NORMS}
        assert r["bwd"] == {"all_gather": N_CONVS, "all_reduce": N_NORMS}


def assert_detections_close(got, want, what: str) -> None:
    got = [np.asarray(t) for t in got]
    want = [np.asarray(t) for t in want]
    np.testing.assert_array_equal(got[2], want[2], err_msg=f"{what}: valid")
    np.testing.assert_allclose(got[1], want[1], atol=2e-3, err_msg=f"{what}: scores")
    np.testing.assert_allclose(got[0], want[0], rtol=5e-3, atol=1e-2, err_msg=f"{what}: boxes")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("which", ["small", "mid"])
def test_spatial_infer_matches_the_one_process_detector(which, world, runs):
    cfg = small_cfg() if which == "small" else mid_cfg()
    det = Detector(cfg, device="cpu").init_weights(0)
    fr = frames(cfg, 2 if which == "small" else 1)
    runs = runs["by_world"][world][f"infer_{which}"]
    for i, (pts, n) in enumerate(fr):
        want = det.infer(torch.from_numpy(pts), int(n))
        assert want.valid.any(), "a frame with no detection holds nothing"
        for r, run in enumerate(runs):
            assert_detections_close(run["outs"][i], want, f"{which} frame {i} rank {r}")
    for run in runs:
        assert run["calls"] == {"scatter": len(fr), "nms": len(fr)}


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_infer_matches_jax_make_spatial_infer(world, runs):
    import test_torch_parity_utils as pu

    assert pu.to_torch_cfg(runs["tcfg"]) == small_cfg()
    for run in runs["by_world"][world]["infer_small"]:
        for i, want in enumerate(runs["jax"]["infer"][world]):
            assert_detections_close(run["outs"][i], want, f"frame {i}")


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_infer_collectives_do_not_grow_with_the_group(world, runs):
    """The port's counterpart of tests/test_parallel.py's
    `test_spatial_infer_halo_count_is_mesh_size_invariant`: per frame, one
    halo all-gather per 3x3 convolution, one all-reduce per InstanceNorm
    and the preds gather, at every group size."""
    for run in runs["by_world"][world]["infer_small"]:
        for per_frame in run["collectives"]:
            assert per_frame == {"all_gather": N_CONVS + 1, "all_reduce": N_NORMS}


def one_process_steps(cfg, global_batches, state_dict=None) -> list[dict]:
    trainer = Trainer(cfg, device="cpu", fence=False)
    if state_dict is not None:
        trainer.detector.load_state_dict(state_dict)
    state = trainer.init_state(None if state_dict is not None else 0)
    out = []
    for b in global_batches:
        state, loss, counts = trainer.train_step(state, b)
        out.append(dict(step_record(trainer, state, loss), counts=counts))
    return out


def assert_grads_by_norm(got: dict, want: dict) -> None:
    for name, g in want.items():
        assert float((got[name] - g).norm()) <= 1e-2 * float(g.norm()) + 1e-12, name


def assert_hybrid_close(got: dict, want_loss: dict, want_sd: dict, what: str) -> None:
    for k, v in want_loss.items():
        np.testing.assert_allclose(got["loss"][k], v, rtol=1e-4, err_msg=f"{what}: {k}")
    for name, w in want_sd.items():
        w = torch.as_tensor(np.array(w))
        if "running" in name:
            torch.testing.assert_close(got["sd"][name], w, rtol=1e-5, atol=1e-6, msg=f"{what}: {name}")
        elif w.is_floating_point():
            assert float((got["sd"][name] - w).abs().max()) <= 3e-3, f"{what}: {name}"


def check_first_hybrid(got: dict, want: dict, dp_grads: dict | None = None, what: str = "") -> None:
    """A hybrid step's first record against the one-process step's `want`;
    the gradients that reached Adam (summed over the world, divided by dp)
    by the norm rule against the one-process step's at dp 1, and at dp 2
    against the data-parallel step's `dp_grads` and against the one-process
    step's over all gradients together."""
    assert_hybrid_close(got, want["loss"], want["sd"], what)
    for k, v in want["counts"].items():
        diff = np.abs(got["counts"][k].numpy() - v.numpy())
        assert diff.max() <= 1, (k, got["counts"][k], v)
    mine = got["grads"]
    if dp_grads is None:
        assert_grads_by_norm(mine, want["grads"])
    else:
        assert_grads_by_norm(mine, dp_grads)
        flat = [torch.cat([g[p].flatten() for p in want["grads"]]) for g in (mine, want["grads"])]
        assert float((flat[0] - flat[1]).norm()) <= 1e-2 * float(flat[1].norm())


@pytest.mark.parametrize("grid,name,batch", [((1, 2), "hybrid12", 2), ((1, 4), "hybrid14", 2),
                                              ((2, 2), "hybrid22", 4)])
def test_hybrid_step_matches_the_one_process_step(grid, name, batch, runs):
    """At dp 1 checked on each rank against the one-process step computed
    there (`check_first_hybrid`); at dp 2 here, against the data-parallel
    step of the two-rank group too."""
    dp, sp_ = grid
    runs_, runs = runs, runs["by_world"][dp * sp_][name]
    assert len(runs) == dp * sp_
    if dp > 1:
        want = one_process_steps(small_cfg(batch_size=batch), hybrid_batches(small_cfg(), batch))[0]
        dp_grads = runs_["by_world"][dp]["dp"][0]["first_grads"]
    for r, run in enumerate(runs):
        assert (run["data_rank"], run["spatial_rank"]) == divmod(r, sp_)
        if dp == 1:
            assert run["first_failure"] is None, f"rank {r}: {run['first_failure']}"
        else:
            check_first_hybrid(run["first"], want, dp_grads, f"rank {r}")


@pytest.mark.parametrize("grid,name", [((1, 2), "hybrid12"), ((1, 4), "hybrid14"), ((2, 2), "hybrid22")])
def test_hybrid_steps_chain_with_equal_weights_on_every_rank(grid, name, runs):
    runs = runs["by_world"][grid[0] * grid[1]][name]
    for run in runs:
        assert len(run["losses"]) == HYBRID_STEPS and np.isfinite(run["losses"]).all()
        assert run["losses"] == runs[0]["losses"]
        tp.assert_same_digests(run["final"], runs[0]["final"], "final weights")


def test_hybrid_step_matches_jax_make_spatial_train(runs):
    for r, run in enumerate(runs["by_world"][4]["hybrid22"]):
        assert_hybrid_close(run["first"], runs["jax"]["train_loss"], runs["jax"]["train_after"], f"rank {r}")


@pytest.mark.parametrize("grid,name", [((1, 2), "hybrid12"), ((1, 4), "hybrid14"), ((2, 2), "hybrid22")])
def test_hybrid_step_issues_the_written_collectives(grid, name, runs):
    """Over the spatial group, forward and backward: a halo all-gather per
    3x3 convolution each way, an all-reduce per InstanceNorm each way, and
    the preds gather; over the data group, sync-BN (2 forward, 2 backward),
    the loss terms and the metric counts; over the world, the gradients."""
    for run in runs["by_world"][grid[0] * grid[1]][name]:
        assert run["collectives"] == {
            "spatial": {"all_gather": 2 * N_CONVS + 1, "all_reduce": 2 * N_NORMS},
            "data": {"all_reduce": 6},
            "world": {"all_reduce": 1},
        }


def test_hybrid_augmentation_draws_by_data_rank(runs):
    """Spatial ranks of one data group draw the same transform; the two
    data groups draw different ones."""
    runs = runs["by_world"][4]["hybrid_aug"]
    by_data = {}
    for run in runs:
        by_data.setdefault(run["data_rank"], []).append(run["draws"])
    for draws in by_data.values():
        for d in draws[1:]:
            for k in d:
                assert torch.equal(d[k], draws[0][k]), k
    assert all(not torch.equal(by_data[0][0][k], by_data[1][0][k]) for k in by_data[0][0])
    for run in runs:
        assert run["losses"] == runs[0]["losses"] and np.isfinite(run["losses"]).all()


def test_infer_app_spatial_writes_the_one_process_annos(runs):
    got, none = runs["by_world"][2]["infer_app"]
    assert none is None
    want = infer_app.infer(small_cfg(), synthetic=True, num_frames=2, range_thresholds=(80.0,), device="cpu")
    assert len(got) == len(want["dt_annos"]) == 2
    for a, b in zip(got, want["dt_annos"]):
        np.testing.assert_array_equal(a["name"], b["name"])
        np.testing.assert_allclose(a["score"], b["score"], atol=2e-3)
        np.testing.assert_allclose(a["location"], b["location"], rtol=5e-3, atol=1e-2)


def test_train_app_spatial_shards_matches_one_process_and_restores(runs, tmp_path):
    cfg = small_cfg(batch_size=2, learning_rate=LR_APP)
    want = train_app.train(cfg, max_steps=2, display_step=1, save_step=2, eval_step=100, synthetic=True, seed=0,
                           model_dir=str(tmp_path), device="cpu")
    r0, r1 = runs["by_world"][2]["train_app"]
    assert r0["steps"] == r1["steps"] == 2
    assert (r0["saves"], r0["evals"]) == (1, 1) and (r1["saves"], r1["evals"]) == (0, 0)
    assert r1["sd"] is None
    tp.assert_same_digests(r1["sd_digests"], tp.digests(r0["sd"]), "the app's weights")
    for k, v in want["trainer"].model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(r0["sd"][k], v, rtol=1e-5, atol=1e-6)
        elif v.is_floating_point():
            assert float((r0["sd"][k] - v).abs().max()) <= 2 * 2 * LR_APP, k
    model_dir = runs["tmp"] / "app"
    assert sorted(p.name for p in model_dir.iterdir()) == ["2.pth", "latest.pth", "log.txt"]
    fresh = Trainer(cfg, device="cpu")
    from det3d_tpu_torch.train.checkpoint import CheckpointManager

    state = CheckpointManager(model_dir, readonly=True).restore_latest(fresh)
    assert state.step == 2
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, r0["sd"][k]), k


def test_serve_spatial_serves_the_one_process_detections(runs):
    """Rank 0 serves 3 frames (and the warm-up); rank 1 ran each of them
    with it and left on the stop header; the detections are one process's.
    Then the replay producer: rank 0 reads the directory's 2 frames and
    serves them, rank 1 follows and leaves again."""
    lead, follower = runs["by_world"][2]["serve"]
    assert lead["served"] + lead["dropped"] == 3 and lead["served"] >= 1
    assert lead["replayed"] == 2 and follower["replayed"] == 0
    assert follower["served"] == 0 and len(follower["ran"]) == len(lead["ran"]) == lead["served"] + 1
    det = Detector(small_cfg(), device="cpu").init_weights(0)
    for (pts, n, got), (pts1, n1, got1) in zip(lead["ran"], follower["ran"]):
        assert torch.equal(pts, pts1) and n == n1
        for a, b in zip(got, got1):
            assert torch.equal(a, b)
        assert_detections_close(got, det.infer(pts, n), f"{n} points")


def test_cli_spatial_commands_under_torchrun(runs):
    """`infer --spatial`, `serve --spatial` and `train --spatial-shards 2`
    on two ranks (the group exits 0 only if every command did): rank 0
    wrote the annos of both frames and a checkpoint at step 2."""
    tmp = runs["tmp"]
    with open(tmp / "dt.pkl", "rb") as f:
        assert len(pickle.load(f)) == 2
    saved = torch.load(tmp / "cli_run" / "latest.pth", weights_only=True)
    assert sorted(p.name for p in (tmp / "cli_run").iterdir()) == ["2.pth", "latest.pth"]
    assert saved["model_state_dict"].keys() == Trainer(small_cfg(), device="cpu").model.state_dict().keys()
