"""The port's data parallelism (`det3d_tpu_torch/parallel/mesh.py`) on the
CPU: gloo groups of 2 and 4 ranks, each a process started by
`multiprocessing`'s spawn with a `file://` rendezvous under the test's
temporary directory (no port, so parallel test workers never collide).
The ranks run every job of a group in one session, and import this module
by name, which imports no JAX: only the tests that compare with the JAX
package import it. A rank writes each job's result to a pickle that
`run_group` deletes once it has read it; what is model-sized stays on the
ranks: a step is compared with its reference on the rank (the same
assertions; the rank returns the first failure's message), and weights
that every rank must hold alike travel as digests of their bytes.

Tolerances, each with its reason:
  * the data-parallel step against the one-process step at the global
    batch: those of tests/test_torch_train.py — loss terms rtol 1e-5
    (per-rank means averaged: other summation orders); metric counts
    equal; gradients within 1e-4 of each tensor's largest; updated
    parameters within 1e-6 where |g| is above 1e-3 of its tensor's largest
    and within 2·lr elsewhere (Adam's first update is about lr·sign(g));
    running statistics rtol 1e-5; Adam's first moments (0.1·g) within
    1e-4 and second moments (0.001·g²) within 2e-4 of the tensor's largest;
  * against JAX's `make_sharded_train_step` on two virtual devices:
    tests/test_parallel.py's (see `test_dp_step_matches_jax_sharded_step`);
  * world 1 against the plain step: bit for bit (a sum over one rank and
    a division by 1 are exact);
  * sharded inference against per-frame inference: scores within 1e-5 and
    valid flags equal (tests/test_parallel.py's tolerances), boxes within
    1e-4 (the golden tolerance);
  * the train app over 3 steps at lr 1e-6 (tests/test_torch_apps.py's
    reason: the untrained network's later gradients amplify earlier
    differences): every parameter within 3 · 2·lr, running statistics
    rtol 1e-5.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import multiprocessing
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from det3d_tpu_torch.apps import infer_app, train_app
from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.parallel import mesh as pm
from det3d_tpu_torch.pipeline import Detector
from det3d_tpu_torch.train.trainer import Trainer, host_batch
from test_torch_tmpdirs import removed, tmp_path  # noqa: F401

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 120.0
BN = "pillar_point_net.pfn_layers.1."
# all-reduces a step issues: sync-BN [count, Σx] and Σ m(x - mean)², each
# forward and backward (4); the flat gradients (1); the loss terms (1); the
# metric counts (1)
STEP_ALL_REDUCES = 7


def small_cfg(**kw):
    """tests/helpers.small_cfg in the port's own config (16x16 grid, 8x8
    feature maps, float32)."""
    cfg = load_config({
        "detection_range": [-8.0, -8.0, -2.5, 8.0, 8.0, 8.5], "center_limit": [-8.0, -8.0, -10.0, 8.0, 8.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 64, "max_num_points": 5, "batch_size": 1,
        "max_points": 256, "max_gt_boxes": 8, "compute_dtype": "float32",
    })
    specs = (dataclasses.replace(cfg.class_specs[0], sizes=((4.6, 2.10, 1.8),), rotations=(0.0, 1.5707963267948966),
                                 feature_map_size=(8, 8, 1)),
             dataclasses.replace(cfg.class_specs[1], feature_map_size=(8, 8, 1)),
             dataclasses.replace(cfg.class_specs[2], feature_map_size=(8, 8, 1)))
    return cfg.replace(class_specs=specs, **kw)


def blocked_cfg():
    """The 32x32 grid of tests/test_parallel.py's blocked test: block0 in two
    row blocks at a local batch of 2, the packed network unblocked at 4."""
    return load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5], "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5, "batch_size": 4,
        "max_points": 4096, "max_gt_boxes": 8, "compute_dtype": "float32", "pack_w": True,
        "block0_blocked_train": True,
    })


def samples(k, seed=0):
    """tests/test_parallel.py's scenes: 400 uniform points and one car."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(k):
        pts = np.concatenate([rng.uniform(-7, 7, (400, 2)), rng.uniform(-2, 6, (400, 1)),
                              rng.uniform(0, 1, (400, 1))], 1).astype(np.float32)
        out.append({"points": pts, "gt_boxes": np.array([[0.0, 0.0, -1.5, 4.6, 2.1, 1.8, 0.3]], np.float32),
                    "gt_classes": np.array([1], np.int32)})
    return out


def batches(cfg, n_steps, seed=0):
    return [host_batch(cfg, samples(cfg.batch_size, seed + i)) for i in range(n_steps)]


# --- what a rank runs ---------------------------------------------------------


def step_record(trainer, state, loss, counts) -> dict:
    return dict(
        loss={k: float(v) for k, v in loss.items()}, counts={k: v.numpy().copy() for k, v in counts.items()},
        sd={k: v.clone() for k, v in trainer.model.state_dict().items()},
        grads={n: p.grad.clone() for n, p in trainer.model.named_parameters()},
        mu=[m.clone() for m in state.mu], nu=[v.clone() for v in state.nu], step=state.step,
    )


def digest(t: torch.Tensor) -> tuple:
    """(dtype, shape, SHA-256 of the bytes, finite): equal digests of finite
    tensors are equal tensors."""
    t = t.detach().contiguous()
    finite = bool(torch.isfinite(t).all()) if t.is_floating_point() else True
    return str(t.dtype), tuple(t.shape), hashlib.sha256(t.numpy().tobytes()).hexdigest(), finite


def digests(tensors) -> dict | list:
    if isinstance(tensors, dict):
        return {k: digest(v) for k, v in tensors.items()}
    return [digest(v) for v in tensors]


def assert_same_digests(got, want, what: str) -> None:
    """Two ranks' digests: the same bits, and finite (a NaN is no weight)."""
    assert got == want, f"{what}: the ranks differ"
    flat = got.values() if isinstance(got, dict) else got
    assert all(d[3] for d in flat), f"{what}: not finite"


def failure(check, *args) -> str | None:
    """Run `check(*args)` on the rank: None, or its assertion's message."""
    try:
        check(*args)
    except AssertionError as e:
        return f"{type(e).__name__}: {e}"
    return None


def check_one_process(cfg, batch, state_dict, got: dict) -> None:
    """The first data-parallel step's record against the one-process step at
    the global batch, computed here from the same weights."""
    want = one_process_step(cfg, batch, state_dict)
    assert_step_close(got, want["loss"], want["counts"], want["sd"],
                      {k: v.numpy() for k, v in want["grads"].items()}, cfg.learning_rate, want["mu"], want["nu"])


def job_steps(mesh, cfg, global_batches, state_dict=None, check="one process", first_grads=False):
    """Data-parallel steps over the global batches from seeded (or given)
    weights: the first step checked here by `check(record)` ("one process":
    against the one-process step; None: not checked) and its collectives,
    the loss after each step, and digests of the final weights and Adam
    moments; with `first_grads`, rank 0's gradients of the first step."""
    trainer = Trainer(cfg, device="cpu")
    if state_dict is not None:
        trainer.detector.load_state_dict(state_dict)
    state = pm.replicated(mesh, trainer, trainer.init_state(None if state_dict is not None else 0))
    step = pm.make_sharded_train_step(trainer, mesh)
    if check == "one process":
        check = functools.partial(check_one_process, cfg, global_batches[0], state_dict)
    out = {"layout": trainer.model.layout(cfg.batch_size // mesh.world, True), "losses": []}
    for i, batch in enumerate(global_batches):
        before = pm.collective_counts(mesh)
        state, loss, counts = step(state, pm.shard_batch(mesh, batch))
        if i == 0:
            first = step_record(trainer, state, loss, counts)
            after = pm.collective_counts(mesh)
            out["collectives"] = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
            out["first_failure"] = None if check is None else failure(check, first)
            out["first_running_mean"] = first["sd"][BN + "running_mean"]
            out["first_grads"] = first["grads"] if first_grads and mesh.rank == 0 else None
            del first
        out["losses"].append(float(loss["loss"]))
    sd = trainer.model.state_dict()
    out["final"], out["final_running_mean"] = digests(sd), sd[BN + "running_mean"].clone()
    out["final_mu"] = digests(state.mu)
    return out


def job_infer(mesh, cfg, points, num_points):
    det = Detector(cfg, device="cpu").init_weights(0)
    before = pm.collective_counts(mesh)
    out = pm.make_sharded_infer(det, mesh)(points, num_points)
    return {"out": out, "gathers": pm.collective_counts(mesh).get("all_gather", 0) - before.get("all_gather", 0)}


def job_augment(mesh, cfg, batch):
    trainer = Trainer(cfg, device="cpu", device_global_augment=True, aug_seed=0)
    state = trainer.init_state(0)
    local = pm.shard_batch(mesh, batch)
    draws = trainer.augment_params(state.step, len(local.points), mesh.rank)
    state, loss, _ = pm.make_sharded_train_step(trainer, mesh)(state, local)
    return {"draws": draws, "sd": digests(trainer.model.state_dict()), "loss": float(loss["loss"])}


def job_app(mesh, cfg, model_dir):
    """The train app over the group: rank 0's weights whole, every rank's as
    digests."""
    summary = train_app.train(cfg, max_steps=3, display_step=1, save_step=3, eval_step=3, eval_frames=2,
                              synthetic=True, seed=0, model_dir=model_dir, device="cpu", mesh=mesh)
    sd = summary["trainer"].model.state_dict()
    return {"sd": sd if mesh.rank == 0 else None, "sd_digests": digests(sd), "steps": summary["steps"],
            "saves": len(summary["save_s"]), "evals": len(summary["eval_strs"]),
            "ms_per_step": len(summary["ms_per_step"])}


def job_infer_app(mesh, cfg, batch, frames):
    out = infer_app.infer(cfg, synthetic=True, num_frames=frames, range_thresholds=(80.0,), batch=batch,
                          device="cpu", mesh=mesh)
    return None if out is None else out["dt_annos"]


def job_echo(mesh, value):
    return {"rank": mesh.rank, "world": mesh.world, "value": value}


JOBS = {"steps": job_steps, "infer": job_infer, "augment": job_augment, "app": job_app,
        "infer_app": job_infer_app}


def rank_session(rank: int, world: int, init: str, out_dir: str, jobs: list) -> None:
    """A rank's process: join the group, run the jobs in order, write each
    result to `out_dir`."""
    import torch.distributed as dist

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


def run_group(world: int, tmp: Path, jobs: list) -> dict:
    """Run `jobs` ([(name, JOBS key or a module-level function, kwargs)]) on
    `world` spawned gloo ranks → {name: [result of rank r]}. A rank that
    fails or outlives the join timeout fails the test."""
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_session, args=(r, world, f"file://{tmp}/rendezvous", str(tmp), jobs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} of {world} still running after {JOIN_TIMEOUT_S} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return load_results(tmp, [name for name, _, _ in jobs], world)


def load_results(tmp: Path, names: list[str], world: int) -> dict:
    """{name: [result of rank r]} from the ranks' pickles in `tmp`, each
    deleted once it is read."""
    out = {}
    for name in names:
        out[name] = []
        for r in range(world):
            path = tmp / f"{name}-{r}.pkl"
            with open(path, "rb") as f:
                out[name].append(pickle.load(f))
            path.unlink()
    return out


# --- the groups ---------------------------------------------------------------


N_STEPS = 3
GLOBAL_BATCH = 4
INFER_FRAMES = 8


def infer_inputs(cfg):
    det = Detector(cfg, device="cpu")
    padded = [det.pad_points(s["points"]) for s in samples(INFER_FRAMES, seed=3)]
    return np.stack([p for p, _ in padded]), np.array([n for _, n in padded], np.int32)


def jax_sharded_step(state_dict: dict | None = None) -> dict:
    """JAX's `make_sharded_train_step` on two of the conftest's virtual
    devices, one step of small_cfg at batch 4 from `init_state(PRNGKey(0))`
    or from the port's `state_dict`, with the pmean'd gradients captured in
    front of its optimizer; and its step-0 weights as the port's
    state_dict."""
    import jax
    import jax.numpy as jnp
    import optax

    import test_torch_parity_utils as pu
    from det3d_tpu.deploy.torch_interop import state_dict_to_variables
    from det3d_tpu.parallel.mesh import make_mesh, make_sharded_train_step, replicated, shard_batch
    from det3d_tpu.train.trainer import Trainer as JaxTrainer
    from det3d_tpu.train.trainer import TrainState
    from det3d_tpu.train.trainer import host_batch as jax_host_batch
    from det3d_tpu_torch.weights import variables_to_state_dict
    from helpers import small_cfg as jax_small_cfg

    jcfg = jax_small_cfg(batch_size=GLOBAL_BATCH)
    trainer = JaxTrainer(jcfg)
    capture = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    trainer.optimizer = optax.chain(capture, trainer.optimizer)
    mesh = make_mesh(2)
    if state_dict is None:
        state = trainer.init_state(jax.random.PRNGKey(0))
    else:
        variables = state_dict_to_variables({k: v.numpy() for k, v in state_dict.items()})
        state = TrainState(step=np.zeros((), np.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=trainer.optimizer.init(variables["params"]))
    before = pu.numpy_variables({"params": state.params, "batch_stats": state.batch_stats})
    new, loss, counts = make_sharded_train_step(trainer, mesh)(
        jax.device_put(state, replicated(mesh)), shard_batch(mesh, jax_host_batch(jcfg, samples(GLOBAL_BATCH))))
    after = pu.numpy_variables({"params": new.params, "batch_stats": new.batch_stats})
    grads = pu.numpy_variables({"params": new.opt_state[0], "batch_stats": new.batch_stats})
    return dict(
        tcfg=pu.to_torch_cfg(jcfg), loss={k: float(v) for k, v in loss.items()},
        counts={k: np.asarray(v) for k, v in counts.items()}, before=pu.bridged_state_dict(before),
        after=variables_to_state_dict(after), grads=variables_to_state_dict(grads),
        lr=float(jcfg.learning_rate),
    )


@pytest.fixture(scope="module")
def jax_sharded():
    """`jax_sharded_step` from JAX's own seeded weights."""
    return jax_sharded_step()


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_sharded):
    """Every two-rank job in one group of processes."""
    tmp = tmp_path_factory.mktemp("world2")
    cfg = small_cfg(batch_size=GLOBAL_BATCH)
    points, num_points = infer_inputs(cfg)
    app_cfg = small_cfg(batch_size=2, learning_rate=1e-6)
    jobs = [
        ("steps", "steps", dict(cfg=cfg, global_batches=batches(cfg, N_STEPS))),
        ("jax", "steps", dict(cfg=jax_sharded["tcfg"], global_batches=batches(cfg, 1),
                              state_dict=jax_sharded["before"],
                              check=functools.partial(check_jax, {k: jax_sharded[k] for k in
                                                                  ("loss", "counts", "after")}))),
        ("blocked", "steps", dict(cfg=blocked_cfg(), global_batches=batches(blocked_cfg(), 1))),
        ("infer", "infer", dict(cfg=cfg, points=points, num_points=num_points)),
        ("augment", "augment", dict(cfg=cfg, batch=batches(cfg, 1)[0])),
        ("app", "app", dict(cfg=app_cfg, model_dir=str(tmp / "app"))),
    ]
    yield dict(runs=run_group(2, tmp / "group", jobs), tmp=tmp, app_cfg=app_cfg)
    removed(tmp)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The four-rank jobs: the step, and `infer --batch 6` (gcd rule: the
    first two ranks)."""
    tmp = tmp_path_factory.mktemp("world4")
    cfg = small_cfg(batch_size=GLOBAL_BATCH)
    jobs = [("steps", "steps", dict(cfg=cfg, global_batches=batches(cfg, N_STEPS))),
            ("infer_app", "infer_app", dict(cfg=cfg, batch=6, frames=8))]
    return run_group(4, tmp / "group", jobs)


def groups(world2, world4):
    return {2: world2["runs"], 4: world4}


def one_process_step(cfg, batch, state_dict=None) -> dict:
    trainer = Trainer(cfg, device="cpu")
    if state_dict is not None:
        trainer.detector.load_state_dict(state_dict)
    state = trainer.init_state(None if state_dict is not None else 0)
    state, loss, counts = trainer.train_step(state, batch)
    return step_record(trainer, state, loss, counts)


def assert_step_close(got: dict, want_loss, want_counts, want_sd, want_grads, lr, mu, nu):
    for k, v in want_loss.items():
        np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5, err_msg=k)
    for k, v in want_counts.items():
        np.testing.assert_array_equal(got["counts"][k], v, err_msg=k)
    n_big = n_all = 0
    for name, g in want_grads.items():
        if name not in got["grads"]:
            continue
        g = np.asarray(g)
        scale = np.abs(g).max()
        np.testing.assert_allclose(got["grads"][name].numpy(), g, rtol=0, atol=1e-4 * scale, err_msg=name)
        p, w = got["sd"][name].numpy(), np.asarray(want_sd[name])
        big = np.abs(g) > 1e-3 * scale
        n_big, n_all = n_big + int(big.sum()), n_all + g.size
        np.testing.assert_allclose(p[big], w[big], rtol=0, atol=1e-6, err_msg=name)
        assert np.abs(p - w).max() <= 2 * lr, name
    assert n_big > 0.9 * n_all
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(got["sd"][BN + name].numpy(), np.asarray(want_sd[BN + name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    for mine, theirs, tol in ((got["mu"], mu, 1e-4), (got["nu"], nu, 2e-4)):
        for a, b in zip(mine, theirs, strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=tol * float(b.abs().max()) + 1e-30)


# --- no process group needed ---------------------------------------------------


def test_run_group_leaves_no_pickles(tmp_path):
    """Each rank's result comes back and its pickle is gone once read."""
    out = run_group(2, tmp_path / "group", [("echo", job_echo, dict(value=3)), ("again", "steps", dict(
        cfg=small_cfg(batch_size=2), global_batches=batches(small_cfg(batch_size=2), 1), check=None))])
    assert out["echo"] == [{"rank": r, "world": 2, "value": 3} for r in range(2)]
    assert [run["losses"] for run in out["again"]] == [out["again"][0]["losses"]] * 2
    assert not list(tmp_path.rglob("*.pkl"))


def fake_mesh(rank, world) -> pm.DataMesh:
    return pm.DataMesh(None, rank, world, torch.device("cpu"), "gloo")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_batch_slices_concatenate_to_the_global_batch(world):
    cfg = small_cfg(batch_size=4)
    batch = host_batch(cfg, samples(4))
    shards = [pm.shard_batch(fake_mesh(r, world), batch) for r in range(world)]
    for field, *parts in zip(batch, *shards):
        assert all(len(p) == 4 // world for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts), field)


def test_shard_batch_refuses_a_batch_the_world_does_not_divide():
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        pm.shard_batch(fake_mesh(0, 3), host_batch(small_cfg(), samples(4)))


def test_make_mesh_needs_torchrun_or_arguments(monkeypatch):
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert not pm.launched_by_torchrun()
    with pytest.raises(RuntimeError, match="launch under torchrun"):
        pm.make_mesh(device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert pm.launched_by_torchrun()


def test_make_mesh_refuses_nccl_on_the_cpu(tmp_path):
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        pm.make_mesh(device="cpu", backend="nccl", rank=0, world_size=1, init_method=f"file://{tmp_path}/r")


def test_train_app_refuses_a_batch_the_world_does_not_divide(tmp_path):
    with pytest.raises(ValueError, match="must be divisible by the 3 data-parallel ranks"):
        train_app.train(small_cfg(batch_size=4), max_steps=1, synthetic=True, model_dir=str(tmp_path),
                        device="cpu", mesh=fake_mesh(0, 3))


@pytest.mark.parametrize("world", [2, 4])
def test_synthetic_batches_shard_the_global_batch(world):
    cfg = small_cfg(batch_size=4)
    whole = train_app._batch_iterator(cfg, True, seed=5)
    shards = [train_app._batch_iterator(cfg, True, seed=5, shard=(r, world)) for r in range(world)]
    for _ in range(2):
        want = next(whole)
        for field, *parts in zip(want, *(next(s) for s in shards)):
            np.testing.assert_array_equal(np.concatenate(parts), field)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    from det3d_tpu_torch.data.synthetic import write_split

    root = tmp_path_factory.mktemp("split")
    cfg = small_cfg(batch_size=4)
    write_split(cfg, root, 10, seed=7, num_objects=(2, 4), ground_points=600)
    return cfg.replace(data_root=str(root), train_info=("data_info.pkl",))


@pytest.mark.parametrize("world,workers", [(2, 0), (4, 0), (2, 2)])
def test_prefetcher_shards_are_the_one_process_batches(split, world, workers):
    """Two epochs of 2 global batches of 4 (10 samples, shuffled per epoch,
    augmented): the ranks' slices, in rank order, are the one-process
    batches array for array, whichever worker augmented which sample."""
    from det3d_tpu_torch.data.dataset import DetectionDataset
    from det3d_tpu_torch.data.prefetcher import BatchPrefetcher

    def take(shard, n_workers):
        ds = DetectionDataset(split, split.train_info, training=True, seed=3)
        with BatchPrefetcher(ds, split, n_workers, seed=2, shard=shard) as pf:
            it = pf.epochs()
            return [next(it) for _ in range(4)]

    want = take((0, 1), 0)
    got = [take((r, world), workers) for r in range(world)]
    for i, batch in enumerate(want):
        for field, *parts in zip(batch, *(g[i] for g in got)):
            np.testing.assert_array_equal(np.concatenate(parts), field)


def test_prefetcher_refuses_a_batch_the_world_does_not_divide(split):
    from det3d_tpu_torch.data.dataset import DetectionDataset
    from det3d_tpu_torch.data.prefetcher import BatchPrefetcher

    with pytest.raises(ValueError, match="must split over the ranks"):
        BatchPrefetcher(DetectionDataset(split, split.train_info), split, 0, shard=(0, 3))


def test_world1_step_is_the_plain_step_bit_for_bit(tmp_path):
    """A group of one (gloo, in this process): sync-BN, the gradient pmean
    and the loss and count reductions are identities, so the data-parallel
    step is the plain step bit for bit (chip_smoke.py phase 15(a) holds the
    same under NCCL on the card)."""
    import torch.distributed as dist

    cfg = small_cfg(batch_size=2)
    global_batches = batches(cfg, 2)
    runs = []
    mesh = pm.make_mesh(device="cpu", rank=0, world_size=1, init_method=f"file://{tmp_path}/rendezvous")
    try:
        for sharded in (False, True):
            trainer = Trainer(cfg, device="cpu")
            state = trainer.init_state(0)
            step = pm.make_sharded_train_step(trainer, mesh) if sharded else trainer.train_step
            for b in global_batches:
                state, loss, counts = step(state, b)
            runs.append((trainer.model.state_dict(), state, loss, counts))
        assert pm.collective_counts(mesh) == {"all_reduce": STEP_ALL_REDUCES * len(global_batches)}
    finally:
        dist.destroy_process_group()
    (sd1, st1, l1, c1), (sd2, st2, l2, c2) = runs
    for k in sd1:
        assert torch.equal(sd1[k], sd2[k]), k
    for a, b in zip(st1.mu + st1.nu, st2.mu + st2.nu):
        assert torch.equal(a, b)
    assert all(torch.equal(l1[k], l2[k]) for k in l1) and all(torch.equal(c1[k], c2[k]) for k in c1)


# --- two and four ranks ----------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_the_one_process_step(world, world2, world4):
    """Checked on each rank (`check_one_process`): `assert_step_close`
    against the one-process step at the global batch."""
    runs = groups(world2, world4)[world]["steps"]
    assert len(runs) == world
    for r, run in enumerate(runs):
        assert run["first_failure"] is None, f"rank {r}: {run['first_failure']}"


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_issues_the_written_collectives(world, world2, world4):
    """The same collectives at every world size: the step's seven
    all-reduces, nothing else."""
    for run in groups(world2, world4)[world]["steps"]:
        assert run["collectives"] == {"all_reduce": STEP_ALL_REDUCES}


@pytest.mark.parametrize("world", [2, 4])
def test_dp_steps_chain_with_equal_weights_on_every_rank(world, world2, world4):
    runs = groups(world2, world4)[world]["steps"]
    for run in runs:
        assert len(run["losses"]) == N_STEPS and np.isfinite(run["losses"]).all()
        assert run["losses"] == runs[0]["losses"]
        assert_same_digests(run["final"], runs[0]["final"], "final weights")
        assert_same_digests(run["final_mu"], runs[0]["final_mu"], "final first moments")
    assert not torch.equal(runs[0]["final_running_mean"], runs[0]["first_running_mean"])


def check_jax(jax_ref: dict, got: dict) -> None:
    """A first step's record against JAX's sharded step (`jax_sharded`'s
    loss, counts and weights after the step)."""
    for k, v in jax_ref["loss"].items():
        np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5, err_msg=k)
    for k, v in jax_ref["counts"].items():
        np.testing.assert_array_equal(got["counts"][k], v, err_msg=k)
    for name, want in jax_ref["after"].items():
        tol = dict(rtol=1e-5, atol=1e-6) if "running" in name else dict(rtol=0, atol=2e-3)
        np.testing.assert_allclose(got["sd"][name].numpy(), want, err_msg=name, **tol)


def test_dp_step_matches_jax_sharded_step(world2, jax_sharded):
    """At tests/test_parallel.py's tolerances (loss rtol 1e-5, parameters
    atol 2e-3), with the metric counts equal and the running statistics
    rtol 1e-5, checked on each rank (`check_jax`). Gradients are not held
    elementwise here: at these JAX weights and this batch the port's
    one-process step itself moves its gradients by up to 2.5 % of a
    tensor's largest when the batch is only reordered (float32 rounding of
    the batch statistics crossing ReLU kinks and InstanceNorms over 2x2
    maps), so no summation order is the right one; at the seeded weights of
    the other tests the same reordering moves them by under 5e-5."""
    assert jax_sharded["tcfg"] == small_cfg(batch_size=GLOBAL_BATCH)
    runs = world2["runs"]["jax"]
    assert len(runs) == 2
    for r, run in enumerate(runs):
        assert run["first_failure"] is None, f"rank {r}: {run['first_failure']}"


def test_blocked_dp_step_matches_the_one_process_step(world2):
    """pack_w + block0_blocked_train: blocked block0 on each rank's batch of
    2, against the packed network unblocked at the global batch of 4."""
    cfg = blocked_cfg()
    trainer = Trainer(cfg, device="cpu")
    assert not trainer.model.layout(cfg.batch_size, True).block0_blocked
    runs = world2["runs"]["blocked"]
    assert len(runs) == 2
    for r, run in enumerate(runs):
        assert run["layout"].pack_w and run["layout"].block0_blocked
        assert run["first_failure"] is None, f"rank {r}: {run['first_failure']}"


def test_sharded_infer_matches_per_frame_infer(world2):
    cfg = small_cfg()
    det = Detector(cfg, device="cpu").init_weights(0)
    points, num_points = infer_inputs(cfg)
    runs = world2["runs"]["infer"]
    for run in runs:
        assert run["gathers"] == 3
        for a, b in zip(run["out"], runs[0]["out"]):
            assert torch.equal(a, b)
    out = runs[0]["out"]
    assert out.boxes.shape[0] == INFER_FRAMES
    for i in (0, 3, 7):
        single = det.infer(torch.from_numpy(points[i]), int(num_points[i]))
        np.testing.assert_array_equal(out.valid[i].numpy(), single.valid.numpy())
        np.testing.assert_allclose(out.scores[i].numpy(), single.scores.numpy(), atol=1e-5)
        np.testing.assert_allclose(out.boxes[i].numpy(), single.boxes.numpy(), atol=1e-4)


def test_device_augmented_dp_step_draws_per_rank(world2):
    r0, r1 = world2["runs"]["augment"]
    differ = [not torch.equal(r0["draws"][k], r1["draws"][k]) for k in r0["draws"]]
    assert all(differ), r0["draws"].keys()
    assert r0["loss"] == r1["loss"] and np.isfinite(r0["loss"])
    assert_same_digests(r1["sd"], r0["sd"], "weights after the step")


def test_train_app_data_parallel_matches_one_process(world2, tmp_path):
    cfg = world2["app_cfg"]
    want = train_app.train(cfg, max_steps=3, display_step=1, save_step=3, eval_step=100, synthetic=True, seed=0,
                           model_dir=str(tmp_path), device="cpu")
    r0, r1 = world2["runs"]["app"]
    assert r0["steps"] == r1["steps"] == 3
    assert (r0["saves"], r0["evals"], r0["ms_per_step"]) == (1, 1, 3)
    assert (r1["saves"], r1["evals"], r1["ms_per_step"]) == (0, 0, 0)
    lr = cfg.learning_rate
    assert r1["sd"] is None
    assert_same_digests(r1["sd_digests"], digests(r0["sd"]), "the app's weights")
    for k, v in want["trainer"].model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(r0["sd"][k], v, rtol=1e-5, atol=1e-6)
        elif v.is_floating_point():
            assert (r0["sd"][k] - v).abs().max() <= 3 * 2 * lr, k
    model_dir = world2["tmp"] / "app"
    assert sorted(p.name for p in model_dir.iterdir()) == ["3.pth", "latest.pth", "log.txt"]
    assert (model_dir / "log.txt").read_text().count("===== step 3 =====") == 1
    saved = torch.load(model_dir / "latest.pth", weights_only=True)
    for k, v in saved["model_state_dict"].items():
        assert torch.equal(v, r0["sd"][k]), k


def test_infer_app_shards_on_the_gcd_of_batch_and_world(world4):
    """`infer --batch 6` on four ranks: the first gcd(6, 4) = 2 shard each
    chunk, rank 0 alone returns the annos, and they are the one-process
    app's."""
    results = world4["infer_app"]
    assert results[1] is None and results[2] is None and results[3] is None
    cfg = small_cfg(batch_size=GLOBAL_BATCH)
    want = infer_app.infer(cfg, synthetic=True, num_frames=8, range_thresholds=(80.0,), batch=6, device="cpu")
    got = results[0]
    assert len(got) == len(want["dt_annos"]) == 8
    for a, b in zip(got, want["dt_annos"]):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["name"], b["name"])
        np.testing.assert_allclose(a["score"], b["score"], atol=1e-5)
        np.testing.assert_allclose(a["location"], b["location"], atol=1e-4)
