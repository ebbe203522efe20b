"""Training application: the reference's `train()` loop, on one device or
data-parallel over several.

Counterpart of the JAX package's apps/train_app.py (reference
train.py:23-162): an endless step loop, running precision / recall printed
every `display_step`, a checkpoint (`latest.pth` + `<step>.pth`) every
`save_step`, and an in-training evaluation with the official mAP appended
to `log.txt` every `eval_step`. The step is `Trainer.train_step` on the
trainer's device: voxelization, the anchor mask and target assignment run
there, so the host only reads, augments and pads.

Data sources, with the JAX app's seeds, so that a seed gives its batches:
  * real: info pickles through `DetectionDataset` and `BatchPrefetcher`
    (`cfg.num_workers` spawned workers; reference DataLoader workers);
  * `synthetic=True`: scenes from `data/synthetic.sample_scene`.
`device_augment=True` (`train --device-augment`) moves the global
transforms of the augmentation into the step, on the device
(`Trainer(device_global_augment=True)`); the dataset's workers then do only
the per-object noise.

Data-parallel (`mesh`, a `parallel.mesh.DataMesh`; `torchrun
--nproc-per-node N -m det3d_tpu_torch train`, the JAX app's pure-DP mode,
train_app.py:151-175): every rank runs `make_sharded_train_step` on its
slice of each global batch of `cfg.batch_size` (which the world must
divide), loading only that slice; every rank starts from the same weights
(seeded, or the same `latest.pth`), broadcast from rank 0 once more by
`replicated`. Rank 0 alone prints, writes `log.txt`, saves checkpoints
and runs the eval; the others open the model directory readonly and wait
at a barrier after each save and eval. Not ported: `spatial_shards`, the
hybrid data x spatial mode (ROADMAP).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.data.synthetic import sample_scene, scene_to_annos
from det3d_tpu_torch.parallel.mesh import DataMesh, make_sharded_train_step, replicated
from det3d_tpu_torch.train.checkpoint import CheckpointManager
from det3d_tpu_torch.train.metrics import RunningMetrics
from det3d_tpu_torch.train.trainer import Trainer, host_batch


def _batch_iterator(cfg: Config, synthetic: bool, seed: int = 0, device_augment: bool = False,
                    shard: tuple[int, int] = (0, 1)):
    """Host TrainBatches forever (the reference's dataloader loop,
    train.py:92-99, restarts at each epoch's end); with `shard=(rank,
    world)`, rank's contiguous slice of each global batch. Closing the
    generator stops the prefetcher's workers."""
    rank, world = shard
    if synthetic:
        local = cfg.batch_size // world
        rng = np.random.RandomState(seed)
        while True:
            # every rank draws the global batch's scenes and keeps its own
            scenes = [sample_scene(cfg, rng) for _ in range(cfg.batch_size)]
            yield host_batch(cfg, scenes[rank * local:(rank + 1) * local])
    else:
        from det3d_tpu_torch.data.dataset import DetectionDataset
        from det3d_tpu_torch.data.prefetcher import BatchPrefetcher

        ds = DetectionDataset(cfg, cfg.train_info, training=True, seed=seed, device_global_augment=device_augment)
        with BatchPrefetcher(ds, cfg, cfg.num_workers, seed=seed, shard=shard) as pf:
            yield from pf.epochs()


def _eval_samples(cfg: Config, synthetic: bool, n: int, seed: int = 1):
    """(samples, gt annos) of the eval set: synthetic scenes, or the first
    `n` frames of `cfg.eval_info`."""
    rng = np.random.RandomState(seed)
    if synthetic:
        samples = [sample_scene(cfg, rng) for _ in range(n)]
        return samples, [scene_to_annos(s, cfg) for s in samples]
    from det3d_tpu_torch.data.dataset import DetectionDataset

    ds = DetectionDataset(cfg, cfg.eval_info, training=False)
    infos = ds.infos[:n]
    return [{"points": ds.load_points(info)} for info in infos], [gt_annos_of(info) for info in infos]


def gt_annos_of(info: dict) -> dict:
    """An info dict's ground truth in the eval annos format."""
    annos = info["annos"]
    return {
        "name": annos["name"],
        "location": annos["location"],
        "dimensions": annos["dimensions"],
        "rotation_y": annos["rotation_y"],
        "num_points": annos.get("num_points", np.full(len(annos["name"]), 100)),
        "score": np.zeros(len(annos["name"])),
    }


def run_eval(trainer: Trainer, samples, gt_annos, range_thresh: float = 80.0) -> str:
    """In-training eval: infer each frame, official mAP (reference
    train.py:138-161), the rotated IoUs on the trainer's device."""
    from det3d_tpu_torch.eval.ap import get_official_eval_result
    from det3d_tpu_torch.postprocess import to_annos

    cfg = trainer.cfg
    dt_annos = []
    for s in samples:
        pts, n = trainer.detector.pad_points(s["points"])
        dt_annos.append(to_annos(cfg, trainer.eval_step(pts, n)))
    _, eval_str = get_official_eval_result(gt_annos, dt_annos, list(cfg.detect_class), range_thresh,
                                           device=trainer.device)
    return eval_str


def train(
    cfg: Config,
    *,
    max_steps: int = 10_000_000,
    display_step: int = 50,
    save_step: int = 5000,
    eval_step: int = 5000,
    eval_frames: int = 64,
    synthetic: bool = False,
    model_dir: str | None = None,
    seed: int = 0,
    device_augment: bool = False,
    device=None,
    mesh: DataMesh | None = None,
) -> dict:
    """Train on `device` ("cuda" unless the caller names another) from
    seeded weights, or resume from `model_dir`'s `latest.pth` with the
    config's lr (reference train.py:69-76); `device_augment`: the global
    augmentation inside the step, on the device; `mesh`: data-parallel on
    the mesh's device (see the module docstring). Returns what the loop saw
    (on rank 0; the other ranks keep the steps, batch waits and their
    trainer and state): the steps run, ms/step of each display window, the
    seconds each step waited for its batch, each save's and each eval's
    wall seconds, the eval strings, and the trainer and its state."""
    model_dir = Path(model_dir or (Path(cfg.model_path or ".") / cfg.experiment))
    log_path = model_dir / "log.txt"
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    lead = rank == 0  # prints, writes, evaluates
    if mesh is not None:
        if cfg.batch_size % world:
            raise ValueError(f"batch_size {cfg.batch_size} must be divisible by the {world} data-parallel ranks")
        device = mesh.device
    if lead:
        model_dir.mkdir(parents=True, exist_ok=True)

    trainer = Trainer(cfg, device, device_global_augment=device_augment, aug_seed=seed)
    ckpt = CheckpointManager(model_dir, readonly=not lead)
    state = trainer.init_state(seed)
    restored = ckpt.restore_latest(trainer)
    if restored is not None:
        state = Trainer.override_lr(restored, cfg.learning_rate)
        if lead:
            print(f"resumed from step {state.step} (lr={cfg.learning_rate})")
    step_fn = trainer.train_step
    if mesh is not None:
        state = replicated(mesh, trainer, state)
        step_fn = make_sharded_train_step(trainer, mesh)
        if lead:
            print(f"data-parallel over {world} ranks ({mesh.backend}), {cfg.batch_size // world} samples each")

    metrics = RunningMetrics()
    batches = _batch_iterator(cfg, synthetic, seed, device_augment, (rank, world))
    eval_set = None
    summary = {"steps": 0, "ms_per_step": [], "batch_wait_s": [], "save_s": [], "eval_s": [], "eval_strs": []}

    t0 = time.perf_counter()
    step = start = state.step
    # counts and losses stay on the device until display time: a per-step
    # fetch would make the host wait for the card every step
    pending_counts = []
    try:
        while step < max_steps:
            t_wait = time.perf_counter()
            batch = next(batches)
            summary["batch_wait_s"].append(time.perf_counter() - t_wait)
            state, loss_dict, counts = step_fn(state, batch)
            step += 1
            if lead:
                pending_counts.append(counts)

            if lead and step % display_step == 0:
                for c in pending_counts:
                    metrics.update(c)
                pending_counts.clear()
                ld = {k: float(v) for k, v in loss_dict.items()}
                dt = (time.perf_counter() - t0) / display_step
                summary["ms_per_step"].append(dt * 1e3)
                print(f"step {step}  loss {ld['loss']:.4f} (cls {ld['cls_loss']:.4f} "
                      f"loc {ld['loc_loss']:.4f} dir {ld['dir_loss']:.4f})  {dt * 1e3:.0f} ms/step\n  {metrics}")
                metrics.clear()
                t0 = time.perf_counter()

            if step % save_step == 0:
                if lead:
                    t_save = time.perf_counter()
                    ckpt.save(state, trainer.model)
                    summary["save_s"].append(time.perf_counter() - t_save)
                    print(f"saved checkpoint @ {step}")
                if mesh is not None:
                    mesh.barrier()

            if step % eval_step == 0:
                if lead:
                    t_eval = time.perf_counter()
                    if eval_set is None:
                        eval_set = _eval_samples(cfg, synthetic, eval_frames)
                    eval_str = run_eval(trainer, *eval_set)
                    summary["eval_s"].append(time.perf_counter() - t_eval)
                    summary["eval_strs"].append(eval_str)
                    print(eval_str)
                    with open(log_path, "a") as f:
                        f.write(f"===== step {step} =====\n{eval_str}\n")
                if mesh is not None:
                    mesh.barrier()
                t0 = time.perf_counter()
    finally:
        batches.close()
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    summary["steps"] = step - start
    summary["trainer"], summary["state"] = trainer, state
    return summary
