"""Checkpoints in the reference's `.pth` format: `latest.pth` plus an
immutable `<step>.pth`.

Counterpart of the JAX package's train/checkpoint.py (reference
train.py:69-76, :117-127). A file holds `{"step", "model_state_dict",
"optimizer_state_dict"}`, what the reference trainer saves and what the JAX
package's `deploy/torch_interop.export_torch_checkpoint` writes, so a JAX
run exported to `.pth` resumes here and a `.pth` written here imports into
the JAX package (`import_torch_checkpoint`):

  * `model_state_dict`: the trainer's model `state_dict`, batch statistics
    (`running_mean`, `running_var`, `num_batches_tracked`) included; the
    port's `TrainState` holds no weights;
  * `optimizer_state_dict`: a valid torch Adam state dict, `state[i] =
    {"step", "exp_avg", "exp_avg_sq"}` for the i-th of `model.parameters()`
    (the reference's parameter order), `param_groups[0]["lr"]` the state's
    lr; `{"state": {}, ...}` before the first step.

Each file is written to `.tmp.<name>.<hex>` in the same directory and then
renamed over its target, so a crash mid-save leaves the previous `latest`.
In a data-parallel run rank 0 alone writes; every other rank opens the
directory `readonly` (no sweep of `.tmp.*` files that rank 0 may be
writing, and `save` raises), restores from it, and waits at a barrier
while rank 0 saves (`apps/train_app.py`).
"""

from __future__ import annotations

import os
import uuid
from pathlib import Path

import torch

from det3d_tpu_torch.train.trainer import ADAM_B1, ADAM_B2, ADAM_EPS, TrainState

LATEST = "latest.pth"


def checkpoint_dict(state: TrainState, model: torch.nn.Module, step: int | None = None) -> dict:
    """The `.pth` contents of `state` and `model`'s weights (CPU copies);
    `step` is the file's step where it differs from Adam's (a checkpoint
    whose optimizer starts afresh)."""
    params = list(model.parameters())
    adam = {}
    if state.step > 0:
        adam = {
            i: {"step": torch.tensor(float(state.step)),
                "exp_avg": m.detach().float().cpu().clone(), "exp_avg_sq": v.detach().float().cpu().clone()}
            for i, (m, v) in enumerate(zip(state.mu, state.nu))
        }
    return {
        "step": int(state.step if step is None else step),
        "model_state_dict": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
        "optimizer_state_dict": {
            "state": adam,
            "param_groups": [{
                "lr": float(state.lr), "betas": (ADAM_B1, ADAM_B2), "eps": ADAM_EPS, "weight_decay": 0,
                "amsgrad": False, "maximize": False, "foreach": None, "capturable": False,
                "differentiable": False, "fused": None, "params": list(range(len(params))),
            }],
        },
    }


def read_checkpoint(path: str | Path, map_location=None) -> tuple[dict, int, dict | None]:
    """A `.pth` file → (model state_dict, step, optimizer state_dict or
    None). Takes the trainer's full dict and a bare `state_dict` (step 0,
    no optimizer state), as the JAX package's `load_reference_checkpoint`."""
    ckpt = torch.load(str(path), map_location=map_location, weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        return ckpt["model_state_dict"], int(ckpt.get("step", 0)), ckpt.get("optimizer_state_dict") or None
    return ckpt, 0, None


def restore(path: str | Path, model: torch.nn.Module, default_lr: float) -> TrainState:
    """Load a `.pth` into `model` (strictly) and return its optimizer state
    on the model's device (`load_into`)."""
    sd, _, opt_sd = read_checkpoint(path, map_location=next(model.parameters()).device)
    return load_into(model, sd, opt_sd, default_lr)


def load_into(model: torch.nn.Module, sd: dict, opt_sd: dict | None, default_lr: float) -> TrainState:
    """Load a model state_dict into `model` (strictly) and return the
    optimizer state of `opt_sd` on the model's device: Adam's moments
    (float32) and step, and the lr of its param group (`default_lr` where
    it has none). An empty or absent optimizer state gives a fresh Adam at
    step 0. torch keeps one Adam step per parameter and the port one for
    all: counts that differ, or moments for some parameters only, cannot be
    represented and raise."""
    model.load_state_dict(sd, strict=True)
    params = list(model.parameters())
    mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    lr, step = float(default_lr), 0
    if opt_sd is not None:
        groups = opt_sd.get("param_groups") or [{}]
        lr = float(groups[0].get("lr", default_lr))
        entries = opt_sd.get("state") or {}
        if entries:
            counts = set()
            for i, p in enumerate(params):
                entry = entries.get(i, entries.get(str(i)))
                if entry is None:
                    raise ValueError(f"Adam state missing for parameter {i} while others have stepped: one "
                                     "step count for all parameters cannot represent it")
                if entry["exp_avg"].shape != p.shape:
                    raise ValueError(f"moment shape {tuple(entry['exp_avg'].shape)} != parameter {i} shape "
                                     f"{tuple(p.shape)}: not this model's parameter order")
                counts.add(int(torch.as_tensor(entry["step"]).item()))
                mu[i].copy_(entry["exp_avg"])
                nu[i].copy_(entry["exp_avg_sq"])
            if len(counts) != 1:
                raise ValueError(f"per-parameter Adam step counts differ ({sorted(counts)}): one step count "
                                 "for all parameters cannot represent them")
            step = counts.pop()
    return TrainState(step=step, mu=mu, nu=nu, lr=lr)


class CheckpointManager:
    """`latest.pth` and `<step>.pth` under `model_dir`."""

    def __init__(self, model_dir: str | Path, readonly: bool = False):
        """readonly=True opens without side effects (no mkdir, no sweep of
        `.tmp.*` files), for readers while another process may be saving."""
        self.model_dir = Path(model_dir).absolute()
        self._readonly = readonly
        if readonly:
            return
        self.model_dir.mkdir(parents=True, exist_ok=True)
        for stale in self.model_dir.glob(".tmp.*"):  # left by a crashed save
            stale.unlink(missing_ok=True)

    @property
    def latest_path(self) -> Path:
        return self.model_dir / LATEST

    def has_latest(self) -> bool:
        return self.latest_path.exists()

    def save(self, state: TrainState, model: torch.nn.Module, step: int | None = None) -> None:
        """Write `latest.pth` and `<step>.pth` (reference train.py:117-127),
        each to a temporary name first and then renamed over its target;
        `step` as in `checkpoint_dict`."""
        if self._readonly:
            raise RuntimeError("CheckpointManager opened readonly; cannot save")
        contents = checkpoint_dict(state, model, step)
        for name in (LATEST, f"{int(contents['step'])}.pth"):
            tmp = self.model_dir / f".tmp.{name}.{uuid.uuid4().hex[:8]}"
            try:
                torch.save(contents, str(tmp))
                os.replace(tmp, self.model_dir / name)
            finally:
                tmp.unlink(missing_ok=True)

    def restore_latest(self, trainer) -> TrainState | None:
        """Load `latest.pth` into `trainer.model` and return its state, or
        None where there is none (reference train.py:69-76)."""
        if not self.has_latest():
            return None
        return restore(self.latest_path, trainer.model, trainer.cfg.learning_rate)


def load_latest_state(cfg, checkpoint: str | Path, detector=None, device=None):
    """Read-only restore for the entry points that do not train (infer): a
    model directory's `latest.pth`, or a `.pth` file, into `detector` (a
    new `Detector(cfg, device)` by default) → (detector, TrainState).
    Raises FileNotFoundError where there is no checkpoint."""
    from det3d_tpu_torch.pipeline import Detector

    path = Path(checkpoint)
    if path.is_dir():
        path = CheckpointManager(path, readonly=True).latest_path
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    detector = detector or Detector(cfg, device)
    return detector, restore(path, detector.model, cfg.learning_rate)
