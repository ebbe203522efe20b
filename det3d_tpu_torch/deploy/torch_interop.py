"""Reference checkpoints in and out: `import-weights` and `export-weights`.

Counterpart of the checkpoint half of the JAX package's
deploy/torch_interop.py (`import_torch_checkpoint` :364,
`export_torch_checkpoint` :163). The port's checkpoint already is the
reference `.pth` (`{"step", "model_state_dict", "optimizer_state_dict"}`,
train/checkpoint.py), so no layout changes here: an import checks a `.pth`
strictly against the model (every key and shape) and the Adam layout (one
step count, moments shaped as their parameters, in `model.parameters()`
order) and writes `latest.pth` + `<step>.pth` through `CheckpointManager`;
an export writes a model directory's latest as one `.pth`, its optimizer
state a valid torch Adam state dict.
"""

from __future__ import annotations

from pathlib import Path

from det3d_tpu_torch.config import Config
from det3d_tpu_torch.models.pointpillars import PointPillars
from det3d_tpu_torch.train.checkpoint import CheckpointManager, checkpoint_dict, load_into, read_checkpoint


def _reference_layout(cfg: Config) -> None:
    """The reference `.pth` layout has the shared head only (the JAX
    package's torch_interop maps `heads.conv_{cls,box,dir}` and nothing
    else), so a multi-head model has no file there to cross to."""
    if cfg.head != "shared":
        raise ValueError(f"head {cfg.head!r}: the reference .pth layout has only the shared head "
                         "(heads.conv_cls/conv_box/conv_dir); a multi-head model's own checkpoints "
                         "(latest.pth of its model directory) restore with --checkpoint")


def import_torch_checkpoint(ckpt_path: str | Path, cfg: Config, model_dir: str | Path,
                            import_optimizer: bool = True) -> int:
    """Check the reference `.pth` at `ckpt_path` against `cfg`'s model and
    write it into `model_dir` → its step. `import_optimizer=False` drops
    Adam's moments: the run resumes with a fresh optimizer, and the files
    keep the `.pth`'s step. Raises ValueError on a key, shape or Adam
    layout that is not this model's, and for a multi-head config."""
    _reference_layout(cfg)
    sd, step, opt_sd = read_checkpoint(ckpt_path, map_location="cpu")
    model = PointPillars(cfg)
    try:
        state = load_into(model, sd, opt_sd if import_optimizer else None, cfg.learning_rate)
    except RuntimeError as e:  # load_state_dict's missing / unexpected keys, wrong shapes
        raise ValueError(f"{ckpt_path} does not fit this config's model: {e}") from None
    if import_optimizer and state.step not in (0, step):
        raise ValueError(f"Adam's step {state.step} differs from the checkpoint's step {step}: one step count "
                         "cannot represent both; import with --no-optimizer")
    CheckpointManager(model_dir).save(state, model, step=step)
    return step


def export_torch_checkpoint(model_dir: str | Path, cfg: Config, out_path: str | Path) -> int:
    """Write `model_dir`'s `latest.pth` (or a `.pth` file) as one
    reference-layout `.pth` at `out_path`, checked against `cfg`'s model
    on the way → its step. Raises ValueError for a multi-head config."""
    import torch

    _reference_layout(cfg)
    path = Path(model_dir)
    if path.is_dir():
        path = CheckpointManager(path, readonly=True).latest_path
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    sd, step, opt_sd = read_checkpoint(path, map_location="cpu")
    model = PointPillars(cfg)
    state = load_into(model, sd, opt_sd, cfg.learning_rate)
    torch.save(checkpoint_dict(state, model, step=step), str(out_path))
    return step
