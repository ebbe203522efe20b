"""Experiment configuration (numpy only).

The port's own copy of the JAX package's config module: the same flat-JSON
schema (reference: configs/ntusl_20cm.json), the same immutable `Config`
with derived geometry computed once, and the same hard-coded per-class
anchor specifications.

Derived values reproduced exactly:
  * the voxel-grid snap of the detection range (grid_size, detection_offset,
    detection_range_diff) — reference framework/voxel_generator.py:7-15;
  * the hard-coded per-class anchor specifications — reference
    framework/anchor_assigner.py:222-245;
  * the feature map, always the voxel grid at half resolution.

Layout keys. The port honours four of the JAX config's layout keys, read
from the same JSON keys and applied by the same rules
(models/pointpillars.PointPillars.forward):
  * `pack_w`: the w-parity packed network fed by the space-to-depth (s2d)
    canvas; needs nx % 2 == 0 and ny % 4 == 0;
  * `block0_blocked` (inference) and `block0_blocked_train` (training, at
    batch <= 2): block0 on the blocked-halo s2d canvas; need packing and
    `block0_blocking(grid)` > 1 block;
  * `late_blocked_train` (training, at batch <= 2): blocks 1-2
    batch-over-row-blocks. The port takes it only with packing; the JAX
    package also takes it on its dense network.
Two divergences, both so that the dense network stays the port's main
path: `pack_w` defaults to False here (True in the JAX package), and
`late_blocked_train` needs `pack_w`. The packing exists to fill the TPU's
128 lanes; on the card the defaults are chosen by measurement
(PERF.md), so `configs/ntusl_20cm.json`, which does not name `pack_w`,
builds the dense network, and its `block0_blocked_train` /
`late_blocked_train` keys are inert. The packed path is taken where a
config says `"pack_w": true` or a caller writes `cfg.replace(pack_w=True)`.
Parameters and `state_dict` keys do not depend on the layout.

Two more keys act on the packed inference network only, with the JAX
package's defaults (True) and rules (models/pointpillars.PointPillars.forward):
  * `fuse_in_stats`: the upsample branches' InstanceNorm statistics from
    Gram matrices of their coarse inputs, with IN + ReLU applied in the
    branch's epilogue, each branch emitted per column parity;
  * `split_head`: with the shared head, the neck returns one 320-channel
    map per column parity and the head and the decode take the pair.
Neither acts in training or on the dense network, so the port's default
network, and every `state_dict`, is the same whatever they say.
"""

from __future__ import annotations

import dataclasses
import json
import re
import warnings
from pathlib import Path
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """Anchor specification for one detection class
    (reference: framework/anchor_assigner.py:224-245)."""

    name: str
    sizes: tuple[tuple[float, float, float], ...]   # (l, w, h) per size
    rotations: tuple[float, ...]
    feature_map_size: tuple[int, int, int]          # per size; all equal here
    matched_threshold: float
    unmatched_threshold: float

    @property
    def num_anchors_per_loc(self) -> int:
        return len(self.sizes) * len(self.rotations)


# The reference hard-codes these three classes regardless of the JSON's
# detect_class entry (reference: framework/anchor_assigner.py:222).
DEFAULT_CLASS_SPECS: tuple[ClassSpec, ...] = (
    ClassSpec(
        name="vehicle",
        sizes=((4.6, 2.10, 1.8), (7.5, 2.6, 2.9), (12.6, 2.9, 3.8)),
        rotations=(0.0, 1.5707963267948966),
        feature_map_size=(400, 400, 1),
        matched_threshold=0.6,
        unmatched_threshold=0.45,
    ),
    ClassSpec(
        name="pedestrian",
        sizes=((0.96874749, 0.9645992, 1.81212425),),
        rotations=(0.0,),
        feature_map_size=(400, 400, 1),
        matched_threshold=0.45,
        unmatched_threshold=0.25,
    ),
    ClassSpec(
        name="cyclist",
        sizes=((2.02032733, 0.98075615, 1.72027404),),
        rotations=(0.0, 1.5707963267948966),
        feature_map_size=(400, 400, 1),
        matched_threshold=0.5,
        unmatched_threshold=0.25,
    ),
)


@dataclasses.dataclass(frozen=True)
class Config:
    """Immutable experiment configuration with all derived geometry."""

    # ---- raw schema fields (reference: configs/ntusl_20cm.json) ----
    data_root: str = ""
    model_path: str = ""
    train_info: tuple[str, ...] = ()
    eval_info: tuple[str, ...] = ()
    dt_info: str = "dt_info.pkl"
    experiment: str = "default"
    result_path: str = "results/"
    batch_size: int = 1
    num_workers: int = 0
    learning_rate: float = 5e-4
    create_mask_gpu: int = 1
    feature_map_size: tuple[int, int, int] = (400, 400, 1)
    detection_range_raw: tuple[float, ...] = (-80.0, -80.0, -2.5, 80.0, 80.0, 8.5)
    center_limit: tuple[float, ...] = (-80.0, -80.0, -10.0, 80.0, 80.0, 10.0)
    voxel_size: tuple[float, float, float] = (0.2, 0.2, 11.0)
    max_voxels: int = 16000
    max_num_points: int = 15
    num_point_features: int = 4
    detect_class: tuple[str, ...] = ("vehicle", "pedestrian", "cyclist")
    box_code_size: int = 7

    # ---- framework-level knobs (no reference counterpart) ----
    max_points: int = 200_000        # static per-frame point budget (pad-to-max)
    head: str = "shared"             # detection head: "shared" | "multi"
    max_gt_boxes: int = 64           # static per-class gt budget for targets
    compute_dtype: str = "bfloat16"  # conv/matmul compute dtype ("float32" for parity runs)

    # ---- layout levers (see the module docstring) ----
    pack_w: bool = False                # w-parity packed network on the s2d canvas
    block0_blocked: bool = False        # inference: blocked-halo block0 (needs pack_w)
    block0_blocked_train: bool = False  # training, batch <= 2: the same
    late_blocked_train: bool = False    # training, batch <= 2: blocks 1-2 row-blocked (needs pack_w)
    fuse_in_stats: bool = True          # packed inference: Gram-statistic branch IN + ReLU epilogues
    split_head: bool = True             # packed inference, shared head: per-column-parity neck and preds

    # ---- derived (reference: framework/voxel_generator.py:7-15) ----
    detection_range: tuple[float, ...] = ()
    detection_offset: tuple[float, float, float] = ()
    detection_range_diff: tuple[float, float, float] = ()
    grid_size: tuple[int, int, int] = ()

    class_specs: tuple[ClassSpec, ...] = DEFAULT_CLASS_SPECS

    @property
    def num_anchors_per_loc(self) -> int:
        return sum(s.num_anchors_per_loc for s in self.class_specs)

    @property
    def num_anchors(self) -> int:
        return sum(
            s.num_anchors_per_loc * int(np.prod(s.feature_map_size))
            for s in self.class_specs
        )

    def replace(self, **kw: Any) -> "Config":
        cfg = dataclasses.replace(self, **kw)
        if "voxel_size" in kw or "detection_range_raw" in kw:
            cfg = _with_derived(cfg)
            # keep feature_map_size / per-class feature maps consistent with
            # the new grid (mirrors load_config) unless explicitly overridden
            if "feature_map_size" not in kw:
                fms = (cfg.grid_size[0] // 2, cfg.grid_size[1] // 2, 1)
                specs = kw.get(
                    "class_specs",
                    tuple(
                        dataclasses.replace(s, feature_map_size=fms)
                        for s in cfg.class_specs
                    ),
                )
                cfg = dataclasses.replace(
                    cfg, feature_map_size=fms, class_specs=specs
                )
        return cfg


def _snap_range(detection_range: np.ndarray, voxel_size: np.ndarray):
    """Snap the detection range onto an integer voxel grid, in float32
    (reference framework/voxel_generator.py:7-15): the range is re-centred
    so `grid_size * voxel_size` exactly tiles it."""
    detection_range = detection_range.astype(np.float32)
    voxel_size = voxel_size.astype(np.float32)
    center = (detection_range[3:] + detection_range[:3]) / 2
    extent = detection_range[3:] - detection_range[:3]
    grid_size = (extent / voxel_size).astype(np.int32)
    range_diff = grid_size.astype(np.float32) * voxel_size
    offset = center - range_diff / 2
    snapped = np.concatenate([offset, offset + range_diff], axis=0)
    return snapped, offset, range_diff, grid_size


def _with_derived(cfg: Config) -> Config:
    snapped, offset, range_diff, grid_size = _snap_range(
        np.array(cfg.detection_range_raw, np.float32),
        np.array(cfg.voxel_size, np.float32),
    )
    return dataclasses.replace(
        cfg,
        detection_range=tuple(float(v) for v in snapped),
        detection_offset=tuple(float(v) for v in offset),
        detection_range_diff=tuple(float(v) for v in range_diff),
        grid_size=tuple(int(v) for v in grid_size),
    )


_TRAILING_COMMA = re.compile(r",\s*([}\]])")


def _loads_tolerant(text: str) -> dict:
    """Parse JSON, tolerating trailing commas (several reference configs —
    e.g. configs/nuscene.json — are invalid strict JSON)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return json.loads(_TRAILING_COMMA.sub(r"\1", text))


def load_config(path: str | Path | dict, **overrides: Any) -> Config:
    """Load a reference-schema JSON config (a path or a dict) into a `Config`.

    Unknown keys are ignored (the reference's `anchor_sizes` / `rotations` /
    threshold keys are superseded by the hard-coded class specs, exactly as
    in the reference where AnchorAssigner overwrites them)."""
    if isinstance(path, dict):
        raw = dict(path)
    else:
        raw = _loads_tolerant(Path(path).read_text())
    raw.update(overrides)

    def get(key, default):
        return raw.get(key, default)

    def tup(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v

    cfg = Config(
        data_root=get("data_root", ""),
        model_path=get("model_path", ""),
        train_info=tup(get("train_info", ())),
        eval_info=tup(get("eval_info", ())),
        dt_info=get("dt_info", "dt_info.pkl"),
        experiment=get("experiment", "default"),
        result_path=get("result_path", "results/"),
        batch_size=int(get("batch_size", 1)),
        num_workers=int(get("num_workers", 0)),
        learning_rate=float(get("learning_rate", 5e-4)),
        create_mask_gpu=int(get("create_mask_gpu", 1)),
        feature_map_size=(400, 400, 1),  # replaced with grid//2 below
        detection_range_raw=tup(get("detection_range", (-80.0, -80.0, -2.5, 80.0, 80.0, 8.5))),
        center_limit=tup(get("center_limit", (-80.0, -80.0, -10.0, 80.0, 80.0, 10.0))),
        voxel_size=tup(get("voxel_size", (0.2, 0.2, 11.0))),
        max_voxels=int(get("max_voxels", 16000)),
        max_num_points=int(get("max_num_points", 15)),
        num_point_features=int(get("num_point_features", 4)),
        detect_class=tup(get("detect_class", ("vehicle", "pedestrian", "cyclist"))),
        box_code_size=int(get("box_code_size", 7)),
        max_points=int(get("max_points", 200_000)),
        max_gt_boxes=int(get("max_gt_boxes", 64)),
        compute_dtype=get("compute_dtype", "bfloat16"),
        head=get("head", "shared"),
        pack_w=bool(get("pack_w", False)),
        block0_blocked=bool(get("block0_blocked", False)),
        block0_blocked_train=bool(get("block0_blocked_train", False)),
        late_blocked_train=bool(get("late_blocked_train", False)),
        fuse_in_stats=bool(get("fuse_in_stats", True)),
        split_head=bool(get("split_head", True)),
    )
    cfg = _with_derived(cfg)
    # The feature map is ALWAYS the voxel grid at half resolution: the RPN's
    # overall stride is 2, so anchors must live on grid//2 or they desync
    # from the head. The JSON field is ignored, as in the reference's
    # AnchorAssigner, which hard-codes per-class maps.
    fms = (cfg.grid_size[0] // 2, cfg.grid_size[1] // 2, 1)
    json_fms = raw.get("feature_map_size")
    if json_fms is not None and tuple(json_fms) != fms:
        warnings.warn(
            f"config feature_map_size {tuple(json_fms)} disagrees with the "
            f"derived grid//2 = {fms}; the JSON field is ignored (the live "
            "network can only produce grid//2 maps)",
            stacklevel=2,
        )
    specs = tuple(
        dataclasses.replace(s, feature_map_size=fms) for s in cfg.class_specs
    )
    return dataclasses.replace(cfg, feature_map_size=fms, class_specs=specs)
