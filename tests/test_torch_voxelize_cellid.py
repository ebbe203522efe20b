"""The cell-id-ordered voxelizer (`ops/voxelize.voxelize(..., fcfs=False)`)
against the JAX package's `voxelize(..., fcfs=False)`, and the detector that
takes it (`Detector(cfg, fcfs=False)`).

Inputs are seeded numpy clouds on the small config (__graft_entry__'s
32x32 grid, 256 pillars x 5 points) and the mid config (tools/make_golden's
200x200 grid, 2000 pillars x 8 points), in four cases each: under both caps,
over the pillar cap (`max_voxels` binds), over the per-pillar point cap,
and with padding rows that hold points past `num_points`.

Tolerances: none. The voxelizer moves points and counts, so `voxels`,
`coors`, `num_points_per_voxel` and `voxel_num` are bit-equal to JAX's. Under
the cap both slot orders keep the same pillars with the same points
(tests/test_voxelize.py's property), so the network sees the same canvas
and the detections are equal too.
"""

from __future__ import annotations

import jax  # noqa: F401  (on the CPU, as tests/conftest.py sets it)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parity_utils as pu
from det3d_tpu.ops import voxelize as jvox
from det3d_tpu_torch.ops import voxelize as tvox
from det3d_tpu_torch.pipeline import Detector
from test_torch_tmpdirs import tmp_path  # noqa: F401

CONFIGS = {"small": pu.small_cfg, "mid": pu.mid_cfg}
# points of each case, by config: under both caps, over the pillar cap, over
# the point cap (the cloud squeezed into a few cells), with padding rows
CASES = {
    "small": {"under": 150, "pillar_cap": 900, "point_cap": 400, "padding": 150},
    "mid": {"under": 1200, "pillar_cap": 6000, "point_cap": 3000, "padding": 1200},
}


def cloud(jcfg, case: str, seed: int = 0) -> tuple[np.ndarray, int]:
    """A padded (max_points, 4) float32 cloud and its point count: uniform
    over the detection range (a 4 m square for "point_cap"), with a tenth of
    the points out of range; for "padding", random points in the rows past
    the count too."""
    n = CASES["small" if jcfg.max_voxels <= 256 else "mid"][case]
    r = np.random.RandomState(seed)
    x0, y0, z0, x1, y1, z1 = jcfg.detection_range
    if case == "point_cap":
        x0, y0, x1, y1 = -2.0, -2.0, 2.0, 2.0
    pts = np.zeros((jcfg.max_points, 4), np.float32)
    rows = jcfg.max_points if case == "padding" else n
    pts[:rows, 0] = r.uniform(x0 - 0.1 * (x1 - x0), x1, rows)
    pts[:rows, 1] = r.uniform(y0, y1, rows)
    pts[:rows, 2] = r.uniform(z0, z1, rows)
    pts[:rows, 3] = r.uniform(0, 1, rows)
    return pts, n


def both(jcfg, pts: np.ndarray, n: int, fcfs: bool):
    jspec = jvox.VoxelizerSpec.from_config(jcfg)
    tspec = tvox.VoxelizerSpec.from_config(pu.to_torch_cfg(jcfg))
    want = jvox.voxelize(jnp.asarray(pts), np.int32(n), jspec, fcfs=fcfs)
    got = tvox.voxelize(torch.from_numpy(pts), n, tspec, tvox.grid_tensors(tspec, pu.CPU), fcfs=fcfs)
    return got, want


def cell_keys(frame) -> np.ndarray:
    c = frame.coors[:int(frame.voxel_num)].numpy().astype(np.int64)
    return (c[:, 0] * 10_000 + c[:, 1]) * 100 + c[:, 2]


@pytest.mark.parametrize("case", ["under", "pillar_cap", "point_cap", "padding"])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_cell_id_order_is_bit_equal_to_jax(which, case):
    jcfg = CONFIGS[which]()
    pts, n = cloud(jcfg, case)
    got, want = both(jcfg, pts, n, fcfs=False)
    for name in ("voxels", "coors", "num_points_per_voxel", "voxel_num"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                      w.view(np.int32) if w.dtype == np.float32 else w, err_msg=name)
    # the case holds what it names
    vn, counts = int(got.voxel_num), got.num_points_per_voxel.numpy()
    if case == "pillar_cap":
        assert vn == jcfg.max_voxels
    else:
        assert 0 < vn < jcfg.max_voxels
    if case == "point_cap":
        assert counts.max() == jcfg.max_num_points
    keys = cell_keys(got)
    assert np.all(np.diff(keys) > 0), "slots follow cell-id order"


@pytest.mark.parametrize("case", ["under", "point_cap", "padding"])
@pytest.mark.parametrize("which", list(CONFIGS))
def test_same_pillars_as_first_occurrence_order_under_the_cap(which, case):
    """tests/test_voxelize.py's property on the port: the same pillar set
    with the same points, in other slots."""
    jcfg = CONFIGS[which]()
    pts, n = cloud(jcfg, case, seed=1)
    spec = tvox.VoxelizerSpec.from_config(pu.to_torch_cfg(jcfg))
    grid = tvox.grid_tensors(spec, pu.CPU)
    a = tvox.voxelize(torch.from_numpy(pts), n, spec, grid, fcfs=True)
    b = tvox.voxelize(torch.from_numpy(pts), n, spec, grid, fcfs=False)
    assert int(a.voxel_num) == int(b.voxel_num) < spec.max_voxels
    ka, kb = np.argsort(cell_keys(a)), np.argsort(cell_keys(b))
    na = int(a.voxel_num)
    for name in ("coors", "num_points_per_voxel", "voxels"):
        x, y = getattr(a, name)[:na].numpy()[ka], getattr(b, name)[:na].numpy()[kb]
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("which", list(CONFIGS))
def test_cap_keeps_the_lowest_cell_ids(which):
    """Where `max_voxels` binds, cell-id order keeps the `max_voxels` lowest
    occupied cells (first-occurrence order keeps the first to occur)."""
    jcfg = CONFIGS[which]()
    pts, n = cloud(jcfg, "pillar_cap", seed=2)
    spec = tvox.VoxelizerSpec.from_config(pu.to_torch_cfg(jcfg))
    every = spec._replace(max_voxels=jcfg.max_points)
    grid = tvox.grid_tensors(spec, pu.CPU)
    occupied = cell_keys(tvox.voxelize(torch.from_numpy(pts), n, every, grid))
    assert len(occupied) > spec.max_voxels
    kept = tvox.voxelize(torch.from_numpy(pts), n, spec, grid, fcfs=False)
    np.testing.assert_array_equal(cell_keys(kept), np.sort(occupied)[:spec.max_voxels])
    first = tvox.voxelize(torch.from_numpy(pts), n, spec, grid, fcfs=True)
    np.testing.assert_array_equal(cell_keys(first), occupied[:spec.max_voxels])


def test_detector_detects_alike_in_both_orders_under_the_cap():
    """`Detector(cfg, fcfs=False).detect` on the small config, seeded
    weights: the detections of `fcfs=True`, element for element."""
    jcfg = pu.small_cfg()
    tcfg = pu.to_torch_cfg(jcfg)
    dets = {f: Detector(tcfg, device="cpu", fcfs=f).init_weights(0) for f in (True, False)}
    assert dets[False].module.fcfs is False and dets[True].module.fcfs is True
    for seed in range(3):
        pts, n = cloud(jcfg, "under", seed=10 + seed)
        frame, _ = dets[False].preprocess(torch.from_numpy(pts), n)
        assert 0 < int(frame.voxel_num) < tcfg.max_voxels
        got, want = (dets[f].detect(pts[:n]) for f in (False, True))
        assert got.keys() == want.keys()
        assert len(want["score"]) > 0, "a frame with no detection holds nothing"
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_export_carries_the_cell_id_order(tmp_path):
    """`export_detector(..., fcfs=False)`: the exported program voxelizes in
    cell-id order. On a frame over the pillar cap, where the two orders
    keep other pillars, it detects as the live `fcfs=False` detector does
    and not as `fcfs=True`."""
    from det3d_tpu_torch.deploy import export as texport
    from det3d_tpu_torch.deploy import runtime as truntime

    jcfg = pu.small_cfg()
    tcfg = pu.to_torch_cfg(jcfg)
    art = texport.export_detector(tcfg, out_dir=tmp_path / "art", device="cpu", fcfs=False)
    runner = truntime.ExportedDetector(art, "cpu")
    pts, n = cloud(jcfg, "pillar_cap", seed=3)
    live = {f: Detector(tcfg, device="cpu", fcfs=f).init_weights(0).infer(torch.from_numpy(pts), n)
            for f in (True, False)}
    got = runner.infer(torch.from_numpy(pts), n)
    for a, b in zip(got, live[False]):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(live[True], live[False]))
