"""Parity of the port's host-side modules and plain ops with the JAX package.

Same numpy inputs (made from seeds) through the JAX function (CPU) and its
`det3d_tpu_torch` counterpart (CPU tensors). Tolerances, with reasons:
  * config, anchors: array-equal — the same numpy code on the same inputs;
  * geometry: allclose 1e-6 — the same float32 formulas, but torch and XLA
    may order an einsum's sums or vectorise sin/cos differently;
  * voxelizer, anchor masks: bit/element-identical — integer keys, a stable
    sort and exact integer-count cumulative sums leave no rounding;
  * decode_stage: valid sets and indices equal, float32 values to 1e-6
    relative (decode's exp/sin/cos may round differently);
  * finalize_stage: equal — NMS and compaction only select and move values.
"""

from __future__ import annotations

import dataclasses

import jax  # noqa: F401  (on the CPU, as tests/conftest.py sets it)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_ref
import test_torch_parity_utils as pu
from det3d_tpu import anchors as janchors
from det3d_tpu import config as jconfig
from det3d_tpu.ops import anchor_mask as jmask
from det3d_tpu.ops import geometry as jgeom
from det3d_tpu.ops import voxelize as jvox
from det3d_tpu_torch import anchors as tanchors
from det3d_tpu_torch import config as tconfig
from det3d_tpu_torch.ops import anchor_mask as tmask
from det3d_tpu_torch.ops import geometry as tgeom
from det3d_tpu_torch.ops import voxelize as tvox

torch.set_num_threads(1)

SMALL_DICT = {
    "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
    "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
    "voxel_size": [1.0, 1.0, 11.0],
    "max_voxels": 256,
    "max_num_points": 5,
    "max_points": 2048,
    "max_gt_boxes": 8,
    "compute_dtype": "float32",
}


def _shared_fields(cfg) -> dict:
    """Every field of the port's Config but `pack_w`, whose default differs
    on purpose (False in the port, True in the JAX package)."""
    names = {f.name for f in dataclasses.fields(tconfig.Config)} - {"pack_w"}
    return {n: getattr(cfg, n) for n in names}


def _config_pair(which: str):
    """(JAX config, the port's config built independently the same way)."""
    if which == "small":
        # __graft_entry__._small_cfg, rebuilt with the port's loader
        t = tconfig.load_config(SMALL_DICT)
        specs = tuple(dataclasses.replace(s, feature_map_size=(16, 16, 1)) for s in t.class_specs)
        specs = (dataclasses.replace(specs[0], sizes=((4.6, 2.10, 1.8),)),) + specs[1:]
        return pu.small_cfg(), t.replace(class_specs=specs)
    if which == "mid":
        from tools.make_golden import mid_cfg

        j = mid_cfg()
        raw = {k: getattr(j, k) for k in ("center_limit", "voxel_size", "max_voxels", "max_num_points",
                                          "max_points", "max_gt_boxes", "compute_dtype")}
        return j, tconfig.load_config({**raw, "detection_range": j.detection_range_raw})
    path = f"configs/{which}.json"
    return jconfig.load_config(path, max_points=120_000), tconfig.load_config(path, max_points=120_000)


class TestConfig:
    @pytest.mark.parametrize("which", ["small", "mid", "ntusl_20cm", "ntusl_10cm"])
    def test_derived_fields_equal(self, which):
        j, t = _config_pair(which)
        jf, tf = _shared_fields(j), _shared_fields(t)
        jf["class_specs"] = tuple(dataclasses.asdict(s) for s in j.class_specs)
        tf["class_specs"] = tuple(dataclasses.asdict(s) for s in t.class_specs)
        assert tf == jf
        assert t.num_anchors == j.num_anchors and t.num_anchors_per_loc == j.num_anchors_per_loc
        assert t.pack_w is False and j.pack_w is True

    def test_replace_rederives_geometry(self):
        j = jconfig.load_config(SMALL_DICT).replace(voxel_size=(0.5, 0.5, 11.0))
        t = tconfig.load_config(SMALL_DICT).replace(voxel_size=(0.5, 0.5, 11.0))
        assert _shared_fields(t) == {**_shared_fields(j), "class_specs": t.class_specs}
        assert t.grid_size == j.grid_size == (64, 64, 1)
        assert t.feature_map_size == (32, 32, 1)


class TestAnchors:
    @pytest.mark.parametrize("which", ["small", "mid", "ntusl_20cm"])
    def test_build_anchors_array_equal(self, which):
        j_cfg, t_cfg = _config_pair(which)
        j, t = janchors.build_anchors(j_cfg), tanchors.build_anchors(t_cfg)
        for name in ("anchors", "anchors_bv", "corner_cells", "matched_threshold", "unmatched_threshold"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
        assert t.grid_hw == j.grid_hw and t.num_channels == j.num_channels
        assert t.class_channels == j.class_channels
        for name in j.class_channels:
            np.testing.assert_array_equal(t.anchors_by_class[name], j.anchors_by_class[name])
            np.testing.assert_array_equal(t.anchors_bv_by_class[name], j.anchors_bv_by_class[name])
        assert (t.mask_index_vectors is None) == (j.mask_index_vectors is None)
        for tv, jv in zip(t.mask_index_vectors or (), j.mask_index_vectors or ()):
            for a, b in zip(tv, jv):
                np.testing.assert_array_equal(a, b)


def _random_boxes(n, seed):
    r = np.random.RandomState(seed)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = r.uniform(-40, 40, (n, 2))
    boxes[:, 2] = r.uniform(-3, 1, n)
    boxes[:, 3:6] = r.uniform(0.5, 8, (n, 3))
    boxes[:, 6] = r.uniform(-2 * np.pi, 2 * np.pi, n)
    return boxes


class TestGeometry:
    """allclose 1e-6: same float32 formulas; torch and XLA may order the
    einsum's two-term sums and vectorise sin/cos differently."""

    TOL = dict(rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_limit_period(self, seed):
        v = np.random.RandomState(seed).uniform(-10, 10, 500).astype(np.float32)
        for offset, period in ((0.5, np.pi), (0.5, 2 * np.pi), (1.0, np.pi)):
            got = tgeom.limit_period(torch.from_numpy(v), offset, period).numpy()
            want = np.asarray(jgeom.limit_period(jnp.asarray(v), offset, period))
            np.testing.assert_allclose(got, want, **self.TOL)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_center_to_corner_and_standup(self, seed):
        b = _random_boxes(300, seed)
        args = (b[:, :2], b[:, 3:5], b[:, 6])
        unit = tgeom.unit_corners(0.5, torch.device("cpu"), torch.float32)
        got = tgeom.center_to_corner_box2d(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), unit)
        want = jgeom.center_to_corner_box2d(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **self.TOL)
        np.testing.assert_allclose(
            tgeom.corner_to_standup(got).numpy(), np.asarray(jgeom.corner_to_standup(want)), **self.TOL
        )

    def test_rotation_and_corners_nd(self):
        r = np.random.RandomState(3)
        pts = r.randn(50, 4, 2).astype(np.float32)
        ang = r.uniform(-3, 3, 50).astype(np.float32)
        got = tgeom.rotation_2d(torch.from_numpy(pts), torch.from_numpy(ang)).numpy()
        np.testing.assert_allclose(got, np.asarray(jgeom.rotation_2d(pts, ang)), **self.TOL)
        dims = r.uniform(0.5, 5, (50, 2)).astype(np.float32)
        unit = tgeom.unit_corners(0.5, torch.device("cpu"), torch.float32)
        np.testing.assert_array_equal(
            tgeom.corners_nd(torch.from_numpy(dims), unit).numpy(), np.asarray(jgeom.corners_nd(jnp.asarray(dims)))
        )

    @pytest.mark.parametrize("seed", [0, 1])
    def test_box_decode(self, seed):
        r = np.random.RandomState(seed)
        anchors = _random_boxes(400, seed + 10)
        enc = (r.randn(400, 7) * 0.3).astype(np.float32)
        got = tgeom.box_decode(torch.from_numpy(enc), torch.from_numpy(anchors)).numpy()
        np.testing.assert_allclose(got, np.asarray(jgeom.box_decode(enc, anchors)), **self.TOL)
        np.testing.assert_allclose(got, np_ref.box_decode_ref(enc, anchors), rtol=1e-5, atol=1e-5)


VOX_SPEC = dict(voxel_size=(1.0, 1.0, 10.0), offset=(0.0, 0.0, -5.0), grid_size=(8, 8, 1))


def _voxel_points(n, seed, lo=-1.0, hi=9.0, max_points=256):
    r = np.random.RandomState(seed)
    pts = np.zeros((max_points, 4), np.float32)
    pts[:n, :2] = r.uniform(lo, hi, (n, 2))
    pts[:n, 2] = r.uniform(-4, 4, n)
    pts[:n, 3] = r.uniform(0, 1, n)
    return pts


class TestVoxelize:
    """Bit-identical to the JAX voxelizer (and, where no cap binds, to the
    sequential numpy oracle)."""

    CASES = {
        "no_cap": (200, 0, -1.0, 9.0, 128, 16),
        "point_cap": (220, 3, 0.0, 4.0, 64, 3),
        "pillar_cap": (200, 5, -1.0, 9.0, 20, 4),
        "empty": (0, 0, -1.0, 9.0, 64, 5),
        "all_out_of_range": (100, 1, 20.0, 30.0, 64, 5),
    }

    @pytest.mark.parametrize("case", list(CASES))
    def test_bit_identical(self, case):
        n, seed, lo, hi, max_voxels, max_num_points = self.CASES[case]
        pts = _voxel_points(n, seed, lo, hi)
        jspec = jvox.VoxelizerSpec(**VOX_SPEC, max_voxels=max_voxels, max_num_points=max_num_points)
        tspec = tvox.VoxelizerSpec(**VOX_SPEC, max_voxels=max_voxels, max_num_points=max_num_points)
        want = jvox.voxelize(jnp.asarray(pts), np.int32(n), jspec)
        got = tvox.voxelize(torch.from_numpy(pts), n, tspec, tvox.grid_tensors(tspec, torch.device("cpu")))
        for name in ("voxels", "coors", "num_points_per_voxel", "voxel_num"):
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                          w.view(np.int32) if w.dtype == np.float32 else w, err_msg=name)
        if case != "pillar_cap":  # the documented divergence when the cap binds
            v, c, cnt, num = np_ref.voxelize_ref(pts[:n], **VOX_SPEC, max_voxels=max_voxels,
                                                 max_num_points=max_num_points)
            assert int(got.voxel_num) == num
            np.testing.assert_array_equal(got.coors[:num].numpy(), c)
            np.testing.assert_array_equal(got.num_points_per_voxel[:num].numpy(), cnt)
            np.testing.assert_array_equal(got.voxels[:num].numpy(), v)

    def test_rejects_too_few_rows(self):
        spec = tvox.VoxelizerSpec(**VOX_SPEC, max_voxels=300, max_num_points=4)
        with pytest.raises(ValueError):
            tvox.voxelize(torch.zeros((256, 4)), 10, spec, tvox.grid_tensors(spec, torch.device("cpu")))


def _mask_case(seed, n_valid=60):
    """Pillar coords on unique cells of the small geometry, -1 padded."""
    j_cfg, _ = _config_pair("small")
    nx, ny = j_cfg.grid_size[:2]
    r = np.random.RandomState(seed)
    coors = np.full((j_cfg.max_voxels, 3), -1, np.int32)
    cells = r.choice(nx * ny, n_valid, replace=False)
    coors[:n_valid, 0], coors[:n_valid, 1], coors[:n_valid, 2] = cells // ny, cells % ny, 0
    return j_cfg, coors, (nx, ny)


class TestAnchorMask:
    """Element-identical: integer occupancy counts, exact f32 sums."""

    @pytest.mark.parametrize("seed,n_valid", [(0, 60), (1, 200), (2, 0)])
    def test_flat_mask(self, seed, n_valid):
        j_cfg, coors, grid = _mask_case(seed, n_valid)
        cells = janchors.build_anchors(j_cfg).corner_cells
        np.testing.assert_array_equal(
            tmask.occupancy_sat(torch.from_numpy(coors), grid).numpy(),
            np.asarray(jmask.occupancy_sat(jnp.asarray(coors), grid)),
        )
        got = tmask.compute_anchors_mask(torch.from_numpy(coors), torch.from_numpy(cells), grid).numpy()
        np.testing.assert_array_equal(got, np.asarray(jmask.compute_anchors_mask(jnp.asarray(coors), cells, grid)))
        np.testing.assert_array_equal(got, np_ref.sat_anchor_mask_ref(coors, grid, cells))

    @pytest.mark.parametrize("seed,n_valid", [(0, 60), (1, 200), (2, 0)])
    def test_separable_mask(self, seed, n_valid):
        j_cfg, coors, grid = _mask_case(seed, n_valid)
        aset = janchors.build_anchors(j_cfg)
        vectors = [tuple(torch.from_numpy(v).long() for v in ch) for ch in aset.mask_index_vectors]
        got = tmask.compute_anchors_mask_separable(torch.from_numpy(coors), vectors, grid).numpy()
        want = np.asarray(jmask.compute_anchors_mask_separable(jnp.asarray(coors), aset.mask_index_vectors, grid))
        np.testing.assert_array_equal(got, want)
        flat = np_ref.sat_anchor_mask_ref(coors, grid, aset.corner_cells)
        np.testing.assert_array_equal(got.reshape(-1), flat)


def _random_preds(cfg, seed):
    """Single-frame preds in the spatial channel-major contract + a mask."""
    r = np.random.RandomState(seed)
    nch = cfg.num_anchors_per_loc
    fx, fy = cfg.feature_map_size[:2]
    return {
        "cls_preds": (r.randn(1, nch, fx, fy) * 2 - 1).astype(np.float32),
        "box_preds": (r.randn(7, nch, fx, fy) * 0.2).astype(np.float32),
        "dir_preds": r.randn(2, nch, fx, fy).astype(np.float32),
    }, r.rand(nch, fx, fy) < 0.7


class TestPostprocess:
    @pytest.mark.parametrize("which,approx", [("small", None), ("mid", True), ("mid", None)])
    def test_decode_stage(self, which, approx):
        from det3d_tpu.postprocess import PostProcessParams, make_postprocessor
        from det3d_tpu_torch.pipeline import Detector

        j_cfg = pu.small_cfg() if which == "small" else pu.mid_cfg()
        preds, mask = _random_preds(j_cfg, seed=7)
        jpost = make_postprocessor(j_cfg, janchors.build_anchors(j_cfg), PostProcessParams(approx_topk=bool(approx)))
        jpreds = {k: jnp.asarray(v) for k, v in preds.items()}
        if approx:
            # the JAX model emits column-parity pairs on this geometry (its
            # split head); the bucketed top-k's buckets follow that form
            jpreds = {k: (v[..., 0::2], v[..., 1::2]) for k, v in jpreds.items()}
        want = jpost.decode_stage(jpreds, jnp.asarray(mask))
        tdet = Detector(pu.to_torch_cfg(j_cfg), device="cpu",
                        postprocess_params=pu.TorchParams(approx_topk=approx))
        got = tdet.postprocess.decode_stage({k: torch.from_numpy(v) for k, v in preds.items()},
                                            torch.from_numpy(mask))
        assert len(got) == len(want) == len(j_cfg.class_specs)
        for g, w in zip(got, want):
            w = [np.asarray(a) for a in w]
            valid = w[3]
            np.testing.assert_array_equal(g.valid.numpy(), valid)
            assert valid.any()
            for name, gi, wi in (("boxes", g.boxes, w[0]), ("scores", g.scores, w[1]), ("standup", g.standup, w[2])):
                np.testing.assert_allclose(gi.numpy()[valid], wi[valid], rtol=1e-6, atol=1e-5, err_msg=name)
            np.testing.assert_array_equal(g.range_ok.numpy()[valid], w[4][valid])

    @pytest.mark.parametrize("seed", [0, 1])
    def test_finalize_stage(self, seed):
        from det3d_tpu.postprocess import make_postprocessor
        from det3d_tpu_torch.pipeline import Detector
        from det3d_tpu_torch.postprocess import Candidates

        j_cfg = pu.small_cfg()
        r = np.random.RandomState(seed)
        cands = []
        for k in (512, 256, 512):  # the small geometry's per-class k
            boxes = _random_boxes(k, seed * 7 + k)
            c, d = boxes[:, :2], boxes[:, 3:5] / 2
            standup = np.concatenate([c - d, c + d], axis=1).astype(np.float32)
            scores = np.sort(r.rand(k).astype(np.float32))[::-1].copy()
            cands.append((boxes, scores, standup, r.rand(k) < 0.8, r.rand(k) < 0.9))
        jpost = make_postprocessor(j_cfg, janchors.build_anchors(j_cfg))
        want = jpost.finalize_stage([tuple(jnp.asarray(a) for a in c) for c in cands])
        tdet = Detector(pu.to_torch_cfg(j_cfg), device="cpu")
        got = tdet.postprocess.finalize_stage([Candidates(*(torch.from_numpy(np.asarray(a)) for a in c)) for c in cands])
        for name in ("boxes", "scores", "valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
        assert got.valid.any()
