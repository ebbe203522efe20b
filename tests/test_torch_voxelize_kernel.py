"""The voxelizer op `det3d::voxelize` (kernels/voxelize_cuda.py,
csrc/voxelize.cu) and where the detector takes it.

CPU half: the op on CPU tensors equals the plain version
(`ops/voxelize.voxelize`) frame by frame, bit for bit, at both families'
specs (ntusl_20cm: 800x800x1, 16 000 x 15 x 4; CenterPoint-PP: 512x512x1,
60 000 x 20 x 5) and at config_nuscene's (512x480x1, 12 000 x 100 x 4: a
point cap past a warp's 32 lanes), in both slot orders, at batch 1 and 3
with unequal counts; its fake gives the real call's shapes, dtypes and
strides; torch.library's checks; the scratch plan; the wrapper's refusals;
an exported detector holds one `det3d::voxelize` node and runs. `mirror` is
csrc/voxelize.cu's algorithm in numpy (the six launches: reset, bin, count,
number, append, fill), with the rows of every atomic pass and the tiles of
the numbering pass visited in shuffled orders, as the card may run them: it
equals the plain version on clouds under both caps, over the pillar cap,
over the point cap (pillars of more than 32 points, which take the fill's
repeated-minimum branch; a cap of 100 points), with padding rows and with
points on and past the grid's edges. Edit it with the kernel.

GPU half (marker `gpu`; skips without a card, decided in a fixture): the
kernels against the plain version on the card, bit for bit, at the three
specs and both slot orders: counts 0, 1 and max_points, the pillar cap
binding, a pillar of more than max_num_points (and of more than 32) points
in shuffled arrival order, points outside the grid and on its edges, a
batch of 4 with unequal counts, scratch full of garbage, replays of a
captured graph; one call per `forward` and per `forward_batch`; bad input
refused. This file imports nothing of JAX. On the card, from the repository
root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_voxelize_kernel.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.kernels import voxelize_cuda
from det3d_tpu_torch.ops.voxelize import VoxelizedFrame, VoxelizerSpec, grid_tensors, voxelize
from test_torch_tmpdirs import tmp_path  # noqa: F401

torch.set_num_threads(1)

OP = "det3d.voxelize.default"
INT_MAX = 2**31 - 1
CONFIGS = {"ntusl": "configs/ntusl_20cm.json", "cppnusc": "benchmark/configs/centerpoint_pp_nusc.json",
           "nusc100": "configs/config_nuscene.json"}
# rows of each configuration's test clouds: the pillar cap and some
ROWS = {"ntusl": 20_000, "cppnusc": 64_000, "nusc100": 16_000}
# real points of a full frame on the card
REAL = {"ntusl": 130_000, "cppnusc": 360_000, "nusc100": 130_000}
FIELDS = VoxelizedFrame._fields


def spec_of(family: str) -> tuple[VoxelizerSpec, int]:
    """(the family's spec, its point features)."""
    cfg = load_config(CONFIGS[family])
    return VoxelizerSpec.from_config(cfg), cfg.num_point_features


def small_spec(**kw) -> VoxelizerSpec:
    """An 8x8 grid of 1 m cells (the small spec of tests/test_torch_ops.py)."""
    return VoxelizerSpec(**{**dict(voxel_size=(1.0, 1.0, 10.0), offset=(0.0, 0.0, -5.0), grid_size=(8, 8, 1),
                                   max_voxels=40, max_num_points=5), **kw})


def mid_spec(**kw) -> VoxelizerSpec:
    """A 200x200 grid of 0.4 m cells, 2000 pillars x 8 points."""
    return VoxelizerSpec(**{**dict(voxel_size=(0.4, 0.4, 8.0), offset=(-40.0, -40.0, -3.0), grid_size=(200, 200, 1),
                                   max_voxels=2000, max_num_points=8), **kw})


def cloud(spec: VoxelizerSpec, rows: int, c: int, seed: int, case: str = "uniform") -> np.ndarray:
    """A (rows, c) float32 cloud: uniform over the grid with a tenth past
    it on every side; "cluster" puts half the points in a few cells;
    "edges" puts points exactly on cell boundaries, the grid's first and
    last included, and one cell past the last."""
    r = np.random.RandomState(seed)
    lo = np.asarray(spec.offset, np.float32)
    ext = np.asarray(spec.voxel_size, np.float32) * np.asarray(spec.grid_size, np.float32)
    pts = r.uniform(0, 1, (rows, c)).astype(np.float32)
    pts[:, :3] = lo - 0.1 * ext + r.uniform(0, 1.2, (rows, 3)).astype(np.float32) * ext
    if case == "cluster":  # 16 cells, in the grid's first z cell
        cells = r.randint(0, 4, (rows // 2, 2)).astype(np.float32) * 3 + 0.5
        pts[: rows // 2, :2] = lo[:2] + cells * np.asarray(spec.voxel_size[:2], np.float32)
        pts[: rows // 2, 2] = lo[2] + 0.5 * np.float32(spec.voxel_size[2])
    elif case == "edges":
        k = r.randint(0, 3, (rows, 3))
        n = np.asarray(spec.grid_size)
        steps = np.where(k == 0, 0, np.where(k == 1, n - 1, n)).astype(np.float32)
        pts[:, :3] = lo + steps * np.asarray(spec.voxel_size, np.float32)
        pts[::3, :3] += r.uniform(0, 1, (len(pts[::3]), 3)).astype(np.float32) * ext
    return pts


def plain_frames(points: torch.Tensor, counts, spec: VoxelizerSpec, fcfs: bool) -> list[VoxelizedFrame]:
    grid = grid_tensors(spec, points.device)
    return [voxelize(points[i], int(counts[i]), spec, grid, fcfs=fcfs) for i in range(points.shape[0])]


def assert_bits_equal(got: VoxelizedFrame, want: list[VoxelizedFrame]) -> None:
    """The op's batch against the plain version's frames, bit for bit."""
    for i, w in enumerate(want):
        for name in FIELDS:
            g, e = getattr(got, name)[i], getattr(w, name)
            assert g.dtype == e.dtype and g.shape == e.shape, (i, name)
            if g.dtype == torch.float32:
                g, e = g.view(torch.int32), e.view(torch.int32)
            assert torch.equal(g.cpu(), e.cpu()), (i, name)


# --- the kernels' algorithm in numpy (csrc/voxelize.cu) ----------------------------


def np_cells(points: np.ndarray, spec: VoxelizerSpec) -> np.ndarray:
    """vox_bin's cell ids, -1 outside the grid (float32 subtract, divide, floor)."""
    vs, off = np.asarray(spec.voxel_size, np.float32), np.asarray(spec.offset, np.float32)
    coor = np.floor((points[:, :3] - off) / vs).astype(np.int64)
    size = np.asarray(spec.grid_size)
    inside = ((coor >= 0) & (coor < size)).all(1)
    nx, ny, nz = spec.grid_size
    return np.where(inside, (coor[:, 0] * ny + coor[:, 1]) * nz + coor[:, 2], -1)


def mirror(points: np.ndarray, counts, spec: VoxelizerSpec, fcfs: bool, seed: int) -> tuple[np.ndarray, ...]:
    """csrc/voxelize.cu's six launches over (B, n, C) points; the outputs
    start as garbage, so every value is one the launches wrote."""
    rng = np.random.default_rng(seed)
    b_, n, c = points.shape
    nx, ny, nz = spec.grid_size
    cells, mv, mp = nx * ny * nz, spec.max_voxels, spec.max_num_points
    voxels = np.full((b_, mv, mp, c), np.nan, np.float32)
    coors = np.full((b_, mv, 3), -7, np.int32)
    npv = np.full((b_, mv), -7, np.int32)
    vnum = np.full((b_,), -7, np.int32)
    for b in range(b_):
        lim = min(int(counts[b]), n)
        cell = np.full(n, -1)
        cell[:max(lim, 0)] = np_cells(points[b, :max(lim, 0)], spec)
        # vox_reset
        first = np.full(cells, INT_MAX, np.int64)
        held = np.zeros(cells, np.int64)
        slots = np.tile(np.asarray([-1, 0, 0, 0], np.int64), (mv, 1))
        vnum[b] = 0
        # vox_bin: atomicMin of the row, atomicAdd of the count, in any order
        for r in rng.permutation(max(lim, 0)):
            if cell[r] >= 0:
                first[cell[r]] = min(first[cell[r]], r)
                held[cell[r]] += 1
        # the scan's items: a row that is its cell's first (fcfs), or an occupied cell
        if fcfs:
            live = max(lim, 0)
            idx = np.arange(live)
            item_cell = cell[:live]
            head = (item_cell >= 0) & (first[np.maximum(item_cell, 0)] == idx)
            item_count = np.where(head, held[np.maximum(item_cell, 0)], 0)
        else:
            live = cells
            item_cell = np.arange(cells)
            head = held > 0
            item_count = held
        tiles = -(-live // voxelize_cuda.TILE)
        # vox_count: each live tile's heads and points
        sums = [(int(head[t * voxelize_cuda.TILE:(t + 1) * voxelize_cuda.TILE].sum()),
                 int(item_count[t * voxelize_cuda.TILE:(t + 1) * voxelize_cuda.TILE].sum())) for t in range(tiles)]
        # vox_number, the tiles in any order: the earlier tiles' sums, the tile's exclusive scan
        for t in rng.permutation(tiles):
            h0, p0 = sum(s[0] for s in sums[:t]), sum(s[1] for s in sums[:t])
            sl = slice(t * voxelize_cuda.TILE, (t + 1) * voxelize_cuda.TILE)
            hh, cc, ce = head[sl].astype(np.int64), item_count[sl], item_cell[sl]
            slot_of, off_of = h0 + np.cumsum(hh) - hh, p0 + np.cumsum(cc) - cc
            for i in np.flatnonzero(hh):
                if slot_of[i] < mv:
                    slots[slot_of[i]] = (ce[i], off_of[i], cc[i], 0)
                    first[ce[i]] = -(slot_of[i] + 1)
            if t == tiles - 1:
                vnum[b] = min(h0 + int(hh.sum()), mv)
        # vox_append: each kept row to its pillar's segment, in any order
        seg = np.full(n, -7, np.int64)
        for r in rng.permutation(max(lim, 0)):
            if cell[r] >= 0 and first[cell[r]] < 0:
                s = -first[cell[r]] - 1
                seg[slots[s, 1] + slots[s, 3]] = r
                slots[s, 3] += 1
        # vox_fill: a warp a slot
        for s in range(mv):
            hold = slots[s, 2] if slots[s, 0] >= 0 else 0
            count = min(hold, mp)
            sg = seg[slots[s, 1]:slots[s, 1] + hold]
            rows = np.full(mp, -7, np.int64)
            if hold <= 32:
                lanes = np.full(32, INT_MAX, np.int64)
                lanes[:hold] = sg
                rank = (lanes[None, :] < lanes[:, None]).sum(1)
                for lane in range(hold):
                    if rank[lane] < mp:
                        rows[rank[lane]] = lanes[lane]
            else:
                last = -1
                for k in range(count):
                    rows[k] = min((e for e in sg if e > last), default=INT_MAX)
                    last = rows[k]
            cid = slots[s, 0]
            coors[b, s] = (cid // (ny * nz), cid % (ny * nz) // nz, cid % nz) if count else (-1, -1, -1)
            npv[b, s] = count
            voxels[b, s] = 0.0
            voxels[b, s, :count] = points[b, rows[:count]]
    return voxels, coors, npv, vnum


MIRROR_CASES = {  # (spec, rows, counts, cloud case)
    "under_both_caps": (mid_spec(), 3000, (1200, 0, 3000), "uniform"),
    "pillar_cap": (mid_spec(max_voxels=1500), 6000, (6000, 2500), "uniform"),
    "point_cap": (mid_spec(), 3000, (3000,), "cluster"),
    "edges": (mid_spec(), 2500, (2500, 1), "edges"),
    "padding": (small_spec(), 256, (150, 256, 40), "uniform"),
    "small_clusters": (small_spec(max_num_points=3), 400, (400,), "cluster"),
    "point_cap_100": (mid_spec(max_num_points=100), 6000, (6000,), "cluster"),
}


@pytest.mark.parametrize("fcfs", [True, False])
@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_the_kernels_algorithm_equals_the_plain_version(case, fcfs):
    spec, rows, counts, kind = MIRROR_CASES[case]
    pts = np.stack([cloud(spec, rows, 4, seed=i, case=kind) for i in range(len(counts))])
    want = plain_frames(torch.from_numpy(pts), counts, spec, fcfs)
    for seed in (0, 1):
        got = VoxelizedFrame(*(torch.from_numpy(a) for a in mirror(pts, counts, spec, fcfs, seed)))
        assert_bits_equal(got, want)
    if case.startswith("point_cap"):  # the fill's repeated-minimum branch ran, the cap bound
        crowd = max(int((np_cells(p, spec) == cid).sum()) for p in pts for cid in np.unique(np_cells(p, spec)))
        assert crowd > max(32, spec.max_num_points)


# --- CPU half: the op ---------------------------------------------------------------


@pytest.mark.parametrize("fcfs", [True, False])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_cpu_op_is_the_plain_version_frame_by_frame(family, batch, fcfs):
    spec, c = spec_of(family)
    rows = ROWS[family]
    counts = [rows, rows // 2, spec.max_voxels // 3][:batch]
    pts = torch.from_numpy(np.stack([cloud(spec, rows, c, seed=7 + i) for i in range(batch)]))
    got = voxelize_cuda.voxelize_batch(pts, torch.tensor(counts, dtype=torch.int32), spec, fcfs)
    assert all(t.is_contiguous() for t in got)
    assert_bits_equal(got, plain_frames(pts, counts, spec, fcfs))


@pytest.mark.parametrize("fcfs", [True, False])
@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_fake_gives_the_real_calls_shapes_dtypes_and_strides(family, fcfs):
    spec, c = spec_of(family)
    pts = torch.from_numpy(np.stack([cloud(spec, spec.max_voxels, c, seed=i) for i in range(2)]))
    counts = torch.tensor([spec.max_voxels, 100], dtype=torch.int32)
    real = voxelize_cuda.voxelize_batch(pts, counts, spec, fcfs)
    with FakeTensorMode() as mode:
        fake = voxelize_cuda.voxelize_batch(mode.from_tensor(pts), mode.from_tensor(counts), spec, fcfs)
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype, r.stride())


@pytest.mark.parametrize("fcfs", [True, False])
def test_opcheck(fcfs):
    spec = small_spec()
    pts = torch.from_numpy(np.stack([cloud(spec, 64, 4, seed=i) for i in range(2)]))
    args = (pts, torch.tensor([64, 20], dtype=torch.int32), list(spec.voxel_size), list(spec.offset),
            list(spec.grid_size), spec.max_voxels, spec.max_num_points, fcfs)
    torch.library.opcheck(torch.ops.det3d.voxelize.default, args)


@pytest.mark.parametrize("fcfs", [True, False])
@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_scratch_is_within_todays_int64_intermediates(family, fcfs):
    """The plain version holds at least four int64 arrays over every padded
    row at once (the sort's order, the row positions, the head keys and the
    cummin's values and indices): 32 bytes a row. The kernels' scratch, at
    the configuration's `max_points` and batch 1 or 4, is no larger."""
    spec, _ = spec_of(family)
    rows = load_config(CONFIGS[family]).max_points
    for batch in (1, 4):
        p = voxelize_cuda.plan(batch, rows, int(np.prod(spec.grid_size)), spec.max_voxels, fcfs)
        assert p.words * 4 <= 32 * rows * batch
        assert p.slots % 4 == p.table % 4 == p.tile_sums % 4 == p.seg % 4 == 0  # 16-byte aligned parts
        assert p.seg + batch * rows <= p.words


@pytest.mark.parametrize("bad", ["float64", "2d", "strided", "counts_shape", "counts_dtype", "max_num_points",
                                 "rows", "cpu"])
def test_kernel_input_is_checked(bad):
    spec = small_spec()
    pts = torch.from_numpy(np.stack([cloud(spec, 64, 4, seed=0)]))
    counts = torch.tensor([64], dtype=torch.int32)
    if bad == "float64":
        pts = pts.double()
    elif bad == "2d":
        pts = pts[0]
    elif bad == "strided":
        pts = torch.cat([pts, pts], -1)[..., ::2]
    elif bad == "counts_shape":
        counts = counts[0]
    elif bad == "counts_dtype":
        counts = counts.long()
    elif bad == "max_num_points":
        spec = spec._replace(max_num_points=voxelize_cuda.MAX_POINTS_PER_VOXEL + 1)
    elif bad == "rows":
        spec = spec._replace(max_voxels=65)
    with pytest.raises(ValueError):
        voxelize_cuda.check_kernel_input(pts, counts, spec)
    with pytest.raises(ValueError):
        voxelize_cuda.voxelize_cuda(pts, counts, spec.voxel_size, spec.offset, spec.grid_size, spec.max_voxels,
                                    spec.max_num_points, True)


@pytest.mark.parametrize("given", ["int", "numpy", "host_0d", "host_batch"])
def test_counts_become_a_tensor_of_the_batch(given):
    want = torch.tensor([5, 7] if given == "host_batch" else [5], dtype=torch.int32)
    value = {"int": 5, "numpy": np.int32(5), "host_0d": torch.tensor(5), "host_batch": np.asarray([5, 7])}[given]
    got = voxelize_cuda.counts_tensor(value, len(want), torch.device("cpu"))
    assert got.dtype == torch.int32 and torch.equal(got, want)


def small_cfg(**kw):
    """The 32x32-grid geometry of chip_smoke.small_config."""
    return load_config({
        "detection_range": [-16.0, -16.0, -2.5, 16.0, 16.0, 8.5],
        "center_limit": [-16.0, -16.0, -10.0, 16.0, 16.0, 10.0],
        "voxel_size": [1.0, 1.0, 11.0], "max_voxels": 256, "max_num_points": 5,
        "max_points": 4096, "max_gt_boxes": 8, "compute_dtype": "float32", **kw,
    })


@pytest.mark.parametrize("fcfs", [True, False])
def test_the_exported_program_holds_one_voxelize_node_and_runs(fcfs, tmp_path):  # noqa: F811
    from det3d_tpu_torch.data.synthetic import sample_scene
    from det3d_tpu_torch.deploy.export import PROGRAM, export_detector
    from det3d_tpu_torch.deploy.runtime import ExportedDetector
    from det3d_tpu_torch.pipeline import Detector

    cfg = small_cfg()
    export_detector(cfg, out_dir=tmp_path / "art", device="cpu", fcfs=fcfs)
    program = torch.export.load(str(tmp_path / "art" / PROGRAM))
    nodes = [n for n in program.graph.nodes if str(n.target) == OP]
    assert len(nodes) == 1 and nodes[0].args[-1] is fcfs
    points = sample_scene(cfg, np.random.RandomState(3), (2, 5), ground_points=1500)["points"]
    got = ExportedDetector(tmp_path / "art", "cpu").detect(points)
    want = Detector(cfg, torch.device("cpu"), fcfs=fcfs).init_weights(0).detect(points)
    assert len(want["name"]) > 0
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --- GPU half ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m gpu)")
    return torch.device("cuda")


def card_cases(family: str):
    """(name, points (B, max_points, C), counts) at the family's full
    `max_points`: the cases of the module docstring."""
    spec, c = spec_of(family)
    n = load_config(CONFIGS[family]).max_points
    real = REAL[family]
    r = np.random.RandomState(11)

    def batch(*clouds):
        return np.stack([np.pad(p, ((0, n - len(p)), (0, 0))) for p in clouds])

    uniform = cloud(spec, real, c, seed=1)
    dense = cloud(spec, spec.max_voxels * 2, c, seed=2)  # more occupied cells than the cap
    crowded = cloud(spec, 20_000, c, seed=3, case="cluster")
    r.shuffle(crowded)  # pillars of many points, in shuffled arrival order
    edges = cloud(spec, 20_000, c, seed=4, case="edges")
    padding = cloud(spec, n, c, seed=5)  # garbage past the count
    return [
        ("empty", batch(uniform), [0]),
        ("one", batch(uniform), [1]),
        ("full", batch(padding), [n]),
        ("cap", batch(dense), [len(dense)]),
        ("crowded", batch(crowded), [len(crowded)]),
        ("edges", batch(edges), [len(edges)]),
        ("padding", padding[None], [real // 2]),
        ("batch4", np.stack([batch(uniform)[0], padding, batch(crowded)[0], batch(dense)[0]]),
         [real, n // 3, len(crowded), 0]),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("fcfs", [True, False])
@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_kernel_against_the_plain_version(cuda, family, fcfs):
    spec, _ = spec_of(family)
    for name, pts, counts in card_cases(family):
        points = torch.from_numpy(pts).to(cuda)
        before = voxelize_cuda.counter.launches
        got = voxelize_cuda.voxelize_batch(points, torch.tensor(counts, dtype=torch.int32, device=cuda), spec, fcfs)
        assert voxelize_cuda.counter.launches == before + 1
        try:
            assert_bits_equal(got, plain_frames(points, counts, spec, fcfs))
        except AssertionError as e:
            raise AssertionError(f"case {name}: {e}") from e
        if name == "cap":
            assert int(got.voxel_num[0]) == spec.max_voxels
        if name == "crowded":
            assert int(got.num_points_per_voxel.max()) == spec.max_num_points


@pytest.mark.gpu
@pytest.mark.parametrize("fcfs", [True, False])
def test_scratch_needs_no_initialisation(cuda, fcfs):
    spec, c = spec_of("ntusl")
    pts = torch.from_numpy(np.stack([cloud(spec, 40_000, c, seed=s) for s in range(2)])).to(cuda)
    counts = torch.tensor([40_000, 25_000], dtype=torch.int32, device=cuda)
    p = voxelize_cuda.plan(2, 40_000, int(np.prod(spec.grid_size)), spec.max_voxels, fcfs)
    scratch = torch.randint(-2**31, 2**31 - 1, (p.words,), dtype=torch.int32, device=cuda)
    out = voxelize_cuda._empty(pts, spec.max_voxels, spec.max_num_points)
    for t in out:
        t.fill_(-3)
    voxelize_cuda.launch(pts, counts, spec, fcfs, out, scratch, p)
    assert_bits_equal(VoxelizedFrame(*out), plain_frames(pts, counts.tolist(), spec, fcfs))


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_replays_of_a_captured_graph(cuda, family):
    spec, c = spec_of(family)
    n = ROWS[family] * 2
    clouds = [torch.from_numpy(np.stack([cloud(spec, n, c, seed=10 * k + i) for i in range(4)])) for k in range(3)]
    counts = [[n, n // 2, 7, n // 3], [n // 4, n, 0, n], [1, n // 5, n, n // 2]]
    static_pts = clouds[0].to(cuda)
    static_n = torch.tensor(counts[0], dtype=torch.int32, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        voxelize_cuda.voxelize_batch(static_pts, static_n, spec)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = voxelize_cuda.voxelize_batch(static_pts, static_n, spec)
    for pts, k in zip(clouds[1:] + clouds[:1], counts[1:] + counts[:1]):
        static_pts.copy_(pts)
        static_n.copy_(torch.tensor(k, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert_bits_equal(out, plain_frames(static_pts, k, spec, True))


@pytest.mark.gpu
def test_one_call_per_forward_and_per_forward_batch(cuda):
    from det3d_tpu_torch.data.synthetic import sample_scene
    from det3d_tpu_torch.pipeline import Detector

    cfg = small_cfg()
    det = Detector(cfg, cuda).init_weights(0)
    rng = np.random.RandomState(0)
    padded = [det.pad_points(sample_scene(cfg, rng, (2, 5), ground_points=1500)["points"]) for _ in range(4)]
    pts = torch.from_numpy(np.stack([p for p, _ in padded])).to(cuda)
    counts = torch.tensor([n for _, n in padded], dtype=torch.int32, device=cuda)
    before = voxelize_cuda.counter.launches
    det.infer(pts[0], counts[0])
    assert voxelize_cuda.counter.launches == before + 1
    det.infer_batch(pts, counts)
    assert voxelize_cuda.counter.launches == before + 2
    frames = det.module.voxelize(pts, counts)
    assert_bits_equal(frames, plain_frames(pts, counts.tolist(), det.module.spec, True))


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["float64", "strided", "counts_on_host", "max_num_points"])
def test_kernel_refuses_bad_input(cuda, bad):
    spec = small_spec()
    pts = torch.from_numpy(np.stack([cloud(spec, 64, 4, seed=0)])).to(cuda)
    counts = torch.tensor([64], dtype=torch.int32, device=cuda)
    if bad == "float64":
        pts = pts.double()
    elif bad == "strided":
        pts = torch.cat([pts, pts], -1)[..., ::2]
    elif bad == "counts_on_host":
        counts = counts.cpu()
    elif bad == "max_num_points":
        spec = spec._replace(max_num_points=voxelize_cuda.MAX_POINTS_PER_VOXEL + 1)
    before = voxelize_cuda.counter.launches
    with pytest.raises((ValueError, RuntimeError)):
        torch.ops.det3d.voxelize(pts, counts, list(spec.voxel_size), list(spec.offset), list(spec.grid_size),
                                 spec.max_voxels, spec.max_num_points, True)
    assert voxelize_cuda.counter.launches == before
