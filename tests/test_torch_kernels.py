"""The port's kernel modules: plain versions against the JAX kernels, and
(marker `gpu`) the CUDA kernels against the plain versions on the card.

CPU half: `scatter_to_bev_plain` against `scatter_to_bev_pallas(interpret=
True)` — equal, the scatter only moves values; `nms_keep_plain` against
`greedy_nms_pallas(interpret=True)` and the sequential numpy oracle — keep
masks equal, both evaluate the same float32 IoU expression; the wrappers'
input checks and device dispatch; the fence's choice of kernel for each
view and its transpose plan walked on the CPU (the matcher's and the train step's
parity with JAX are in test_torch_targets.py and test_torch_train.py). JAX
is imported inside those tests only, so that the GPU half runs where JAX
is absent.

GPU half: needs a CUDA card and skips without one (decided in a fixture,
never at import): every kernel against its plain version, bit for bit
for the scatters (dense, s2d in both orders, blocked s2d), their backwards
and the fence's three kernels. On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import pytest
import torch

import np_ref
from det3d_tpu_torch.config import load_config
from det3d_tpu_torch.kernels import build, fence_cuda, matcher_cuda, nms_cuda, scatter_cuda
from det3d_tpu_torch.ops.nms import greedy_keep, rank_cap

torch.set_num_threads(1)


def scatter_case(b, v, c, grid_xy, n_valid, seed, dtype=np.float32):
    r = np.random.RandomState(seed)
    nx, ny = grid_xy
    feats = r.randn(b, v, c).astype(dtype)
    coors = np.full((b, v, 3), -1, np.int32)
    for bi in range(b):
        cells = r.choice(nx * ny, n_valid, replace=False)
        slots = r.permutation(v)[:n_valid]  # valid rows anywhere, not only first
        coors[bi, slots, 0], coors[bi, slots, 1], coors[bi, slots, 2] = cells // ny, cells % ny, 0
    return feats, coors


def nms_case(k, seed, spread=25.0, invalid=0.2):
    """(K, 4) minmax boxes in descending score order, valid flags, scores."""
    r = np.random.RandomState(seed)
    c = r.uniform(-spread, spread, (k, 2)).astype(np.float32)
    d = r.uniform(1, 8, (k, 2)).astype(np.float32)
    boxes = np.concatenate([c - d / 2, c + d / 2], -1)
    scores = np.sort(r.uniform(0, 1, k).astype(np.float32))[::-1].copy()
    return boxes, r.rand(k) >= invalid, scores


def nms_special_case(name, k=1000):
    """(K, 4) boxes and valid flags that stress the chunked sweep."""
    if name == "chain":  # each box over the threshold only with its neighbours: K dependent decisions
        x = np.arange(k, dtype=np.float32) * 5
        zero = np.zeros(k, np.float32)
        return np.stack([x, zero, x + 9, zero + 9], -1), np.ones(k, bool)
    if name == "identical":  # the first box suppresses every other
        return np.tile(np.array([[1.0, 2.0, 6.0, 5.0]], np.float32), (k, 1)), np.ones(k, bool)
    assert name == "last_chunk"  # valid flags only in the last chunk of 32 rows
    boxes, _, _ = nms_case(k, 30, invalid=0.0)
    return boxes, np.arange(k) >= (k - 1) // 32 * 32


def head_views(dtype, device="cpu", hw=(50, 40)):
    """The head's three outputs as `SharedHead` returns them: views into one
    channels-last (2, 90, H, W) tensor."""
    h, w = hw
    y = torch.randn(2, 90, h, w, device=device).to(dtype).contiguous(memory_format=torch.channels_last)
    cls, box, dire = torch.split(y, [9, 63, 18], dim=1)
    return {name: part.reshape(2, 9, k, h, w).transpose(1, 2)
            for name, part, k in (("cls_preds", cls, 1), ("box_preds", box, 7), ("dir_preds", dire, 2))}


# the fence's views and the kernel of csrc/fence.cu that copies each
FENCE_ROUTES = {
    "cls_preds": "transpose", "box_preds": "transpose", "dir_preds": "transpose", "cls_preds_f32": "transpose",
    "odd_planes_u8": "transpose", "wide_run_f64": "generic", "contiguous": "contiguous", "odd_offset": "contiguous",
    "odd_bytes_u8": "contiguous", "scalar": "contiguous", "int64_sliced": "generic", "unit_axes": "generic",
    "rank6": "generic",
}


def fence_view(name, device="cpu"):
    if name in ("cls_preds", "box_preds", "dir_preds"):
        return head_views(torch.bfloat16, device)[name]
    if name == "cls_preds_f32":
        return head_views(torch.float32, device)["cls_preds"]
    if name == "odd_planes_u8":  # 91 pixels of one byte: no output plane but the first is 16-byte aligned
        y = torch.randint(0, 255, (2, 5, 7, 13), device=device, dtype=torch.uint8)
        return y.contiguous(memory_format=torch.channels_last)[:, :3]
    if name == "wide_run_f64":  # a run of 400 doubles per pixel: 16 pixels of it do not fit a tile
        return torch.randn(3, 20, 400, device=device, dtype=torch.float64).transpose(1, 2)
    if name == "contiguous":
        return torch.randn(2, 1, 9, 50, 40, device=device)
    if name == "odd_offset":  # the source pointer is 2 bytes past a 16-byte boundary
        return torch.randn(2, 9, 50, 40, device=device).to(torch.bfloat16).flatten()[1:]
    if name == "odd_bytes_u8":
        return torch.randint(0, 255, (7, 13, 3), device=device, dtype=torch.uint8)
    if name == "scalar":
        return torch.tensor(3.5, device=device)
    if name == "int64_sliced":
        return torch.randint(-5, 5, (6, 10, 4), device=device)[:, 2::3]
    if name == "unit_axes":
        return torch.randn(1, 5, 1, 7, device=device)[:, :, :, ::3]
    assert name == "rank6"
    return torch.randn(3, 4, 5, 6, 7, 8, device=device)[::2, :, 1:, ::3].permute(0, 5, 2, 3, 4, 1)


def emulate_transpose(x, plan):
    """The transpose kernel's walk on the CPU: per block, a tile of `tile`
    pixels x the run read in source order into rows of `row` elements, then
    each row written to its output plane."""
    pixel = len(plan.sizes) - plan.inner - 1
    run_sizes, run_dst = plan.sizes[pixel + 1:], plan.dst[pixel + 1:]
    run = math.prod(run_sizes)
    out = torch.zeros(x.numel(), dtype=x.dtype)
    for outer in itertools.product(*(range(n) for n in plan.sizes[:pixel])):
        src0 = x.storage_offset() + sum(i * s for i, s in zip(outer, plan.src))
        dst0 = sum(i * d for i, d in zip(outer, plan.dst))
        for p0 in range(0, plan.sizes[pixel], plan.tile):
            n = min(plan.tile, plan.sizes[pixel] - p0)
            tile = torch.zeros(run, plan.row, dtype=x.dtype)
            tile[:, :n] = torch.as_strided(x, (n, run), (plan.src[pixel], 1), src0 + p0 * plan.src[pixel]).T
            torch.as_strided(out, (*run_sizes, n), (*run_dst, 1), dst0 + p0).copy_(tile[:, :n].reshape(*run_sizes, n))
    return out.reshape(x.shape)


class TestScatterPlain:
    @pytest.mark.parametrize("b,v,c,grid,n_valid,seed", [
        (1, 37, 8, (20, 25), 30, 0),
        (2, 64, 16, (16, 16), 50, 1),
        (1, 200, 64, (32, 32), 150, 2),
    ])
    def test_matches_pallas_interpret(self, b, v, c, grid, n_valid, seed):
        import jax.numpy as jnp

        from det3d_tpu.kernels.scatter_pallas import scatter_to_bev_pallas

        feats, coors = scatter_case(b, v, c, grid, n_valid, seed)
        want = np.asarray(scatter_to_bev_pallas(jnp.asarray(feats), jnp.asarray(coors), grid, interpret=True))
        got = scatter_cuda.scatter_to_bev_plain(torch.from_numpy(feats), torch.from_numpy(coors), grid)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_all_empty(self):
        import jax.numpy as jnp

        from det3d_tpu.kernels.scatter_pallas import scatter_to_bev_pallas

        feats = np.ones((1, 5, 4), np.float32)
        coors = np.full((1, 5, 3), -1, np.int32)
        want = np.asarray(scatter_to_bev_pallas(jnp.asarray(feats), jnp.asarray(coors), (8, 8), interpret=True))
        got = scatter_cuda.scatter_to_bev(torch.from_numpy(feats), torch.from_numpy(coors), (8, 8))
        assert got.shape == (1, 8, 8, 4)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got == 0).all()

    def test_bf16_moves_bits(self):
        feats, coors = scatter_case(1, 50, 6, (10, 10), 40, 3)
        f = torch.from_numpy(feats).to(torch.bfloat16)
        got = scatter_cuda.scatter_to_bev(f, torch.from_numpy(coors), (10, 10))
        assert got.dtype == torch.bfloat16
        keep = coors[0, :, 0] >= 0
        rows = got[0, coors[0, keep, 0], coors[0, keep, 1]]
        assert torch.equal(rows.view(torch.int16), f[0, torch.from_numpy(keep)].view(torch.int16))

    def test_cpu_dispatch_takes_plain_version(self):
        feats, coors = scatter_case(1, 20, 4, (8, 8), 10, 4)
        before = scatter_cuda.counter.launches
        scatter_cuda.scatter_to_bev(torch.from_numpy(feats), torch.from_numpy(coors), (8, 8))
        assert scatter_cuda.counter.launches == before  # the kernel never ran

    @pytest.mark.parametrize("bad", ["dtype", "coors_dtype", "shape", "kernel_on_cpu"])
    def test_rejects_bad_input(self, bad):
        feats, coors = (torch.from_numpy(a) for a in scatter_case(1, 20, 4, (8, 8), 10, 5))
        if bad == "dtype":
            feats, err = feats.double(), TypeError
        elif bad == "coors_dtype":
            coors, err = coors.long(), TypeError
        elif bad == "shape":
            coors, err = coors[:, :10], ValueError
        else:
            err = ValueError
        fn = scatter_cuda.scatter_to_bev_cuda if bad == "kernel_on_cpu" else scatter_cuda.scatter_to_bev
        with pytest.raises(err):
            fn(feats, coors, (8, 8))


class TestNmsPlain:
    @pytest.mark.parametrize("k,seed,invalid", [(100, 0, 0.0), (300, 1, 0.2), (1000, 2, 0.2), (1000, 3, 0.0)])
    def test_matches_pallas_interpret_and_oracle(self, k, seed, invalid):
        import jax.numpy as jnp

        from det3d_tpu.kernels.nms_pallas import greedy_nms_pallas

        boxes, valid, scores = nms_case(k, seed, invalid=invalid)
        got = rank_cap(nms_cuda.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.1), 300).numpy()
        want = np.asarray(greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(valid), 0.1, 300, interpret=True))
        np.testing.assert_array_equal(got, want)
        # the oracle sorts by score itself; invalid boxes are left out
        idx = np.flatnonzero(valid)
        kept = idx[np_ref.nms_greedy_ref(boxes[idx], scores[idx], 0.1, 300)]
        np.testing.assert_array_equal(np.flatnonzero(got), np.sort(kept))

    def test_batched_classes_equal_per_class(self):
        cases = [nms_case(k, 10 + i) for i, k in enumerate((700, 1000, 300))]
        kmax = 1000
        boxes = np.zeros((3, kmax, 4), np.float32)
        valid = np.zeros((3, kmax), bool)
        for i, (b, v, _) in enumerate(cases):
            boxes[i, : len(b)], valid[i, : len(v)] = b, v
        got = nms_cuda.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.1).numpy()
        for i, (b, v, _) in enumerate(cases):
            alone = nms_cuda.nms_keep(torch.from_numpy(b), torch.from_numpy(v), 0.1).numpy()
            np.testing.assert_array_equal(got[i, : len(b)], alone)
            assert not got[i, len(b):].any()  # invalid padding is never kept

    def test_greedy_nms_matches_jax_plain(self):
        import jax.numpy as jnp

        from det3d_tpu.ops.nms import greedy_nms as jax_greedy_nms

        boxes, valid, _ = nms_case(500, 7, spread=10.0)
        got = rank_cap(greedy_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.1), 20).numpy()
        want = np.asarray(jax_greedy_nms(jnp.asarray(boxes), jnp.asarray(valid), 0.1, 20))
        np.testing.assert_array_equal(got, want)
        assert got.sum() == 20

    @pytest.mark.parametrize("bad", ["dtype", "valid_dtype", "shape", "kernel_on_cpu"])
    def test_rejects_bad_input(self, bad):
        boxes, valid, _ = (torch.from_numpy(a) for a in nms_case(50, 6))
        if bad == "dtype":
            boxes, err = boxes.double(), TypeError
        elif bad == "valid_dtype":
            valid, err = valid.int(), TypeError
        elif bad == "shape":
            valid, err = valid[:40], ValueError
        else:
            err = ValueError
        fn = nms_cuda.nms_keep_cuda if bad == "kernel_on_cpu" else nms_cuda.nms_keep
        with pytest.raises(err):
            fn(boxes, valid, 0.1)


class TestTrainKernelWrappers:
    def test_kernels_reject_cpu_tensors(self):
        feats, coors = (torch.from_numpy(a) for a in scatter_case(1, 20, 4, (8, 8), 10, 6))
        with pytest.raises(ValueError):
            scatter_cuda.scatter_to_bev_bwd_cuda(torch.zeros(1, 8, 8, 4), coors)
        with pytest.raises(ValueError):
            fence_cuda.fence_copy_cuda(feats)
        cfg = load_config(MATCH_CFG)
        assigner = make_assigner(cfg, "cpu")
        mask, gt_boxes, gt_classes, gt_valid = matcher_case(cfg, assigner, 0, "cpu")
        with pytest.raises(ValueError):
            matcher_cuda.match_cuda(assigner.tables, mask.reshape(2, -1), gt_boxes,
                                    gt_boxes[..., :4].contiguous(), gt_classes, gt_valid)

    @pytest.mark.parametrize("view", ["cls_preds", "sliced", "contiguous", "unit_axes"])
    def test_fence_iteration_layout_is_the_copy(self, view):
        if view == "cls_preds":
            y = torch.randn(2, 90, 8, 6).contiguous(memory_format=torch.channels_last)
            x = y[:, :9].reshape(2, 9, 1, 8, 6).transpose(1, 2)
        elif view == "sliced":
            x = torch.randn(4, 6, 10)[:, 1::2, 3:]
        elif view == "contiguous":
            x = torch.randn(3, 4, 5)
        else:
            x = torch.randn(1, 5, 1, 7)[:, :, :, ::3]
        sizes, src, dst = fence_cuda._iteration_layout(x)
        assert len(sizes) <= max(x.dim(), 1) and all(s > 1 for s in sizes)
        # the iteration space read from the source and written to the output
        # through their strides is the copy
        seen = torch.as_strided(x, sizes, src, x.storage_offset())
        out = torch.empty(x.numel(), dtype=x.dtype)
        torch.as_strided(out, sizes, dst).copy_(seen)
        assert torch.equal(out, x.reshape(-1))
        assert src == sorted(src, reverse=True)
        if view == "cls_preds":
            assert sizes == [2, 8 * 6, 9] and src[-1] == 1

    @pytest.mark.parametrize("view", sorted(FENCE_ROUTES))
    def test_fence_route_and_transpose_plan(self, view):
        x = fence_view(view)
        plan = fence_cuda.copy_plan(x)
        assert plan.route == FENCE_ROUTES[view]
        assert (plan.sizes, plan.src, plan.dst) == fence_cuda._iteration_layout(x)
        if plan.route != "transpose":
            assert (plan.inner, plan.tile, plan.row) == (0, 0, 0)
            return
        pixel = len(plan.sizes) - plan.inner - 1
        run = math.prod(plan.sizes[pixel + 1:])
        assert plan.dst[pixel] == 1 and plan.src[-1] == 1
        assert plan.inner == (2 if view in ("box_preds", "dir_preds") else 1)
        # a power-of-two tile of whole 16-byte pieces that fits the shared memory, rows an odd count of pieces
        row_bytes = plan.row * x.element_size()
        assert plan.tile & (plan.tile - 1) == 0 and 16 <= plan.tile <= fence_cuda.MAX_TILE
        assert row_bytes % 16 == 0 and row_bytes // 16 % 2 == 1 and plan.row >= plan.tile
        assert run * row_bytes <= fence_cuda.TILE_BYTES
        got = emulate_transpose(x, plan)
        assert got.is_contiguous() and torch.equal(got, x.contiguous())

    def test_fence_plain_is_a_contiguous_copy(self):
        x = fence_view("cls_preds")
        assert not x.clone().is_contiguous()  # a bare clone keeps the view's stride order
        for got in (fence_cuda.fence_copy_plain(x), fence_cuda.s2b_fence(x)):
            assert got.is_contiguous() and got.data_ptr() != x.data_ptr()
            assert torch.equal(got.view(torch.int16), x.contiguous().view(torch.int16))
        before = (fence_cuda.counter.launches, dict(fence_cuda.route_launches))
        fence_cuda.s2b_fence(x)
        assert (fence_cuda.counter.launches, dict(fence_cuda.route_launches)) == before  # no kernel on the CPU

    def test_matcher_and_fence_build_flags(self):
        assert {"-fmad=false", "-prec-div=true"} <= set(build.EXTRA_FLAGS["matcher"])
        assert set(build.EXTRA_FLAGS) == {"scatter", "nms", "matcher", "fence"}
        assert all((build.CSRC / f"{name}.cu").exists() for name in build.EXTRA_FLAGS)


def test_build_hash_covers_source_and_flags(monkeypatch):
    """A library's file name changes with its flags, so a stale build of
    other flags is never loaded."""
    before = build._library_path("nms")
    monkeypatch.setitem(build.EXTRA_FLAGS, "nms", ())
    assert build._library_path("nms") != before
    assert before.parent == build.BUILD_DIR and before.suffix == ".so"


# --- the matcher's inputs (numpy-made, no JAX) -----------------------------

# the mid geometry (100x100 feature map, 9 anchor channels, 16 gt)
MATCH_CFG = {
    "detection_range": [-50.0, -50.0, -2.5, 50.0, 50.0, 8.5],
    "center_limit": [-50.0, -50.0, -10.0, 50.0, 50.0, 10.0],
    "voxel_size": [0.5, 0.5, 11.0], "max_voxels": 2000, "max_num_points": 8,
    "max_points": 20000, "max_gt_boxes": 16, "compute_dtype": "float32",
}


def make_assigner(cfg, device):
    from det3d_tpu_torch.anchors import build_anchors
    from det3d_tpu_torch.targets import make_target_assigner

    return make_target_assigner(cfg, build_anchors(cfg), device)


def matcher_case(cfg, assigner, seed, device, n_gt=12):
    """A batch of two: gt on anchor centres of random classes (ties and
    force-matches happen), padding rows, a random anchor mask."""
    from det3d_tpu_torch.targets import pad_gt

    r = np.random.RandomState(seed)
    anchors = assigner.tables.anchors.cpu().numpy()
    hw = assigner.grid_hw[0] * assigner.grid_hw[1]
    rows = []
    for _ in range(2):
        classes = r.randint(1, len(cfg.class_specs) + 1, n_gt).astype(np.int32)
        boxes = np.zeros((n_gt, 7), np.float32)
        for i, c in enumerate(classes):
            c0, c1 = assigner.channels[c - 1]
            boxes[i] = anchors[r.randint(c0 * hw, c1 * hw)]
            boxes[i, :2] += r.uniform(-0.6, 0.6, 2)
            boxes[i, 3:6] *= r.uniform(0.6, 1.4, 3)
            boxes[i, 6] = r.uniform(-np.pi, np.pi)
        rows.append(pad_gt(cfg, boxes, classes))
    gt_boxes, gt_classes, gt_valid = (torch.from_numpy(np.stack(x)).to(device) for x in zip(*rows))
    fx, fy = assigner.grid_hw
    mask = torch.from_numpy(r.rand(2, anchors.shape[0] // hw, fx, fy) > 0.3).to(device)
    return mask, gt_boxes, gt_classes, gt_valid


# --- GPU half: the CUDA kernels against their plain versions -------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip with -m gpu)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 16000, 64, (800, 800), 12000), (2, 300, 10, (40, 30), 250),
                                   (1, 500, 64, (64, 64), 0)])
def test_scatter_kernel_bit_equal(cuda, dtype, shape):
    b, v, c, grid, n_valid = shape
    feats, coors = scatter_case(b, v, c, grid, n_valid, seed=n_valid)
    f = torch.from_numpy(feats).to(device=cuda, dtype=dtype)
    co = torch.from_numpy(coors).to(cuda)
    before = scatter_cuda.counter.launches
    got = scatter_cuda.scatter_to_bev(f, co, grid)
    want = scatter_cuda.scatter_to_bev_plain(f, co, grid)
    torch.cuda.synchronize()
    assert scatter_cuda.counter.launches == before + 1
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(ints), want.view(ints))


@pytest.mark.gpu
@pytest.mark.parametrize("ncls,k,invalid", [(3, 1000, 0.2), (1, 1024, 0.0), (2, 77, 0.5), (3, 1000, 1.0)])
def test_nms_kernel_equal(cuda, ncls, k, invalid):
    cases = [nms_case(k, 20 + i, invalid=invalid) for i in range(ncls)]
    boxes = torch.from_numpy(np.stack([c[0] for c in cases])).to(cuda)
    valid = torch.from_numpy(np.stack([c[1] for c in cases])).to(cuda)
    before = nms_cuda.counter.launches
    got = nms_cuda.nms_keep(boxes, valid, 0.1)
    want = nms_cuda.nms_keep_plain(boxes, valid, 0.1)
    torch.cuda.synchronize()
    assert nms_cuda.counter.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_nms_kernel_rejects_large_k(cuda):
    boxes = torch.zeros((1, nms_cuda.MAX_K + 1, 4), device=cuda)
    valid = torch.ones((1, nms_cuda.MAX_K + 1), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        nms_cuda.nms_keep(boxes, valid, 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("ncls,k,invalid", [(1, 1, 0.0), (1, 31, 0.2), (2, 32, 0.2), (8, 33, 0.2), (8, 1000, 0.2),
                                            (1, 1000, 0.0), (3, 1024, 0.2)])
def test_nms_kernel_equal_over_chunk_edges(cuda, ncls, k, invalid):
    cases = [nms_case(k, 40 + i, invalid=invalid) for i in range(ncls)]
    boxes = torch.from_numpy(np.stack([c[0] for c in cases])).to(cuda)
    valid = torch.from_numpy(np.stack([c[1] for c in cases])).to(cuda)
    got = nms_cuda.nms_keep(boxes, valid, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_cuda.nms_keep_plain(boxes, valid, 0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [33, 77, 1000, 1024])
@pytest.mark.parametrize("case", ["chain", "identical", "last_chunk"])
def test_nms_kernel_equal_on_sweep_cases(cuda, case, k):
    boxes, valid = (torch.from_numpy(a).to(cuda) for a in nms_special_case(case, k))
    before = nms_cuda.counter.launches
    got = nms_cuda.nms_keep(boxes, valid, 0.1)  # 2-D input: one class
    torch.cuda.synchronize()
    assert nms_cuda.counter.launches == before + 1
    assert torch.equal(got, nms_cuda.nms_keep_plain(boxes, valid, 0.1))
    if case == "chain":
        assert torch.equal(got.cpu(), torch.arange(k) % 2 == 0)
    elif case == "identical":
        assert int(got.sum()) == 1 and bool(got[0])


@pytest.mark.gpu
def test_nms_scratch_needs_no_initialisation(cuda):
    """The sweep reads only words the mask kernel wrote: a scratch tensor
    full of ones gives the same keep mask."""
    cases = [nms_case(1000, 50 + i) for i in range(3)]
    boxes = torch.from_numpy(np.stack([c[0] for c in cases])).to(cuda)
    valid = torch.from_numpy(np.stack([c[1] for c in cases])).to(cuda)
    ones = torch.full_like(nms_cuda.mask_scratch(boxes), -1)
    got = nms_cuda.launch(boxes, valid, 0.1, ones)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_cuda.nms_keep_plain(boxes, valid, 0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("view", sorted(FENCE_ROUTES))
def test_fence_kernel_routes_bit_equal(cuda, view):
    x = fence_view(view, cuda)
    before = (fence_cuda.counter.launches, fence_cuda.route_launches[FENCE_ROUTES[view]])
    got = fence_cuda.s2b_fence(x)
    torch.cuda.synchronize()
    after = (fence_cuda.counter.launches, fence_cuda.route_launches[FENCE_ROUTES[view]])
    assert after == (before[0] + 1, before[1] + 1)
    want = x.clone(memory_format=torch.contiguous_format)
    assert got.is_contiguous() and got.dtype == x.dtype and got.shape == x.shape
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    assert torch.equal(got.view(ints), want.view(ints))
    assert torch.equal(fence_cuda.fence_copy_plain(x).view(ints), want.view(ints))


@pytest.mark.gpu
def test_fence_full_width_cls_preds_and_gradient(cuda):
    x = head_views(torch.bfloat16, cuda, hw=(400, 400))["cls_preds"].requires_grad_()
    got = fence_cuda.s2b_fence(x)
    g = torch.randn_like(got)
    (got * g).sum().backward()
    torch.cuda.synchronize()
    assert got.is_contiguous() and torch.equal(got.view(torch.int16), x.contiguous().view(torch.int16))
    assert torch.equal(x.grad, g)


# the anchors' count is odd and no class range is a multiple of the kernels'
# chunk: the scalar instantiation, and chunks that straddle two classes
RAGGED_MATCH_CFG = dict(MATCH_CFG, detection_range=[-22.5, -22.5, -2.5, 22.5, 22.5, 8.5],
                        center_limit=[-22.5, -22.5, -10.0, 22.5, 22.5, 10.0])
MATCHER_CASES = [
    "random", "no valid gt", "every anchor masked", "class with valid gt and no included anchor",
    "class with included anchors and no valid gt", "gt outside the range", "zero-size gt",
    "two gt with one standup box", "boxes that only touch", "matched threshold 0", "G = 256",
    "odd A, classes straddle chunks",
]


def matcher_special_case(case, device):
    """(assigner, mask (2, nch, fx, fy), gt_boxes, gt_classes, gt_valid) for
    one of MATCHER_CASES; sample 1 stays the random scene."""
    import dataclasses

    cfg = load_config(RAGGED_MATCH_CFG if case == "odd A, classes straddle chunks" else MATCH_CFG)
    if case == "G = 256":
        cfg = cfg.replace(max_gt_boxes=256)
    if case == "matched threshold 0":
        cfg = cfg.replace(class_specs=tuple(
            dataclasses.replace(s, matched_threshold=0.0, unmatched_threshold=0.0) for s in cfg.class_specs))
    assigner = make_assigner(cfg, device)
    mask, gt_boxes, gt_classes, gt_valid = matcher_case(cfg, assigner, 1, "cpu", n_gt=200 if case == "G = 256" else 12)
    hw = assigner.grid_hw[0] * assigner.grid_hw[1]
    c0, c1 = assigner.channels[1]
    if case == "no valid gt":
        gt_valid[:] = False
    elif case == "every anchor masked":
        mask[:] = False
    elif case == "class with valid gt and no included anchor":
        gt_classes[0, 1] = 2
        mask[0, c0:c1] = False
    elif case == "class with included anchors and no valid gt":
        gt_classes[0][gt_classes[0] == 2] = 3
    elif case == "gt outside the range":
        gt_boxes[0, :, :2] += 200.0
    elif case == "zero-size gt":
        gt_boxes[0, 1, 3:5] = 0.0
        gt_boxes[0, 2, 3] = 0.0
    elif case == "two gt with one standup box":
        # equal IoU with every anchor, other z and height: the first row is the one matched
        gt_classes[0, 2] = gt_classes[0, 1]
        gt_boxes[0, 2] = gt_boxes[0, 1]
        gt_boxes[0, 2, 2] += 1.0
        gt_boxes[0, 2, 5] *= 1.2
    elif case == "boxes that only touch":
        # the gt's standup box starts exactly where an anchor's ends
        ci = int(gt_classes[0, 1]) - 1
        k0 = assigner.channels[ci][0] * hw
        anchors, bvs = assigner.tables.anchors.cpu().numpy(), assigner.tables.anchors_bv.cpu().numpy()
        one = np.float32(1.0)
        k = next(k for k in range(k0, k0 + hw) if np.float32(np.float32(bvs[k, 2] + one) - one) == bvs[k, 2])
        gt = anchors[k].copy()
        gt[0], gt[3], gt[4], gt[6] = np.float32(bvs[k, 2] + one), 2.0, 2.0, 0.0
        gt_boxes[0, 1] = torch.from_numpy(gt)
    return assigner, *(t.to(device) for t in (mask, gt_boxes, gt_classes, gt_valid))


@pytest.mark.gpu
@pytest.mark.parametrize("case", MATCHER_CASES)
def test_matcher_kernels_equal_plain(cuda, case):
    from det3d_tpu_torch.targets import gt_standup

    assigner, mask, gt_boxes, gt_classes, gt_valid = matcher_special_case(case, cuda)
    before = (matcher_cuda.gt_max_counter.launches, matcher_cuda.assign_counter.launches)
    got = assigner(gt_boxes, gt_classes, gt_valid, mask)
    want = assigner.plain(gt_boxes, gt_classes, gt_valid, mask)
    bits = matcher_cuda.gt_max_bits_cuda(assigner.tables, mask.reshape(2, -1), gt_boxes, gt_standup(gt_boxes),
                                         gt_classes, gt_valid)
    torch.cuda.synchronize()
    assert (matcher_cuda.gt_max_counter.launches, matcher_cuda.assign_counter.launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(matcher_cuda.decode_gt_max(bits), assigner.gt_max_plain(gt_boxes, gt_classes, gt_valid, mask))
    for name in ("labels", "bbox_outside_weights", "dir_targets"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    torch.testing.assert_close(got.bbox_targets, want.bbox_targets, rtol=1e-6, atol=1e-6)
    if case == "random":
        assert (got.labels > 0).sum() >= 12
    elif case == "matched threshold 0":
        assert (got.labels[0] > 0).sum() > mask[0].sum() // 2  # positives on a row of zeros


@pytest.mark.gpu
@pytest.mark.parametrize("early", [False, True])
def test_matcher_assign_early_or_late_launch(cuda, early):
    """Pass 2 launched to start while pass 1 runs, or only after it: the same result."""
    from det3d_tpu_torch.targets import gt_standup

    assigner, mask, gt_boxes, gt_classes, gt_valid = matcher_special_case("random", cuda)
    args = (assigner.tables, mask.reshape(2, -1), gt_boxes, gt_standup(gt_boxes), gt_classes, gt_valid)
    for _ in range(3):
        bits = matcher_cuda.gt_max_bits_cuda(*args)
        got = matcher_cuda.assign_cuda(*args, bits, early=early)
    want = assigner.plain(gt_boxes, gt_classes, gt_valid, mask)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want.labels.reshape(2, -1))
    torch.testing.assert_close(got[1], want.bbox_targets.reshape(2, 7, -1), rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["channels_last", "strided"])
def test_scatter_bwd_kernel_bit_equal(cuda, dtype, layout):
    feats, coors = scatter_case(2, 300, 16, (40, 30), 250, seed=5)
    co = torch.from_numpy(coors).to(cuda)
    g = torch.randn(2, 16, 40, 30, device=cuda).to(dtype)
    if layout == "channels_last":
        g = g.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        assert g.is_contiguous()
    else:
        g = torch.randn(2, 40, 60, 16, device=cuda).to(dtype)[:, :, ::2]  # y stride doubled
    before = scatter_cuda.bwd_counter.launches
    got = scatter_cuda.scatter_to_bev_bwd_cuda(g, co)
    want = scatter_cuda.scatter_to_bev_bwd_plain(g, co)
    torch.cuda.synchronize()
    assert scatter_cuda.bwd_counter.launches == before + 1
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(ints), want.view(ints))


@pytest.mark.gpu
def test_scatter_autograd_uses_both_kernels(cuda):
    feats, coors = scatter_case(2, 300, 16, (40, 30), 250, seed=6)
    f = torch.from_numpy(feats).to(cuda).requires_grad_()
    co = torch.from_numpy(coors).to(cuda)
    before = (scatter_cuda.counter.launches, scatter_cuda.bwd_counter.launches)
    g = torch.randn(2, 40, 30, 16, device=cuda)
    scatter_cuda.scatter_to_bev(f, co, (40, 30)).backward(g)
    torch.cuda.synchronize()
    assert (scatter_cuda.counter.launches, scatter_cuda.bwd_counter.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(f.grad, scatter_cuda.scatter_to_bev_bwd_plain(g, co))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sp", [2, 4])
def test_slab_scatter_is_the_canvas_rows_bit_for_bit(cuda, dtype, sp):
    """The spatial path's slab canvas (models/pointpillars.slab_canvas): the
    dense scatter of the pillars with x shifted by the slab's first row into
    a grid of the slab's rows is the full canvas's rows, and its backward
    the full backward's rows for the slab's pillars and zero for the
    others (uneven slabs: 25 coarse rows)."""
    from det3d_tpu_torch.parallel.spatial import slab_bounds

    grid = (200, 96)
    feats, coors = scatter_case(2, 2000, 16, grid, 1500, seed=7)
    f = torch.from_numpy(feats).to(device=cuda, dtype=dtype)
    co = torch.from_numpy(coors).to(cuda)
    full = scatter_cuda.scatter_to_bev(f, co, grid)
    g = torch.randn(2, *grid, 16, device=cuda).to(dtype)
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    for lo, hi in slab_bounds(grid[0], sp)[0]:
        shifted = torch.cat([co[..., :1] - lo, co[..., 1:]], dim=-1).contiguous()
        before = (scatter_cuda.counter.launches, scatter_cuda.bwd_counter.launches)
        fs = f.clone().requires_grad_()
        slab = scatter_cuda.scatter_to_bev(fs, shifted, (hi - lo, grid[1]))
        slab.backward(g[:, lo:hi].contiguous())
        torch.cuda.synchronize()
        assert (scatter_cuda.counter.launches, scatter_cuda.bwd_counter.launches) == (before[0] + 1, before[1] + 1)
        assert torch.equal(slab.detach().view(ints), full[:, lo:hi].view(ints))
        inside = (co[..., 0] >= lo) & (co[..., 0] < hi)
        want = torch.where(inside[..., None], scatter_cuda.scatter_to_bev_bwd_plain(g, co), 0)
        assert torch.equal(fs.grad.view(ints), want.view(ints))


@pytest.mark.gpu
@pytest.mark.parametrize("view", ["cls_preds", "contiguous", "odd_bytes", "int64_sliced"])
def test_fence_kernel_bit_equal(cuda, view):
    if view == "cls_preds":
        y = torch.randn(2, 90, 50, 40, device=cuda).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        x = y[:, :9].reshape(2, 9, 1, 50, 40).transpose(1, 2)
    elif view == "contiguous":
        x = torch.randn(2, 1, 9, 50, 40, device=cuda)
    elif view == "odd_bytes":
        x = torch.randint(0, 255, (7, 13, 3), device=cuda, dtype=torch.uint8)
    else:
        x = torch.randint(-5, 5, (6, 10, 4), device=cuda)[:, 2::3]
    before = fence_cuda.counter.launches
    got = fence_cuda.s2b_fence(x)
    torch.cuda.synchronize()
    assert fence_cuda.counter.launches == before + 1 and got.is_contiguous()
    assert got.dtype == x.dtype and torch.equal(got, x.clone())


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


S2D_SHAPES = [(1, 16000, 64, (800, 800), 12000), (2, 300, 10, (40, 32), 250), (1, 500, 64, (64, 64), 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_major", [False, True])
@pytest.mark.parametrize("shape", S2D_SHAPES)
def test_s2d_kernel_bit_equal(cuda, dtype, w_major, shape):
    b, v, c, grid, n_valid = shape
    feats, coors = scatter_case(b, v, c, grid, n_valid, seed=n_valid + 1)
    f = torch.from_numpy(feats).to(device=cuda, dtype=dtype)
    co = torch.from_numpy(coors).to(cuda)
    before = scatter_cuda.s2d_counter.launches
    got = scatter_cuda.scatter_to_bev_s2d(f, co, grid, w_major)
    want = scatter_cuda.scatter_to_bev_s2d_plain(f, co, grid, w_major)
    torch.cuda.synchronize()
    assert scatter_cuda.s2d_counter.launches == before + 1
    assert got.stride() == want.stride() and torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["channels_last", "w_major", "strided"])
def test_s2d_bwd_kernel_bit_equal(cuda, dtype, layout):
    _, coors = scatter_case(2, 300, 16, (40, 32), 250, seed=7)
    co = torch.from_numpy(coors).to(cuda)
    if layout == "channels_last":  # the entry conv's input gradient
        g = torch.randn(2, 64, 20, 16, device=cuda).to(dtype).contiguous(memory_format=torch.channels_last)
        g = g.permute(0, 2, 3, 1)
    elif layout == "w_major":
        g = torch.randn(2, 16, 20, 64, device=cuda).to(dtype).transpose(1, 2)
    else:
        g = torch.randn(2, 20, 32, 64, device=cuda).to(dtype)[:, :, ::2]
    before = scatter_cuda.s2d_bwd_counter.launches
    got = scatter_cuda.scatter_to_bev_s2d_bwd_cuda(g, co)
    want = scatter_cuda.scatter_to_bev_s2d_bwd_plain(g, co)
    torch.cuda.synchronize()
    assert scatter_cuda.s2d_bwd_counter.launches == before + 1
    assert torch.equal(_bits(got), _bits(want))


BLOCKED_SHAPES = [(2, 16000, 64, (800, 800), 12000, 8), (2, 300, 10, (48, 40), 250, 3), (1, 500, 64, (64, 64), 0, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BLOCKED_SHAPES)
def test_blocked_kernel_bit_equal(cuda, dtype, shape):
    b, v, c, grid, n_valid, nblk = shape
    feats, coors = scatter_case(b, v, c, grid, n_valid, seed=n_valid + 2)
    f = torch.from_numpy(feats).to(device=cuda, dtype=dtype)
    co = torch.from_numpy(coors).to(cuda)
    before = scatter_cuda.blocked_counter.launches
    got = scatter_cuda.scatter_to_bev_s2d_blocked(f, co, grid, nblk, (4, 3))
    want = scatter_cuda.scatter_to_bev_s2d_blocked_plain(f, co, grid, nblk, (4, 3))
    torch.cuda.synchronize()
    assert scatter_cuda.blocked_counter.launches == before + 1
    assert torch.equal(_bits(got), _bits(want))


# the blocked backward's cases beyond BLOCKED_SHAPES: every cell of the grid
# holds a pillar, so every halo row of every block has copies to add
BLOCKED_BWD_SHAPES = BLOCKED_SHAPES[:2] + [(2, 1920, 16, (48, 40), 1920, 3), BLOCKED_SHAPES[2]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "strided", "narrow"])
@pytest.mark.parametrize("shape", BLOCKED_BWD_SHAPES)
def test_blocked_bwd_kernel_bit_equal(cuda, dtype, layout, shape):
    """Bit-equal to the plain version: at the 20 cm train shape, on an odd
    channel count, with every halo row occupied, with every slot empty; on
    a contiguous cotangent, on a padded row stride, and on a y stride of an
    odd element count; in the piece width the wrapper reports (one element
    for the odd stride and for 10-channel rows, else 16 bytes)."""
    b, v, c, grid, n_valid, nblk = shape
    _, coors = scatter_case(b, v, c, grid, n_valid, seed=n_valid + 3)
    co = torch.from_numpy(coors).to(cuda)
    rtot = grid[0] // 2 // nblk + 7
    shape5 = (b, nblk, rtot, grid[1] // 2, 4 * c)
    if layout == "contiguous":
        g = torch.randn(shape5, device=cuda).to(dtype)
    elif layout == "strided":  # a channels_last conv gradient at batch b·nblk, seen as blocks, with a padded row stride
        g = torch.randn(b, nblk, rtot + 1, grid[1] // 2, 4 * c, device=cuda).to(dtype)[:, :, :rtot]
    else:
        g = torch.randn(b, nblk, rtot, grid[1] // 2, 4 * c + 1, device=cuda).to(dtype)[..., :4 * c]
    wide = layout != "narrow" and c * g.element_size() % 16 == 0
    assert scatter_cuda.blocked_bwd_piece_bytes(g) == (16 if wide else g.element_size())
    before = scatter_cuda.blocked_bwd_counter.launches
    got = scatter_cuda.scatter_to_bev_s2d_blocked_bwd_cuda(g, co, (4, 3))
    want = scatter_cuda.scatter_to_bev_s2d_blocked_bwd_plain(g, co, (4, 3))
    torch.cuda.synchronize()
    assert scatter_cuda.blocked_bwd_counter.launches == before + 1
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.gpu
def test_layout_scatters_autograd_use_their_kernels(cuda):
    feats, coors = scatter_case(2, 300, 16, (48, 40), 250, seed=8)
    co = torch.from_numpy(coors).to(cuda)
    counters = (scatter_cuda.s2d_counter, scatter_cuda.s2d_bwd_counter, scatter_cuda.blocked_counter,
                scatter_cuda.blocked_bwd_counter)
    before = [c.launches for c in counters]
    f = torch.from_numpy(feats).to(cuda).requires_grad_()
    g = torch.randn(2, 24, 20, 64, device=cuda)
    scatter_cuda.scatter_to_bev_s2d(f, co, (48, 40)).backward(g)
    assert torch.equal(f.grad, scatter_cuda.scatter_to_bev_s2d_bwd_plain(g, co))
    f.grad = None
    g5 = torch.randn(2, 3, 15, 20, 64, device=cuda)
    scatter_cuda.scatter_to_bev_s2d_blocked(f, co, (48, 40), 3, (4, 3)).backward(g5)
    assert torch.equal(f.grad, scatter_cuda.scatter_to_bev_s2d_blocked_bwd_plain(g5, co, (4, 3)))
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 1 for n in before]


# --- the device guard: tensors on another card than the current one --------


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (run on a machine of several cards with -m gpu)")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["scatter", "scatter_bwd", "s2d", "s2d_bwd", "blocked", "blocked_bwd", "nms",
                                    "matcher", "fence"])
def test_kernels_launch_on_the_card_of_their_tensors(second_card, kernel):
    """Every wrapper launches on its tensors' card, not on the current one
    (the CUDA runtime's default): the tensors on cuda:1 while cuda:0 is
    current, the result equal to the plain version there, and cuda:0 still
    current afterwards."""
    dev = second_card
    feats, coors = scatter_case(2, 300, 16, (48, 40), 250, seed=9)
    f, co = torch.from_numpy(feats).to(dev), torch.from_numpy(coors).to(dev)
    if kernel == "scatter":
        got, want = scatter_cuda.scatter_to_bev_cuda(f, co, (48, 40)), scatter_cuda.scatter_to_bev_plain(f, co, (48, 40))
    elif kernel == "scatter_bwd":
        g = torch.randn(2, 48, 40, 16, device=dev)
        got, want = scatter_cuda.scatter_to_bev_bwd_cuda(g, co), scatter_cuda.scatter_to_bev_bwd_plain(g, co)
    elif kernel == "s2d":
        got = scatter_cuda.scatter_to_bev_s2d_cuda(f, co, (48, 40))
        want = scatter_cuda.scatter_to_bev_s2d_plain(f, co, (48, 40))
    elif kernel == "s2d_bwd":
        g = torch.randn(2, 24, 20, 64, device=dev)
        got, want = scatter_cuda.scatter_to_bev_s2d_bwd_cuda(g, co), scatter_cuda.scatter_to_bev_s2d_bwd_plain(g, co)
    elif kernel == "blocked":
        got = scatter_cuda.scatter_to_bev_s2d_blocked_cuda(f, co, (48, 40), 3, (4, 3))
        want = scatter_cuda.scatter_to_bev_s2d_blocked_plain(f, co, (48, 40), 3, (4, 3))
    elif kernel == "blocked_bwd":
        g = torch.randn(2, 3, 15, 20, 64, device=dev)
        got = scatter_cuda.scatter_to_bev_s2d_blocked_bwd_cuda(g, co, (4, 3))
        want = scatter_cuda.scatter_to_bev_s2d_blocked_bwd_plain(g, co, (4, 3))
    elif kernel == "nms":
        boxes, valid = zip(*(nms_case(700, seed)[:2] for seed in (1, 2, 3)))
        b = torch.from_numpy(np.stack(boxes)).to(dev)
        v = torch.from_numpy(np.stack(valid)).to(dev)
        got, want = nms_cuda.nms_keep_cuda(b, v, 0.5), nms_cuda.nms_keep_plain(b, v, 0.5)
    elif kernel == "matcher":
        cfg = load_config(MATCH_CFG)
        assigner = make_assigner(cfg, dev)
        args = matcher_case(cfg, assigner, seed=4, device=dev)
        got = assigner(*args[1:], args[0])
        want = assigner.plain(*args[1:], args[0])
        got, want = torch.stack([got.labels, got.dir_targets]), torch.stack([want.labels, want.dir_targets])
    else:
        x = torch.randn(2, 90, 50, 40, device=dev).contiguous(memory_format=torch.channels_last)[:, :9]
        got, want = fence_cuda.fence_copy_cuda(x), fence_cuda.fence_copy_plain(x)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    assert got.device == dev and torch.equal(got, want)
