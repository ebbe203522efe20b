"""The port's kernel modules: plain versions against the JAX kernels, and
(marker `gpu`) the CUDA kernels against the plain versions on the card.

CPU half: `scatter_to_bev_plain` against `scatter_to_bev_pallas(interpret=
True)` — equal, the scatter only moves values; `nms_keep_plain` against
`greedy_nms_pallas(interpret=True)` and the sequential numpy oracle — keep
masks equal, both evaluate the same float32 IoU expression. JAX is imported
inside those tests only, so that the GPU half runs where JAX is absent.

GPU half: needs a CUDA card and skips without one (decided in a fixture,
never at import). On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import np_ref
from det3d_tpu_torch.kernels import build, nms_cuda, scatter_cuda
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


def test_build_hash_covers_source_and_flags(monkeypatch):
    """A library's file name changes with its flags, so a stale build of
    other flags is never loaded."""
    before = build._library_path("nms")
    monkeypatch.setitem(build.EXTRA_FLAGS, "nms", ())
    assert build._library_path("nms") != before
    assert before.parent == build.BUILD_DIR and before.suffix == ".so"


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
