"""The algorithm of `det3d_tpu_torch/kernels/csrc/nms.cu`, emulated in numpy.

The CUDA kernels run only on a card; this file runs their two parts as
designed on the CPU and holds the keep masks against the port's plain
version (`ops.nms.greedy_keep`), the sequential numpy oracle
(`np_ref.nms_greedy_ref`) and, for one case, the JAX package's
`greedy_nms_pallas(interpret=True)`:

  * `mask_tiles`: the suppression matrix as 32-bit words, rows of 32 words,
    written only for tiles of 64 x 64 boxes on or above the diagonal. Every
    word the kernel does not write holds 0xFFFFFFFF here, and the emulated
    sweep asserts that every word it uses was written;
  * `sweep`: rows in chunks of 32; the chunk's 32 diagonal words decide its
    rows in a register chain, then the kept rows' words right of the diagonal
    are ORed into the `removed` words of the later chunks.

All comparisons are exact: every version evaluates the same float32 IoU
expression in the same order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import np_ref
from det3d_tpu_torch.kernels import nms_cuda
from det3d_tpu_torch.ops.nms import greedy_keep

torch.set_num_threads(1)

TILE = 64
CHUNK = 32
ROW_WORDS = nms_cuda.MASK_ROW_WORDS
UNWRITTEN = np.uint32(0xFFFFFFFF)
THR = 0.1


def suppression_bits(boxes: np.ndarray, thr: float) -> np.ndarray:
    """(K, K) bool: IoU(i, j) > thr in float32, one area per box, the pair's
    operations in the kernel's order."""
    one = np.float32(1.0)
    x1, y1, x2, y2 = (boxes[:, d] for d in range(4))
    area = (x2 - x1 + one) * (y2 - y1 + one)
    iw = np.maximum(np.minimum(x2[:, None], x2[None, :]) - np.maximum(x1[:, None], x1[None, :]) + one, 0)
    ih = np.maximum(np.minimum(y2[:, None], y2[None, :]) - np.maximum(y1[:, None], y1[None, :]) + one, 0)
    inter = iw * ih
    assert inter.dtype == np.float32
    return inter / (area[:, None] + area[None, :] - inter) > np.float32(thr)


def mask_tiles(boxes: np.ndarray, valid: np.ndarray, thr: float) -> tuple[np.ndarray, np.ndarray]:
    """Part A: (K, 32) uint32, tiles left of the diagonal and words past the
    last tile left at UNWRITTEN, and which words were written."""
    k = len(boxes)
    tiles = -(-k // TILE)
    over = suppression_bits(boxes, thr)
    mask = np.full((k, ROW_WORDS), UNWRITTEN, np.uint32)
    written = np.zeros((k, ROW_WORDS), bool)
    for tr in range(tiles):
        for tc in range(tr, tiles):
            for i in range(tr * TILE, min((tr + 1) * TILE, k)):
                for w in range(TILE // 32):
                    j0 = tc * TILE + 32 * w
                    bits = 0
                    if valid[i] and j0 + 31 > i:
                        for c in range(32):  # columns past K are invalid
                            j = j0 + c
                            if j < k and valid[j] and over[i, j]:
                                bits |= 1 << c
                        if i >= j0:
                            bits &= ~((2 << (i - j0)) - 1)
                    mask[i, 2 * tc + w] = bits & 0xFFFFFFFF
                    written[i, 2 * tc + w] = True
    return mask, written


def rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF if n else x


def sweep(mask: np.ndarray, written: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Part B: the keep flags (K,) from the mask words, chunk by chunk."""
    k = len(valid)
    chunks = -(-k // CHUNK)
    words = 2 * -(-k // TILE)  # the words of a row that part A wrote
    lanes = np.arange(ROW_WORDS)
    valid_words = np.zeros(ROW_WORDS, np.uint32)
    for i in np.flatnonzero(valid):
        valid_words[i // CHUNK] |= np.uint32(1 << (i % CHUNK))
    removed = np.zeros(ROW_WORDS, np.uint32)
    keep = np.zeros(k, bool)
    for c in range(chunks):
        rows = mask[c * CHUNK:(c + 1) * CHUNK]  # fewer than 32 rows in the last chunk
        usable = written[c * CHUNK:(c + 1) * CHUNK]
        assert usable[:, c].all()  # the diagonal words
        # a row that is not valid counts as removed: it is not kept and ORs nothing
        r = int(removed[c]) | (~int(valid_words[c]) & 0xFFFFFFFF)
        # the kernel's chain: x is r rotated so that the row to decide is bit 31
        x = rotl(r, 31)
        for b in range(CHUNK):
            m = 0xFFFFFFFF if x >> 31 else 0
            e = rotl(int(rows[b, c]), (30 - b) & 31) if b < len(rows) else 0  # the diagonal word, rotated to match
            x = rotl(x, 31) | (~m & e)
        # a row's bit is final when the row is decided: later rows set only later bits
        kept = ~rotl(x, 1) & 0xFFFFFFFF
        spread = (lanes > c) & (lanes < words)
        for b in range(CHUNK):
            if kept >> b & 1:
                keep[c * CHUNK + b] = True
                assert usable[b, spread].all()
                removed[spread] |= rows[b, spread]
    return keep


def emulated_keep(boxes: np.ndarray, valid: np.ndarray, thr: float = THR) -> np.ndarray:
    return sweep(*mask_tiles(boxes, valid, thr), valid)


def random_case(k: int, seed: int, invalid: float):
    r = np.random.RandomState(seed)
    c = r.uniform(-25.0, 25.0, (k, 2)).astype(np.float32)
    d = r.uniform(1, 8, (k, 2)).astype(np.float32)
    boxes = np.concatenate([c - d / 2, c + d / 2], -1)
    return boxes, r.rand(k) >= invalid


def chain_case(k: int):
    """Boxes in a row, each over the threshold only with its neighbours: the
    keeps alternate along k dependent decisions."""
    x = np.arange(k, dtype=np.float32) * 5
    zero = np.zeros(k, np.float32)
    return np.stack([x, zero, x + 9, zero + 9], -1), np.ones(k, bool)


def check_against_plain_and_oracle(boxes: np.ndarray, valid: np.ndarray) -> np.ndarray:
    got = emulated_keep(boxes, valid)
    want = greedy_keep(torch.from_numpy(boxes), torch.from_numpy(valid), THR).numpy()
    np.testing.assert_array_equal(got, want)
    idx = np.flatnonzero(valid)
    scores = -np.arange(len(boxes), dtype=np.float32)  # rows are in score order already
    kept = idx[np_ref.nms_greedy_ref(boxes[idx], scores[idx], THR, len(boxes))]
    np.testing.assert_array_equal(np.flatnonzero(got), np.sort(kept))
    assert not got[~valid].any()
    return got


@pytest.mark.parametrize("invalid", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 77, 1000, 1024])
def test_emulated_kernel_equals_plain_and_oracle(k, invalid):
    boxes, valid = random_case(k, seed=k, invalid=invalid)
    got = check_against_plain_and_oracle(boxes, valid)
    assert got.any() == valid.any()


@pytest.mark.parametrize("k", [33, 1000])
def test_chain_alternates(k):
    got = check_against_plain_and_oracle(*chain_case(k))
    np.testing.assert_array_equal(got, np.arange(k) % 2 == 0)


@pytest.mark.parametrize("k", [77, 1024])
def test_identical_boxes_keep_the_first(k):
    boxes = np.tile(np.array([[1.0, 2.0, 6.0, 5.0]], np.float32), (k, 1))
    got = check_against_plain_and_oracle(boxes, np.ones(k, bool))
    assert got[0] and got.sum() == 1


def test_valid_only_in_the_last_chunk():
    boxes, _ = random_case(1000, seed=5, invalid=0.0)
    valid = np.arange(1000) >= 31 * CHUNK
    got = check_against_plain_and_oracle(boxes, valid)
    assert got[31 * CHUNK] and not got[: 31 * CHUNK].any()


def test_unwritten_words_lie_left_of_the_diagonal_or_past_the_tiles():
    boxes, valid = random_case(200, seed=3, invalid=0.1)
    mask, written = mask_tiles(boxes, valid, THR)
    assert (mask[~written] == UNWRITTEN).all()
    rows, words = np.nonzero(~written)
    assert len(rows) and (((words // 2) < (rows // TILE)) | (words >= 2 * 4)).all()
    # a written word holds no bit at or left of its row, and none past K
    for i in range(200):
        for w in range(2 * (i // TILE), 2 * 4):
            for c in range(32):
                if mask[i, w] >> np.uint32(c) & np.uint32(1):
                    assert i < 32 * w + c < 200


def test_emulated_kernel_equals_pallas_interpret():
    import jax.numpy as jnp

    from det3d_tpu.kernels.nms_pallas import greedy_nms_pallas

    boxes, valid = random_case(300, seed=11, invalid=0.2)
    want = np.asarray(greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(valid), THR, 300, interpret=True))
    np.testing.assert_array_equal(emulated_keep(boxes, valid), want)
