"""Multiprocessing batch prefetcher for training.

The port's own copy of the JAX package's data/prefetcher.py (reference:
`DataLoader(num_workers, worker_init_fn)`, train.py:37-55): sample loading
and augmentation run in spawned worker processes ahead of the consumer, and
the parent collates each batch into the port's numpy `TrainBatch`
(`train.trainer.host_batch`). Spawn, not fork: the parent holds a live CUDA
context, and a forked child of it is unsafe. The dataset is pickled once
into each worker; this module and the dataset's import no torch, so a
worker never touches the card.

Workers reseed the augmentation rng per (seed, epoch, index), so an epoch
is the same whichever worker, or whichever rank of a data-parallel run,
takes which sample, and the same as the JAX prefetcher's for the same
seed. `shard=(rank, world)` loads only a rank's contiguous slice of each
global batch of `cfg.batch_size` samples (the shuffle is the same on every
rank), so the ranks' slices in rank order are the one-process batch. In
the hybrid data x spatial mode the shard is `(data rank, dp)`, so the
ranks of one spatial group load the same slice.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Iterator

import numpy as np

from det3d_tpu_torch.config import Config

_WORKER_DS = None


def _init_worker(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _load_with(dataset, job) -> dict:
    seed, idx = job
    dataset.rng = np.random.RandomState(seed)
    return dataset[int(idx)]


def _load_one(job) -> dict:
    return _load_with(_WORKER_DS, job)


class BatchPrefetcher:
    """Iterate TrainBatches with worker-process sample loading.

        with BatchPrefetcher(dataset, cfg, num_workers=3, seed=0) as pf:
            for batch in pf.epochs():   # endless, reshuffled per epoch
                ...
    """

    def __init__(self, dataset, cfg: Config, num_workers: int, *, seed: int = 0, shard: tuple[int, int] = (0, 1)):
        rank, world = shard
        if cfg.batch_size % world or not 0 <= rank < world:
            raise ValueError(f"rank {rank} of {world}: batch_size {cfg.batch_size} must split over the ranks")
        self.dataset = dataset
        self.cfg = cfg
        self.num_workers = max(int(num_workers), 0)
        self.seed = seed
        self.shard = shard
        self._pool = None
        if self.num_workers > 0:
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(self.num_workers, initializer=_init_worker, initargs=(dataset,))

    def _epoch_batches(self, epoch: int):
        from det3d_tpu_torch.train.trainer import host_batch

        rng = np.random.RandomState(self.seed + epoch)
        order = np.arange(len(self.dataset))
        rng.shuffle(order)
        bs = self.cfg.batch_size
        rank, world = self.shard
        local = bs // world
        idxs = order[: (len(order) // bs) * bs]
        # this rank's slice of each global batch
        idxs = idxs.reshape(-1, world, local)[:, rank].reshape(-1)
        jobs = [((self.seed * 1_000_003 + epoch * 9_999_991 + int(i)) & 0xFFFFFFFF, i) for i in idxs]
        if self._pool is None:
            samples = (_load_with(self.dataset, job) for job in jobs)
        else:
            samples = self._pool.imap(_load_one, jobs, chunksize=max(1, local // self.num_workers))
        buf = []
        for s in samples:
            buf.append(s)
            if len(buf) == local:
                yield host_batch(self.cfg, buf)
                buf = []

    def epochs(self) -> Iterator:
        epoch = 0
        while True:
            produced = 0
            for batch in self._epoch_batches(epoch):
                produced += 1
                yield batch
            if produced == 0:
                # len(dataset) < batch_size: no epoch has a full batch
                raise ValueError(f"dataset yields no full batches (len={len(self.dataset)}, "
                                 f"batch_size={self.cfg.batch_size})")
            epoch += 1

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
