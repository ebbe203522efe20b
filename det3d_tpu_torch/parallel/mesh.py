"""Data-parallel groups of processes, one card each, for the train step and
batched inference.

Counterpart of the data-parallel half of the JAX package's
parallel/mesh.py (`make_mesh`, `replicated`, `shard_batch`,
`collective_counts`, `make_sharded_train_step`, `make_sharded_infer`;
mesh.py:34-132 and 217-260). JAX runs one program over a mesh of devices
and writes the step's reductions as `psum` / `pmean` over the `data` axis
of a `shard_map`. PyTorch runs one process per card (`torchrun`), each with
its own copy of the weights, and the same reductions are collectives of a
process group (NCCL between cards, gloo on the CPU):

  * the PFN's masked sync-BN statistics: `all_reduce_sum` of [count, Σx]
    and of Σ m(x - mean)², whose backward is again a sum all-reduce (the
    transpose of `psum`), so the statistics are the global batch's;
  * the gradients, once a step as one flat buffer, summed and divided by
    the world size (`pmean`) before the clip and Adam, so every rank
    applies the same update;
  * the mean of the loss terms and the sum of the metric counts.

A rank's batch is its contiguous slice of the global batch (`shard_batch`,
JAX's `P(DATA_AXIS)`), so a step at world W equals the one-process step at
the global batch. The hand-written kernels run per rank on its slice, as
the Pallas calls run per device inside JAX's `shard_map`.

Not ported: the spatial modes (`make_spatial_mesh`, `make_hybrid_mesh`,
`make_spatial_train`, `make_spatial_infer`): GSPMD's automatic halo
exchange has no PyTorch counterpart (ROADMAP).
"""

from __future__ import annotations

import collections
import dataclasses
import os

import torch
import torch.distributed as dist

from det3d_tpu_torch.postprocess import Detections
from det3d_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass
class DataMesh:
    """The process group of the data axis and this process's place in it.
    `rank` is -1 and `group` None on a process outside the group (a
    `make_mesh(n)` of fewer ranks than the world). `collectives` counts the
    collectives this module issued over the group, by kind (the
    counterpart of JAX's `collective_counts`, which reads them from the
    compiled program)."""

    group: object
    rank: int
    world: int
    device: torch.device
    backend: str
    collectives: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def member(self) -> bool:
        return self.rank >= 0

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place."""
        dist.all_reduce(t, group=self.group)
        self.collectives["all_reduce"] += 1
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank, in place."""
        dist.broadcast(t, src=0, group=self.group)
        self.collectives["broadcast"] += 1
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` concatenated along axis 0, in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        self.collectives["all_gather"] += 1
        return torch.cat(parts)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)
        self.collectives["barrier"] += 1


def launched_by_torchrun() -> bool:
    """Whether this process is a rank of a `torchrun` launch (its
    environment names the rank and the world)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def make_mesh(n: int | None = None, *, device=None, backend: str | None = None, rank: int | None = None,
              world_size: int | None = None, init_method: str | None = None) -> DataMesh:
    """The data axis over the world's processes, or over its first `n`
    (every process of the world calls this; the others get a mesh they are
    not a member of).

    The world's process group is made on the first call: from `torchrun`'s
    environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`), or
    from `rank`, `world_size` and `init_method` (a `file://` path needs no
    port). `device` is "cuda" unless named; a CUDA device without an index
    becomes `cuda:LOCAL_RANK` and the current device. The backend is NCCL
    on the card and gloo on the CPU; gloo on the card only where `backend`
    names it (NCCL refuses two ranks on one card). A failed NCCL start
    raises: nothing falls back to gloo or to one process."""
    if not dist.is_initialized():
        if rank is None:
            if not launched_by_torchrun():
                raise RuntimeError("no process group: launch under torchrun, or pass rank, world_size and "
                                   "init_method")
            rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        device = _rank_device(device, rank)
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError(f"NCCL needs a CUDA device, got {device}")
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world_size,
                                **kw)
    else:
        device = _rank_device(device, dist.get_rank())
    mesh = DataMesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), device, dist.get_backend())
    if n is None or n == mesh.world:
        return mesh
    if not 1 <= n <= mesh.world:
        raise ValueError(f"need {n} ranks, the world has {mesh.world}")
    group = dist.new_group(list(range(n)))  # a collective of the whole world
    inside = mesh.rank < n
    return DataMesh(group if inside else None, mesh.rank if inside else -1, n, device, mesh.backend)


def _rank_device(device, rank: int) -> torch.device:
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    return device


def collective_counts(mesh: DataMesh) -> dict[str, int]:
    """The collectives issued over `mesh` so far, by kind."""
    return dict(mesh.collectives)


# --- the step's reductions ------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.clone(memory_format=torch.contiguous_format)), None


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of `x` over the ranks (`jax.lax.psum`), differentiable: its
    backward sums the cotangents over the ranks as well, psum's transpose."""
    return _AllReduceSum.apply(x, mesh)


@torch.no_grad()
def pmean_gradients(params, mesh: DataMesh) -> None:
    """Every parameter's `.grad` replaced by its mean over the ranks (JAX's
    `pmean(grads)`), through one all-reduce of a flat buffer; each `.grad`
    keeps its tensor and layout (a missing one becomes zeros, as the
    optimizer reads it)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce_(flat).div_(mesh.world)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view(g.shape))


@torch.no_grad()
def psum(tree: dict[str, torch.Tensor], mesh: DataMesh) -> dict[str, torch.Tensor]:
    """Each tensor of a dict of tensors of one dtype summed over the ranks,
    in one all-reduce."""
    keys = list(tree)
    flat = mesh.all_reduce_(torch.cat([tree[k].detach().reshape(-1) for k in keys]))
    parts = flat.split([tree[k].numel() for k in keys])
    return {k: part.view(tree[k].shape) for k, part in zip(keys, parts)}


def pmean(tree: dict[str, torch.Tensor], mesh: DataMesh) -> dict[str, torch.Tensor]:
    """`psum` divided by the world size."""
    return {k: v / mesh.world for k, v in psum(tree, mesh).items()}


# --- placement --------------------------------------------------------------


@torch.no_grad()
def replicated(mesh: DataMesh, trainer, state):
    """Rank 0's weights, batch statistics, Adam moments, step and lr on
    every rank (in place; returns `state`), as JAX places a state
    replicated: one broadcast per dtype of the tensors and one of the two
    scalars."""
    tensors = list(trainer.model.state_dict().values()) + list(state.mu) + list(state.nu)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = mesh.broadcast_(torch.cat([t.reshape(-1) for t in group]))
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view(t.shape))
    scalars = mesh.broadcast_(torch.tensor([state.step, state.lr], dtype=torch.float64, device=mesh.device))
    state.step, state.lr = int(scalars[0]), float(scalars[1])
    return state


def local_slice(mesh: DataMesh, n: int) -> slice:
    """This rank's contiguous share of `n` items (`n` a multiple of the
    world size)."""
    if n % mesh.world:
        raise ValueError(f"a batch of {n} does not split over {mesh.world} ranks")
    k = n // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(mesh: DataMesh, batch):
    """Rank r's contiguous slice of a global batch (a NamedTuple of arrays
    with a leading batch axis, e.g. a `TrainBatch`): the global batch is the
    concatenation of the ranks' slices in rank order, as `P(DATA_AXIS)`
    splits it."""
    sl = local_slice(mesh, len(batch[0]))
    return type(batch)(*(a[sl] for a in batch))


# --- the sharded step and inference -----------------------------------------


def make_sharded_train_step(trainer, mesh: DataMesh):
    """Data-parallel training: `step(state, local_batch)` runs the whole
    `Trainer.train_step` on this rank's slice of the global batch (the
    scatter, matcher and fence kernels launched per rank), with the sync-BN
    statistics, the gradients, the loss terms and the metric counts reduced
    over the mesh inside it. Pass `shard_batch(mesh, global_batch)`, or the
    slice a rank loaded itself; the result equals the one-process step at
    the global batch, and every rank holds it."""
    def step(state, batch):
        return trainer.train_step(state, batch, mesh=mesh)

    return step


def make_sharded_infer(detector, mesh: DataMesh):
    """Batched inference sharded on the data axis: `infer(points (B,
    max_points, C), num_points (B,))`, host arrays or tensors of the global
    batch, runs `Detector.infer_batch` on this rank's contiguous slice (its
    network once, its NMS call once) and returns the global batch's
    `Detections` on every rank, gathered in frame order. The one-stage form
    of the JAX function; two-stage dispatch is not ported (ROADMAP)."""
    if not mesh.member:
        raise ValueError("this process is outside the mesh")

    def infer(points, num_points) -> Detections:
        sl = local_slice(mesh, len(points))
        pts = torch.as_tensor(points[sl]).to(detector.device)
        cnt = torch.as_tensor(num_points[sl]).to(detector.device)
        out = detector.infer_batch(pts, cnt)
        # bools travel as bytes, which every backend gathers
        return Detections(mesh.all_gather(out.boxes), mesh.all_gather(out.scores),
                          mesh.all_gather(out.valid.to(torch.uint8)).bool())

    return infer
