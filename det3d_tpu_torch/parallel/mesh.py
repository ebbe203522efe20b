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

The entry points are compiled, as JAX jits its `shard_map`s:
`make_sharded_train_step`, `make_sharded_infer`, `make_spatial_infer` and
`make_spatial_train` return callables that capture one CUDA graph per call
shape on the card (`utils/graphs.CapturedCall`, through
`Trainer.train_step_jit` and `Detector.infer_jit`), with the call's NCCL
collectives inside the graph, and run op by op on the CPU. Their outputs
are the graph's buffers, which the next call overwrites. The eager
per-rank bodies stay `Trainer.train_step(state, batch, mesh=...)` and
`Detector.infer`; a gloo group on a CUDA device runs only those
(`utils/graphs.refuse_host_staged`).

The spatial half (mesh.py:51-60 and 135-214 of the JAX package): one
frame's RPN split along x over the ranks of a spatial group, whose halo
exchanges, InstanceNorm statistics and preds gather are written by hand in
`parallel/spatial.py` (JAX leaves them to GSPMD):

  * `make_spatial_mesh(n)`: the spatial group over the world or its first
    n ranks; `make_spatial_infer(cfg, mesh)` runs one frame on it, every
    rank voxelizing, running the PFN, decoding and running NMS on the
    gathered preds (replicated, as JAX's replicated shardings place them),
    each its slab of the scatter, the RPN and the head;
  * `make_hybrid_mesh(dp, sp)`: rank = d·sp + s, as JAX's `reshape(dp,
    sp)`; a `HybridMesh` holds the rank's data group (the ranks of its
    spatial index) and its spatial group (the ranks of its data index).
    `make_spatial_train` steps on it: each data group's spatial ranks load
    the same slice of the batch and split its RPN along x; sync-BN, the
    loss mean and the metric sums run over the data group, and the
    gradients take one all-reduce over the world divided by dp (the sum of
    the spatial ranks' partial gradients, then the mean over data).
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
    """The process group of one axis (data or spatial) and this process's
    place in it.
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
        """Every rank's `t` concatenated along axis 0, in rank order: one
        gather into one flat buffer, the bytes in the order of `torch.cat`
        of the ranks' parts, with no parts to concatenate after it."""
        t = t.contiguous()
        out = torch.empty((self.world * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.group)
        self.collectives["all_gather"] += 1
        return out

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
    port; a world of one with no `init_method` needs none). `device` is
    "cuda" unless named; a CUDA device without an index
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
        if init_method is None and world_size == 1:
            kw["store"] = dist.HashStore()  # a group of this process alone needs no rendezvous
        else:
            kw["init_method"] = init_method or "env://"
        dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
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


def make_spatial_mesh(n: int | None = None, **kw) -> DataMesh:
    """The spatial group over the world's processes, or over its first `n`
    (JAX's 1-D mesh over the `spatial` axis); `make_mesh`'s arguments."""
    return make_mesh(n, **kw)


@dataclasses.dataclass
class HybridMesh:
    """A (data, spatial) grid of dp x sp ranks, rank = d·sp + s: the world,
    this rank's data group (ranks s + k·sp, k < dp) and its spatial group
    (ranks d·sp + k, k < sp)."""

    world: DataMesh
    data: DataMesh
    spatial: DataMesh

    @property
    def dp(self) -> int:
        return self.data.world

    @property
    def sp(self) -> int:
        return self.spatial.world

    @property
    def device(self) -> torch.device:
        return self.world.device


def make_hybrid_mesh(dp: int, sp: int, **kw) -> HybridMesh:
    """The (data, spatial) grid over a world of dp·sp processes (every
    process calls this; `make_mesh`'s arguments). Every rank makes every
    group, in the same order, as `new_group` asks; a group of the whole
    world is the world's."""
    world = make_mesh(**kw)
    if dp < 1 or sp < 1 or dp * sp != world.world:
        raise ValueError(f"a {dp} x {sp} (data x spatial) grid needs {dp * sp} ranks, the world has {world.world}")
    d, s = divmod(world.rank, sp)

    def group(members: list[int]):
        # new_group is a collective of the whole world
        return world.group if len(members) == world.world else dist.new_group(members)

    data = [group([t + k * sp for k in range(dp)]) for t in range(sp)][s]
    spatial = [group([t * sp + k for k in range(sp)]) for t in range(dp)][d]
    return HybridMesh(world, DataMesh(data, d, dp, world.device, world.backend),
                      DataMesh(spatial, s, sp, world.device, world.backend))


def collective_counts(mesh: DataMesh | HybridMesh) -> dict:
    """The collectives issued over `mesh` so far, by kind; for a
    `HybridMesh`, by group ("world", "data", "spatial") and kind. A
    captured call counts as its eager form does: each call adds what its
    capture issued (`utils.graphs.CapturedCall`), its warm-ups nothing."""
    if isinstance(mesh, HybridMesh):
        return {name: dict(getattr(mesh, name).collectives) for name in ("world", "data", "spatial")}
    return dict(mesh.collectives)


def groups(mesh: DataMesh | HybridMesh | None) -> list[DataMesh]:
    """The groups a step on `mesh` issues collectives over."""
    if mesh is None:
        return []
    return [mesh.world, mesh.data, mesh.spatial] if isinstance(mesh, HybridMesh) else [mesh]


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
def pmean_gradients(params, mesh: DataMesh, n: int | None = None) -> None:
    """Every parameter's `.grad` replaced by its sum over the ranks divided
    by `n`, the world size by default (JAX's `pmean(grads)`), through one
    all-reduce of a flat buffer; each `.grad` keeps its tensor and layout (a
    missing one becomes zeros, as the optimizer reads it)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce_(flat).div_(mesh.world if n is None else n)
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
    """Data-parallel training, compiled (JAX's `jax.jit(shard_map(...),
    donate_argnums=(0,))`): `step(state, local_batch)` is
    `trainer.train_step_jit` on the mesh, one captured CUDA graph a step
    with the step's seven all-reduces inside it (op by op on the CPU). It
    runs the whole `Trainer.train_step` on this rank's slice of the global
    batch (the scatter, matcher and fence kernels launched per rank), with
    the sync-BN statistics, the gradients, the loss terms and the metric
    counts reduced over the mesh inside it. Pass `shard_batch(mesh,
    global_batch)`, or the slice a rank loaded itself; the result equals
    the one-process step at the global batch, and every rank holds it. The
    loss dict and counts are the graph's buffers, which the next step
    overwrites. A trainer's captured step serves one mesh; the eager
    per-rank body is `trainer.train_step(state, batch, mesh=mesh)`."""
    def step(state, batch):
        return trainer.train_step_jit(state, batch, mesh=mesh)

    return step


def make_sharded_infer(detector, mesh: DataMesh):
    """Batched inference sharded on the data axis, compiled (JAX's jitted
    `shard_map`): `infer(points (B, max_points, C), num_points (B,))`, host
    arrays or tensors of the global batch, runs one captured CUDA graph per
    local batch size: `Detector.infer_batch` on this rank's contiguous slice
    (its network once, its NMS call once) and the three all-gathers of the
    results, which returns the global batch's `Detections` on every rank,
    gathered in frame order, in the graph's buffers (op by op on the CPU).
    The one-stage form of the JAX function; two-stage dispatch is not
    ported (ROADMAP)."""
    if not mesh.member:
        raise ValueError("this process is outside the mesh")
    from det3d_tpu_torch.pipeline import CapturedInfer

    def gathered(points, num_points):
        boxes, scores, valid = detector.module.forward_batch(points, num_points)
        # bools travel as bytes, which every backend gathers
        return mesh.all_gather(boxes), mesh.all_gather(scores), mesh.all_gather(valid.to(torch.uint8)).bool()

    captured: dict[int, CapturedInfer] = {}

    def infer(points, num_points) -> Detections:
        sl = local_slice(mesh, len(points))
        n = sl.stop - sl.start
        if n not in captured:
            captured[n] = CapturedInfer(gathered, detector.device, meshes=[mesh])
        return captured[n](points[sl], num_points[sl])

    infer.captured = captured
    return infer


# --- the spatial modes ----------------------------------------------------------


def make_spatial_infer(cfg, mesh: DataMesh, **detector_kwargs):
    """Single-frame inference split along x over the spatial group `mesh`,
    compiled (JAX's `make_spatial_infer` without its `variables` argument:
    the detector holds its weights, which every rank must load alike) →
    `(detector, infer_fn)`; `infer_fn(points (max_points, C), num_points)`,
    a host array or a tensor, is `detector.infer_jit`: one captured CUDA
    graph a frame with its halo all-gathers, InstanceNorm all-reduces and
    preds gather inside (op by op on the CPU), which returns the frame's
    `Detections` on every rank in the graph's buffers. Each rank launches
    the dense scatter once, into its slab, and NMS once, on the gathered
    preds. The eager form is `detector.infer(points, num_points)`."""
    from det3d_tpu_torch.pipeline import Detector

    det = Detector(cfg, mesh.device, spatial=mesh, **detector_kwargs)

    def infer(points, num_points) -> Detections:
        return det.infer_jit(points, num_points)

    return det, infer


def make_spatial_train(cfg, mesh: HybridMesh, *, s2b_fence: bool = False, **trainer_kwargs):
    """Hybrid data x spatial training, compiled (JAX's `make_spatial_train`)
    → `(trainer, step_fn)`; `step_fn(state, batch)` is
    `trainer.train_step_jit` on the grid, one captured CUDA graph a step
    with every collective of the three groups inside it (op by op on the
    CPU). It takes this rank's data group's slice of the global batch
    (`shard_batch(mesh.data, batch)`), the same on every rank of a spatial
    group, and returns what `Trainer.train_step` returns, the same on every
    rank, the loss dict and counts in the graph's buffers. The fence is off
    by default, as in JAX (it is an identity copy). The eager form is
    `trainer.train_step(state, batch, mesh=mesh)`."""
    from det3d_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, mesh.device, spatial=mesh.spatial, fence=s2b_fence, **trainer_kwargs)

    def step(state, batch):
        return trainer.train_step_jit(state, batch, mesh=mesh)

    return trainer, step
