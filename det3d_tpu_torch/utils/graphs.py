"""One function of fixed shapes, captured once as a CUDA graph and replayed:
the port's counterpart of `jax.jit` for the compiled entry points
(`Detector.infer_jit`, `Trainer.train_step_jit`, the sharded and spatial
entry points of `parallel/mesh.py`, the exported runtime).

`CapturedCall(fn, device)` is called like `fn`, with a pytree of tensors,
numpy arrays or numpy scalars whose shapes the first call fixes. Each call
copies them into static buffers on `device`: a device tensor by a
device-to-device copy, a host array through a pinned staging buffer by a
non-blocking copy behind an event (the host waits only for the previous
call's copies to leave the staging buffers, never for the card's work).
On the card the first call runs `fn` `WARMUP_CALLS` times on a side
stream (the kernels' build, cuDNN's first calls, every lazily made device
constant), puts back the tensors of `preserve` as they were before the
warm-up (the state that `fn` updates in place), then captures `fn` once
over the static buffers on that stream; every call then replays that one
graph on the caller's stream. A capture that fails
raises: nothing falls back to running `fn` op by op. On the CPU `fn` runs
op by op over the same static buffers, and its results are copied into
static output buffers, so that both devices hand over alike.

The contract: the outputs are the call's own buffers (on the card the
graph's), and the next call overwrites them. Clone what must outlive it.
`fn` reads every other tensor (parameters, optimizer state) at the address
it had at the capture: update those in place, never replace them.
Capture errors are thread-local: other threads (serving's producer) may
use CUDA while this one captures.

Tracing (`utils.timing`, on while a profiler runs on the thread): a call
records the spans `call.stage` (`_fill`: the wait for the previous call's
copies, the pinned copy, the non-blocking host-to-device enqueue) and
`call.launch` (the replay, or the run op by op), under one call id (the
open span's, or a new one), and counts `call.replays`. The stage marks
that `fn` places (`timing.mark`) are captured into the graph as event
nodes, owned by the call; a replay made while recording has its marks
read at the next call, or by `timing.replays()`.

Collectives (`meshes`: the `parallel.mesh.DataMesh` groups that `fn`
issues collectives over). The warm-up calls run every collective before
the capture, so each NCCL communicator is made outside the graph; every
rank of a group makes the same calls, so all of them warm up twice and
capture once, in the same order, and the graph of each rank holds its
share of the group's collectives, which run when every rank replays. A
`DataMesh` counts the collectives issued per call: the capture records
what it issued over each group, the counts go back to where they stood
before the warm-ups, and every call then adds the capture's record, as
JAX counts a jitted program's collectives from the compiled program. A
group whose backend is not NCCL on a CUDA device raises by name before
anything runs: gloo stages CUDA tensors through the host, which a graph
cannot hold (the eager forms run there).
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable

import torch
from torch.utils import _pytree as pytree

from det3d_tpu_torch.utils import timing

WARMUP_CALLS = 2
_WARMUP_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a device for every warm-up and capture: each new
    stream costs a cuBLAS workspace (32 MiB on the H100) that torch keeps
    for the life of the process, and pins the cached segment it lies in."""
    if device not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[device]


def refuse_host_staged(meshes) -> None:
    """Raise if a group of `meshes` runs its collectives through the host
    on a CUDA device (gloo on a card): no graph can capture them."""
    for m in meshes:
        if m.device.type == "cuda" and m.backend != "nccl":
            raise ValueError(f"a {m.backend} group on {m.device} cannot be captured in a CUDA graph: {m.backend} "
                             "stages CUDA tensors through the host. Use NCCL (make_mesh's backend on a card), or "
                             "call the eager form (Trainer.train_step(..., mesh=...), Detector.infer)")


class CapturedCall:
    """`fn` over static buffers: one CUDA graph on the card, op by op on the
    CPU (see the module docstring). `captures` counts the graphs captured;
    on the card `collectives[i]` is the capture's record of what a call
    issues over `meshes[i]`, by kind (op by op, the groups count as eager
    calls do)."""

    def __init__(self, fn: Callable, device, *, preserve: Iterable[torch.Tensor] = (), meshes: Iterable = ()):
        self.meshes = list({id(m): m for m in meshes}.values())
        refuse_host_staged(self.meshes)
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:  # so that a tensor's device compares equal
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.preserve = list(preserve)
        self.captures = 0
        self.collectives: list[collections.Counter] = []
        self.graph: torch.cuda.CUDAGraph | None = None
        self._spec = None
        self._inputs: list[torch.Tensor] = []
        self._staging: dict[int, torch.Tensor] = {}
        self._copied = None
        self._outputs = None
        self._flat_outputs: list[torch.Tensor] = []
        self._marks: list = []       # the graph's stage marks (timing.mark), (name, event)
        self._unread = False         # the last replay was recorded and its marks not read yet

    def __call__(self, *args):
        call = timing.call_id()      # None while the recorder is off
        with timing.span("call.stage", call):
            self._fill(args)
        if self.device.type != "cuda":
            with timing.span("call.launch", call):
                return self._run_op_by_op(call)
        if self.graph is None:
            self._capture()
        if self._unread:
            timing.settle(self._marks)
            self._unread = False
        with timing.span("call.launch", call):
            self.graph.replay()
        if call is not None:
            timing.count("call.replays", 1)
            if self._marks:
                timing.replayed(call, self._marks)
                self._unread = True
        for mesh, issued in zip(self.meshes, self.collectives):
            mesh.collectives.update(issued)
        return self._outputs

    def capture(self, *args) -> None:
        """Fill the static inputs from `args` and capture, without a replay
        (to pay the capture before the first real call)."""
        self._fill(args)
        if self.device.type == "cuda" and self.graph is None:
            self._capture()

    # -- inputs --------------------------------------------------------------
    def _fill(self, args) -> None:
        leaves, spec = pytree.tree_flatten(args)
        leaves = [torch.as_tensor(x) for x in leaves]
        if self._spec is None:
            self._spec = spec
            self._inputs = [torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in leaves]
        elif spec != self._spec or any(x.shape != s.shape for x, s in zip(leaves, self._inputs)):
            raise ValueError("a captured call takes the structure and shapes of its first call: "
                             f"{[tuple(s.shape) for s in self._inputs]}, got {[tuple(x.shape) for x in leaves]}")
        host = [(i, x) for i, x in enumerate(leaves) if x.device != self.device]
        for i, x in enumerate(leaves):
            if x.device == self.device:
                self._inputs[i].copy_(x)
        if not host:
            return
        if self._copied is None:
            self._copied = torch.cuda.Event()
        self._copied.synchronize()  # the previous call's copies have left the staging buffers
        for i, x in host:
            staging = self._staging.get(i)
            if staging is None:
                staging = self._staging[i] = torch.empty(x.shape, dtype=self._inputs[i].dtype).pin_memory()
            staging.copy_(x)
            self._inputs[i].copy_(staging, non_blocking=True)
        self._copied.record()

    # -- the two ways to run ---------------------------------------------------
    def _run_op_by_op(self, call: int | None):
        args = pytree.tree_unflatten(self._inputs, self._spec)
        if call is None:
            out = self.fn(*args)
        else:
            with timing.marking(cuda=False) as marks:
                out = self.fn(*args)
            timing.count("call.replays", 1)
            timing.ran(call, marks)
        leaves, spec = pytree.tree_flatten(out)
        if self._outputs is None:
            self._flat_outputs = [t.detach().clone() for t in leaves]
            self._outputs = pytree.tree_unflatten(self._flat_outputs, spec)
        else:
            for buf, t in zip(self._flat_outputs, leaves):
                buf.copy_(t)
        return self._outputs

    def _capture(self) -> None:
        args = pytree.tree_unflatten(self._inputs, self._spec)
        saved = [t.detach().clone() for t in self.preserve]
        counted = [collections.Counter(m.collectives) for m in self.meshes]
        current = torch.cuda.current_stream(self.device)
        side = _warmup_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.fn(*args)
        current.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(self.preserve, saved):
                t.copy_(s)
        del saved
        graph = torch.cuda.CUDAGraph()
        # captured on the warm-up stream, whose cuBLAS workspace the warm-up
        # made outside the graph's pool: one made inside it would keep the
        # pool's memory after the graph is gone
        at_capture = [collections.Counter(m.collectives) for m in self.meshes]
        with timing.marking(cuda=True) as marks, torch.cuda.device(self.device), \
                torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            self._outputs = self.fn(*args)
        self._marks = marks
        self.collectives = [m.collectives - before for m, before in zip(self.meshes, at_capture)]
        for m, before in zip(self.meshes, counted):
            m.collectives.clear()
            m.collectives.update(before)
        self.graph = graph
        self.captures += 1
