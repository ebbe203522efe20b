"""One function of fixed shapes, captured once as a CUDA graph and replayed:
the port's counterpart of `jax.jit` for the compiled entry points
(`Detector.infer_jit`, `Trainer.train_step_jit`, the exported runtime).

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
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch.utils import _pytree as pytree

WARMUP_CALLS = 2
_WARMUP_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a device for every warm-up and capture: each new
    stream costs a cuBLAS workspace (32 MiB on the H100) that torch keeps
    for the life of the process, and pins the cached segment it lies in."""
    if device not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[device]


class CapturedCall:
    """`fn` over static buffers: one CUDA graph on the card, op by op on the
    CPU (see the module docstring). `captures` counts the graphs captured."""

    def __init__(self, fn: Callable, device, *, preserve: Iterable[torch.Tensor] = ()):
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:  # so that a tensor's device compares equal
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.preserve = list(preserve)
        self.captures = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self._spec = None
        self._inputs: list[torch.Tensor] = []
        self._staging: dict[int, torch.Tensor] = {}
        self._copied = None
        self._outputs = None
        self._flat_outputs: list[torch.Tensor] = []

    def __call__(self, *args):
        self._fill(args)
        if self.device.type != "cuda":
            return self._run_op_by_op()
        if self.graph is None:
            self._capture()
        self.graph.replay()
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
    def _run_op_by_op(self):
        out = self.fn(*pytree.tree_unflatten(self._inputs, self._spec))
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
        with torch.cuda.device(self.device), torch.cuda.graph(graph, stream=side,
                                                               capture_error_mode="thread_local"):
            self._outputs = self.fn(*args)
        self.graph = graph
        self.captures += 1
