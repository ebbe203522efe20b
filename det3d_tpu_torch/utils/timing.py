"""Spans, counters and stage marks on the port's frame path, and the
profiler around them.

The recorder is on exactly while a `torch.profiler` profile runs on the
calling thread (`trace` below, or any other profiler over the block):
`recording()` reads the profiler's own flag, so nothing else turns it on.
While it is on:

- `span(name)` records a host span: its name, its start and end on
  `time.perf_counter_ns`, the span open on this thread when it began (its
  parent), and a call id that every span of one frame or batch shares (a
  root span takes a new one unless it is given one). It also opens
  `torch.profiler.record_function("det3d.<name>")`, so the span sits in
  the profiler's trace on the clock of the card's kernels and copies, and
  each idle gap of the card can be put down to the span the host was in.
- `count(name, n)` adds `n` to a counter, stamped with the time.
- Stage marks: `mark(name)` inside a function that a
  `utils.graphs.CapturedCall` runs. While the call captures its CUDA
  graph, a mark is a timing event recorded on the capturing stream as an
  external event node, so every replay times its own stages; the marks are
  captured whether the recorder is on or not (a few event nodes a replay),
  and read only for replays made while it is on, at the call's next call
  where the card has passed the last mark by then (a replay it has not
  finished is dropped: reading it would wait for the card), or by
  `replays()` for the last one. While the call runs op by op on the CPU
  with the recorder on, a mark is a host stamp (CPU ops have finished when
  they return). Anywhere else, and while `torch.compile` or `torch.export`
  traces, a mark does nothing.

While the recorder is off, a span is one flag check and a shared no-op
context, a count one flag check: no allocation, no lock, no clock read.
Spans, counts and read replays are kept in memory, the last `KEEP` of
each, read by `spans()`, `counters()` and `replays()` (each from a time on
the `perf_counter_ns` clock, if given) and emptied by `reset()`; they are
module-level and outlive the detector that made them. The profiler's
trace is the file an operator opens.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, NamedTuple

import torch

KEEP = 1 << 16
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_spans: collections.deque = collections.deque(maxlen=KEEP)
_counts: collections.deque = collections.deque(maxlen=KEEP)
_replays: collections.deque = collections.deque(maxlen=KEEP)
_unread: dict[int, tuple] = {}   # id of a graph's marks -> (call, t_ns, marks) of its last replay while recording


class Span(NamedTuple):
    id: int
    name: str
    call: int
    parent: int | None   # the id of the span open on this thread when it began
    start_ns: int
    end_ns: int


class Count(NamedTuple):
    name: str
    n: int
    t_ns: int


class Replay(NamedTuple):
    """One run of a captured call's marked function: `marks` are (name, ms
    since the first mark), device time on the card, host time on the CPU."""
    call: int
    t_ns: int
    marks: tuple[tuple[str, float], ...]


def recording() -> bool:
    """True while a torch.profiler profile runs on this thread."""
    return torch.autograd._profiler_enabled()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def call_id() -> int | None:
    """While recording, the call id of the span open on this thread, or a
    new one where none is; None while the recorder is off."""
    if not torch.autograd._profiler_enabled():
        return None
    stack = _stack()
    return stack[-1].call if stack else next(_ids)


class _Span:
    __slots__ = ("name", "call", "id", "parent", "start", "_range")

    def __init__(self, name: str, call: int | None):
        self.name, self.call = name, call

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        if self.call is None:
            self.call = next(_ids) if parent is None else parent.call
        stack.append(self)
        self._range = torch.profiler.record_function(f"det3d.{self.name}")
        self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _stack().pop()
        _spans.append(Span(self.id, self.name, self.call, self.parent, self.start, end))


def span(name: str, call: int | None = None):
    """A context that records the block as span `name` while recording
    (see the module docstring); `call`: the call id, where the caller
    already holds one."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name, call)


def count(name: str, n: int) -> None:
    """Add `n` to counter `name` while recording."""
    if torch.autograd._profiler_enabled():
        _counts.append(Count(name, int(n), time.perf_counter_ns()))


# -- stage marks ----------------------------------------------------------
def mark(name: str) -> None:
    """The end of stage `name` (or the start, for the first mark) of the
    function that a captured call runs; see the module docstring."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return
    slot = getattr(_local, "marks", None)
    if slot is None:
        return
    marks, cuda = slot
    if cuda:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        marks.append((name, event))
    else:
        marks.append((name, time.perf_counter_ns()))


@contextlib.contextmanager
def marking(cuda: bool):
    """Route this thread's marks into a new list, yielded: CUDA events
    (`cuda`, around a graph's capture) or host stamps (around a run op by
    op while recording)."""
    marks: list = []
    before = getattr(_local, "marks", None)
    _local.marks = (marks, cuda)
    try:
        yield marks
    finally:
        _local.marks = before


def _read(call: int, t_ns: int, marks: list) -> None:
    first = marks[0][1]
    if isinstance(first, int):
        ms = tuple((name, (t - first) / 1e6) for name, t in marks)
    else:
        ms = tuple((name, first.elapsed_time(e)) for name, e in marks)
    _replays.append(Replay(call, t_ns, ms))


def ran(call: int, marks: list) -> None:
    """A run op by op, recording, left the host stamps `marks`."""
    if marks:
        _read(call, time.perf_counter_ns(), marks)


def replayed(call: int, marks: list) -> None:
    """A replay of the graph that holds the events `marks` was launched
    while recording: its times are read at the graph's next call
    (`settle`) or by `replays()`."""
    _unread[id(marks)] = (call, time.perf_counter_ns(), marks)


def settle(marks: list) -> None:
    """Before the graph holding `marks` replays again (which records them
    anew): read its last recorded replay if the card has passed the last
    mark, else drop it."""
    item = _unread.pop(id(marks), None)
    if item is not None and item[2][-1][1].query():
        _read(*item)


# -- reading --------------------------------------------------------------
def spans(since_ns: int = 0) -> list[Span]:
    """The spans kept that started at `since_ns` or later."""
    return [s for s in list(_spans) if s.start_ns >= since_ns]


def counters(since_ns: int = 0) -> dict[str, int]:
    """Each counter's sum over the counts kept from `since_ns` on."""
    out: dict[str, int] = {}
    for c in list(_counts):
        if c.t_ns >= since_ns:
            out[c.name] = out.get(c.name, 0) + c.n
    return out


def replays(since_ns: int = 0) -> list[Replay]:
    """The replays read, from `since_ns` on; the last replay of each graph
    is read first, waiting for the card to pass its last mark."""
    for key in list(_unread):
        item = _unread.pop(key, None)
        if item is not None:
            item[2][-1][1].synchronize()
            _read(*item)
    return [r for r in list(_replays) if r.t_ns >= since_ns]


def reset() -> None:
    """Forget every span, count and replay kept or waiting to be read."""
    _spans.clear()
    _counts.clear()
    _replays.clear()
    _unread.clear()


# -- the card and the profiler -------------------------------------------
def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree: Any) -> Any:
    """Wait for the card to finish `tree`'s CUDA tensors (any nesting of
    dicts, lists and tuples, NamedTuples included); returns `tree`."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)
    return tree


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """torch.profiler over the block (host, and the card where there is
    one), which turns the recorder on for the block; writes `trace.json`
    (chrome://tracing, Perfetto) into `log_dir`, a fresh temporary
    directory by default. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir or tempfile.mkdtemp(prefix="det3d-torch-trace-"))
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
