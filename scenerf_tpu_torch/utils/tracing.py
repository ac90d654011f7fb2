"""Spans and counters of the program's stages, on the host clock.

    from scenerf_tpu_torch.utils import tracing

    with tracing.span("encode"):
        ...
    tracing.count("h2d_bytes", nbytes)

    with tracing.recording():           # or inside any torch.profiler session
        trainer.train_step(batch)
    for s in tracing.snapshot():
        print(s.name, s.id, s.parent, s.root, (s.end - s.start) / 1e6, s.counts)

A span records its name, its id, its parent's id (0 for a root), its root
(the request it belongs to: the number its root span was opened with, such
as the trainer's step number for `train_step`, else the root span's own id),
its start and end in `time.perf_counter_ns()`, and the counters charged to
it. That is the clock on which `benchmark/harness/trace.py` aligns the
device trace, so every span can be placed on the trace. The stack of open
spans is per thread (autograd's backward runs on threads of its own): a span
opened where its thread has none open is a root. `count(name, n)` adds n to
a counter of the calling thread's innermost open span; with none open it is
not recorded.

Recording is on while a `torch.profiler` session is active (torch's own
flag, read at each span's entry) or inside `recording()`. Off, `span`
returns one shared empty context after one flag read and allocates nothing,
and `count` returns at once.

The buffer is a ring of the MAX_SPANS spans that ended last: a long profiled
run keeps its newest spans and drops its oldest, so the buffer never holds
more than MAX_SPANS records (a few hundred bytes each). `snapshot()` returns
them without clearing them; `recording()` clears them on entry.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch.autograd.profiler as torch_profiler

MAX_SPANS = 1 << 16


class Span(NamedTuple):
    name: str
    id: int
    parent: int
    root: int
    start: int
    end: int
    counts: Dict[str, int]


class _Recording:
    """Stands in for torch's profiler module inside `recording()`."""
    _is_profiler_enabled = True


# where `span` and `count` read whether to record: torch's profiler module,
# whose flag is set while a torch.profiler session is active, or _Recording
_flag_owner = torch_profiler
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []  # this thread's open spans, innermost last


_local = _Local()


class _Open:
    __slots__ = ("name", "request", "id", "parent", "root", "start", "counts")

    def __init__(self, name: str, request: Optional[int]):
        self.name, self.request = name, request

    def __enter__(self) -> "_Open":
        stack = _local.stack
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = 0, self.id if self.request is None else self.request
        self.counts = {}
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        _local.stack.pop()
        _spans.append(Span(self.name, self.id, self.parent, self.root, self.start, end,
                           self.counts))


def span(name: str, request: Optional[int] = None):
    """A context that records the block as a span named `name` while
    recording is on; `request` numbers the request where the span is a
    root."""
    if not _flag_owner._is_profiler_enabled:
        return _OFF
    return _Open(name, request)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` of the innermost open span."""
    if not _flag_owner._is_profiler_enabled:
        return
    stack = _local.stack
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def snapshot() -> Tuple[Span, ...]:
    """The recorded spans, oldest first; the buffer is left as it is."""
    return tuple(_spans)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record inside the block, with or without a profiler; clears the
    buffer on entry."""
    global _flag_owner
    _spans.clear()
    before, _flag_owner = _flag_owner, _Recording
    try:
        yield
    finally:
        _flag_owner = before
