"""Wall-clock stage accounting for the pipelined inference sweep (a copy of
mapfree_tpu/utils/timing.py). ``StageTimes`` accumulates per-stage busy time
and call counts; stages overlap, so the times do not sum to elapsed time.

The program opens each stage through :func:`stage`, which also makes it a
span of the calling thread, whatever ``times`` keeps its duration. Each
thread holds a context: its active ``times`` (what :func:`span` opens a
stage on, for code that is handed no ``times``), the batch it works on, and
its stack of open spans, whose innermost is the parent of the next one.
Inside :func:`recording` every span that closes, on any thread, is kept.
While a ``torch.profiler`` records, each span also opens a
``record_function("mapfree::<name>", "<batch>")`` range, so that the
profiler's trace names the layer that launched each kernel."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch.autograd.profiler as _profiler

RANGE_PREFIX = "mapfree::"


class StageTimes:
    """Per-stage timer (float accumulation under the GIL)."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def add(self, name: str, seconds: float):
        self.seconds[name] += seconds
        self.calls[name] += 1

    def reset(self):
        """Zero the counters (after a warm-up window, so that the summary
        covers only the measured region)."""
        self.seconds.clear()
        self.calls.clear()

    def summary(self) -> dict:
        return {k: round(v, 4) for k, v in sorted(self.seconds.items())}

    def __repr__(self):
        parts = [f"{k}={self.seconds[k]:.3f}s/{self.calls[k]}" for k in sorted(self.seconds)]
        return "StageTimes(" + ", ".join(parts) + ")"


class _NullTimes:
    """No-op stand-in so call sites never branch on None."""

    @contextmanager
    def stage(self, name: str):
        yield

    def add(self, name: str, seconds: float):
        pass

    def summary(self) -> dict:
        return {}


NULL_TIMES = _NullTimes()


class Span:
    """One opened stage: its name, the batch its thread worked on, the name
    of the innermost span open on its thread when it opened (or None), its
    thread's ``threading.get_native_id()`` (not the id that a
    ``torch.profiler`` event's ``thread`` gives), and its start and end in
    ``time.perf_counter_ns()``."""

    __slots__ = ("name", "batch", "parent", "thread", "start_ns", "end_ns")

    def __init__(self, name, batch, parent, thread, start_ns):
        self.name, self.batch, self.parent = name, batch, parent
        self.thread, self.start_ns, self.end_ns = thread, start_ns, None

    def __repr__(self):
        return f"Span{tuple(getattr(self, k) for k in self.__slots__)!r}"


class _Context(threading.local):
    """The calling thread's active ``times``, batch id and open spans."""

    def __init__(self):
        self.times = NULL_TIMES
        self.batch = None
        self.stack = []
        self.thread = threading.get_native_id()


_context = _Context()
_kept = ()  # the lists of the open recordings (:func:`recording`)


@contextmanager
def opened(name: str):
    """Open span ``name`` on the calling thread; yields its :class:`Span`,
    whose end is set when the block exits. The span is the thread's
    innermost until then."""
    ctx = _context
    s = Span(name, ctx.batch, ctx.stack[-1].name if ctx.stack else None, ctx.thread,
             time.perf_counter_ns())
    ctx.stack.append(s)
    rf = None
    if _profiler._is_profiler_enabled:
        rf = _profiler.record_function(RANGE_PREFIX + name, str(s.batch))
        rf.__enter__()
    try:
        yield s
    finally:
        if rf is not None:
            rf.__exit__(None, None, None)
        ctx.stack.pop()
        s.end_ns = time.perf_counter_ns()
        for kept in _kept:
            kept.append(s)


@contextmanager
def stage(times, name: str):
    """Stage ``name`` of ``times``, opened as a span (:func:`opened`). The
    stages of :data:`NULL_TIMES` are spans only while a profiler records."""
    if times is NULL_TIMES and not _profiler._is_profiler_enabled:
        yield
        return
    with opened(name), times.stage(name):
        yield


def span(name: str):
    """A stage ``name`` of the calling thread's active ``times`` (see
    :func:`active`), :data:`NULL_TIMES` if none is."""
    return stage(_context.times, name)


@contextmanager
def recording():
    """Yields a list to which every span that closes inside the block, on
    any thread, is appended as it closes."""
    global _kept
    kept = []
    _kept = _kept + (kept,)
    try:
        yield kept
    finally:
        _kept = tuple(k for k in _kept if k is not kept)


@contextmanager
def active(times):
    """Make ``times`` the calling thread's active one inside the block."""
    ctx = _context
    prev, ctx.times = ctx.times, times
    try:
        yield
    finally:
        ctx.times = prev


def set_batch(batch):
    """Set the batch id of the calling thread's next spans; returns the
    previous one."""
    ctx = _context
    prev, ctx.batch = ctx.batch, batch
    return prev


def in_batch(batch, fn, *args):
    """``fn(*args)`` with the calling thread's batch id set to ``batch``
    (for a worker thread that takes up one batch's work)."""
    prev = set_batch(batch)
    try:
        return fn(*args)
    finally:
        set_batch(prev)
