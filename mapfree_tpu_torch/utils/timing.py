"""Wall-clock stage accounting for the pipelined inference sweep (a copy of
mapfree_tpu/utils/timing.py). ``StageTimes`` accumulates per-stage busy time
and call counts; stages overlap, so the times do not sum to elapsed time."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


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
