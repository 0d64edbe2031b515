"""The traced run's device trace: ``torch.profiler`` (CPU and CUDA
activities) on a schedule that records a few short spans spread over the
window, each reduced as it closes to intervals and counts, so that no
trace is kept or written.

Device time is the union of the intervals in which a kernel, a copy or a
fill ran, clipped to the recorded steps: overlapping work on several
streams counts once. An idle gap is named by the innermost host operation
running at its middle."""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import numpy as np

COPY_PREFIXES = ("Memcpy", "Memset")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, launched before a span's recorded steps
NAMED_GAPS = 64  # the longest gaps of a span, each named by its host operation


def union_length(intervals) -> float:
    """Total length covered by ``intervals`` [(start, end)]."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def reduce_events(events, naming: bool = False) -> dict:
    """One recorded span's events (``FunctionEvent``-like: ``name``,
    ``device_type``, ``time_range.start`` / ``.end`` in microseconds) to:
    ``window_us``, from the first device operation after the span's marker
    kernel to the last one's end (the span drained the device before the
    marker and after its last step, so these are exactly the work its steps
    launched); ``busy_us``, the union of those operations' intervals;
    ``kernels``, those that are not copies or fills; ``device_us`` and
    ``device_n`` by name. With ``naming`` (a span that also recorded the
    host's operations) only ``gap_us``: the :data:`NAMED_GAPS` longest idle
    gaps by the innermost host operation (other than a CUDA runtime call,
    where there is one) running at each one's middle, the rest together.
    Device-side copies of host annotations (a name the host also records)
    are ranges over other work, and left out."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type != DeviceType.CUDA]
    host_names = {e.name for e in host}
    device = sorted((e for e in events
                     if e.device_type == DeviceType.CUDA and e.name not in host_names),
                    key=lambda e: e.time_range.start)
    marks = [e.time_range.end for e in device if MARKER in e.name]
    if not marks:
        return {}
    device = [e for e in device if e.time_range.start >= max(marks) and MARKER not in e.name]
    if not device:
        return {}
    lo = device[0].time_range.start
    hi = max(e.time_range.end for e in device)
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    if naming:
        o_start = np.array([e.time_range.start for e in host], dtype=np.float64)
        o_end = np.array([e.time_range.end for e in host], dtype=np.float64)
        o_runtime = np.array([e.name.startswith("cuda") for e in host], dtype=bool)
        gap_us = defaultdict(float)
        idle = sorted(gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])
        for s, t in idle[:NAMED_GAPS]:
            mid = 0.5 * (s + t)
            around = np.nonzero((o_start <= mid) & (o_end >= mid))[0]
            if len(around) and not o_runtime[around].all():
                around = around[~o_runtime[around]]
            name = host[around[np.argmin(o_end[around] - o_start[around])]].name \
                if len(around) else "(host between operations)"
            gap_us[name] += t - s
        rest = sum(t - s for s, t in idle[NAMED_GAPS:])
        if rest:
            gap_us["(shorter gaps)"] += rest
        return {"gap_us": dict(gap_us)}
    device_us, device_n, kernels = defaultdict(float), defaultdict(int), 0
    for e in device:
        device_us[e.name] += e.time_range.end - e.time_range.start
        device_n[e.name] += 1
        if not e.name.startswith(COPY_PREFIXES):
            kernels += 1
    return {"window_us": hi - lo, "busy_us": union_length(intervals), "kernels": kernels,
            "device_us": dict(device_us), "device_n": dict(device_n)}


class Tracer:
    """The profiler of a traced run, or nothing (``enabled`` False). Call
    :meth:`start` when the window opens, :meth:`step` once per batch, and :meth:`stop` when the window closes.

    ``plan``: ``cycles`` spans, spread evenly over the window, each of
    ``warmup_steps`` steps (the profiler's start-up) and then
    ``active_steps`` recorded steps, CUDA activity only, which costs the
    host little; and, after them, one more span with the host's operations
    too, which costs the host much more and serves only to name the idle
    gaps. Before the recorded steps the device is drained and a marker
    kernel launched; after them the device is drained again. Each span is
    reduced (:func:`reduce_events`) as it closes; :attr:`spans` holds the
    results."""

    def __init__(self, enabled: bool, plan: dict):
        self.enabled, self.plan = enabled, plan
        self.spans, self.naming = [], []
        self.prof, self.starts = None, []
        self.traced_steps, self.traced_wall = 0, 0.0

    def start(self, seconds: float) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's start-up, paid here
            import torch

            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        n = int(self.plan["cycles"]) + 1
        t0 = self.t0 = time.perf_counter()
        self.starts = [t0 + seconds * (k + 0.5) / n for k in range(n)]
        self.phase, self.left = None, 0

    def _open(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.naming_span = not self.starts  # the last span names the gaps
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.naming_span else [])
        self.opened = time.perf_counter()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.phase, self.left = "warmup", int(self.plan["warmup_steps"])

    def _close(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        naming = self.naming_span
        events = self.prof.events()
        span = reduce_events(events, naming=naming)
        print(f"perfbench: traced span {len(self.spans) + len(self.naming) + 1} "
              f"({self.opened - self.t0:.2f}-{time.perf_counter() - self.t0:.2f} s): {len(events)} "
              f"events, {'named gaps' if naming else span.get('kernels', 'no')} kernels"
              f"{'' if span else ' (no marker or no device work: dropped)'}",
              file=sys.stderr, flush=True)
        if span:
            (self.naming if naming else self.spans).append(span)
            if not naming:
                span["steps"] = self.recorded
        self.prof, self.phase = None, None
        self.traced_wall += time.perf_counter() - self.opened

    def step(self) -> None:
        if not self.enabled or (self.prof is None and not self.starts):
            return
        import torch

        if self.prof is None:
            if time.perf_counter() >= self.starts[0]:
                self.starts.pop(0)
                self._open()
            return
        self.traced_steps += 1
        if self.phase == "warmup":
            self.left -= 1
            if self.left <= 0:
                torch.cuda.synchronize()
                torch.cuda._sleep(1000)  # the marker kernel
                self.phase, self.left, self.recorded = "record", int(self.plan["active_steps"]), 0
            return
        self.recorded += 1
        self.left -= 1
        if self.left <= 0:
            self._close()

    def stop(self) -> None:
        if self.prof is not None:
            if self.phase == "record" and self.recorded:
                self._close()
            else:
                self.prof.stop()
                self.prof = None
                self.traced_wall += time.perf_counter() - self.opened
                print(f"perfbench: traced span cut by the window's end "
                      f"({self.opened - self.t0:.2f} s)", file=sys.stderr, flush=True)
        self.starts = []

    def totals(self) -> dict:
        """The recorded spans summed: ``window_s``, ``busy_s``, ``steps``,
        ``kernels``, ``device_s`` and ``device_n`` by name, and the naming
        span's ``gap_s`` by host operation; ``traced_steps`` and
        ``traced_wall_s``, the steps and the host's seconds that the
        profiler was open for (its own cost included)."""
        out = {"window_s": 0.0, "busy_s": 0.0, "steps": 0, "kernels": 0,
               "traced_steps": self.traced_steps, "traced_wall_s": self.traced_wall,
               "device_s": defaultdict(float), "device_n": defaultdict(int),
               "gap_s": defaultdict(float)}
        for s in self.spans:
            out["window_s"] += 1e-6 * s["window_us"]
            out["busy_s"] += 1e-6 * s["busy_us"]
            out["steps"] += s["steps"]
            out["kernels"] += s["kernels"]
            for k, v in s["device_us"].items():
                out["device_s"][k] += 1e-6 * v
            for k, v in s["device_n"].items():
                out["device_n"][k] += v
        for s in self.naming:
            for k, v in s["gap_us"].items():
                out["gap_s"][k] += 1e-6 * v
        for k in ("device_s", "device_n", "gap_s"):
            out[k] = dict(out[k])
        return out


def breakdown(totals: dict, n: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the longest idle time by host operation, [name, seconds]."""
    def top(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
    return {"device_ops": top(totals["device_s"]), "idle_gaps": top(totals["gap_s"])}
