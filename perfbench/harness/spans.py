"""The program's own spans in a traced sweep, laid over the device trace.

The program (``mapfree_tpu_torch/utils/timing.py``) opens a span at each
stage of the sweep and around each layer of the network, each with its
batch, its parent, its thread and its start and end in
``time.perf_counter_ns()``, whatever ``times`` it is handed, and keeps every
span that closes inside ``timing.recording()``. While a profiler records,
each span is also a ``record_function`` range named ``mapfree::<name>``.
``perfbench/layers.py`` runs a cell's traced sweep with the spans kept and
reads each traced span's events here; the benchmark's own traced run reads
none of this.

Three clocks meet here: the spans' (``perf_counter``), the profiler's for
the host operations and those ranges, and CUPTI's for the device operations
and the CUDA runtime calls. Each traced span maps the spans onto CUPTI's by
its marker: the runtime call that launched the marker kernel (the kernel's
start where that call is missing) less the host's stamp taken just before
the launch. In the span that records the host's operations too, matching
each ``mapfree::`` range to the span of the same name nearest it gives the
profiler's host clock against the spans'; the two offsets' difference
carries a runtime call onto the ranges' clock.

- In each CUDA-only span: the device's idle time, by the calling thread's
  innermost open span at each idle instant (the path of names from the
  outermost, as ``dispatch/encoder``).
- In the naming span: each kernel, through the runtime call that launched it
  (the profiler gives both one correlation id), goes to the innermost
  ``mapfree::`` range open on that call's thread, and its device interval to
  that range's layer; each runtime call that waits for the device (a
  synchronise, a synchronous copy, or an enqueue that found the device's
  queue full), to its innermost range, with the first such range in each
  ``dispatch``; and every runtime call inside ``dispatch``, by name.

Where the program opens no spans (a tree before them), nothing is read."""

from __future__ import annotations

import bisect
import statistics
import sys
from collections import Counter, defaultdict

from perfbench.harness import trace
from perfbench.harness.trace import COPY_PREFIXES, MARKER

RANGE_PREFIX = "mapfree::"  # the program's spans' profiler ranges
BETWEEN = "(between spans)"
UNATTRIBUTED = "(unattributed)"
CALLER = "dispatch"  # the stage that only the sweep's calling thread opens
# device operations pending (enqueued, unfinished) at which an enqueue waits
# for a slot: the H100's queue holds about 1,024 (in fusion-sweep every
# launch call over 50 us found 1,022-1,023 pending)
QUEUE_FULL = 1000


def record_of(span) -> tuple:
    """(name, batch, parent, thread, start_ns, end_ns) of a program span."""
    return (span.name, span.batch, span.parent, span.thread, span.start_ns, span.end_ns)


def closed_since(spans, t_ns) -> list:
    """The records (:func:`record_of`) of the program spans in ``spans``
    (kept in the order they closed) that closed at ``t_ns`` (a traced
    span's marker) or later: a slice from the end, so that a traced span
    reads only its own."""
    if not spans or t_ns is None:
        return []
    i = len(spans)
    while i and spans[i - 1].end_ns >= t_ns:
        i -= 1
    return [record_of(r) for r in spans[i:]]


def device_after_marker(events) -> tuple:
    """(the device operations that one traced span's steps launched, sorted
    by start, as :func:`trace.reduce_events` takes them: after the last
    marker kernel, without it and without device-side copies of host
    annotations; and without the program's ``mapfree::`` ranges, which on
    the card appear on the device only beside their host twins; the last
    marker kernel), or ``([], None)`` without a marker."""
    from torch.autograd import DeviceType

    host_names = {e.name for e in events if e.device_type != DeviceType.CUDA}
    device = sorted((e for e in events
                     if e.device_type == DeviceType.CUDA and e.name not in host_names
                     and not e.name.startswith(RANGE_PREFIX)),
                    key=lambda e: e.time_range.start)
    marks = [e for e in device if MARKER in e.name]
    if not marks:
        return [], None
    mark = max(marks, key=lambda e: e.time_range.end)
    return [e for e in device
            if e.time_range.start >= mark.time_range.end and MARKER not in e.name], mark


def per_batch_ms(records, name: str):
    """The median over batches of the host's time in the spans ``name``
    of each batch (summed within one), in ms; None without such spans."""
    per = defaultdict(int)
    for r in records or ():
        if r[0] == name and r[1] is not None and r[5] is not None:
            per[r[1]] += r[5] - r[4]
    return 1e-6 * statistics.median(per.values()) if per else None


def blocks(name: str) -> bool:
    """A CUDA API call (``cuda*`` or ``cu*``) that waits for the device: a
    stream, device, context or event synchronise, or a synchronous copy."""
    return name.startswith("cu") and (
        "Synchronize" in name
        or (name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name))


def queue_full(calls: dict, device) -> set:
    """The correlation ids of the runtime calls (``calls`` by id) that
    enqueued one of ``device``'s operations while :data:`QUEUE_FULL` or
    more of the others were enqueued and unfinished: such a call returns
    only when the device frees a slot. Both lie on the runtime's clock."""
    ops = [(calls[e.id].time_range.start, e.id, e.time_range.end)
           for e in device if e.id in calls]
    starts = sorted(s for s, _, _ in ops)
    ends = sorted(e for _, _, e in ops)
    return {i for s, i, _ in ops
            if bisect.bisect_left(starts, s) - bisect.bisect_left(ends, s) >= QUEUE_FULL}


def timeline(spans) -> list:
    """[(start, end, path)]: the stretches in which any of ``spans``
    [(start, end, name)], nested as one thread's are, is open, each with the
    names from the outermost open span to the innermost joined by ``/``."""
    points = sorted([(s, 1, n) for s, e, n in spans] + [(e, 0, n) for s, e, n in spans],
                    key=lambda p: (p[0], p[1]))  # at one instant, ends first
    out, stack, at = [], [], None
    for t, start, name in points:
        if stack and t > at:
            out.append((at, t, "/".join(stack)))
        if start:
            stack.append(name)
        else:  # the innermost of that name: the top, where the spans nest
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        at = t
    return out


def label_at(line: list, starts: list, t: float):
    """The path of the stretch of ``line`` (its ``starts``) holding ``t``,
    or None."""
    i = bisect.bisect_right(starts, t) - 1
    return line[i][2] if i >= 0 and t < line[i][1] else None


def split(gap: tuple, line: list, starts: list, out: dict) -> None:
    """Add the length of ``gap`` (start, end) to ``out`` by the path of
    ``line`` open over each part, :data:`BETWEEN` where none is."""
    s, t = gap
    i = max(0, bisect.bisect_right(starts, s) - 1)
    at = s
    while i < len(line) and line[i][0] < t:
        a, b = max(line[i][0], s), min(line[i][1], t)
        if b > a:
            if a > at:
                out[BETWEEN] += a - at
            out[line[i][2]] += b - a
            at = b
        i += 1
    if t > at:
        out[BETWEEN] += t - at


def partition(ops) -> dict:
    """Busy time by layer: ``ops`` [(start, end, layer, is a copy or
    fill)]; each instant in which any runs goes to one of them, a kernel
    before a copy or fill, then the latest started. Where kernels do not
    overlap each other, a layer's time is the union of its kernels'
    intervals and of its copies' outside every kernel, and the layers sum
    to the busy time."""
    # at one instant, ends first
    points = sorted([(s, 1, i) for i, (s, _, _, _) in enumerate(ops)]
                    + [(e, 0, i) for i, (_, e, _, _) in enumerate(ops)])
    out, active, at = defaultdict(float), set(), None
    for t, start, i in points:
        if active and t > at:
            j = max(active, key=lambda k: (not ops[k][3], ops[k][0]))
            out[ops[j][2]] += t - at
        (active.add if start else active.discard)(i)
        at = t
    return dict(out)


def caller_thread(records):
    """The native id of the thread that opens the sweep's ``dispatch``
    spans, or None."""
    threads = Counter(r[3] for r in records if r[0] == CALLER)
    return threads.most_common(1)[0][0] if threads else None


def reduce_span(events, records, stamp_ns, naming: bool = False) -> dict:
    """One traced span's events (``FunctionEvent``-like: ``name``,
    ``device_type``, ``id``, ``thread``, ``time_range`` in microseconds)
    against the program's span ``records`` (:func:`record_of`) and the
    host's stamp before the marker's launch (``perf_counter_ns``):
    ``offset_us``, the marker's (the runtime's clock less the spans'), and
    in a CUDA-only span ``idle_us`` (:func:`idle_by_span`), in the naming
    span what :func:`by_range` reads. Empty without records, a stamp or a
    marker."""
    from torch.autograd import DeviceType

    if stamp_ns is None or not records:
        return {}
    device, mark = device_after_marker(events)
    if mark is None or not device:
        return {}
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    calls = {e.id: e for e in host if e.name.startswith("cu")}  # runtime calls by correlation
    marker = calls.get(mark.id, mark)
    offset = marker.time_range.start - 1e-3 * stamp_ns
    if not naming:
        return {"offset_us": offset, "idle_us": idle_by_span(device, records, offset)}
    out = by_range(host, device, calls, records, offset, marker.time_range.start)
    return dict(out, offset_us=offset) if out else {}


def idle_by_span(device, records, offset: float) -> dict:
    """The device's idle time between ``device``'s first operation and its
    last, by the path of the calling thread's spans open at each idle
    instant, the spans laid on the device's clock by ``offset``."""
    caller = caller_thread(records)
    line = timeline([(1e-3 * r[4] + offset, 1e-3 * r[5] + offset, r[0])
                     for r in records if r[3] == caller and r[5] is not None])
    starts = [seg[0] for seg in line]
    idle = defaultdict(float)
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    for gap in trace.gaps(intervals, device[0].time_range.start,
                          max(e for _, e in intervals)):
        split(gap, line, starts, idle)
    return dict(idle)


def by_range(host, device, calls, records, offset: float, begin: float) -> dict:
    """The naming span read through its ``mapfree::`` ranges: the ranges'
    clock against the spans' (each range against the span of its name
    whose start lies nearest on the marker's ``offset``; the median of
    their midpoints' distances: ``range_offset_us`` over ``matched``); each
    device operation's layer, the innermost range open on the thread of the
    runtime call that launched it (``layer_us``, :func:`partition`, and
    ``busy_us``); the runtime calls from ``begin`` (the marker's launch,
    the runtime's clock) on: those that wait for the device (:func:`blocks`
    or :func:`queue_full`) by the innermost range (``blocked_us``), and
    within each of the ``dispatches`` the ones that wait
    (``dispatch_blocked_us``, of which ``dispatch_queued_us`` on a full
    queue in ``queued_n`` calls; ``first_block``, the range of each one's
    first) and all of them by name (``runtime_us``, ``runtime_n``). Empty
    without a matched range."""
    by_name = defaultdict(list)
    for r in records:
        if r[5] is not None:
            by_name[r[0]].append((1e-3 * r[4], 1e-3 * r[5]))
    for v in by_name.values():
        v.sort()
    ranges = [e for e in host if e.name.startswith(RANGE_PREFIX)]
    diffs = []
    for e in ranges:
        named = by_name.get(e.name[len(RANGE_PREFIX):])
        if not named:
            continue
        s0 = e.time_range.start - offset
        i = bisect.bisect_left(named, (s0,))
        near = min(named[max(0, i - 1):i + 1], key=lambda sp: abs(sp[0] - s0))
        diffs.append(0.5 * (e.time_range.start + e.time_range.end) - 0.5 * (near[0] + near[1]))
    if not diffs:
        return {}
    range_offset = statistics.median(diffs)
    shift = offset - range_offset  # the runtime's clock less the ranges'

    lines = defaultdict(list)
    for e in ranges:
        lines[e.thread].append((e.time_range.start, e.time_range.end,
                                e.name[len(RANGE_PREFIX):]))
    lines = {t: timeline(v) for t, v in lines.items()}
    starts = {t: [seg[0] for seg in line] for t, line in lines.items()}

    def path_of(call, at):
        t = call.thread
        return label_at(lines[t], starts[t], at) if t in lines else None

    ops = []
    for e in device:
        call = calls.get(e.id)
        path = path_of(call, call.time_range.start - shift) if call is not None else None
        ops.append((e.time_range.start, e.time_range.end,
                    path.rsplit("/", 1)[-1] if path else UNATTRIBUTED,
                    e.name.startswith(COPY_PREFIXES)))

    begin -= shift
    dispatches = sorted((e.time_range.start, e.time_range.end, e.thread) for e in ranges
                        if e.name == RANGE_PREFIX + CALLER and e.time_range.start >= begin)
    opened = [d[0] for d in dispatches]
    full = queue_full(calls, device)
    blocked, runtime = defaultdict(float), defaultdict(float)
    first, runtime_n = Counter(), Counter()
    in_dispatch, queued, queued_n, seen = 0.0, 0.0, 0, set()
    for call in sorted(calls.values(), key=lambda c: c.time_range.start):
        a, b = call.time_range.start - shift, call.time_range.end - shift
        if a < begin:
            continue
        k = bisect.bisect_right(opened, a) - 1
        inside = k >= 0 and a < dispatches[k][1] and dispatches[k][2] == call.thread
        if inside:
            runtime[call.name] += b - a
            runtime_n[call.name] += 1
        if not (blocks(call.name) or call.id in full):
            continue
        path = path_of(call, 0.5 * (a + b)) or BETWEEN
        blocked[path] += b - a
        if inside:
            in_dispatch += b - a
            if call.id in full:
                queued += b - a
                queued_n += 1
            if k not in seen:
                seen.add(k)
                first[path] += 1
    return {"range_offset_us": range_offset, "matched": len(diffs),
            "busy_us": trace.union_length((e.time_range.start, e.time_range.end)
                                          for e in device),
            "layer_us": partition(ops), "blocked_us": dict(blocked),
            "dispatches": len(dispatches), "dispatch_blocked_us": in_dispatch,
            "dispatch_queued_us": queued, "queued_n": queued_n,
            "first_block": dict(first), "runtime_us": dict(runtime),
            "runtime_n": dict(runtime_n)}


def summarise(cuda_only: list, naming: list) -> dict:
    """The traced spans' results (:func:`reduce_span`, each with the
    ``steps`` it recorded) summed, per batch, in ms, and printed on standard
    error: ``idle_ms`` by the calling thread's path and ``dispatch_idle_ms``
    (the CUDA-only spans); ``device_ms`` by layer, ``busy_ms``,
    ``blocked_ms`` by path, ``dispatch_blocked_ms``, ``first_block`` and
    ``dispatch_runtime_ms`` by call (the naming span)."""
    out = {}

    def per(total: dict, n: int) -> dict:
        return {k: 1e-3 * v / n for k, v in sorted(total.items(), key=lambda kv: -kv[1])}

    def add(results, key) -> dict:
        total = defaultdict(float)
        for r in results:
            for k, v in r[key].items():
                total[k] += v
        return total

    steps = sum(r["steps"] for r in cuda_only)
    if steps:
        out["idle_ms"] = per(add(cuda_only, "idle_us"), steps)
        out["dispatch_idle_ms"] = sum(v for k, v in out["idle_ms"].items()
                                      if k.split("/")[0] == CALLER)
        print(f"perfbench: device idle by the calling thread's span, ms per batch "
              f"({steps} batches): {_fmt(out['idle_ms'])}", file=sys.stderr)
    for r in naming:
        print(f"perfbench: clocks of the naming span: marker offset {r['offset_us']:.1f} us, "
              f"ranges' offset {r['range_offset_us']:.1f} us over {r['matched']} ranges "
              f"(differ by {r['offset_us'] - r['range_offset_us']:.1f} us)", file=sys.stderr)
    steps = sum(r["steps"] for r in naming)
    if steps:
        out["device_ms"] = per(add(naming, "layer_us"), steps)
        out["busy_ms"] = 1e-3 * sum(r["busy_us"] for r in naming) / steps
        print(f"perfbench: device time by the layer that launched it, ms per batch "
              f"({steps} batches): {_fmt(out['device_ms'])}; layers sum "
              f"{sum(out['device_ms'].values()):.4f} of busy {out['busy_ms']:.4f}",
              file=sys.stderr)
    n = sum(r["dispatches"] for r in naming)
    if n:
        out["blocked_ms"] = per(add(naming, "blocked_us"), n)
        out["dispatch_blocked_ms"] = 1e-3 * sum(r["dispatch_blocked_us"] for r in naming) / n
        queued = 1e-3 * sum(r["dispatch_queued_us"] for r in naming) / n
        out["first_block"] = dict(add(naming, "first_block"))
        out["dispatch_runtime_ms"] = per(add(naming, "runtime_us"), n)
        calls = add(naming, "runtime_n")
        print(f"perfbench: runtime calls that wait for the device by innermost span, ms per "
              f"dispatch ({n} dispatches): {_fmt(out['blocked_ms'])}; inside dispatch "
              f"{out['dispatch_blocked_ms']:.4f}, of which enqueues on a full queue {queued:.4f} "
              f"({sum(r['queued_n'] for r in naming) / n:.0f} calls); first waiting span in a "
              f"dispatch: {out['first_block']}; all runtime calls inside dispatch, ms per "
              f"dispatch (calls): " + ", ".join(
                  f"{k} {v:.4f} ({calls[k] / n:.0f})"
                  for k, v in list(out["dispatch_runtime_ms"].items())[:6]), file=sys.stderr)
    return out


def _fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in d.items())
