"""The program's spans laid over a device trace (harness/spans.py), on
made-up events and span records with known clocks: the offsets come back,
each operation goes to the layer that launched it and the layers sum to the
busy time, idle time falls in the calling thread's span, blocking calls are
summed inside ``dispatch``, with the enqueues that found the device's queue
full; ``reduce_events`` reads as before with the program's ``mapfree::``
ranges in the trace; and the network stages' host time is read per batch."""

from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from perfbench.harness import spans, trace
from perfbench.harness.cell import load_reader

OFFSET = 1000.0  # the runtime's clock less the spans' (us)
GAP = 150.0  # the runtime's clock less the host operations' (us)
MAIN, WORKER = 11, 12  # the spans' native thread ids
P_MAIN, P_WORKER = 1, 2  # the profiler's


def ev(name, start, end, device=False, id=0, thread=P_MAIN):
    return NS(name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU, id=id,
              thread=thread, time_range=NS(start=start, end=end))


def rec(name, batch, parent, start_us, end_us, thread=MAIN):
    return (name, batch, parent, thread, int(start_us * 1000), int(end_us * 1000))


# one batch on the spans' clock (us): the network's spans inside dispatch
RECORDS = [
    rec("h2d", 1, None, 140, 160, thread=WORKER),
    rec("to_float", 0, "dispatch", 102, 108), rec("encoder", 0, "dispatch", 110, 180),
    rec("aggregator", 0, "dispatch", 180, 220), rec("head", 0, "dispatch", 220, 280),
    rec("dispatch", 0, None, 100, 300), rec("d2h_wait", 0, None, 300, 340),
    rec("pose_extract", 0, None, 340, 350),
]
STAMP_NS = 50_000  # the host's stamp before the marker's launch


def launched(name, call_at, start, end, id, thread=P_MAIN, call="cudaLaunchKernel"):
    """A device operation over [start, end] and the runtime call (``call_at``
    on the spans' clock) that launched it."""
    return [ev(call, call_at + OFFSET, call_at + OFFSET + 2, id=id, thread=thread),
            ev(name, start, end, device=True, id=id)]


def events(with_ranges=True, device_ranges=False):
    out = launched("at::cuda::spin_kernel(long)", 50, 1052, 1054, id=1)
    out += launched("Memcpy HtoD (Pinned -> Device)", 150, 1100, 1130, id=2, thread=P_WORKER,
                    call="cudaMemcpyAsync")
    out += launched("void conv_kernel", 120, 1125, 1160, id=3)
    out += launched("void conv_kernel", 170, 1160, 1200, id=4)
    out += launched("void correlation_fwd_wgmma_kernel", 190, 1200, 1230, id=5)
    out += launched("void svd3_kernel", 230, 1240, 1250, id=6)
    out += launched("void cat_kernel", 290, 1290, 1295, id=7)
    out += launched("Memcpy DtoH (Device -> Pinned)", 295, 1345, 1346, id=8,
                    call="cudaMemcpyAsync")
    out += [ev("cudaStreamSynchronize", 260 + OFFSET, 275 + OFFSET, id=9),  # in dispatch/head
            ev("cudaEventSynchronize", 305 + OFFSET, 330 + OFFSET, id=10)]  # in d2h_wait
    if with_ranges:  # the calling thread's ranges on the host operations' clock
        for name, _, _, thread, a, b in RECORDS:
            if thread == MAIN:
                shift = OFFSET - GAP + (1 if name == "dispatch" else -1)  # jitter
                out.append(ev(spans.RANGE_PREFIX + name, a / 1e3 + shift, b / 1e3 + shift))
                if device_ranges:
                    out.append(ev(spans.RANGE_PREFIX + name, a / 1e3 + OFFSET,
                                  b / 1e3 + OFFSET, device=True))
    return out


def test_clocks_come_back():
    r = spans.reduce_span(events(), RECORDS, STAMP_NS, naming=True)
    assert r["offset_us"] == pytest.approx(OFFSET)
    assert r["range_offset_us"] == pytest.approx(OFFSET - GAP, abs=1)
    assert r["matched"] == 7
    assert spans.reduce_span(events(), RECORDS, STAMP_NS)["offset_us"] == pytest.approx(OFFSET)


def test_each_operation_goes_to_the_layer_that_launched_it():
    r = spans.reduce_span(events(), RECORDS, STAMP_NS, naming=True)
    # the copy from the worker (no ranges there) runs beside the first
    # convolution: 25 us alone, then behind the kernel; the D2H copy was
    # launched inside dispatch
    assert r["layer_us"] == pytest.approx({
        spans.UNATTRIBUTED: 25, "encoder": 75, "aggregator": 30, "head": 10, "dispatch": 6})
    assert sum(r["layer_us"].values()) == pytest.approx(r["busy_us"]) == 146


def test_blocking_calls_are_summed_inside_dispatch():
    r = spans.reduce_span(events(), RECORDS, STAMP_NS, naming=True)
    assert r["blocked_us"] == pytest.approx({"dispatch/head": 15, "d2h_wait": 25})
    assert r["dispatches"] == 1 and r["dispatch_blocked_us"] == pytest.approx(15)
    assert r["dispatch_queued_us"] == 0 and r["queued_n"] == 0  # no queue near full
    assert r["first_block"] == {"dispatch/head": 1}
    # every runtime call the calling thread made inside dispatch, by name
    assert r["runtime_us"] == pytest.approx({"cudaLaunchKernel": 10, "cudaMemcpyAsync": 2,
                                             "cudaStreamSynchronize": 15})
    assert r["runtime_n"] == {"cudaLaunchKernel": 5, "cudaMemcpyAsync": 1,
                              "cudaStreamSynchronize": 1}


def test_enqueues_on_a_full_queue_wait_for_the_device(monkeypatch):
    # with a queue of one slot, the launches at 190 (aggregator), 230 (head)
    # and the copy at 295 (dispatch) each find one operation unfinished
    monkeypatch.setattr(spans, "QUEUE_FULL", 1)
    r = spans.reduce_span(events(), RECORDS, STAMP_NS, naming=True)
    assert r["blocked_us"] == pytest.approx({"dispatch/aggregator": 2, "dispatch/head": 17,
                                             "dispatch": 2, "d2h_wait": 25})
    assert r["dispatch_blocked_us"] == pytest.approx(21)
    assert r["dispatch_queued_us"] == pytest.approx(6) and r["queued_n"] == 3
    assert r["first_block"] == {"dispatch/aggregator": 1}
    assert spans.summarise([], [dict(r, steps=1)])["dispatch_blocked_ms"] == pytest.approx(0.021)


def test_idle_falls_in_the_calling_threads_span():
    r = spans.reduce_span(events(with_ranges=False), RECORDS, STAMP_NS)
    # device idle at [1230, 1240] and [1250, 1290] (head until 1280, then
    # dispatch), [1295, 1345] (dispatch until 1300, d2h_wait until 1340, then
    # pose_extract)
    assert r["idle_us"] == pytest.approx({"dispatch/head": 40, "dispatch": 15, "d2h_wait": 40,
                                          "pose_extract": 5})
    out = spans.summarise([dict(r, steps=2)], [])
    assert out["dispatch_idle_ms"] == pytest.approx(1e-3 * 55 / 2)


def test_summarise_per_batch_and_dispatch():
    naming = dict(spans.reduce_span(events(), RECORDS, STAMP_NS, naming=True), steps=1)
    out = spans.summarise([], [naming])
    assert out["device_ms"]["encoder"] == pytest.approx(0.075)
    assert out["busy_ms"] == pytest.approx(0.146)
    assert out["dispatch_blocked_ms"] == pytest.approx(0.015)
    assert "dispatch_idle_ms" not in out


def test_nothing_without_the_programs_spans():
    assert spans.reduce_span(events(), [], STAMP_NS, naming=True) == {}
    assert spans.reduce_span(events(), RECORDS, None) == {}
    assert spans.reduce_span(events(with_ranges=False), RECORDS, STAMP_NS, naming=True) == {}
    assert spans.summarise([], []) == {}
    assert spans.per_batch_ms(None, "encoder") is None


def test_per_batch_ms_is_the_median_over_batches():
    records = [rec("encoder", b, "dispatch", 0, ms * 1000) for b, ms in enumerate((1, 3, 2))]
    records.append(rec("encoder", 1, "dispatch", 0, 1000))  # a second replica's
    assert spans.per_batch_ms(records, "encoder") == pytest.approx(2.0)


def test_blocking_names():
    assert all(map(spans.blocks, ["cudaStreamSynchronize", "cudaDeviceSynchronize",
                                  "cudaEventSynchronize", "cudaMemcpy", "cuMemcpyDtoH_v2",
                                  "cuCtxSynchronize"]))
    assert not any(map(spans.blocks, ["cudaMemcpyAsync", "cudaLaunchKernel",
                                      "aten::synchronize", "cudaStreamWaitEvent"]))


@pytest.mark.parametrize("naming", [False, True])
def test_reduce_events_reads_as_before_beside_the_ranges(naming):
    # the benchmark's own reader beside the program's ranges: in a CUDA-only
    # span the card records no ranges; in the naming span the host's ranges
    # hide their device twins, and name an idle gap only where no other host
    # operation runs (a range over the whole window names every one)
    plain = trace.reduce_events(events(with_ranges=False), naming=naming)
    ranged = trace.reduce_events(events(device_ranges=True), naming=naming)
    cuda_only = [e for e in events(with_ranges=False)
                 if e.device_type == DeviceType.CUDA or e.name.startswith("cu")]
    if naming:
        assert plain == ranged == {"gap_us": {"(host between operations)": 10,
                                              "cudaStreamSynchronize": 40,
                                              "cudaEventSynchronize": 50}}
        over = ev(spans.RANGE_PREFIX + "sweep", 1000, 1400)
        assert trace.reduce_events(events(device_ranges=True) + [over], naming=True) == {
            "gap_us": {spans.RANGE_PREFIX + "sweep": 100}}
        return
    expected = {"window_us": 246, "busy_us": 146, "kernels": 5,
                "device_us": {"Memcpy HtoD (Pinned -> Device)": 30, "void conv_kernel": 75,
                              "void correlation_fwd_wgmma_kernel": 30, "void svd3_kernel": 10,
                              "void cat_kernel": 5, "Memcpy DtoH (Device -> Pinned)": 1},
                "device_n": {"Memcpy HtoD (Pinned -> Device)": 1, "void conv_kernel": 2,
                             "void correlation_fwd_wgmma_kernel": 1, "void svd3_kernel": 1,
                             "void cat_kernel": 1, "Memcpy DtoH (Device -> Pinned)": 1}}
    assert plain == ranged == trace.reduce_events(cuda_only) == expected
    # the layers' reading takes the same device operations
    device, mark = spans.device_after_marker(events(device_ranges=True))
    assert mark.name == "at::cuda::spin_kernel(long)"
    assert sum(e.time_range.end - e.time_range.start for e in device) == sum(
        expected["device_us"].values())


@pytest.mark.parametrize("name", ["encoder", "aggregator", "head"])
def test_the_network_stages_host_time_is_read_per_batch(name):
    read = load_reader(f"{name}_dispatch_ms.host")
    assert read({"stages": {name: [0.004, 0.001, 0.003], "dispatch": [0.03] * 3}}) == \
        pytest.approx(3.0)
    # a tree whose program opens no network stages: the metric is left out
    assert read({"stages": {"dispatch": [0.03]}}) is None and read({}) is None


def test_a_traced_span_reads_the_records_closed_while_it_was_open():
    kept = [NS(name=n, batch=0, parent=None, thread=MAIN, start_ns=a, end_ns=b)
            for n, a, b in (("load_wait", 0, 10), ("dispatch", 5, 20), ("d2h_wait", 12, 30))]
    assert spans.closed_since(kept, 20) == [("dispatch", 0, None, MAIN, 5, 20),
                                            ("d2h_wait", 0, None, MAIN, 12, 30)]
    assert spans.closed_since(kept, 31) == [] and spans.closed_since(kept, None) == []
    assert spans.closed_since(None, 0) == [] and len(spans.closed_since(kept, 0)) == 3
