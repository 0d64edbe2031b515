"""The device trace's arithmetic on made-up events: a union of intervals,
not a sum of durations, counted from the span's marker kernel on."""

from types import SimpleNamespace as NS

from torch.autograd import DeviceType

from perfbench.harness import trace


def ev(name, start, end, device=True):
    return NS(name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
              time_range=NS(start=start, end=end))


def test_union_and_gaps():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]


def test_reduce_counts_from_the_marker_and_unions_streams():
    events = [
        ev("before", 0, 5),                    # launched before the span: left out
        ev("at::cuda::spin_kernel(long)", 6, 7),
        ev("conv", 10, 20), ev("Memcpy HtoD (Pinned -> Device)", 15, 25),  # overlap: once
        ev("bn", 30, 35), ev("conv", 40, 50),
        ev("Optimizer.step", 10, 50), ev("Optimizer.step", 9, 51, device=False),  # annotation
    ]
    span = trace.reduce_events(events)
    assert span["window_us"] == 40 and span["busy_us"] == 30
    assert span["kernels"] == 3 and span["device_n"]["conv"] == 2
    assert span["device_us"]["conv"] == 20


def test_naming_span_names_gaps_by_innermost_host_operation():
    events = [ev("at::cuda::spin_kernel(long)", 0, 1), ev("k", 2, 4), ev("k", 10, 12),
              ev("aten::linalg_eigh", 3, 11, device=False),
              ev("cudaStreamSynchronize", 5, 11, device=False),
              ev("predict", 0, 20, device=False)]
    span = trace.reduce_events(events, naming=True)
    assert span == {"gap_us": {"aten::linalg_eigh": 6}}


def test_without_a_marker_nothing_is_read():
    assert trace.reduce_events([ev("k", 0, 1)]) == {}
    assert trace.Tracer(False, {}).totals()["window_s"] == 0


def test_breakdown_keeps_ten_of_each():
    t = {"device_s": {f"k{i}": float(i) for i in range(12)}, "gap_s": {"a": 1.0}}
    b = trace.breakdown(t)
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k11", 11.0]
    assert b["idle_gaps"] == [["a", 1.0]]
