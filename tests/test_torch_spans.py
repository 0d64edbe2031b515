"""The port's spans (mapfree_tpu_torch/utils/timing.py), on the CPU: a sweep
through ``predict`` inside ``timing.recording()`` gives each batch's six
pipeline stages one batch id (``h2d`` on a transfer worker's thread), the
network's spans ``dispatch`` as their parent, whatever ``times`` keeps the
sums; ``NULL_TIMES``' stages are no spans; ``mapfree::`` ranges reach a
``torch.profiler`` trace only while one records (the calling thread's: the
profiler records the thread that started it)."""

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mapfree_tpu_torch.config import cfg as default_cfg
from mapfree_tpu_torch.models.builder import build_model
from mapfree_tpu_torch.utils import timing
from mapfree_tpu_torch.utils.submission import predict

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

H, W, B, F = 64, 48, 4, 3
PIPELINE = ("load_wait", "h2d", "transfer_wait", "dispatch", "d2h_wait", "pose_extract")
NETWORK = {"Regression": ("to_float", "encoder", "aggregator", "head"),
           "RegressionMultiFrameFusion": ("to_float", "encoder", "aggregator", "head", "fuse")}
TINY = {
    "ENCODER.TYPE": "ResUNet", "ENCODER.BLOCK_TYPE": 1,
    "ENCODER.NUM_BLOCKS": "1-1-1", "ENCODER.NUM_OUT_LAYERS": 8,
    "AGGREGATOR.TYPE": "CorrelationVolumeWarping",
    "AGGREGATOR.POSITION_ENCODER": True, "AGGREGATOR.MAX_SCORE_CHANNEL": True,
    "HEAD.TYPE": "ProcrustesDeepResBlock", "HEAD.ADD_BASIS": True, "HEAD.AVG_POOL": True,
    "DATASET.HEIGHT": H, "DATASET.WIDTH": W,
    "TPU.INFER_BATCH": B, "TPU.COMPUTE_DTYPE": "float32",
}


class SumsOnly:
    """A ``times`` that is not the program's own (as the benchmark's is):
    it keeps each stage's durations and knows nothing of spans."""

    def __init__(self):
        self.per_call = defaultdict(list)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.per_call[name].append(time.perf_counter() - t0)


def make_model(model: str):
    cfg = default_cfg.clone()
    for key, value in {**TINY, "MODEL": model}.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return build_model(cfg, device="cpu")


def make_batches(model: str, n: int) -> list:
    """``n`` loader batches of noise, the last one short (padded by the
    predictor); the two-view model's share one reference frame."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        b = B - 1 if i == n - 1 else B
        batch = {"scene_id": [f"s{i}"] * b,
                 "pair_names": [("ref", f"{i}_{r}") for r in range(b)]}
        if model == "Regression":
            batch.update(image0_unique=rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8),
                         ref_idx=np.zeros(b, np.int32),
                         image1=rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8))
        else:
            q = rng.normal(size=(b, F, 4))
            batch.update(image0=rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8),
                         image1=rng.integers(0, 256, (b, F, H, W, 3), dtype=np.uint8),
                         abs_q_1_w2c_device=(q / np.linalg.norm(q, axis=-1,
                                                                keepdims=True)).astype(np.float32),
                         abs_c_1_c2w_device=rng.normal(size=(b, F, 3)).astype(np.float32))
        out.append(batch)
    return out


@pytest.fixture(scope="module", params=sorted(NETWORK))
def swept(request):
    """(model name, the sweep's span records, its batch count, its times)."""
    model, n = request.param, 3
    times = timing.StageTimes()
    with timing.recording() as kept:
        results = predict(make_batches(model, n), make_model(model), times)
    assert sum(len(v) for v in results.values()) == n * B - 1
    return model, kept, n, times


def test_each_batch_has_its_six_pipeline_spans(swept):
    _, spans, n, _ = swept
    main = threading.get_native_id()
    for seq in range(n):
        names = sorted(s.name for s in spans if s.batch == seq and s.name in PIPELINE)
        assert names == sorted(PIPELINE), (seq, names)
        h2d = next(s for s in spans if s.batch == seq and s.name == "h2d")
        assert h2d.thread != main and h2d.parent is None  # a transfer worker's
        for s in spans:
            if s.batch == seq and s.name != "h2d":
                assert s.thread == main, s
    # the loader's last wait finds it exhausted: the number after the last batch
    assert [s.batch for s in spans if s.name == "load_wait"][-1] == n
    assert all(s.end_ns >= s.start_ns for s in spans)


def test_the_network_spans_nest_in_dispatch(swept):
    model, spans, n, _ = swept
    for seq in range(n):
        (dispatch,) = [s for s in spans if s.batch == seq and s.name == "dispatch"]
        inner = [s for s in spans if s.parent == "dispatch" and s.batch == seq]
        assert tuple(sorted(s.name for s in inner)) == tuple(sorted(NETWORK[model]))
        for s in inner:
            assert s.thread == dispatch.thread
            assert dispatch.start_ns <= s.start_ns <= s.end_ns <= dispatch.end_ns
        starts = [s.start_ns for s in sorted(inner, key=lambda s: s.start_ns)]
        assert [s.name for s in sorted(inner, key=lambda s: s.start_ns)] == list(NETWORK[model])
        assert starts == sorted(starts)
    assert not any(s.parent == "dispatch" for s in spans if s.name in PIPELINE)


def test_the_summary_gains_the_network_stages(swept):
    model, spans, n, times = swept
    calls = {name: n for name in PIPELINE + NETWORK[model]}
    calls["load_wait"] = n + 1  # the last finds the loader exhausted
    assert dict(times.calls) == calls and set(times.summary()) == set(calls)
    assert len(spans) == sum(calls.values())


def test_a_times_that_knows_no_spans_gets_them_all():
    # the benchmark's ``times`` only sums: the spans are the program's own
    model, n = "RegressionMultiFrameFusion", 2
    times = SumsOnly()
    with timing.recording() as kept:
        predict(make_batches(model, n), make_model(model), times)
    assert {k: len(v) for k, v in times.per_call.items()} == {
        **{name: n for name in PIPELINE + NETWORK[model]}, "load_wait": n + 1}
    assert sorted(s.name for s in kept) == sorted(
        name for name, calls in times.per_call.items() for _ in calls)
    assert {s.batch for s in kept if s.parent == "dispatch"} == set(range(n))


def test_null_times_keeps_nothing():
    model = "Regression"
    other = timing.StageTimes()
    with timing.active(other):
        pass  # active only inside the block: the sweep below runs without it
    with timing.recording() as kept:
        predict(make_batches(model, 2), make_model(model))  # NULL_TIMES
    assert kept == [] and other.summary() == {} and timing.NULL_TIMES.summary() == {}
    plain = timing.StageTimes()
    with timing.stage(plain, "dispatch"):
        with timing.active(plain), timing.span("encoder"):
            pass
    assert plain.calls == {"dispatch": 1, "encoder": 1}
    assert timing._context.stack == [] and timing._context.times is timing.NULL_TIMES
    assert timing._context.batch is None and timing._kept == ()


def test_recordings_nest_and_end():
    times = timing.StageTimes()
    with timing.recording() as outer:
        with timing.stage(times, "load_wait"):
            pass
        with timing.recording() as inner:
            with timing.stage(times, "dispatch"):
                pass
        with timing.stage(times, "pose_extract"):
            pass
    with timing.stage(times, "d2h_wait"):
        pass
    assert [s.name for s in outer] == ["load_wait", "dispatch", "pose_extract"]
    assert [s.name for s in inner] == ["dispatch"] and timing._kept == ()


def test_batch_and_active_times_are_per_thread_and_restored():
    times = timing.StageTimes()
    seen = {}

    def work():
        with timing.stage(times, "h2d"):
            pass
        seen["worker"] = timing._context.batch

    timing.set_batch(7)
    try:
        with timing.recording() as kept:
            t = threading.Thread(target=timing.in_batch, args=(3, work))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with timing.stage(times, "dispatch"), timing.active(times):
                with timing.span("encoder"):
                    with timing.span("inner"):
                        pass
        assert timing._context.times is timing.NULL_TIMES
    finally:
        assert timing.set_batch(None) == 7
    by_name = {s.name: s for s in kept}
    assert seen == {"worker": 3} and by_name["h2d"].batch == 3
    assert by_name["h2d"].thread == t.native_id
    assert (by_name["encoder"].batch, by_name["encoder"].parent) == (7, "dispatch")
    assert by_name["inner"].parent == "encoder" and by_name["dispatch"].parent is None
    assert [s.name for s in kept] == ["h2d", "inner", "encoder", "dispatch"]
    assert dict(times.calls) == {"h2d": 1, "dispatch": 1, "encoder": 1, "inner": 1}


def test_ranges_reach_the_profiler_only_while_it_records(monkeypatch):
    model = "RegressionMultiFrameFusion"
    predictor = make_model(model)
    batch = make_batches(model, 1)[0]
    entered = []
    record_function = timing._profiler.record_function

    def spy(name, args=None):
        entered.append((name, args))
        return record_function(name, args)

    monkeypatch.setattr(timing._profiler, "record_function", spy)
    times = timing.StageTimes()
    predict([batch], predictor, times)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predict([batch], predictor, times)
    assert not timing._profiler._is_profiler_enabled
    ranges = {e.name for e in prof.events() if e.name.startswith(timing.RANGE_PREFIX)}
    # the profiler records the thread that started it, not the transfer workers
    assert ranges == {timing.RANGE_PREFIX + n for n in PIPELINE + NETWORK[model]
                      if n != "h2d"}
    assert (timing.RANGE_PREFIX + "encoder", "0") in entered
    entered.clear()
    predict([batch], predictor)  # NULL_TIMES, no profiler
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predict([batch], predictor)  # NULL_TIMES: ranges, no records
    assert timing.RANGE_PREFIX + "dispatch" in {e.name for e in prof.events()}
