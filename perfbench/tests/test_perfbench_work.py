"""The work counts: the kernels' products against ``FlopCounterMode`` on the
reference's correlation, and the model's FLOPs on the meta device against
the same count on the CPU."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import work
from perfbench.reference.model import correlate, exact


def counted(fn):
    with FlopCounterMode(display=False) as c:
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("B,h,w,C", [(2, 6, 5, 8), (3, 4, 4, 16)])
def test_k1_products_are_the_reference_correlations(B, h, w, C):
    v = torch.randn(B, C, h, w)
    flops, nbytes = work.k1_work(B, h * w, C, C)
    assert counted(lambda: correlate(v, v, exact)) == flops
    assert nbytes == 2 * (B * h * w * 3 * C + 2 * h * w) + 4 * B * h * w * (C + 3)


def test_bound_takes_the_larger_rate():
    assert work.bound_s(989e12, 0) == (1.0, "operations")
    assert work.bound_s(0, 3.35e12) == (1.0, "bytes")


@pytest.mark.parametrize("frames", [0, 3])
def test_meta_count_is_the_cpu_count(frames):
    ref = {"num_blocks": (1, 1, 1), "channels": 8, "points": 6, "frames": frames}
    meta = work.model_flops(ref, 96, 72)
    from perfbench.reference.model import Model

    model = Model(**ref)
    x = torch.rand(1, 3, 96, 72)
    assert counted(lambda: model.encoder(x, exact)) == meta["image"]
    assert meta["pair"] > 0


def test_window_flops_counts_unique_references_once():
    rec = {"driver": "sweep", "shape": {"H": 96, "W": 72, "batch": 4, "frames": 0},
           "ref_args": {"num_blocks": (1, 1, 1), "channels": 8, "points": 6, "frames": 0},
           "unique_refs": [1, 2], "batches": 2, "window_s": 1.0}
    w = work.of_record(rec)
    assert work.window_flops(rec) == w["image"] * (4 + 1 + 4 + 2) + 2 * 4 * w["pair"]
