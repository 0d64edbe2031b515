"""The yardstick of work: the card's published peaks, the correlation
kernels' operations and bytes, and the model's FLOPs as
``torch.utils.flop_counter.FlopCounterMode`` counts them on the reference
at the cell's shapes (on the meta device: no memory, no time)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.model import Model, correlate, exact

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> tuple:
    """(least seconds, "operations" | "bytes"): the larger of the products
    at the bf16 peak and the bytes at the memory's peak."""
    t_ops, t_bytes = flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("bytes" if t_bytes > t_ops else "operations")


def k1_work(B: int, HW: int, cq: int, cv: int, elem: int = 2) -> tuple:
    """K1 (softmax(q k^T) [v | grid], the max score): the two products'
    FLOPs, 2 B HW^2 (Cq + Cv + 2), and its bytes: q, k, v and the grid in
    the compute type read once, the float32 [warped | pos | max] written
    once."""
    flops = 2.0 * B * HW * HW * (cq + cv + 2)
    nbytes = elem * (B * HW * (2 * cq + cv) + 2 * HW) + 4 * B * HW * (cv + 3)
    return flops, nbytes


def _count(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def model_flops(ref: dict, H: int, W: int) -> dict:
    """FLOPs of the reference model ``ref`` (a configuration's reference
    arguments) at an H x W input, counted on the meta device: ``image``,
    the encoder over one image; ``pair``, the correlation and the head over
    one pair."""
    with torch.device("meta"):
        model = Model(**ref)
        x = torch.empty(1, 3, H, W)
        image = _count(lambda: model.encoder(x, exact))
        vol = model.encoder(x, exact)

        def pair():
            agg = correlate(vol, vol, exact)
            y = agg
            for i in range(1, 5):
                y = getattr(model.head, f"resblock{i}")(y, exact)
            model.head.mlp(y.mean(dim=(2, 3)))

        pair_flops = _count(pair)
    return {"image": image, "pair": pair_flops}


K1_NAMES = ("correlation_fwd",)


def of_record(rec: dict) -> dict:
    """The cell's grid, channels and model FLOPs (:func:`model_flops`),
    counted once per record."""
    if "work" not in rec:
        H, W = rec["shape"]["H"], rec["shape"]["W"]
        with torch.device("meta"):
            vol = Model(**rec["ref_args"]).encoder(torch.empty(1, 3, H, W), exact)
        rec["work"] = {"hw": vol.shape[2] * vol.shape[3], "channels": vol.shape[1],
                       **model_flops(rec["ref_args"], H, W)}
    return rec["work"]


def pairs_per_launch(rec: dict) -> int:
    """Pairs in one correlation launch: the batch, times the frames of a
    window."""
    return rec["shape"]["batch"] * max(1, rec["shape"]["frames"])


def k1_roofline_pct(rec: dict) -> float | None:
    """K1's share of its bound in its traced device time: launches x the
    bound of one launch at the cell's shape / the device time, in %."""
    t = rec.get("trace") or {}
    names = K1_NAMES
    seconds = sum(v for k, v in t.get("device_s", {}).items() if any(n in k for n in names))
    launches = sum(v for k, v in t.get("device_n", {}).items() if names[0] in k)
    if not seconds or not launches:
        return None
    w = of_record(rec)
    bound, _ = bound_s(*k1_work(pairs_per_launch(rec), w["hw"], w["channels"], w["channels"]))
    return 100.0 * launches * bound / seconds


def window_flops(rec: dict) -> float:
    """Model FLOPs of the work the window finished: per sweep batch the
    encoder over its unique references (each window's reference) and its
    queries (frames) and the correlation and head over its pairs."""
    w = of_record(rec)
    B, F = rec["shape"]["batch"], rec["shape"]["frames"]
    if F:
        return rec["batches"] * (w["image"] * B * (F + 1) + w["pair"] * B * F)
    return sum(w["image"] * (B + u) + w["pair"] * B for u in rec["unique_refs"])


def mfu_pct(rec: dict) -> float:
    """Model FLOPs a second over the traced run's window, outside the
    stretches in which the profiler was open (it slows the host), at the
    bf16 peak, in %."""
    t = rec.get("trace") or {}
    steps = rec["batches"]
    untraced = steps - t.get("traced_steps", 0)
    seconds = rec["window_s"] - t.get("traced_wall_s", 0.0)
    return 100.0 * window_flops(rec) / steps * untraced / (seconds * PEAK_FLOPS_BF16)
