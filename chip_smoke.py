#!/usr/bin/env python3
"""Drive the PyTorch port (mapfree_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels, compiled from this checkout's sources with nvcc;
3. kernel: K1 (the fused correlation softmax-warp) against its plain PyTorch
   version on the card (ragged HW, Cq != Cv, bf16, the 3d3d shape), then
   timed at the 3d3d main-path shape (B=64, HW=6,256, C=32, bf16) beside
   the plain version, one PyTorch library call (scaled_dot_product_attention,
   timed here only) and the kernel's bound;
4. main path: the 3d3d model (configs/regression/mapfree/3d3d.yaml over
   configs/mapfree.yaml: ResUNet 3-3-3 bottleneck, 360x270, bf16, batch 64,
   unique refs, planar YUV420 input) with random weights from a seed, driven
   through build_model -> predict -> save_submission on synthetic pairs;
   every pose must be finite with det(R) = 1 and K1 must have launched once
   per batch; then a torch.profiler window over three forwards prints the
   device time by kernel and the device's busy share;
5. device parity: a small float32 model on the GPU and the CPU with the
   same weights and batch, the process's TF32 settings on (the float32
   forward turns TF32 off for itself).

The last line of standard output is {"ok": true, "device": {...}}; a
"kernels" JSON line and the card's name and power limit precede it. With no
CUDA device, or outside a checkout of the repository, it exits nonzero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from zipfile import ZipFile

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit) and the
# exponential rate of the special-function units (16 per SM per clock,
# 132 SMs, 1.98 GHz boost clock)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_EXP_PER_S = 132 * 16 * 1.98e9

# K1 against its plain version: f32 outputs differ by exp2 of log2e-scaled
# scores and summation order; bf16 cases feed both sides the same bf16 inputs
# and both accumulate in f32
ATOL = {"float32": 5e-5, "bfloat16": 1e-3}
# device parity of the float32 model: cuDNN and CPU convolutions sum in
# different orders; the Kabsch solve passes that on to R and t
PARITY_ATOL = 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 -----------------------------------------------------------------

def phase_device() -> str:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    log(f"[device] nvidia-smi: {smi}")
    return smi.splitlines()[0]


# -- phase 2 -----------------------------------------------------------------

def phase_build() -> None:
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    t0 = time.perf_counter()
    _build.load_library(corr.KERNEL)
    log(f"[build] {corr.KERNEL}: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds[corr.KERNEL]:.2f} s)")
    for line in _build.build_logs.get(corr.KERNEL, "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


# -- phase 3 -----------------------------------------------------------------

def _k1_inputs(B, H, W, cq, cv, dtype, seed):
    import torch

    from mapfree_tpu_torch.models.aggregators import _uv_grid

    rng = np.random.default_rng(seed)
    HW = H * W
    dev = torch.device("cuda", 0)
    td = getattr(torch, dtype)
    q, k = (torch.from_numpy(rng.standard_normal((B, HW, cq), np.float32)).to(dev, td)
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((B, HW, cv), np.float32)).to(dev, td)
    return q, k, v, _uv_grid(H, W, device=dev)


def _max_err(out, ref) -> float:
    return max(float((o - r).abs().max()) for o, r in zip(out, ref))


def phase_kernel_cases() -> list:
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    cases = []
    for name, (B, H, W, cq, cv, dtype) in {
        "f32_hw130": (2, 10, 13, 32, 32, "float32"),
        "f32_q16_v32": (2, 10, 13, 16, 32, "float32"),
        "bf16_hw130": (2, 10, 13, 32, 32, "bfloat16"),
        "f32_hw6256_b2": (2, 92, 68, 32, 32, "float32"),
        "bf16_hw6256_b2": (2, 92, 68, 32, 32, "bfloat16"),
    }.items():
        q, k, v, grid = _k1_inputs(B, H, W, cq, cv, dtype, seed=len(cases))
        out = corr.fused_correlation_warp(q, k, v, grid)
        torch.cuda.synchronize()
        ref = corr.fused_correlation_warp_plain(q, k, v, grid)
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        ok = err <= ATOL[dtype]
        cases.append({"case": name, "max_abs_err": err, "atol": ATOL[dtype], "ok": ok})
        log(f"[kernel] {name}: max |kernel - plain| = {err:.3g} (atol {ATOL[dtype]:g})")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version in case {name}")
    return cases


def k1_bound(B, HW, cq, cv, dtype, nbytes) -> tuple:
    """Least time for K1's work: bytes at the memory rate, and the products
    and exponentials at their peak rates. Returns (ms, "bytes"|"operations")."""
    flops = 2.0 * B * HW * HW * (cq + cv + 2)
    t_ops = max(flops / PEAK_FLOPS[dtype], B * HW * HW / PEAK_EXP_PER_S)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes > t_ops else "operations")


def phase_kernel_timing() -> dict:
    import torch
    import torch.nn.functional as F

    from mapfree_tpu_torch.ops import correlation as corr

    B, H, W, C, dtype = 64, 92, 68, 32, "bfloat16"
    HW = H * W
    q, k, v, grid = _k1_inputs(B, H, W, C, C, dtype, seed=100)
    out = corr.fused_correlation_warp(q, k, v, grid)
    torch.cuda.synchronize()
    ref = corr.fused_correlation_warp_plain(q, k, v, grid)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    log(f"[kernel] main shape B={B} HW={HW} C={C} {dtype}: max |kernel - plain| = "
        f"{err:.3g} (atol {ATOL[dtype]:g})")
    if err > ATOL[dtype]:
        raise AssertionError("K1 disagrees with its plain version at the main-path shape")
    del out, ref

    ms = cuda_time_ms(lambda: corr.fused_correlation_warp(q, k, v, grid), iters=10)
    plain_ms = cuda_time_ms(lambda: corr.fused_correlation_warp_plain(q, k, v, grid),
                            iters=3)
    torch.cuda.empty_cache()
    # one library call computing P [v | grid] (padded to 40 columns for the
    # fused attention backends); timed here only, the port never calls it
    vg = torch.cat([v, grid.to(v.dtype).expand(B, HW, 2),
                    v.new_zeros(B, HW, 6)], dim=-1)[:, None]
    qh, kh = q[:, None], k[:, None]
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vg, scale=1.0), iters=10)

    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) \
        + HW * 2 * v.element_size() + B * HW * (C + 3) * 4
    bound_ms, bound_by = k1_bound(B, HW, C, C, dtype, nbytes)
    log(f"[kernel] kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={library_ms:.3f} "
        f"bound_ms={bound_ms:.3f} ({bound_by}); kernel at "
        f"{100 * bound_ms / ms:.1f}% of its bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}


# -- phase 4 -----------------------------------------------------------------

def load_cfg(overrides: dict | None = None):
    from mapfree_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.merge_from_file(str(REPO / "configs/mapfree.yaml"))
    cfg.merge_from_file(str(REPO / "configs/regression/mapfree/3d3d.yaml"))
    for key, value in (overrides or {}).items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


def synthetic_batches(n_pairs: int, batch: int, H: int, W: int, seed: int) -> list:
    """Collated batches of YUV420 pairs sharing 1-2 reference frames each:
    ``image0_unique`` [U, H*3/2, W], ``ref_idx`` [B], ``image1`` [B, H*3/2, W]."""
    rng = np.random.default_rng(seed)
    batches = []
    for b0 in range(0, n_pairs, batch):
        B = min(batch, n_pairs - b0)
        U = 1 + (b0 // batch) % 2
        ref_idx = np.sort(rng.integers(0, U, B)).astype(np.int32)
        ref_idx[0] = 0
        ref_idx[-1] = U - 1
        scenes = [f"s{b0 // batch:05d}_{r}" for r in ref_idx]
        batches.append({
            "image0_unique": rng.integers(0, 256, (U, H * 3 // 2, W), dtype=np.uint8),
            "ref_idx": ref_idx,
            "image1": rng.integers(0, 256, (B, H * 3 // 2, W), dtype=np.uint8),
            "scene_id": scenes,
            "pair_names": [("seq0/frame_00000.jpg", f"seq1/frame_{b0 + i:05d}.jpg")
                           for i in range(B)],
        })
    return batches


def phase_main_path() -> int:
    """Returns K1's launches in the measured sweep."""
    import torch

    from mapfree_tpu_torch.models.builder import build_model
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.utils import submission
    from mapfree_tpu_torch.utils.submission import predict, save_submission
    from mapfree_tpu_torch.utils.timing import StageTimes

    cfg = load_cfg({"TPU.SEED": SEED})
    H, W, bs = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, int(cfg.TPU.INFER_BATCH)
    log(f"[main] 3d3d: {cfg.ENCODER.TYPE} {cfg.ENCODER.NUM_BLOCKS} block "
        f"{cfg.ENCODER.BLOCK_TYPE}, {H}x{W}, {cfg.TPU.COMPUTE_DTYPE}, batch {bs}, "
        f"unique refs {cfg.TPU.UNIQUE_REFS}, YUV420 {cfg.TPU.YUV420_TRANSFER}")
    model = build_model(cfg, device="cuda")
    n_params = sum(p.numel() for p in model.net.parameters())

    batches = synthetic_batches(5 * bs + 23, bs, H, W, seed=SEED + 1)
    n_pairs = sum(len(b["ref_idx"]) for b in batches)

    # warm-up over as many batches as the pipeline holds at once, so that the
    # pinned host blocks the measured sweep needs are already allocated
    n_warm = submission.MAX_TRANSFERS + submission.DEPTH
    predict(synthetic_batches(n_warm * bs, bs, H, W, seed=SEED + 2), model)
    torch.cuda.synchronize()

    times = StageTimes()
    corr.launches = 0
    t0 = time.perf_counter()
    results = predict(batches, model, times)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = corr.launches
    log(f"[main] {n_pairs} pairs in {len(batches)} batches: {elapsed:.3f} s, "
        f"{n_pairs / elapsed:.1f} pairs/s, {1e3 * elapsed / len(batches):.1f} ms/batch; "
        f"K1 launches {launches}; stages {times.summary()}")
    if launches != len(batches):
        raise AssertionError(f"K1 launched {launches} times for {len(batches)} batches")

    poses = [p for ps in results.values() for p in ps]
    if len(poses) != n_pairs:
        raise AssertionError(f"{len(poses)} poses for {n_pairs} pairs")
    for p in poses:
        if not (np.all(np.isfinite(p.q)) and np.all(np.isfinite(p.t))):
            raise AssertionError(f"non-finite pose for {p.image_name}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "submission.zip"
        save_submission(results, path)
        with ZipFile(path) as z:
            lines = [ln for n in z.namelist() for ln in z.read(n).decode().splitlines()]
    if len(lines) != n_pairs or any(len(ln.split(" ")) != 9 for ln in lines):
        raise AssertionError("submission.zip does not hold one 9-field line per pair")

    R, t, _ = model.predict_batch(batches[0])
    det = np.linalg.det(R.astype(np.float64))
    if not (np.all(np.isfinite(R)) and np.all(np.isfinite(t))
            and np.abs(det - 1.0).max() < 1e-3):
        raise AssertionError(f"bad rotations: det(R) in [{det.min()}, {det.max()}]")

    # the forward alone, on a batch already on the device
    transferred = model.transfer_batch(batches[0])
    model_ms = cuda_time_ms(lambda: model.dispatch_device(transferred)(), iters=5)
    log(f"[main] model forward {model_ms:.2f} ms per batch of {bs} "
        f"({1e3 * bs / model_ms:.1f} pairs/s model-only); {n_params / 1e6:.2f} M "
        f"parameters; submission.zip {len(lines)} lines; max |det(R) - 1| = "
        f"{np.abs(det - 1.0).max():.2e}")
    profile_forward(model, transferred)
    return launches


def profile_forward(model, transferred, n: int = 3) -> None:
    """Device time by kernel over ``n`` forwards of a batch already on the
    device, and the share of the window the device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.dispatch_device(transferred)()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            model.dispatch_device(transferred)()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    totals: dict = {}
    for evt in prof.events():  # device-side events only: the kernels and copies
        if evt.device_type == DeviceType.CUDA:
            us, count = totals.get(evt.name, (0.0, 0))
            totals[evt.name] = (us + evt.time_range.elapsed_us(), count + 1)
    rows = [(us, count, name) for name, (us, count) in totals.items()]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {n} forwards: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%)")
    for us, count, key in rows[:15]:
        log(f"[profile] {us / 1e3 / n:9.3f} ms/forward {100 * us / busy:5.1f}%  "
            f"x{count // n:<4d} {key[:90]}")


# -- phase 5 -----------------------------------------------------------------

def phase_device_parity() -> None:
    import torch

    from mapfree_tpu_torch.models.builder import build_model

    cfg = load_cfg({"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96,
                    "DATASET.WIDTH": 72, "TPU.INFER_BATCH": 4,
                    "TPU.COMPUTE_DTYPE": "float32", "TPU.SEED": SEED})
    batch = synthetic_batches(3, 4, 96, 72, seed=SEED + 3)[0]
    # TF32 on for the process: the float32 forward must turn it off itself
    # and leave the process's settings as they were
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        out[dev] = model.predict_batch(batch)[:2]
    if not (torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("the float32 forward changed the process's TF32 settings")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    dR = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    dt = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    log(f"[parity] float32 GPU vs CPU: max |dR| = {dR:.3g}, max |dt| = {dt:.3g} "
        f"(atol {PARITY_ATOL:g})")
    if max(dR, dt) > PARITY_ATOL:
        raise AssertionError("the GPU and CPU forwards disagree")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, str(REPO))
    try:
        import mapfree_tpu_torch  # noqa: F401
    except ImportError:
        fail(f"mapfree_tpu_torch not found beside {Path(__file__).name}: run it from "
             "a checkout of the repository")

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    cases = phase_kernel_cases()
    timing = phase_kernel_timing()
    launches = phase_main_path()
    phase_device_parity()

    from mapfree_tpu_torch.ops import correlation as corr

    kernels = [{
        "name": corr.KERNEL,
        "route": "cuda",
        "source": "mapfree_tpu_torch/ops/csrc/correlation_fwd.cu",
        "replaces": "mapfree_tpu/ops/correlation.py:60",
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "cases": cases,
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
