#!/usr/bin/env python3
"""Drive the PyTorch port (mapfree_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels (correlation_fwd: K1; correlation_bwd: K2, K3 in
   their two designs, tensor cores for bf16 and float32 FMA, and K2's
   prologue), compiled at once from this checkout's sources with nvcc, with
   ptxas's registers and spills per kernel;
3. kernel: K1 (the fused correlation softmax-warp), K2 and K3 (its backward
   row and column passes) against their plain PyTorch versions on the card
   (ragged HW, HW < 64, Cq != Cv, 8 to 64 channels, bf16 and float32, a bf16
   shape only the FMA design takes, the mid-window HW=576, the 3d3d shape,
   the max-score cotangent alone, two runs of K3 for equal bits), each case
   with the design that served it; the tensor-core design is held to the
   plain backward with the same bf16 roundings (tight, relative L2) and to
   the exact one (the tolerance the CPU tests derive), and its prologue's
   outputs to the plain prologue. Then each is timed beside the plain
   version, one PyTorch library call (scaled_dot_product_attention and its
   backward, timed here only) and its bound: K1 at the inference shape
   (B=64, HW=6,256, C=32, bf16) and K1, K2, K3 at the training shape (B=10),
   which the tensor-core design must serve;
4. inference path: the 3d3d model (configs/regression/mapfree/3d3d.yaml over
   configs/mapfree.yaml: ResUNet 3-3-3 bottleneck, 360x270, bf16, batch 64,
   unique refs, planar YUV420 input) with random weights from a seed, driven
   through build_model -> predict -> save_submission on synthetic pairs;
   every pose must be finite with det(R) = 1 and K1 must have launched once
   per batch; then a torch.profiler window over three forwards prints the
   device time by kernel and the device's busy share;
5. training path: the same model at its training batch of 10 (rot_angle_loss
   + trans_l1_loss, Adam 1e-4), on uint8 RGB noise with random poses: timed
   steps through init_state -> make_train_step (ms per step, samples/s, peak
   memory, the loss at each step, a profiler window over three steps), then
   the fit loop with validation passes and checkpoints in a temporary
   directory. Every loss must be finite, K1, K2 and K3 must each have
   launched once per train step and K1 once per validation batch, the
   parameters and BatchNorm statistics must have changed, and the restored
   ``last`` checkpoint must reproduce the validation loss;
6. device parity: a small float32 model on the GPU and the CPU with the
   same weights and batch, the process's TF32 settings on (the float32
   forward and train step turn TF32 off for themselves): the poses, then the
   loss and every gradient of one train step; 8 steps on one batch at
   LR 1e-3 lower the loss on the card; and one bf16 train step of the same
   small model with the kernels (the tensor-core backward) against the same
   step with the plain versions on the card.

The last line of standard output is {"ok": true, "device": {...}}; a
"kernels" JSON line and the card's name and power limit precede it. With no
CUDA device, or outside a checkout of the repository, it exits nonzero and
prints no result. ``--kernels-only`` stops after phase 3 and prints no
result line (a quick check while working on a kernel).
"""

from __future__ import annotations

import contextlib
import io
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
# K2 and K3 in the FMA design (float32 inputs, and bf16 shapes the
# tensor-core design does not take) against the plain backward, as a share of
# each gradient's largest magnitude (or of 1 where that is smaller): both
# sides take the same inputs and sum in f32; the kernels take exp2 of
# log2e-scaled scores, get the row constant c from the forward's output
# instead of summing dP.P, and sum over up to 6,256 terms in another order.
# The tensor-core design's two tolerances are the package's
# (ops/correlation.py: MMA_VS_EXACT_TOL, MMA_VS_MATCHED_L2_TOL).
BWD_TOL = 1e-4
# the prologue's row constant c = dout . out against the plain prologue's, as
# a share of the largest |c| (or of 1): 35 float32 terms in another order
PROLOGUE_TOL = 1e-5
# device parity of the float32 model: cuDNN and CPU convolutions sum in
# different orders; the Kabsch solve passes that on to R and t
PARITY_ATOL = 2e-4
# one float32 train step on the card with the kernels against the same step
# on the card with the plain versions in their place: everything else is the
# same cuDNN arithmetic, so every gradient agrees to float32 summation order,
# as a share of its tensor's largest entry (with a floor for tensors whose true
# gradient is zero: conv biases before a BatchNorm)
STEP_GRAD_TOL = 2e-4
STEP_GRAD_FLOOR = 1e-6
# the same step on the CPU: cuDNN and the CPU sum convolutions in other orders,
# so a few of the millions of ReLU and max-pool inputs that lie within round-off
# of zero (or of a tie) take the other branch, which changes the gradient at
# that position by a finite amount: several per cent of an early layer's
# largest entry. So the CPU comparison is of the loss, of the whole gradient
# in the L2 norm, and of the median tensor; the worst tensor is only printed
STEP_LOSS_RTOL = 1e-4
STEP_CPU_L2_TOL = 2e-2
STEP_CPU_MEDIAN_TOL = 1e-3
# one bf16 train step with K1 and the tensor-core K2 and K3 against the same
# step with the plain backward after the same K1 forward: the two share their
# forward to the bit, so the loss is equal and the gradients differ by what
# K2 and K3 differ. Those round dmain, P and dS to bf16 (at most
# MMA_VS_EXACT_TOL of a gradient's largest entry, about half a per cent in
# L2), the layers below are linear in them, and two runs of one step already
# differ by some 3e-3 in L2 (cuDNN's bf16 weight gradients use atomics): the
# whole gradient is held to MMA_VS_EXACT_TOL in the L2 norm
STEP_BF16_BWD_L2_TOL = 2e-2
# the same step with the plain forward too. K1 and the plain forward agree to
# 1e-5, but every bf16 layer after them rounds such a difference up to whole
# bf16 steps (2^-8), so the loss agrees only to a few of those and the
# gradient, through a loss whose rotation term is an arccos, to several per
# cent (7.75e-2 in L2 on an H100, the same in each run). This comparison is of
# K1, not of the backward: it is held loosely, against gross faults only
STEP_BF16_LOSS_RTOL = 1e-2
STEP_BF16_L2_TOL = 0.15


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
    """Every CUDA source at once, one nvcc process each."""
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    t0 = time.perf_counter()
    _build.load_libraries(corr.LIBRARIES)
    log(f"[build] {len(corr.LIBRARIES)} libraries in {time.perf_counter() - t0:.2f} s")
    for name in corr.LIBRARIES:
        log(f"[build] {name}: nvcc {_build.build_seconds[name]:.2f} s")
        for kernel, regs, spill in ptxas_report(_build.build_logs.get(name, "")):
            log(f"[build]   {kernel}: {regs} registers, {spill} bytes spilled")


def ptxas_report(build_log: str) -> list:
    """(kernel<template arguments>, registers, spilled bytes) per entry
    function, from ``nvcc -Xptxas -v``'s output."""
    import re

    out, kernel, spill = [], "?", 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            # the mangled name: <length><name>[I<template arguments>E]
            m = re.search(
                r"\d+(correlation_\w+?_kernel)(?:I((?:f|13__nv_bfloat16|Li\d+E)+)E)?", line)
            if m:
                tokens = re.findall(r"f|13__nv_bfloat16|Li\d+E", m.group(2) or "")
                names = [{"f": "f32", "13__nv_bfloat16": "bf16"}.get(tok, tok[2:-1])
                         for tok in tokens]
                kernel = m.group(1) + (f"<{', '.join(names)}>" if names else "")
            else:
                kernel = line.split("'")[1][:70]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((kernel, int(m.group(1)), spill))
    return out


# -- phase 3 -----------------------------------------------------------------

def _kernel_inputs(B, H, W, cq, cv, dtype, seed):
    import torch

    from mapfree_tpu_torch.models.aggregators import _uv_grid

    rng = np.random.default_rng(seed)
    HW = H * W
    dev = torch.device("cuda", 0)
    td = getattr(torch, dtype)
    q, k = (torch.from_numpy(rng.standard_normal((B, HW, cq), np.float32)).to(dev, td)
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((B, HW, cv), np.float32)).to(dev, td)
    return q, k, v, _uv_grid(H, W, device=dev).to(td)


def _cotangent(B, HW, cv, seed, ms_only=False):
    """Random float32 cotangent of the forward's [B, HW, Cv + 3] buffer: all
    three outputs, or the max score alone."""
    import torch

    rng = np.random.default_rng(seed)
    dout = rng.standard_normal((B, HW, cv + 3), np.float32)
    if ms_only:
        dout[..., :cv + 2] = 0.0
    return torch.from_numpy(dout).to("cuda:0")


def _max_err(out, ref) -> float:
    return max(float((o - r).abs().max()) for o, r in zip(out, ref))


def _scaled_err(out, ref) -> float:
    """max |out - ref| over the tensors, each relative to max(1, max |ref|)."""
    return max(float((o - r).abs().max()) / max(1.0, float(r.abs().max()))
               for o, r in zip(out, ref))


def _rel_l2(out, ref) -> float:
    """The largest relative L2 error ||out - ref|| / ||ref|| over the tensors."""
    return max(float((o - r).norm() / r.norm().clamp_min(1e-30)) for o, r in zip(out, ref))


def backward_case(q, k, v, grid, dout) -> dict:
    """K2 and K3 against their plain versions on the same inputs, by the
    design that serves them. Where the kernel's first argmax differs from the
    plain version's, the two scores must be equal within float32 summation
    noise (the two sum q.k in other orders); the plain version then routes
    the max-score cotangent as the kernel did, so that the comparison is of
    the same function. The tensor-core design is compared twice: with the
    plain backward that rounds dmain, P and dS to bf16 as it does (relative
    L2), and with the exact one; its prologue's outputs are compared too."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    design = corr.backward_design(q.dtype, q.shape[-1], v.shape[-1])
    out = torch.cat(corr.fused_correlation_warp(q, k, v, grid), dim=-1)
    dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout)
    dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows)
    torch.cuda.synchronize()
    amax = rows.amax.long()
    if int(amax.min()) < 0 or int(amax.max()) >= q.shape[1]:
        raise AssertionError("K2 wrote an argmax outside [0, HW)")
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    top = s.amax(dim=-1)
    gap = (top - s.gather(2, amax[..., None])[..., 0]).abs()
    moved = int((s.argmax(dim=-1) != amax).sum())
    tie_tol = 4e-6 * float(s.abs().max())
    if float(gap.max()) > tie_tol:
        raise AssertionError(f"K2's argmax is not a maximum: score gap {float(gap.max()):.3g}")
    del s, top, gap
    dq_p, dk_p, dv_p, _ = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, amax)
    torch.cuda.synchronize()
    res = {"design": design, "k2_err": _scaled_err([dq], [dq_p]),
           "k3_err": _scaled_err([dk, dv], [dk_p, dv_p]), "argmax_near_ties": moved,
           "dk": dk, "dv": dv, "rows": rows, "tol": BWD_TOL}
    if design == corr.DESIGN_MMA:
        del dq_p, dk_p, dv_p
        dq_m, dk_m, dv_m, _ = corr.fused_correlation_warp_bwd_plain(
            q, k, v, grid, dout, amax, bf16_roundings=True)
        torch.cuda.synchronize()
        res.update(tol=corr.MMA_VS_EXACT_TOL, l2_tol=corr.MMA_VS_MATCHED_L2_TOL,
                   k2_l2=_rel_l2([dq], [dq_m]), k3_l2=_rel_l2([dk, dv], [dk_m, dv_m]),
                   k2_matched=_scaled_err([dq], [dq_m]),
                   k3_matched=_scaled_err([dk, dv], [dk_m, dv_m]))
        # the prologue: dmain, 1/d and d_ms to the bit, c to summation order
        # (K2 has filled the statistics' first column since)
        dmain_p, stats_p = corr.correlation_bwd_prologue_plain(out, dout)
        if not torch.equal(rows.dmain, dmain_p):
            raise AssertionError("the prologue's bf16 dmain differs from the plain prologue's")
        if not torch.equal(rows.stats[..., [1, 3]], stats_p[..., [1, 3]]):
            raise AssertionError("the prologue's 1/d or d_ms differs from the plain prologue's")
        res["prologue_c_err"] = _scaled_err([rows.stats[..., 2]], [stats_p[..., 2]])
        if res["prologue_c_err"] > PROLOGUE_TOL:
            raise AssertionError(f"the prologue's c is off by {res['prologue_c_err']:.3g}")
    return res


def check_backward(res: dict, what: str) -> None:
    """Raise if K2 or K3 of a :func:`backward_case` is out of tolerance."""
    for kernel in ("k2", "k3"):
        if not res[kernel + "_err"] <= res["tol"]:
            raise AssertionError(
                f"{kernel.upper()} disagrees with its plain version in {what}: "
                f"{res[kernel + '_err']:.3g} > {res['tol']:g} of the largest gradient")
        if "l2_tol" in res and not res[kernel + "_l2"] <= res["l2_tol"]:
            raise AssertionError(
                f"{kernel.upper()} disagrees with the plain backward of the same roundings "
                f"in {what}: relative L2 {res[kernel + '_l2']:.3g} > {res['l2_tol']:g}")


def _case_line(res: dict) -> str:
    """One case's backward errors, with the design that served it."""
    from mapfree_tpu_torch.ops import correlation as corr

    line = (f"design {res['design']}; K2 {res['k2_err']:.3g}, K3 {res['k3_err']:.3g} of the "
            f"largest gradient vs the exact plain backward (tol {res['tol']:g})")
    if res["design"] == corr.DESIGN_MMA:
        line += (f"; vs the plain backward with the kernels' bf16 roundings: relative L2 K2 "
                 f"{res['k2_l2']:.3g}, K3 {res['k3_l2']:.3g} (tol {res['l2_tol']:g}), largest "
                 f"entry K2 {res['k2_matched']:.3g}, K3 {res['k3_matched']:.3g}; prologue c "
                 f"{res['prologue_c_err']:.3g} (tol {PROLOGUE_TOL:g})")
    return line + f"; argmax near-ties {res['argmax_near_ties']}"


def phase_kernel_cases() -> dict:
    """K1, K2 and K3 against their plain versions, per case. Returns the
    cases per kernel."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    cases = {corr.KERNEL: [], corr.KERNEL_BWD_ROWS: [], corr.KERNEL_BWD_COLS: []}

    def record(kernel, name, err, atol, **more):
        cases[kernel].append({"case": name, "max_abs_err": err, "atol": atol,
                              "ok": err <= atol, **more})
        if not err <= atol:
            raise AssertionError(f"{kernel} disagrees with its plain version in case "
                                 f"{name}: {err:.3g} > {atol:g}")

    def record_backward(name, res):
        for kernel, key in ((corr.KERNEL_BWD_ROWS, "k2"), (corr.KERNEL_BWD_COLS, "k3")):
            more = {"design": res["design"]}
            if res["design"] == corr.DESIGN_MMA:
                more.update(matched_rel_l2=res[key + "_l2"], matched_rel_l2_tol=res["l2_tol"])
            record(kernel, name, res[key + "_err"], res["tol"], **more)
        check_backward(res, f"case {name}")

    for i, (name, (B, H, W, cq, cv, dtype)) in enumerate({
        "f32_hw48_c16": (2, 6, 8, 16, 16, "float32"),
        "f32_hw130": (2, 10, 13, 32, 32, "float32"),
        "f32_q16_v32": (2, 10, 13, 16, 32, "float32"),
        "bf16_hw130": (2, 10, 13, 32, 32, "bfloat16"),
        "f32_hw576_b1_c8": (1, 24, 24, 8, 8, "float32"),
        "f32_hw6256_b2": (2, 92, 68, 32, 32, "float32"),
        "bf16_hw6256_b2": (2, 92, 68, 32, 32, "bfloat16"),
        "bf16_hw48_c16": (2, 6, 8, 16, 16, "bfloat16"),
        "bf16_q16_v32": (2, 10, 13, 16, 32, "bfloat16"),
        "bf16_hw576_b1_c8": (1, 24, 24, 8, 8, "bfloat16"),
        "bf16_hw130_c64": (2, 10, 13, 64, 64, "bfloat16"),
        # K1 takes Cv + 2 <= 128, so 120 is the widest v the backward is given
        "bf16_hw130_q128_v120": (1, 10, 13, 128, 120, "bfloat16"),
        "bf16_hw130_c12_fma": (2, 10, 13, 12, 12, "bfloat16"),
    }.items()):
        q, k, v, grid = _kernel_inputs(B, H, W, cq, cv, dtype, seed=i)
        out = corr.fused_correlation_warp(q, k, v, grid)
        torch.cuda.synchronize()
        ref = corr.fused_correlation_warp_plain(q, k, v, grid)
        torch.cuda.synchronize()
        k1_err = _max_err(out, ref)
        del out, ref
        res = backward_case(q, k, v, grid, _cotangent(B, H * W, cv, seed=50 + i))
        expected = corr.DESIGN_FMA if dtype == "float32" or name.endswith("_fma") \
            else corr.DESIGN_MMA
        if res["design"] != expected:
            raise AssertionError(f"case {name} was served by the {res['design']} design")
        log(f"[kernel] {name}: K1 max |kernel - plain| = {k1_err:.3g} (atol "
            f"{ATOL[dtype]:g}); {_case_line(res)}")
        record(corr.KERNEL, name, k1_err, ATOL[dtype])
        record_backward(name, res)
        if name in ("f32_hw130", "bf16_hw130"):
            # the argmax route alone: only the max score has a cotangent
            only = backward_case(q, k, v, grid, _cotangent(B, H * W, cv, 70, ms_only=True))
            log(f"[kernel] {name}, max-score cotangent only: {_case_line(only)}")
            record_backward(name + "_ms_only", only)
        if name == "bf16_hw6256_b2":
            # K3 sums in a fixed order: a second run gives the same bits
            dout = _cotangent(B, H * W, cv, seed=50 + i)
            dk2, dv2 = corr.correlation_bwd_cols(q, k, v, grid, dout, res["rows"])
            torch.cuda.synchronize()
            same = torch.equal(dk2, res["dk"]) and torch.equal(dv2, res["dv"])
            log(f"[kernel] {name}: two runs of K3 give equal bits: {same}")
            if not same:
                raise AssertionError("two runs of K3 differ")
        del res
    return cases


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def op_bound(flops, n_exp, nbytes, dtype) -> tuple:
    """Least time for the work: bytes at the memory rate, and the products
    and exponentials at their peak rates. Returns (ms, "bytes"|"operations")."""
    t_ops = max(flops / PEAK_FLOPS[dtype], n_exp / PEAK_EXP_PER_S)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes > t_ops else "operations")


def k1_bound(B, HW, cq, cv, dtype, nbytes) -> tuple:
    return op_bound(2.0 * B * HW * HW * (cq + cv + 2), B * HW * HW, nbytes, dtype)


def k2_bound(B, HW, cq, cv, dtype, nbytes) -> tuple:
    """Three products: q k^T, dmain [v|grid]^T, dS k."""
    return op_bound(2.0 * B * HW * HW * (2 * cq + cv + 2), B * HW * HW, nbytes, dtype)


def k3_bound(B, HW, cq, cv, dtype, nbytes) -> tuple:
    """Four products: k q^T, [v|grid] dmain^T, dS^T q, P^T dmain[:Cv]."""
    return op_bound(2.0 * B * HW * HW * (2 * cq + 2 * cv + 2), B * HW * HW, nbytes, dtype)


def time_k1(B, H, W, C, dtype, seed) -> dict:
    """K1 at one shape: agreement, then its time beside the plain version's,
    one library call's and its bound."""
    import torch
    import torch.nn.functional as F

    from mapfree_tpu_torch.ops import correlation as corr

    HW = H * W
    q, k, v, grid = _kernel_inputs(B, H, W, C, C, dtype, seed=seed)
    out = corr.fused_correlation_warp(q, k, v, grid)
    torch.cuda.synchronize()
    ref = corr.fused_correlation_warp_plain(q, k, v, grid)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    if err > ATOL[dtype]:
        raise AssertionError(f"K1 disagrees with its plain version at B={B} HW={HW}")
    del out, ref

    ms = cuda_time_ms(lambda: corr.fused_correlation_warp(q, k, v, grid), iters=10)
    plain_ms = cuda_time_ms(lambda: corr.fused_correlation_warp_plain(q, k, v, grid),
                            iters=3)
    torch.cuda.empty_cache()
    # one library call computing P [v | grid] (padded to 40 columns for the
    # fused attention backends); timed here only, the port never calls it
    vg = torch.cat([v, grid.expand(B, HW, 2), v.new_zeros(B, HW, 6)], dim=-1)[:, None]
    qh, kh = q[:, None], k[:, None]
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vg, scale=1.0), iters=10)

    nbytes = _nbytes(q, k, v, grid) + B * HW * (C + 3) * 4
    bound_ms, bound_by = k1_bound(B, HW, C, C, dtype, nbytes)
    log(f"[kernel] K1 B={B} HW={HW} C={C} {dtype}: max |kernel - plain| = {err:.3g}; "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={library_ms:.3f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}); kernel at {100 * bound_ms / ms:.1f}% "
        f"of its bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "shape": f"B={B} HW={HW} C={C} {dtype}"}


def time_backward(B, H, W, C, dtype, seed) -> tuple:
    """K2 and K3 at one shape, each beside its plain version and its bound;
    the library call (the backward of scaled_dot_product_attention over
    [v | grid], without the max-score route) stands for the pair."""
    import torch
    import torch.nn.functional as F

    from mapfree_tpu_torch.ops import correlation as corr

    HW = H * W
    q, k, v, grid = _kernel_inputs(B, H, W, C, C, dtype, seed=seed)
    dout = _cotangent(B, HW, C, seed=seed + 1)
    res = backward_case(q, k, v, grid, dout)
    log(f"[kernel] K2, K3 B={B} HW={HW} C={C} {dtype}: {_case_line(res)}")
    if dtype == "bfloat16" and res["design"] != corr.DESIGN_MMA:
        raise AssertionError(f"B={B} HW={HW} C={C} {dtype} is not served by the tensor-core "
                             f"design but by {res['design']}")
    check_backward(res, f"B={B} HW={HW}")
    rows, design = res["rows"], res["design"]
    k2_err, k3_err = res["k2_err"], res["k3_err"]
    del res
    out = torch.cat(corr.fused_correlation_warp(q, k, v, grid), dim=-1)

    k2_ms = cuda_time_ms(lambda: corr.correlation_bwd_rows(q, k, v, grid, out, dout), iters=10)
    k3_ms = cuda_time_ms(lambda: corr.correlation_bwd_cols(q, k, v, grid, dout, rows), iters=10)
    k2_plain = cuda_time_ms(lambda: corr.correlation_bwd_rows_plain(q, k, v, grid, dout), iters=3)
    k3_plain = cuda_time_ms(lambda: corr.correlation_bwd_cols_plain(q, k, v, grid, dout), iters=3)
    torch.cuda.empty_cache()

    vg = torch.cat([v, grid.expand(B, HW, 2), v.new_zeros(B, HW, 6)], dim=-1)[:, None]
    qh, kh, vh = (t.detach().requires_grad_(True) for t in (q[:, None], k[:, None], vg))
    o = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
    do = torch.cat([dout[..., :C + 2], dout.new_zeros(B, HW, 6)], dim=-1)[:, None].to(o.dtype)
    library_ms = cuda_time_ms(
        lambda: torch.autograd.grad(o, (qh, kh, vh), do, retain_graph=True), iters=10)

    common = _nbytes(q, k, v, grid, dout, rows.stats, rows.amax)
    k2_bound_ms, k2_by = k2_bound(B, HW, C, C, dtype, common + _nbytes(out) + B * HW * C * 4)
    k3_bound_ms, k3_by = k3_bound(B, HW, C, C, dtype, common + 2 * B * HW * C * 4)
    shape = f"B={B} HW={HW} C={C} {dtype}, design {design}"
    log(f"[kernel] K2 {shape}: err {k2_err:.3g}; kernel_ms={k2_ms:.3f} "
        f"plain_ms={k2_plain:.3f} bound_ms={k2_bound_ms:.4f} ({k2_by}), "
        f"{100 * k2_bound_ms / k2_ms:.1f}% of its bound")
    log(f"[kernel] K3 {shape}: err {k3_err:.3g}; kernel_ms={k3_ms:.3f} "
        f"plain_ms={k3_plain:.3f} bound_ms={k3_bound_ms:.4f} ({k3_by}), "
        f"{100 * k3_bound_ms / k3_ms:.1f}% of its bound")
    log(f"[kernel] K2+K3 {k2_ms + k3_ms:.3f} ms; library (attention backward) "
        f"{library_ms:.3f} ms")
    k2 = {"ms": k2_ms, "plain_ms": k2_plain, "library_ms": library_ms,
          "library_covers": "K2+K3", "bound_ms": k2_bound_ms, "bound_by": k2_by,
          "max_abs_err": k2_err, "shape": shape, "design": design}
    k3 = {"ms": k3_ms, "plain_ms": k3_plain, "library_ms": library_ms,
          "library_covers": "K2+K3", "bound_ms": k3_bound_ms, "bound_by": k3_by,
          "max_abs_err": k3_err, "shape": shape, "design": design}
    return k2, k3


def phase_kernel_timing() -> dict:
    """K1 at the inference shape (batch 64) and K1, K2, K3 at the training
    shape of 3d3d.yaml (batch 10)."""
    from mapfree_tpu_torch.ops import correlation as corr

    k1 = time_k1(64, 92, 68, 32, "bfloat16", seed=100)
    k1["train_shape"] = time_k1(10, 92, 68, 32, "bfloat16", seed=101)
    k2, k3 = time_backward(10, 92, 68, 32, "bfloat16", seed=102)
    return {corr.KERNEL: k1, corr.KERNEL_BWD_ROWS: k2, corr.KERNEL_BWD_COLS: k3}


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
    """The inference sweep. Returns K1's launches in the measured sweep."""
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
    corr.reset_launches()
    t0 = time.perf_counter()
    results = predict(batches, model, times)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = corr.launches[corr.KERNEL]
    if corr.launches[corr.KERNEL_BWD_ROWS] or corr.launches[corr.KERNEL_BWD_COLS]:
        raise AssertionError("the inference sweep launched a backward kernel")
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
    profile_window(lambda: model.dispatch_device(transferred)(), "forward")
    return launches


def profile_window(fn, what: str, n: int = 3) -> None:
    """Device time by kernel over ``n`` calls of ``fn`` (a forward or a train
    step on a batch already on the device), and the share of the window the
    device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    totals: dict = {}
    events = list(prof.events())
    host_names = {evt.name for evt in events if evt.device_type != DeviceType.CUDA}
    ranges_us = 0.0
    for evt in events:  # device-side events only: the kernels and copies
        if evt.device_type == DeviceType.CUDA:
            if evt.name in host_names:
                # a host annotation mirrored on the device's timeline (the
                # optimizer's step): a range over kernels counted below
                ranges_us += evt.time_range.elapsed_us()
                continue
            us, count = totals.get(evt.name, (0.0, 0))
            totals[evt.name] = (us + evt.time_range.elapsed_us(), count + 1)
    rows = [(us, count, name) for name, (us, count) in totals.items()]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {n} {what}s: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), {len(rows)} kinds of "
        f"kernel, {sum(r[1] for r in rows) // n} launches per {what}; annotation ranges "
        f"left out: {ranges_us / 1e3:.2f} ms")
    for rank, (us, count, key) in enumerate(rows):
        if rank < 15 or "correlation_" in key:  # this package's kernels wherever they rank
            log(f"[profile] {us / 1e3 / n:9.3f} ms/{what} {100 * us / busy:5.1f}%  "
                f"x{count // n:<4d} {key[:90]}")


# -- phase 5 -----------------------------------------------------------------

def train_batches(n: int, batch: int, H: int, W: int, seed: int, last: int = 0) -> list:
    """Collated training batches: uint8 RGB noise pairs with random
    unit-quaternion poses (``image0``, ``image1`` [B, H, W, 3], ``T_0to1``
    [B, 4, 4] float64 as the dataset yields it). ``last`` > 0 makes the final
    batch ragged."""
    from mapfree_tpu_torch.geom.quaternion import quat2mat

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        B = last if last and i == n - 1 else batch
        q = rng.normal(size=(B, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        T = np.tile(np.eye(4), (B, 1, 1))
        T[:, :3, :3] = quat2mat(q)
        T[:, :3, 3] = rng.normal(size=(B, 3)) * 0.1
        out.append({"image0": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
                    "image1": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
                    "T_0to1": T})
    return out


def _expect_launches(corr, expected: dict, what: str) -> None:
    got = dict(corr.launches)
    if got != expected:
        raise AssertionError(f"{what}: kernel launches {got}, expected {expected}")


def phase_train_path() -> dict:
    """The training path at full width. Returns each kernel's launches in the
    fit loop's run."""
    import torch

    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train import (CheckpointManager, init_state, make_train_step,
                                         make_val_step, run_validation)
    from mapfree_tpu_torch.train.fit import _device_batch, fit_loaders

    # the model and optimizer settings are 3d3d.yaml's; only the run's length
    # is set here: one epoch of 8 batches, validation twice over 2 batches
    cfg = load_cfg({"TPU.SEED": SEED, "TRAINING.EPOCHS": 1, "TRAINING.VAL_INTERVAL": 0.5,
                    "TRAINING.VAL_BATCHES": 2, "TRAINING.LOG_INTERVAL": 1})
    H, W, bs = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, int(cfg.TRAINING.BATCH_SIZE)
    log(f"[train] 3d3d: batch {bs}, {H}x{W}, {cfg.TPU.COMPUTE_DTYPE}, "
        f"{cfg.TRAINING.ROT_LOSS} + {cfg.TRAINING.LAMBDA} * {cfg.TRAINING.TRANS_LOSS}, "
        f"Adam LR {cfg.TRAINING.LR}, clip {cfg.TRAINING.GRAD_CLIP}")
    dev = torch.device("cuda", 0)

    # (a) steps through init_state -> make_train_step on batches already on
    # the device: time, memory, losses
    net = build_regression_net(cfg)
    state = init_state(net, cfg, torch.Generator().manual_seed(SEED), device=dev)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    train_step = make_train_step(net, cfg)
    n_warm, n_steps = 3, 10
    dbatches = [_device_batch(b, dev, bs)
                for b in train_batches(n_warm + n_steps, bs, H, W, seed=SEED + 10)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in dbatches[:n_warm]:
        state, _ = train_step(state, b)
    torch.cuda.synchronize()
    corr.reset_launches()
    logs = []
    t0 = time.perf_counter()
    for b in dbatches[n_warm:]:
        state, step_logs = train_step(state, b)
        logs.append(step_logs)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    _expect_launches(corr, {corr.KERNEL: n_steps, corr.KERNEL_BWD_ROWS: n_steps,
                            corr.KERNEL_BWD_COLS: n_steps}, f"{n_steps} train steps")
    losses = [float(lg["train/loss"]) for lg in logs]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {n_steps} steps after {n_warm} warm-up: {step_ms:.2f} ms/step, "
        f"{1e3 * bs / step_ms:.1f} samples/s; peak memory {peak_gb:.2f} GB; K1, K2, K3 "
        f"each launched {n_steps} times")
    log("[train] loss per step: " + " ".join(f"{x:.4f}" for x in losses)
        + "; R_loss " + " ".join(f"{float(lg['train/R_loss']):.3f}" for lg in logs)
        + "; t_loss " + " ".join(f"{float(lg['train/t_loss']):.3f}" for lg in logs))
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    after = net.state_dict()
    for key in ("encoder.firstconv.weight", "head.mlp.4.weight", "encoder.firstbn.running_mean",
                "encoder.firstbn.running_var", "head.resblock4.bn2.running_var"):
        if torch.equal(after[key], before[key]):
            raise AssertionError(f"{key} did not change in {n_warm + n_steps} train steps")
    del before
    batch = dbatches[-1]
    del dbatches

    def one_step():
        train_step(state, batch)

    profile_window(one_step, "train step")
    del state, net, train_step
    torch.cuda.empty_cache()

    # (b) the fit loop: loaders of numpy batches, validation, checkpoints
    train_loader = train_batches(8, bs, H, W, seed=SEED + 11, last=7)
    val_loader = train_batches(3, bs, H, W, seed=SEED + 12)
    with tempfile.TemporaryDirectory() as tmp:
        corr.reset_launches()
        captured = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured):
            state = fit_loaders(cfg, train_loader, val_loader, experiment="smoke",
                                weights_dir=tmp, device=dev)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(corr.launches)
        for line in captured.getvalue().splitlines():
            log(f"[fit]   {line}")
        # 8 train steps; validation at steps 4 and 8 over 2 of the 3 batches
        _expect_launches(corr, {corr.KERNEL: 8 + 2 * 2, corr.KERNEL_BWD_ROWS: 8,
                                corr.KERNEL_BWD_COLS: 8}, "the fit loop")
        records = [json.loads(ln) for ln in
                   (Path(tmp) / "smoke" / "scalars.jsonl").read_text().splitlines()]
        train_losses = [r["train/loss"] for r in records if "train/loss" in r]
        val_losses = [r["val_loss/loss"] for r in records if "val_loss/loss" in r]
        if len(train_losses) != 8 or len(val_losses) != 2 or state.step != 8:
            raise AssertionError("the fit loop did not take 8 steps with 2 validations")
        if not (np.all(np.isfinite(train_losses)) and np.all(np.isfinite(val_losses))):
            raise AssertionError("non-finite loss in the fit loop")
        ckpts = CheckpointManager(Path(tmp) / "smoke")
        files = sorted(p.name for p in (Path(tmp) / "smoke").glob("*.pt"))
        if files != ["last.pt", "step_4.pt", "step_8.pt"]:
            raise AssertionError(f"checkpoints written: {files}")

        # the restored 'last' checkpoint reproduces the validation loss
        val_step = make_val_step(state.net, cfg)
        vbatches = [_device_batch(b, dev, bs) for b in val_loader[:2]]
        ref = run_validation(val_step, state, vbatches)["val_loss/loss"]
        other = build_regression_net(cfg)
        restored = init_state(other, cfg, torch.Generator().manual_seed(SEED + 99), device=dev)
        untrained = run_validation(make_val_step(other, cfg), restored, vbatches)["val_loss/loss"]
        restored = ckpts.restore(restored, tag="last")
        got = run_validation(make_val_step(other, cfg), restored, vbatches)["val_loss/loss"]
    log(f"[fit] 8 steps, 2 validations, 3 checkpoints in {elapsed:.2f} s; launches {launches}; "
        f"validation loss {ref:.6f} (logged at step 8: {val_losses[-1]:.6f}), from the "
        f"restored 'last' checkpoint {got:.6f}, from another seed's weights {untrained:.6f}")
    if restored.step != 8 or abs(got - ref) > 1e-6 * abs(ref) \
            or abs(val_losses[-1] - ref) > 1e-6 * abs(ref):
        raise AssertionError("the restored checkpoint does not reproduce the validation loss")
    if abs(untrained - ref) < 1e-3 * abs(ref):
        raise AssertionError("the validation loss does not depend on the weights")
    return launches


# -- phase 6 -----------------------------------------------------------------

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


@contextlib.contextmanager
def plain_versions_on_the_card(forward: bool = True):
    """Inside the block the correlation Function computes the plain versions
    on CUDA tensors too (and counts no launch for them): the yardstick for a
    whole train step. With ``forward=False`` K1 still runs and only the
    backward is the plain one, so that the two steps share their forward to
    the bit. Used here only; the port has no such switch."""
    from mapfree_tpu_torch.ops import correlation as corr

    saved = corr._forward_cuda, corr.correlation_bwd_rows, corr.correlation_bwd_cols
    if forward:
        corr._forward_cuda = corr._plain_buffer
    corr.correlation_bwd_rows = lambda q, k, v, grid, out, dout: (
        corr.correlation_bwd_rows_plain(q, k, v, grid, dout)[0], None)
    corr.correlation_bwd_cols = lambda q, k, v, grid, dout, rows: (
        corr.correlation_bwd_cols_plain(q, k, v, grid, dout))
    try:
        yield
    finally:
        corr._forward_cuda, corr.correlation_bwd_rows, corr.correlation_bwd_cols = saved


def _grad_errors(got: dict, ref: dict) -> tuple:
    """(per-tensor max error as a share of the tensor's largest entry, sorted
    descending with names; relative L2 error of the whole gradient)."""
    import torch

    per = []
    for key, g in ref.items():
        scale = max(float(g.abs().max()), STEP_GRAD_FLOOR / STEP_GRAD_TOL)
        per.append((float((got[key] - g).abs().max()) / scale, key))
    per.sort(reverse=True)
    diff = torch.sqrt(sum(((got[k] - g).double() ** 2).sum() for k, g in ref.items()))
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in ref.values()))
    return per, float(diff / norm)


def phase_train_parity() -> None:
    """One float32 train step (clip 1.0, as the JAX package's tiny test
    config) on the card with K1, K2, K3, against the same step with the plain
    versions on the card and on the CPU, same weights and batch; then 8 steps
    on one batch at LR 1e-3 must lower the loss on the card."""
    import torch

    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train import init_state, make_train_step
    from mapfree_tpu_torch.train.fit import _device_batch

    cfg = load_cfg({"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96,
                    "DATASET.WIDTH": 72, "TRAINING.BATCH_SIZE": 4, "TRAINING.LR": 1e-3,
                    "TRAINING.GRAD_CLIP": 1.0, "TPU.COMPUTE_DTYPE": "float32",
                    "TPU.SEED": SEED})
    batch = train_batches(1, 4, 96, 72, seed=SEED + 20)[0]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    loss, grads, states = {}, {}, {}

    def one_step(name, dev):
        net = build_regression_net(cfg)
        states[name] = init_state(net, cfg, torch.Generator().manual_seed(SEED), device=dev)
        step = make_train_step(net, cfg)
        states[name], logs = step(states[name], _device_batch(batch, torch.device(dev), 4))
        loss[name] = float(logs["train/loss"])
        grads[name] = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}

    corr.reset_launches()
    one_step("kernels", "cuda")
    _expect_launches(corr, {corr.KERNEL: 1, corr.KERNEL_BWD_ROWS: 1, corr.KERNEL_BWD_COLS: 1},
                     "one train step on the card")
    with plain_versions_on_the_card():
        one_step("plain", "cuda")
    one_step("cpu", "cpu")
    _expect_launches(corr, {corr.KERNEL: 1, corr.KERNEL_BWD_ROWS: 1, corr.KERNEL_BWD_COLS: 1},
                     "the plain steps")
    if not (torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("the float32 train step changed the process's TF32 settings")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    per, l2 = _grad_errors(grads["kernels"], grads["plain"])
    rel = abs(loss["kernels"] - loss["plain"]) / abs(loss["plain"])
    log(f"[parity] float32 train step, kernels vs plain versions on the card: loss "
        f"{loss['kernels']:.6f} vs {loss['plain']:.6f} (rel {rel:.2e}, tol {STEP_LOSS_RTOL:g}); "
        f"worst gradient {per[0][0]:.2e} of its tensor's largest entry at {per[0][1]} "
        f"(tol {STEP_GRAD_TOL:g}); whole gradient {l2:.2e} in L2; {len(per)} tensors")
    if rel > STEP_LOSS_RTOL or per[0][0] > STEP_GRAD_TOL:
        raise AssertionError("the train step with the kernels disagrees with the plain versions")

    per, l2 = _grad_errors(grads["kernels"], grads["cpu"])
    rel = abs(loss["kernels"] - loss["cpu"]) / abs(loss["cpu"])
    median = per[len(per) // 2][0]
    log(f"[parity] float32 train step, GPU vs CPU: loss {loss['kernels']:.6f} vs "
        f"{loss['cpu']:.6f} (rel {rel:.2e}, tol {STEP_LOSS_RTOL:g}); whole gradient {l2:.2e} "
        f"in L2 (tol {STEP_CPU_L2_TOL:g}); median tensor {median:.2e} of its largest entry "
        f"(tol {STEP_CPU_MEDIAN_TOL:g}); worst tensor {per[0][0]:.2e} at {per[0][1]} "
        f"(branch flips at ReLU and max-pool inputs within round-off of zero)")
    if rel > STEP_LOSS_RTOL or l2 > STEP_CPU_L2_TOL or median > STEP_CPU_MEDIAN_TOL:
        raise AssertionError("the GPU and CPU train steps disagree")

    state = states["kernels"]
    step = make_train_step(state.net, cfg)
    dbatch = _device_batch(batch, torch.device("cuda"), 4)
    losses = []
    for _ in range(8):
        state, logs = step(state, dbatch)
        losses.append(float(logs["train/loss"]))
    log("[parity] 8 steps on one batch at LR 1e-3: loss " + " ".join(f"{x:.4f}" for x in losses))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("8 steps on one batch did not lower the loss")


def phase_train_parity_bf16() -> None:
    """One bf16 train step of the small model on the card with K1 and the
    tensor-core K2 and K3, against the same step with the plain versions on
    the card: the loss and the whole gradient in the L2 norm. A second run of
    the kernels' step gives the floor."""
    import torch

    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train import init_state, make_train_step
    from mapfree_tpu_torch.train.fit import _device_batch

    cfg = load_cfg({"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96,
                    "DATASET.WIDTH": 72, "TRAINING.BATCH_SIZE": 4, "TRAINING.LR": 1e-3,
                    "TRAINING.GRAD_CLIP": 1.0, "TPU.COMPUTE_DTYPE": "bfloat16",
                    "TPU.SEED": SEED})
    batch = train_batches(1, 4, 96, 72, seed=SEED + 21)[0]
    loss, grads = {}, {}

    def one_step(name):
        net = build_regression_net(cfg)
        state = init_state(net, cfg, torch.Generator().manual_seed(SEED), device="cuda")
        _, logs = make_train_step(net, cfg)(state, _device_batch(batch, torch.device("cuda"), 4))
        loss[name] = float(logs["train/loss"])
        grads[name] = {k: p.grad.detach().float().cpu() for k, p in net.named_parameters()}

    designs = []
    rows_kernel = corr.correlation_bwd_rows

    def rows_noting_the_design(q, k, v, grid, out, dout):
        designs.append(corr.backward_design(q.dtype, q.shape[-1], v.shape[-1]))
        return rows_kernel(q, k, v, grid, out, dout)

    corr.reset_launches()
    corr.correlation_bwd_rows = rows_noting_the_design
    try:
        one_step("kernels")
    finally:
        corr.correlation_bwd_rows = rows_kernel
    one_step("again")
    _expect_launches(corr, {corr.KERNEL: 2, corr.KERNEL_BWD_ROWS: 2, corr.KERNEL_BWD_COLS: 2},
                     "two bf16 train steps on the card")
    if designs != [corr.DESIGN_MMA]:
        raise AssertionError(f"the bf16 train step's backward ran the designs {designs}")
    with plain_versions_on_the_card(forward=False):
        one_step("plain_backward")
    with plain_versions_on_the_card():
        one_step("plain")

    _, floor = _grad_errors(grads["again"], grads["kernels"])
    per_b, l2_b = _grad_errors(grads["kernels"], grads["plain_backward"])
    per, l2 = _grad_errors(grads["kernels"], grads["plain"])
    rel = abs(loss["kernels"] - loss["plain"]) / abs(loss["plain"])
    log(f"[parity] bf16 train step, tensor-core K2 and K3 vs the plain backward after the same "
        f"K1 forward: loss {loss['kernels']:.6f} vs {loss['plain_backward']:.6f}; whole "
        f"gradient {l2_b:.2e} in L2 (tol {STEP_BF16_BWD_L2_TOL:g}); worst tensor "
        f"{per_b[0][0]:.2e} of its largest entry at {per_b[0][1]}, median tensor "
        f"{per_b[len(per_b) // 2][0]:.2e}; a second run of the kernels' step differs by "
        f"{floor:.2e} in L2")
    log(f"[parity] bf16 train step, kernels vs plain versions on the card, forward too: loss "
        f"{loss['kernels']:.6f} vs {loss['plain']:.6f} (rel {rel:.2e}, tol "
        f"{STEP_BF16_LOSS_RTOL:g}); whole gradient {l2:.2e} in L2 (tol {STEP_BF16_L2_TOL:g}); "
        f"worst tensor {per[0][0]:.2e} at {per[0][1]}, median tensor "
        f"{per[len(per) // 2][0]:.2e}")
    if loss["kernels"] != loss["plain_backward"]:
        raise AssertionError("two bf16 steps with the same K1 forward differ in the loss")
    if not (np.isfinite(loss["kernels"]) and rel <= STEP_BF16_LOSS_RTOL
            and l2_b <= STEP_BF16_BWD_L2_TOL and l2 <= STEP_BF16_L2_TOL):
        raise AssertionError("the bf16 train step with the kernels disagrees with the plain "
                             "versions")


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
    if "--kernels-only" in sys.argv[1:]:
        # a quick check while working on a kernel; prints no result line
        phase_kernel_timing()
        log(f"[done] kernels only, {time.perf_counter() - t_start:.1f} s")
        return
    timing = phase_kernel_timing()
    sweep_launches = phase_main_path()
    train_launches = phase_train_path()
    phase_device_parity()
    phase_train_parity()
    phase_train_parity_bf16()

    from mapfree_tpu_torch.ops import correlation as corr

    by_path = {name: {"train_loop": n} for name, n in train_launches.items()}
    by_path[corr.KERNEL]["inference_sweep"] = sweep_launches
    kernels = []
    for name, source, replaces in (
            (corr.KERNEL, "correlation_fwd.cu", 60),
            (corr.KERNEL_BWD_ROWS, "correlation_bwd.cu", 109),
            (corr.KERNEL_BWD_COLS, "correlation_bwd.cu", 148)):
        t = timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"mapfree_tpu_torch/ops/csrc/{source}",
            "replaces": f"mapfree_tpu/ops/correlation.py:{replaces}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            **t,
            "cases": cases[name],
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
