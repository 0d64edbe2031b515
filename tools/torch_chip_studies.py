#!/usr/bin/env python3
"""Measurements of the PyTorch port on one NVIDIA GPU that chip_smoke.py
does not repeat on every run. From the root of a checkout:

    python3 tools/torch_chip_studies.py decode-threads
    python3 tools/torch_chip_studies.py bf16-seeds
    python3 tools/torch_chip_studies.py bf16-faults
    python3 tools/torch_chip_studies.py upsample-ab
    python3 tools/torch_chip_studies.py sweep-determinism
    python3 tools/torch_chip_studies.py decode-under-load [CHECKOUT ...]
    python3 tools/torch_chip_studies.py mesh-faults
    python3 tools/torch_chip_studies.py wide-unscaled
    python3 tools/torch_chip_studies.py k1-variants
    python3 tools/torch_chip_studies.py k1-wgmma-variants [SHAPE WORD ...]
    python3 tools/torch_chip_studies.py k1-fma-variants
    python3 tools/torch_chip_studies.py k1-fma-edits
    python3 tools/torch_chip_studies.py f32-checkouts [CHECKOUT ...]
    python3 tools/torch_chip_studies.py k23-fma-variants
    python3 tools/torch_chip_studies.py k23-mma-variants
    python3 tools/torch_chip_studies.py k23-wgmma-variants [SHAPE WORD ...]
    python3 tools/torch_chip_studies.py k23-narrow-variants [SHAPE WORD ...]
    python3 tools/torch_chip_studies.py bwd-checkouts [CHECKOUT ...]

decode-threads: wall time of data/jpeg.py::decode_resize_batch for 64 frames
of the 540x720 fixtures (tests/data/torch_port/) to 270x360 planar YUV420,
with 1, 2, 4 and 8 host decode threads (the mean of 5 batches after one).

k1-wgmma-variants: K1's tensor-core kernels at every shape a driven path
gives them (C = 32 at B = 64, 10 and 576 and on ScanNet's 80x60 grid, C = 128
at B = 10 and 64, Cq 256 / Cv 96, C = 256, C = 1,024 on the ResNet's 5x4
grid): instantiations of the wgmma kernel and of the mma.sync kernel, built
from a file that includes the .cu, each held to the package's bits, timed in
turns; words after the name keep the shapes whose names contain one.

bf16-seeds: chip_smoke.py phase 6's bf16 train-step comparison of the small
3d3d model (1-1-1 blocks, 96x72, batch 4) over six (batch, weight) seeds:
the kernels' step against the plain backward after the same K1 forward, and
against the plain versions with the forward too (K1's bf16 rounding of P),
the whole gradient in L2, once with the ResUNet's upsample in bf16 (the
port's) and once with F.interpolate in float32 (the port before it).

bf16-faults: the same comparison, forward too, with faults planted in K1
(:data:`FAULTS`): the forward K1's wrapper returns is replaced by one that
errs in one way, K2 and K3 run on it, and the step is held to the sound plain
versions over the same six seeds, beside the sound K1's reading. It shows
which faults phase 6's limits (STEP_BF16_L2_TOL, STEP_BF16_LOSS_RTOL) catch,
and first whether phase 3's check of K1 alone (chip_smoke.py::forward_case
and check_forward) catches each, at two of its bf16 shapes.

upsample-ab: the 3d3d model of chip_smoke.py phase 4 (batch 64, bf16, random
weights) in one process with the ResUNet's upsample as the port computes it
(two matmuls in bf16) and as F.interpolate under autocast (float32, the port
before it), alternated over four rounds: the forward by CUDA events, the
host's time to issue one forward, and the sweep from memory (pairs/s and its
dispatch stage) over the phase's synthetic pairs.

sweep-determinism: the 3d3d submission CLI (random weights, bf16) over
chip_smoke.py phase 8's tree of 320 pairs, run again and again in one
process: with cuDNN's default engines and the sweep's four transfer
workers, with one transfer worker, and with
torch.backends.cudnn.deterministic; each run's poses against the first
run's of its setting (the number of runs with other bits, and the largest
difference: rotation angle in radians, t relative to max(1, |t|)).

decode-under-load: 64 frames of the fixtures decoded to 270x360 uint8 by
data/jpeg.py while 60 float32 4096^2 products are queued on the card,
three times, against the same batch decoded on an idle card: the frames
that differ. For this checkout and for each other CHECKOUT given (a
directory holding a mapfree_tpu_torch/, e.g. a parent commit unpacked with
git archive), each in a process of its own.

mesh-faults: chip_smoke.py phase 16 (c), two gloo ranks sharing the card on
one float32 3d3d step at full width against one process, with faults
planted in the ranks (:data:`MESH_FAULTS`), beside the sound mesh: each
held to the phase's limits (MESH_NOISE_FACTOR times the step on the batch
in reverse order), naming the limits it fails.

wide-unscaled: float32 K1, K2 and K3 at Cq = Cv = 1,024 with q and k not
scaled (scores reach some 100) against their plain versions, six seeds at
HW 20, 70 and 1,000 (phase 3's three unscaled cases are among them), then
K1 with its last 128-channel chunk skipped and with q and k in bf16.

k1-variants: instantiations of K1's tensor-core kernel that its dispatch
(ops/csrc/correlation_fwd.cu::dispatch_mma) could take at the wide shapes
(:data:`K1_VARIANTS`: channels a q tile, v channels a column tile, q
streamed or resident, m-tiles a warp, warps a block, blocks a SM, ring
stages), built into a temporary directory from a file that includes the
checkout's correlation_fwd.cu, each with ptxas's registers and spills, held
to the package's K1 on the same inputs (equal bits: every variant sums in
the same order) and timed by CUDA events, the package's own launch first.

k1-fma-variants: the same for K1's FMA design (float32, and bf16 widths that
are not multiples of 8; ops/csrc/correlation_fwd.cu::dispatch_fma): long-rows
instantiations (:data:`K1_FMA_ROWS`: channels a k^T chunk, q^T streamed or
resident, 4-column groups a column tile, row and key halves a block, ring
stages, blocks a SM) at the 3d3d grid in float32 at B=64 and B=10, and the
few-rows kernel's column tiles (:data:`K1_FMA_SHORT`) at the ResNet
bottleneck's 1,024 channels on its 5x4 grid at B=64, each held to the exact
plain forward (max |kernel - plain| at most 5e-5) and timed by CUDA events
and from a CUDA graph (the device's time alone, which the host's time to
issue a call hides at the small shapes), beside the package's dispatch and
float32 attention (TF32 off).

k1-fma-edits: the FMA design's long-rows kernel against edits of its own
source that no template argument reaches (:data:`K1_FMA_EDITS`: the row max
reduced on every tile instead of lazily, loops unrolled otherwise), each a
copy of ops/csrc/ that a text edit changes, all built at once, held to the
exact plain forward and timed at the 3d3d grid in float32 (B=64, B=10) beside
the unedited source, in two rounds of opposite order.

f32-checkouts: chip_smoke.py phase 17 (the float32 3d3d and ResNet sweeps:
forward ms, K1's ms in it, pairs/s) and phase 11's float32 ResNet train step
with the kernels against the plain versions at three batch seeds (worst
gradient as a share of its tensor's largest entry, loss), by this checkout's
chip_smoke.py over the package of each checkout: this one and each CHECKOUT
given (e.g. a parent unpacked with git archive), in the order given, then
again in reverse, each in a process of its own.

k23-fma-variants: K2 and K3's FMA design (ops/csrc/correlation_bwd.cu::
dispatch_rows, dispatch_cols) against instantiations its dispatch could take:
long-rows tiles (:data:`K23_FMA_ROWS`, :data:`K23_FMA_COLS`: own and
streamed halves of the register tile, column tiles, ring stages, blocks a
SM) at the 3d3d grid in float32 at B=10 and at Cq 256 / Cv 96 in bf16, and
the few-rows pair's score tiles, its ring, its split of the threads between
the scores and dP, and its column tiles (:data:`K23_FMA_SHORT`) at the ResNet
bottleneck's 1,024 channels on its 5x4 grid at B=10 in float32 and bf16.
Built into a temporary directory from a file that includes the checkout's
correlation_bwd.cu, each with ptxas's registers and spills; each K2 variant
given the exact forward's buffer and held to the exact plain backward (1e-4
of the largest gradient) with the package's row max and argmax to the bit,
each K3 variant given the package's K2 statistics and held the same way;
timed by CUDA events and from a CUDA graph (the device's time alone), beside
the package's dispatch and the backward of float32 attention (TF32 off).

k23-mma-variants: K2 and K3's tensor-core design (ops/csrc/correlation_bwd_mma.cu::
dispatch_rows_mma, dispatch_cols_mma) against instantiations its dispatch
could take (:data:`K23_MMA_VARIANTS`: own tiles resident with m-tiles,
warps, blocks a SM, ring stages, A fragments in registers or shared memory;
streamed with column tiles of 64 or 128) at C=32 (3d3d grid,
B=10 and 90), C=128 (B=10), Cq 256 / Cv 96 (B=10) and 1,024 channels (HW 20
and 1,000, B=10). Built into a temporary directory from a file that includes
the checkout's correlation_bwd_mma.cu, each with ptxas's registers and
spills; the package's pair is held to the plain backward with its roundings on two
batch rows, each variant to the package's outputs (equal bits: every
instantiation sums in the same order; else the matched tolerance), K3's given
the package's K2 outputs; timed by CUDA events, at HW 20 from CUDA graphs
(the device alone) beside the FMA few-rows pair on the same inputs, with the
backward of scaled_dot_product_attention.

k23-wgmma-variants: the wgmma kernels of K2 and K3's tensor-core design at
every shape a driven bf16 path gives the pair (the 3d3d grid at C = 128, Cq
256 / Cv 96 and C = 256, B = 10): instantiations (:data:`K23_WGMMA_VARIANTS`: column tiles, consumer
warpgroups, ring stages, blocks a SM, keys or rows a pass; the dispatch's
first) built from a file that includes the checkout's
correlation_bwd_wgmma.cu, with ptxas's registers, spills and every
instantiation whose wgmma it serialised; each K2 given the exact forward's
buffer and each K3 the package's K2 outputs, held to the package's bits
(else to the matched tolerance), timed by CUDA events in turns (the list,
then again in reverse) beside the package's mma.sync pair (its bits
compared) and the backward of scaled_dot_product_attention; words after the
name keep the shapes whose names contain one.

k23-narrow-variants: the same for the narrow pair
(correlation_bwd_narrow.cu, :data:`K23_NARROW_VARIANTS`: consumer
warpgroups, ring stages, blocks a SM, keys or rows a pass) at the 3d3d grid
at C = 32 (B = 10 and 90), 16 / 32, 16 and 64 (B = 10). Where the mma.sync
pair measures faster, ops/correlation.py::MMA_SYNC_FASTER keeps it.

bwd-checkouts: K2 and K3 through the package's wrapper at the shapes phase 3
times them (bf16 at the 3d3d grid at C=32, B=10 and 90, and C=128, B=10;
float32 3d3d grid at B=10; 1,024 channels on the 5x4 grid at B=10 in float32
and bf16, there also from a CUDA graph; Cq 256 / Cv 96 bf16 at the 3d3d
grid), each given the exact forward's buffer and held to the exact plain
backward on two batch rows at the tolerance of the design that served it, by this
checkout's chip_smoke.py over the package of each checkout: this one and each
CHECKOUT given (e.g. a parent unpacked with git archive), in the order given,
then again in reverse, each in a process of its own.

Each line carries the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SEEDS = ((21, 0), (22, 0), (23, 0), (21, 1), (21, 2), (24, 3))  # (batch, weights)
# faults planted in K1's forward for bf16-faults: keyword arguments of
# faulty_forward, each one way a tensor-core K1 could go wrong
FAULTS = {
    "P not rounded to bf16": dict(round_p=False),
    "denominator summed from the bf16 P": dict(d_from_rounded=True),
    "normaliser 1% small": dict(scale=1.01),
    "accumulator not rescaled on a new max": dict(rescale=False),
    "last key tile skipped": dict(drop_last=True),
    "grid read one key off": dict(grid_shift=1),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def decode_threads() -> None:
    import torch

    from mapfree_tpu_torch.data import jpeg

    frames = sorted((REPO / "tests" / "data" / "torch_port").glob("frame_*.jpg"))
    batch = [str(frames[i % len(frames)]) for i in range(64)]
    for threads in (1, 2, 4, 8):
        jpeg.DECODE_THREADS = threads
        jpeg._decoder = None  # a new pool (and decode states) of that size
        jpeg.decode_resize_batch(batch, 270, 360, yuv420=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            jpeg.decode_resize_batch(batch, 270, 360, yuv420=True)
        ms = 1e3 * (time.perf_counter() - t0) / 5
        print(f"[{card()}] decode 64 frames 540x720 -> 270x360 yuv420, {threads} threads: "
              f"{ms:.2f} ms per batch, {64e3 / ms:.1f} frames/s", flush=True)


def bf16_seeds() -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from mapfree_tpu_torch.models import blocks
    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train import init_state, make_train_step
    from mapfree_tpu_torch.train.fit import _device_batch

    _build.load_libraries(corr.LIBRARIES)

    def grads_of(cfg, batch, init_seed):
        net = build_regression_net(cfg)
        state = init_state(net, cfg, torch.Generator().manual_seed(init_seed), device="cuda")
        make_train_step(net, cfg)(state, _device_batch(batch, torch.device("cuda"), 4))
        return {k: p.grad.detach().float().cpu() for k, p in net.named_parameters()}

    def interpolate_f32(x, out_hw):
        return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=True)

    bf16_upsample = blocks.resize_bilinear_align_corners
    for name, upsample in (("bf16 upsample", bf16_upsample),
                           ("float32 upsample", interpolate_f32)):
        blocks.resize_bilinear_align_corners = upsample
        try:
            for batch_seed, init_seed in SEEDS:
                cfg = cs.load_cfg({"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96,
                                   "DATASET.WIDTH": 72, "TRAINING.BATCH_SIZE": 4,
                                   "TRAINING.LR": 1e-3, "TRAINING.GRAD_CLIP": 1.0,
                                   "TPU.COMPUTE_DTYPE": "bfloat16", "TPU.SEED": init_seed})
                batch = cs.train_batches(1, 4, 96, 72, seed=batch_seed)[0]
                kernels = grads_of(cfg, batch, init_seed)
                with cs.plain_versions_on_the_card(forward=False):
                    plain_backward = grads_of(cfg, batch, init_seed)
                with cs.plain_versions_on_the_card():
                    plain = grads_of(cfg, batch, init_seed)
                _, l2_b = cs._grad_errors(kernels, plain_backward)
                per, l2 = cs._grad_errors(kernels, plain)
                print(f"[{card()}] {name}, batch seed {batch_seed}, weight seed {init_seed}: "
                      f"plain backward {l2_b:.3e} in L2, forward too {l2:.3e} in L2 "
                      f"(worst {per[0][0]:.2e} at {per[0][1]})", flush=True)
        finally:
            blocks.resize_bilinear_align_corners = bf16_upsample


def faulty_forward(q, k, v, grid, round_p=True, d_from_rounded=False, scale=1.0,
                   rescale=True, drop_last=False, grid_shift=0):
    """K1's [B, HW, Cv + 3] float32 buffer by its tensor-core arithmetic
    (ops/correlation.py::_tiled_buffer with bf16_roundings), with one fault:
    P left unrounded, the denominator summed from the rounded P, the buffer
    scaled (a normaliser off by ``scale``), the accumulator and denominator
    not rescaled when the running max grows, the last key tile skipped, or
    the grid read ``grid_shift`` keys off."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    B, HW, _ = q.shape
    tile = corr.FWD_KEY_TILE
    grid = grid.expand(B, HW, 2).roll(grid_shift, dims=1) if grid_shift else grid
    vg = torch.cat([v, grid.to(v.dtype).expand(B, HW, 2)], dim=-1).float()
    qf, kf = q.float(), k.float()
    m = qf.new_full((B, HW, 1), float("-inf"))
    d = qf.new_zeros((B, HW, 1))
    acc = qf.new_zeros((B, HW, vg.shape[-1]))
    end = (HW - 1) // tile * tile if drop_last and HW > tile else HW
    for j0 in range(0, end, tile):
        s = torch.bmm(qf, kf[:, j0:min(j0 + tile, end)].transpose(1, 2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new) if rescale else torch.ones_like(m)
        p = torch.exp(s - m_new)
        p_r = p.to(torch.bfloat16).float() if round_p else p
        d = d * alpha + (p_r if d_from_rounded else p).sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.bmm(p_r, vg[:, j0:min(j0 + tile, end)])
        m = m_new
    inv = 1.0 / d
    return torch.cat([acc * inv, inv], dim=-1) * scale


def bf16_faults() -> None:
    import torch

    import chip_smoke as cs
    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train import init_state, make_train_step
    from mapfree_tpu_torch.train.fit import _device_batch

    _build.load_libraries(corr.LIBRARIES)

    saved = corr._forward_cuda
    for name, fault in [("sound K1", None)] + list(FAULTS.items()):
        if fault is not None:
            corr._forward_cuda = (lambda q, k, v, grid, f=fault:
                                  faulty_forward(q, k, v, grid, **f))
        try:
            for shape in ((2, 10, 13), (2, 92, 68)):  # phase 3's bf16_hw130, bf16_hw6256_b2
                res = cs.forward_case(*cs._kernel_inputs(*shape, 32, 32, "bfloat16", seed=5))
                try:
                    cs.check_forward(res, name)
                    verdict = "passes"
                except AssertionError:
                    verdict = "FAILS"
                print(f"[{card()}] phase 3's K1 check, {name}, B={shape[0]} HW="
                      f"{shape[1] * shape[2]}: relative L2 {res['l2']:.2e} against the plain "
                      f"forward with K1's rounding (limit {res['l2_tol']:g}), {res['err']:.2e} "
                      f"against the exact one (limit {res['tol']:g}), max score "
                      f"{res['ms_err']:.2e} (limit {res['ms_tol']:g}): {verdict}", flush=True)
        finally:
            corr._forward_cuda = saved

    def step_of(cfg, batch, init_seed):
        net = build_regression_net(cfg)
        state = init_state(net, cfg, torch.Generator().manual_seed(init_seed), device="cuda")
        _, logs = make_train_step(net, cfg)(state, _device_batch(batch, torch.device("cuda"), 4))
        return (float(logs["train/loss"]),
                {k: p.grad.detach().float().cpu() for k, p in net.named_parameters()})

    readings: dict = {}
    for batch_seed, init_seed in SEEDS:
        cfg = cs.load_cfg({"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96,
                           "DATASET.WIDTH": 72, "TRAINING.BATCH_SIZE": 4,
                           "TRAINING.LR": 1e-3, "TRAINING.GRAD_CLIP": 1.0,
                           "TPU.COMPUTE_DTYPE": "bfloat16", "TPU.SEED": init_seed})
        batch = cs.train_batches(1, 4, 96, 72, seed=batch_seed)[0]
        with cs.plain_versions_on_the_card():
            plain_loss, plain = step_of(cfg, batch, init_seed)
        cases = [("sound K1", None)] + list(FAULTS.items())
        for name, fault in cases:
            saved = corr._forward_cuda
            if fault is not None:
                corr._forward_cuda = (lambda q, k, v, grid, f=fault:
                                      faulty_forward(q, k, v, grid, **f))
            try:
                loss, grads = step_of(cfg, batch, init_seed)
            finally:
                corr._forward_cuda = saved
            _, l2 = cs._grad_errors(grads, plain)
            rel = abs(loss - plain_loss) / abs(plain_loss)
            readings.setdefault(name, []).append((l2, rel))
            print(f"[{card()}] {name}, batch seed {batch_seed}, weight seed {init_seed}: "
                  f"whole gradient {l2:.3e} in L2 against the plain versions, loss rel "
                  f"{rel:.2e}", flush=True)
    for name, rs in readings.items():
        l2s, rels = [r[0] for r in rs], [r[1] for r in rs]
        print(f"[{card()}] {name} over {len(rs)} seeds: L2 {min(l2s):.3f}-{max(l2s):.3f}, "
              f"loss rel {min(rels):.2e}-{max(rels):.2e}", flush=True)


def _rank_bn_backward_local(*args):
    """chip_smoke._mesh_rank with the synced BatchNorm's backward taking its
    two per-channel sums from this rank's rows alone."""
    import chip_smoke as cs
    from mapfree_tpu_torch.models import blocks

    reduce = blocks._all_reduce
    blocks._all_reduce = lambda t, group: t if t.dim() == 2 else reduce(t, group)
    cs._mesh_rank(*args)


def _rank_bn_forward_local(*args):
    """chip_smoke._mesh_rank with each rank's BatchNorm statistics its own
    rows' (the forward's sums not all-reduced)."""
    import chip_smoke as cs
    from mapfree_tpu_torch.models import blocks

    reduce = blocks._all_reduce
    blocks._all_reduce = lambda t, group: t if t.dim() == 1 else reduce(t, group)
    cs._mesh_rank(*args)


def _rank_grads_not_averaged(*args):
    """chip_smoke._mesh_rank with each rank stepping on its own rows'
    gradients."""
    import chip_smoke as cs
    from mapfree_tpu_torch.train import state

    state.average_gradients_ = lambda params, group, world: None
    cs._mesh_rank(*args)


def _rank_grads_summed(*args):
    """chip_smoke._mesh_rank with the gradients summed over the ranks, not
    averaged."""
    import chip_smoke as cs
    from mapfree_tpu_torch.train import state

    average = state.average_gradients_
    state.average_gradients_ = lambda params, group, world: average(params, group, 1)
    cs._mesh_rank(*args)


# faults planted in phase 16 (c)'s ranks for mesh-faults
MESH_FAULTS = {
    "BatchNorm backward sums not all-reduced": _rank_bn_backward_local,
    "BatchNorm statistics each rank's own": _rank_bn_forward_local,
    "gradients not averaged over the ranks": _rank_grads_not_averaged,
    "gradients summed over the ranks": _rank_grads_summed,
}


def mesh_faults() -> None:
    import chip_smoke as cs
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    _build.load_libraries(corr.LIBRARIES)
    cfg, batch = cs.mesh_step_inputs()
    single = cs.single_mesh_step(cfg, batch)[:3]
    control = cs.mesh_control(cfg, batch, single)
    for name, rank_fn in [("sound mesh", None)] + list(MESH_FAULTS.items()):
        ranks = cs.spawn_mesh_ranks(cfg, batch, n_timed=0, rank_fn=rank_fn)
        verdict = cs.mesh_verdict(ranks[0], single, control, what=name)
        caught = [k for k in verdict["limits"] if verdict["got"][k] > verdict["limits"][k]]
        print(f"[{card()}] phase 16 (c), {name}: "
              + ", ".join(f"{k} {verdict['got'][k]:.3e} (limit {verdict['limits'][k]:.3e})"
                          for k in verdict["limits"])
              + f": {'FAILS on ' + ', '.join(caught) if caught else 'passes'}", flush=True)


def _faulty_k1(fault):
    """K1 on inputs that one fault of the wide FMA design would see in its
    products: the last chunk of 128 channels skipped, or q and k staged in
    bf16."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    sound = corr._forward_cuda

    def forward(q, k, v, grid):
        if fault == "last channel chunk skipped":
            q = q.clone()
            q[..., -128:] = 0
        else:
            q, k = (x.to(torch.bfloat16).to(x.dtype) for x in (q, k))
        return sound(q, k, v, grid)

    return forward


def wide_unscaled() -> None:
    import chip_smoke as cs
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    _build.load_libraries(corr.LIBRARIES)
    shapes = {20: (4, 5), 70: (7, 10), 1000: (25, 40)}
    readings: dict = {}
    for seed in range(6):
        for HW, (H, W) in shapes.items():
            q, k, v, grid = cs._kernel_inputs(2, H, W, 1024, 1024, "float32", seed=300 + seed)
            fwd = cs.forward_case(q, k, v, grid)
            bwd = cs.backward_case(q, k, v, grid, cs._cotangent(2, HW, 1024, seed=800 + seed))
            for key, val in (("K1", fwd["err"]), ("K2", bwd["k2_err"]), ("K3", bwd["k3_err"])):
                readings.setdefault((key, HW), []).append(val)
            print(f"[{card()}] unscaled float32, Cq = Cv = 1,024, HW={HW}, seed {seed}: K1 "
                  f"max |kernel - plain| {fwd['err']:.3e}; K2 {bwd['k2_err']:.3e}, K3 "
                  f"{bwd['k3_err']:.3e} of each gradient's largest entry; argmax near ties "
                  f"{bwd['argmax_near_ties']}", flush=True)
            del q, k, v, bwd
    for (key, HW), vals in sorted(readings.items()):
        print(f"[{card()}] sound {key}, HW={HW}, over {len(vals)} seeds: "
              f"{min(vals):.3e}-{max(vals):.3e}", flush=True)
    saved = corr._forward_cuda
    for fault in ("last channel chunk skipped", "q and k staged in bf16"):
        corr._forward_cuda = _faulty_k1(fault)
        try:
            for HW, (H, W) in shapes.items():
                q, k, v, grid = cs._kernel_inputs(2, H, W, 1024, 1024, "float32", seed=300)
                fwd = cs.forward_case(q, k, v, grid)
                print(f"[{card()}] K1 with {fault}, unscaled float32, Cq = Cv = 1,024, "
                      f"HW={HW}: max |kernel - plain| {fwd['err']:.3e}", flush=True)
        finally:
            corr._forward_cuda = saved


class _Libraries:
    """The functions of several libraries, each found in the one that has it."""

    def __init__(self, libs):
        self.libs = libs

    def __getattr__(self, name):
        for lib in self.libs:
            if hasattr(lib, name):
                return getattr(lib, name)
        raise AttributeError(name)


def _variant_lib(tmp: Path, body: list, source: str = "correlation_fwd.cu", parts: int = 1):
    """Build a library of the extern "C" functions ``body`` from a file that
    includes the checkout's ``source`` (``parts`` files of them, one nvcc
    each, all at once); print ptxas's registers and every kernel whose wgmma
    it serialised."""
    import ctypes

    import chip_smoke as cs
    from mapfree_tpu_torch.ops import _build

    chunks = [body[i::parts] for i in range(parts) if body[i::parts]]
    procs = []
    t0 = time.perf_counter()
    for i, chunk in enumerate(chunks):
        cu, so = tmp / f"variants{i}.cu", tmp / f"libvariants{i}.so"
        cu.write_text("\n".join([f'#include "{_build.CSRC_DIR / source}"'] + chunk) + "\n")
        procs.append((so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = [(so, proc.communicate()[0], proc.returncode) for so, proc in procs]
    for _, log, rc in logs:
        if rc:
            sys.exit(log)
    print(f"[{card()}] {len(body)} variants built in {time.perf_counter() - t0:.1f} s "
          f"({len(chunks)} nvcc at once)", flush=True)
    for _, log, _ in logs:
        for kernel, regs, spill in cs.ptxas_report(log):
            print(f"  {kernel}: {regs} registers, {spill} bytes spilled", flush=True)
        for line in log.splitlines():
            if "Performance Loss" in line:  # ptxas serialised a kernel's wgmma: why, and which
                why = line.split("serialized due to ")[-1].split(" in the function")[0]
                name = re.search(r"(correlation_\w+?_kernel)I(\w*?)EEv", line)
                args = ", ".join(re.findall(r"Li(\d+)E", name.group(2))) if name else "?"
                print(f"  {name.group(1) if name else '?'}<{args}>: wgmma serialised, {why}",
                      flush=True)
    libs = [ctypes.CDLL(str(so)) for so, _, _ in logs]
    return libs[0] if len(libs) == 1 else _Libraries(libs)


# (name, B, H, W, Cq, Cv) -> candidate template arguments of launch_mma
K1_VARIANTS = {
    ("C=128, 3d3d grid, B=10", 10, 92, 68, 128, 128): [
        "128, 128, false, 1, 8, 1, 3", "128, 128, false, 1, 8, 1, 2",
        "128, 128, false, 1, 4, 2, 2", "128, 128, false, 1, 4, 1, 3",
        "64, 128, true, 1, 4, 2, 3", "64, 128, true, 1, 8, 1, 3"],
    ("C=128, 3d3d grid, B=64", 64, 92, 68, 128, 128): [
        "128, 128, false, 1, 8, 1, 3", "128, 128, false, 1, 4, 2, 2"],
    ("C=1,024, ResNet grid 5x4, B=64", 64, 5, 4, 1024, 1024): [
        "64, 128, true, 1, 2, 2, 3", "64, 128, true, 1, 4, 2, 3",
        "128, 128, true, 1, 2, 1, 3", "64, 128, true, 1, 2, 2, 4",
        "32, 128, true, 1, 2, 3, 4"],
    ("Cq=256 Cv=96, 3d3d grid, B=10", 10, 92, 68, 256, 96): [
        "64, 128, true, 1, 4, 2, 3", "64, 128, true, 1, 8, 1, 3",
        "128, 128, true, 1, 4, 1, 3", "32, 128, true, 1, 4, 2, 4"],
}


def k1_variants() -> None:
    import ctypes
    import tempfile

    import torch

    import chip_smoke as cs
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    _build.load_libraries([corr.KERNEL])
    args = sorted({a for variants in K1_VARIANTS.values() for a in variants})
    body = [f"""extern "C" int variant_{i}(const void* q, const void* k, const void* v,
    const void* grid, void* out, int B, int HW, int Cq, int Cv, int dtype, void* stream) {{
  const MmaArgs a{{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(grid),
                  static_cast<float*>(out), B, HW, Cq, Cv, static_cast<cudaStream_t>(stream)}};
  return launch_mma<{a}>(a);
}}""" for i, a in enumerate(args)]
    with tempfile.TemporaryDirectory() as tmp:
        lib = _variant_lib(Path(tmp), body)
        for (name, B, H, W, cq, cv), variants in K1_VARIANTS.items():
            q, k, v, grid = cs._kernel_inputs(B, H, W, cq, cv, "bfloat16", seed=7, spread32=True)
            ref = torch.cat(corr.fused_correlation_warp(q, k, v, grid), dim=-1)
            ms = cs.cuda_time_ms(lambda: corr.fused_correlation_warp(q, k, v, grid), iters=20,
                                 warmup=2)
            print(f"[{card()}] K1 {name}: the package's dispatch {ms:.4f} ms", flush=True)
            for a in variants:
                fn = getattr(lib, f"variant_{args.index(a)}")
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                out = torch.empty_like(ref)

                def launch():
                    err = fn(*(t.data_ptr() for t in (q, k, v, grid, out)), B, H * W, cq, cv,
                             1, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant <{a}> failed to launch: {err}")

                launch()
                torch.cuda.synchronize()
                same = torch.equal(out, ref)
                vms = cs.cuda_time_ms(launch, iters=20, warmup=2)
                print(f"[{card()}] K1 {name}: <{a}> {vms:.4f} ms, equal bits to the "
                      f"package's: {same}", flush=True)
            del q, k, v, ref
            torch.cuda.empty_cache()


# K1's tensor-core kernels at every shape a driven path gives them: (name, B,
# H, W, Cq, Cv) -> candidate template arguments of launch_wgmma (the
# package's first) and of launch_mma (the mma.sync kernel the package took
# before); the wgmma kernel does not take Cq beyond 256
_C32_WG = ["1, 32, 1, 32, 2, 3, 2", "1, 32, 1, 32, 2, 4, 2", "1, 32, 1, 32, 2, 2, 2",
           "1, 32, 1, 32, 2, 4, 1", "1, 32, 1, 32, 3, 4, 1", "1, 32, 1, 32, 1, 4, 3"]
_C128_WG = ["2, 64, 2, 64, 2, 3, 1", "2, 64, 2, 64, 3, 3, 1", "2, 64, 2, 64, 2, 4, 1"]
_MMA_C32 = ["32, 32, false, 2, 4, 3, 3"]
K1_WGMMA_VARIANTS = {
    ("C=32, 3d3d grid, B=64", 64, 92, 68, 32, 32): (_C32_WG, _MMA_C32),
    ("C=32, 3d3d grid, B=10", 10, 92, 68, 32, 32): (_C32_WG[:3], _MMA_C32),
    ("C=32, 3d3d grid, B=576", 576, 92, 68, 32, 32): (_C32_WG[:2], _MMA_C32),
    ("C=32, ScanNet grid 80x60, B=64", 64, 60, 80, 32, 32): (_C32_WG[:2], _MMA_C32),
    ("C=128, 3d3d grid, B=10", 10, 92, 68, 128, 128): (_C128_WG, ["128, 128, false, 1, 4, 2, 2"]),
    ("C=128, 3d3d grid, B=64", 64, 92, 68, 128, 128): (_C128_WG[1::-1],
                                                       ["128, 128, false, 1, 4, 2, 2"]),
    ("Cq=256 Cv=96, 3d3d grid, B=10", 10, 92, 68, 256, 96): (
        ["4, 64, 2, 64, 2, 3, 1", "4, 64, 2, 64, 2, 2, 1", "4, 64, 2, 64, 3, 2, 1"],
        ["64, 128, true, 1, 4, 2, 3"]),
    ("C=256, 3d3d grid, B=10", 10, 92, 68, 256, 256): (
        ["4, 64, 2, 64, 3, 2, 1", "4, 64, 2, 64, 2, 3, 1", "4, 64, 4, 64, 2, 2, 1"],
        ["64, 128, true, 1, 4, 2, 3"]),
    ("C=1,024, ResNet grid 5x4, B=64", 64, 5, 4, 1024, 1024): ([], ["64, 128, true, 1, 2, 2, 3"]),
}


def k1_wgmma_variants() -> None:
    """The wgmma kernel's instantiations against the mma.sync kernel's, each
    built from a file that includes the checkout's .cu, each held to the
    package's bits, timed in turns (wgmma, mma.sync, mma.sync, wgmma) by CUDA
    events through the same C entry, and where the host paces the call (HW
    of 64 or fewer) on the device alone from CUDA graphs; then the host's
    time to issue one call of each kernel (the wgmma kernel encodes three
    tensor maps a call)."""
    import ctypes
    import tempfile

    import torch

    import chip_smoke as cs
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    _build.load_libraries([corr.KERNEL])
    new = sorted({a for wg, _ in K1_WGMMA_VARIANTS.values() for a in wg})
    old = sorted({a for _, mm in K1_WGMMA_VARIANTS.values() for a in mm})
    args = ("const void* q, const void* k, const void* v, const void* grid, void* out, int B, "
            "int HW, int Cq, int Cv, int dtype, void* stream")
    mma = ("const MmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), "
           "static_cast<const bf16*>(v), static_cast<const bf16*>(grid), "
           "static_cast<float*>(out), B, HW, Cq, Cv, static_cast<cudaStream_t>(stream)};")
    body = [f'extern "C" int wg_{i}({args}) {{ {mma} return launch_wgmma<{a}>(a); }}'
            for i, a in enumerate(new)]
    body += [f'extern "C" int mm_{i}({args}) {{ {mma} return launch_mma<{a}>(a); }}'
             for i, a in enumerate(old)]
    with tempfile.TemporaryDirectory() as tmp:
        lib = _variant_lib(Path(tmp), body)
        for (name, B, H, W, cq, cv), (wg, mm) in K1_WGMMA_VARIANTS.items():
            if sys.argv[2:] and not any(w in name for w in sys.argv[2:]):
                continue
            HW = H * W
            q, k, v, grid = cs._kernel_inputs(B, H, W, cq, cv, "bfloat16", seed=7, spread32=True)
            kernel = corr.forward_kernel(q.dtype, HW, cq, cv)
            ref = corr._forward_cuda(q, k, v, grid)
            torch.cuda.synchronize()
            cands = [(f"wgmma <{a}>", getattr(lib, f"wg_{new.index(a)}")) for a in wg]
            cands += [(f"mma.sync <{a}>", getattr(lib, f"mm_{old.index(a)}")) for a in mm]
            launches = {}
            for label, fn in cands:
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                out = torch.empty_like(ref)

                def launch(fn=fn, out=out, label=label):
                    err = fn(*(t.data_ptr() for t in (q, k, v, grid, out)), B, HW, cq, cv, 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{label} failed to launch: cudaError_t {err}")

                launch()
                torch.cuda.synchronize()
                launches[label] = launch
                print(f"[{card()}] K1 {name}: {label} gives the package's bits: "
                      f"{torch.equal(out, ref)}", flush=True)
            iters = max(3, min(50, int(400 / max(1, B * HW * HW * (cq + cv) / 2e9))))
            timer = (lambda f: cs.graph_ms(f, 20)) if HW <= 64 else \
                (lambda f: cs.cuda_time_ms(f, iters=iters, warmup=2))
            times = {label: [] for label in launches}
            order = list(launches) + list(launches)[::-1]
            for label in order:
                times[label].append(timer(launches[label]))
            where = "on the device alone" if HW <= 64 else "CUDA events"
            for label, ts in times.items():
                print(f"[{card()}] K1 {name} ({where}): {label} "
                      f"{min(ts):.4f}-{max(ts):.4f} ms", flush=True)
            print(f"[{card()}] K1 {name}: the package takes the {kernel} kernel", flush=True)
            for label, launch in launches.items():
                launch()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    launch()
                us = 1e6 * (time.perf_counter() - t0) / 20
                torch.cuda.synchronize()
                if HW <= 64 or cq <= 32 and B <= 10:
                    print(f"[{card()}] K1 {name}: {label} host time to issue one call "
                          f"{us:.1f} us", flush=True)
            del q, k, v, ref, launches
            torch.cuda.empty_cache()


# (name, B, H, W, Cq, Cv) -> candidate template arguments of launch_rows (after
# the type); the package's choice first
K1_FMA_ROWS = {
    ("float32, 3d3d grid, B=64", 64, 92, 68, 32, 32): [
        "32, false, 8, 2, 2, 2, 1", "32, false, 8, 2, 2, 3, 1", "32, false, 8, 2, 1, 2, 1",
        "32, false, 8, 1, 2, 2, 2"],
    ("float32, 3d3d grid, B=10", 10, 92, 68, 32, 32): [
        "32, false, 8, 2, 2, 2, 1", "32, false, 8, 2, 1, 2, 1"],
}
# (name, B, H, W, Cq, Cv) -> (template arguments of launch_short after the
# type, column tiles); the package's choice first
K1_FMA_SHORT = {("float32, C=1,024, ResNet grid 5x4, B=64", 64, 5, 4, 1024, 1024):
                [("2, 8, 3", 5), ("2, 8, 2", 5), ("2, 8, 3", 8), ("2, 8, 3", 10),
                 ("2, 8, 3", 16), ("2, 8, 3", 20), ("2, 8, 3", 40), ("4, 16, 2", 5)]}


def k1_fma_variants() -> None:
    import ctypes
    import tempfile

    import torch

    import chip_smoke as cs
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    _build.load_libraries([corr.KERNEL])
    rows = sorted({a for variants in K1_FMA_ROWS.values() for a in variants})
    args = ("const void* q, const void* k, const void* v, const void* grid, void* out, int B, "
            "int HW, int Cq, int Cv, int dtype, void* stream")
    fma = ("const FmaArgs a{q, k, v, grid, static_cast<float*>(out), B, HW, Cq, Cv, "
           "static_cast<cudaStream_t>(stream)};")
    body = [f'extern "C" int rows_{i}({args}) {{ {fma} return launch_rows<float, {a}>(a); }}'
            for i, a in enumerate(rows)]
    shorts = sorted({a for variants in K1_FMA_SHORT.values() for a, _ in variants})
    body += [f'extern "C" int short_{i}({args}, int n) {{ {fma} '
             f'return launch_short<float, {a}>(a, n); }}' for i, a in enumerate(shorts)]
    with tempfile.TemporaryDirectory() as tmp:
        lib = _variant_lib(Path(tmp), body)
        cases = [(key, f"rows_{rows.index(a)}", a, ()) for key, vs in K1_FMA_ROWS.items()
                 for a in vs]
        cases += [(key, f"short_{shorts.index(a)}", f"<float, {a}>, {n} column tiles", (n,))
                  for key, variants in K1_FMA_SHORT.items() for a, n in variants]
        shape = None
        for key, fname, label, extra in cases:
            name, B, H, W, cq, cv = key
            if key != shape:
                shape = key
                q, k, v, grid = cs._kernel_inputs(B, H, W, cq, cv, "float32", seed=7,
                                                  spread32=cq > 32)
                ref = torch.cat(corr.fused_correlation_warp_plain(q, k, v, grid), dim=-1)
                # the SM clock and power while the package's K1 runs: the FMA
                # bound assumes the 1.98 GHz boost clock
                smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                        "--format=csv,noheader,nounits", "-lms", "100"],
                                       stdout=subprocess.PIPE, text=True)
                ms = cs.cuda_time_ms(lambda: corr.fused_correlation_warp(q, k, v, grid),
                                     iters=30 if cq <= 32 else 200, warmup=2)
                smi.terminate()
                samples = [tuple(float(x) for x in ln.split(",")) for ln in
                           smi.communicate()[0].splitlines() if ln.count(",") == 1]
                if samples:
                    busy = samples[len(samples) // 4:] or samples
                    print(f"[{card()}] K1 {name}: SM clock {min(x[0] for x in busy):.0f}-"
                          f"{max(x[0] for x in busy):.0f} MHz, power {min(x[1] for x in busy):.0f}-"
                          f"{max(x[1] for x in busy):.0f} W over {len(busy)} samples while it "
                          "ran", flush=True)
                gms = cs.graph_ms(lambda: corr.fused_correlation_warp(q, k, v, grid), 10)
                vg = torch.cat([v, grid.expand(B, H * W, 2), v.new_zeros(B, H * W, 6)],
                               dim=-1)[:, None]
                lib_ms, backend = cs.sdpa_ms(q[:, None], k[:, None], vg, iters=10)
                lib_gms, _ = cs.sdpa_ms(q[:, None], k[:, None], vg, iters=10, timer=cs.graph_ms)
                print(f"[{card()}] K1 {name}: the package's dispatch {ms:.4f} ms ({gms:.4f} on "
                      f"the device alone); float32 attention ({backend}, TF32 off) {lib_ms:.4f} "
                      f"ms ({lib_gms:.4f})", flush=True)
            fn = getattr(lib, fname)
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                           + [ctypes.c_int] * len(extra))
            fn.restype = ctypes.c_int
            out = torch.full_like(ref, float("nan"))

            def launch():
                err = fn(*(t.data_ptr() for t in (q, k, v, grid, out)), B, H * W, cq, cv, 0,
                         torch.cuda.current_stream().cuda_stream, *extra)
                if err:
                    raise RuntimeError(f"variant {label} failed to launch: {err}")

            launch()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            vms = cs.cuda_time_ms(launch, iters=10, warmup=2)
            gms = cs.graph_ms(launch, 10)
            print(f"[{card()}] K1 {name}: {label}: {vms:.4f} ms ({gms:.4f} on the device "
                  f"alone, CUDA graph), max |kernel - plain| "
                  f"{err:.3g} (limit {cs.ATOL['float32']:g})", flush=True)
            if not err <= cs.ATOL["float32"]:
                raise AssertionError(f"variant {label} disagrees with the plain forward")


# name -> (old, new) text edits of correlation_fwd.cu, each a candidate the
# long-rows kernel was measured against
_COPY_T = "#pragma unroll\n  for (int e0 = 0; e0 < R * KC; e0 += NT) {"
_COPY_V = "#pragma unroll\n  for (int e0 = 0; e0 < BN * CT; e0 += NT) {"
_PV = "#pragma unroll 4\n    for (int j = 0; j < G::KS; j += 4) {"
_S = "#pragma unroll 8\n      for (int cc = 0; cc < KC; ++cc) {"
K1_FMA_EDITS = {
    "row max reduced on every tile": [("    bool renew = false;", "    bool renew = true;")],
    "copy loops not unrolled": [(_COPY_T, _COPY_T.replace("unroll", "unroll 1")),
                                (_COPY_V, _COPY_V.replace("unroll", "unroll 1"))],
    "P . v loop unrolled 2": [(_PV, _PV.replace("unroll 4", "unroll 2"))],
    "P . v loop unrolled fully": [(_PV, _PV.replace("unroll 4", "unroll"))],
    "P . v loop not unrolled": [(_PV, _PV.replace("unroll 4", "unroll 1"))],
    "score loop unrolled fully": [(_S, _S.replace("unroll 8", "unroll"))],
}


def k1_fma_edits() -> None:
    import ctypes
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    src = (_build.CSRC_DIR / "correlation_fwd.cu").read_text()
    variants = {"the package's source": src}
    for name, edits in K1_FMA_EDITS.items():
        edited = src
        for old, new in edits:
            if old not in edited:
                sys.exit(f"{name}: {old!r} is not in correlation_fwd.cu")
            edited = edited.replace(old, new)
        variants[name] = edited
    with tempfile.TemporaryDirectory() as tmp:
        def build(item):
            i, (name, text) = item
            d = Path(tmp) / str(i)
            shutil.copytree(_build.CSRC_DIR, d)
            (d / "correlation_fwd.cu").write_text(text)
            so = d / "libvariant.so"
            proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                   str(d / "correlation_fwd.cu")], capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"{name}:\n{proc.stdout}{proc.stderr}")
            regs = [r for r in cs.ptxas_report(proc.stdout + proc.stderr)
                    if r[0].startswith("correlation_fwd_rows_kernel<f32, 32, false, 8")]
            return name, so, regs

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(variants)) as ex:
            built = list(ex.map(build, enumerate(variants.items())))
        print(f"[{card()}] {len(built)} builds in {time.perf_counter() - t0:.1f} s", flush=True)
        for name, _, regs in built:
            print(f"  {name}: " + ", ".join(f"{k}: {r} registers, {sp} bytes spilled"
                                           for k, r, sp in regs), flush=True)
        for B in (64, 10):
            q, k, v, grid = cs._kernel_inputs(B, 92, 68, 32, 32, "float32", seed=7)
            ref = torch.cat(corr.fused_correlation_warp_plain(q, k, v, grid), dim=-1)
            for rnd in range(2):
                for name, so, _ in built if rnd == 0 else built[::-1]:
                    fn = ctypes.CDLL(str(so)).correlation_fwd
                    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    out = torch.full_like(ref, float("nan"))

                    def launch():
                        if fn(*(t.data_ptr() for t in (q, k, v, grid, out)), B, 92 * 68, 32, 32,
                              0, torch.cuda.current_stream().cuda_stream):
                            raise RuntimeError(f"{name} failed to launch")

                    launch()
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    if not err <= cs.ATOL["float32"]:
                        raise AssertionError(f"{name} disagrees with the plain forward: {err:.3g}")
                    ms = cs.cuda_time_ms(launch, iters=10, warmup=1)
                    print(f"[{card()}] K1 float32, 3d3d grid, B={B}, round {rnd}, {name}: "
                          f"{ms:.4f} ms, max |kernel - plain| {err:.3g}", flush=True)
            del q, k, v, ref
            torch.cuda.empty_cache()


def upsample_ab() -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from mapfree_tpu_torch.models import blocks
    from mapfree_tpu_torch.models.builder import build_model
    from mapfree_tpu_torch.utils import submission
    from mapfree_tpu_torch.utils.submission import predict
    from mapfree_tpu_torch.utils.timing import StageTimes

    cs.phase_build()
    cfg = cs.load_cfg({"TPU.SEED": cs.SEED})
    H, W, bs = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, int(cfg.TPU.INFER_BATCH)
    model = build_model(cfg, device="cuda")
    batches = cs.synthetic_batches(5 * bs + 23, bs, H, W, seed=cs.SEED + 1)
    warm = cs.synthetic_batches((submission.MAX_TRANSFERS + submission.DEPTH) * bs, bs, H, W,
                                seed=cs.SEED + 2)
    n_pairs = sum(len(b["ref_idx"]) for b in batches)
    transferred = model.transfer_batch(batches[0])

    def interpolate(x, out_hw):
        return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=True)

    matmuls = blocks.resize_bilinear_align_corners
    variants = {"two bf16 matmuls": matmuls, "F.interpolate (float32)": interpolate}
    try:
        for rnd in range(4):
            order = list(variants) if rnd % 2 == 0 else list(reversed(variants))
            for name in order:
                blocks.resize_bilinear_align_corners = variants[name]
                predict(warm, model)
                torch.cuda.synchronize()
                forward_ms = cs.cuda_time_ms(lambda: model.dispatch_device(transferred)(),
                                             iters=10)
                issue = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    finalize = model.dispatch_device(transferred)
                    issue.append(1e3 * (time.perf_counter() - t0))
                    finalize()
                times = StageTimes()
                t0 = time.perf_counter()
                predict(batches, model, times)
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
                print(f"[{card()}] round {rnd}, upsample by {name}: forward {forward_ms:.2f} ms "
                      f"(CUDA events, 10 forwards), host issue of one forward "
                      f"{min(issue):.2f}-{max(issue):.2f} ms, sweep from memory "
                      f"{n_pairs / elapsed:.1f} pairs/s (dispatch "
                      f"{1e3 * times.seconds['dispatch'] / len(batches):.2f} ms a batch)",
                      flush=True)
    finally:
        blocks.resize_bilinear_align_corners = matmuls


def sweep_determinism(runs: int = 5) -> None:
    import tempfile

    import torch

    import chip_smoke as cs
    import mapfree_tpu_torch.utils.submission as us
    from mapfree_tpu_torch import submission

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cs.write_mapfree_tree(root, seed=cs.SEED + 160)
        dataset_cfg, _ = cs.write_configs(root)
        argv = [str(REPO / "configs/regression/mapfree/3d3d.yaml"), "--dataset_config",
                str(dataset_cfg), "--device", "cuda"]
        settings = (("default engines, 4 transfer workers", 4, False),
                    ("default engines, 1 transfer worker", 1, False),
                    ("cudnn.deterministic, 4 transfer workers", 4, True),
                    ("cudnn.deterministic, 1 transfer worker", 1, True))
        saved = us.TRANSFER_WORKERS, us.MAX_TRANSFERS, torch.backends.cudnn.deterministic
        try:
            for name, workers, deterministic in settings:
                us.TRANSFER_WORKERS, us.MAX_TRANSFERS = workers, workers + 1
                torch.backends.cudnn.deterministic = deterministic
                poses = [cs.read_submission(submission.main(argv + ["-o", str(root / f"o{i}")]))
                         for i in range(runs)]
                moved = [cs._pose_differences(p, poses[0]) for p in poses[1:]]
                print(f"[{card()}] {name}: {sum(int(m.max() > 0) for m in moved)} of "
                      f"{runs - 1} runs differ from the first, largest difference "
                      f"{max(m.max() for m in moved):.3e}, frames differing per run "
                      f"{[int((m > 0).sum()) for m in moved]} of {len(moved[0])}", flush=True)
        finally:
            us.TRANSFER_WORKERS, us.MAX_TRANSFERS, torch.backends.cudnn.deterministic = saved


DECODE_UNDER_LOAD = """
import sys
from pathlib import Path
root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))
import torch
from mapfree_tpu_torch.data import jpeg
frames = sorted((root / "tests/data/torch_port").glob("frame_*.jpg"))
batch = [str(frames[i % len(frames)]) for i in range(64)]
quiet = jpeg.decode_resize_batch(batch, 270, 360, device="cuda", uint8=True)
x = torch.randn(4096, 4096, device="cuda")
counts = []
for _ in range(3):
    torch.cuda.synchronize()
    for _ in range(60):
        torch.mm(x, x)
    busy = jpeg.decode_resize_batch(batch, 270, 360, device="cuda", uint8=True)
    torch.cuda.synchronize()
    counts.append(int((busy != quiet).any(axis=(1, 2, 3)).sum()))
print(counts)
"""


def decode_under_load(*checkouts) -> None:
    for root in (REPO, *[Path(c) for c in checkouts]):
        got = subprocess.run([sys.executable, "-c", DECODE_UNDER_LOAD, str(root)],
                             capture_output=True, text=True, timeout=600, check=True)
        print(f"[{card()}] {root}: frames of 64 decoded beside queued work that differ "
              f"from the idle decode, three trials: {got.stdout.strip()}", flush=True)


F32_CHECKOUT = """
import importlib.util
import sys
from pathlib import Path
root, smoke = Path(sys.argv[1]).resolve(), sys.argv[2]
sys.path.insert(0, str(root))
spec = importlib.util.spec_from_file_location("chip_smoke_here", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import mapfree_tpu_torch
assert Path(mapfree_tpu_torch.__file__).resolve().is_relative_to(root)
cs.phase_build()
print(cs.phase_f32_sweeps()["numbers"])
cfg = cs.load_cfg({**cs.WIDE_MODELS["resnet"], "TRAINING.BATCH_SIZE": 4, "TRAINING.LR": 1e-3,
                   "TRAINING.GRAD_CLIP": 1.0, "TPU.COMPUTE_DTYPE": "float32", "TPU.SEED": cs.SEED})
for seed in (97, 98, 99):
    batch = cs.train_batches(1, 4, cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, seed=cs.SEED + seed)[0]
    try:
        cs.f32_step_kernels_vs_plain(cfg, batch, f"resnet step, batch seed {seed}")
    except AssertionError as e:
        print(e)
"""


def f32_checkouts(*checkouts) -> None:
    roots = [REPO, *[Path(c) for c in checkouts]]
    for root in roots + roots[::-1]:
        got = subprocess.run([sys.executable, "-c", F32_CHECKOUT, str(root),
                              str(REPO / "chip_smoke.py")],
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in (got.stdout + got.stderr).splitlines()
                 if ln.startswith(("[float32", "[resnet step", "resnet step", "{"))
                 or "Error" in ln]
        for ln in lines:
            print(f"[{card()}] {root}: {ln}", flush=True)
        if got.returncode:
            sys.exit(f"{root}: exit {got.returncode}")


# (name, B, H, W, Cq, Cv, dtype) -> candidate template arguments of
# correlation_bwd.cu's launch_rows / launch_cols after the type (STREAM, CX,
# NG, OH, SH, RING, MINB); the package's choice first
K23_FMA_ROWS = {
    ("float32, 3d3d grid, B=10", 10, 92, 68, 32, 32, "float32"): [
        "false, 8, 1, 2, 1, 2, 1", "false, 8, 1, 2, 2, 2, 1", "false, 8, 1, 1, 2, 2, 1",
        "false, 8, 1, 2, 1, 3, 1", "false, 8, 1, 1, 1, 2, 2"],
    ("bf16, Cq=256 Cv=96, 3d3d grid, B=10", 10, 92, 68, 256, 96, "bfloat16"): [
        "true, 16, 2, 1, 1, 2, 1", "true, 16, 1, 1, 1, 2, 1", "true, 16, 1, 2, 1, 2, 1",
        "true, 16, 2, 1, 1, 2, 2"]}
K23_FMA_COLS = {
    ("float32, 3d3d grid, B=10", 10, 92, 68, 32, 32, "float32"): [
        "false, 8, 1, 2, 1, 2, 1", "false, 8, 1, 2, 1, 3, 1", "false, 8, 1, 1, 1, 2, 1"],
    ("bf16, Cq=256 Cv=96, 3d3d grid, B=10", 10, 92, 68, 256, 96, "bfloat16"): [
        "true, 16, 2, 1, 1, 2, 1", "true, 16, 1, 1, 1, 2, 1", "true, 16, 2, 1, 1, 2, 2"]}
# (name, B, H, W, Cq, Cv, dtype) -> (kernel, "TR, TC, RQ, RING, SPLIT", column
# tiles); the package's choice first for each kernel
K23_FMA_SHORT = {
    (f"{dt}, C=1,024, ResNet grid 5x4, B=10", 10, 5, 4, 1024, 1024, dt): [
        (kind, a, n) for kind in ("rows", "cols") for a, n in (
            ("1, 2, 6, 3, false", 13), ("1, 2, 6, 3, false", 8), ("1, 2, 6, 3, false", 26),
            ("2, 2, 8, 3, false", 13), ("1, 2, 6, 2, false", 13), ("2, 2, 8, 3, true", 13),
            ("2, 2, 8, 2, true", 13), ("2, 2, 8, 3, true", 26), ("2, 2, 8, 3, true", 8))]
    for dt in ("float32", "bfloat16")}
_BWD_ARGS = ("const void* q, const void* k, const void* v, const void* grid, const void* out, "
             "const void* dout, void* dq, void* dk, void* dv, void* stats, void* amax, int B, "
             "int HW, int Cq, int Cv, int dtype, void* stream")
_BWD_STRUCT = ("const Args a{q, k, v, grid, static_cast<const float*>(out), "
               "static_cast<const float*>(dout), static_cast<float*>(dq), "
               "static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(stats), "
               "static_cast<int*>(amax), B, HW, Cq, Cv, static_cast<cudaStream_t>(stream)};")


def _k23_case(cs, corr, B, H, W, cq, cv, dtype, seed):
    """Inputs on the card, the exact forward's buffer, a cotangent, the
    package's K2 and K3 outputs and the exact plain backward with its
    argmax."""
    import torch

    q, k, v, grid = cs._kernel_inputs(B, H, W, cq, cv, dtype, seed=seed, spread32=cq > 32)
    dout = cs._cotangent(B, H * W, cv, seed=seed + 1)
    out = corr._plain_buffer(q, k, v, grid)
    dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout)
    dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows)
    ref = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, rows.amax.long())[:3]
    torch.cuda.synchronize()
    return (q, k, v, grid, out, dout), rows, ref


def k23_fma_variants() -> None:
    import ctypes
    import tempfile

    import torch

    import chip_smoke as cs
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    _build.load_libraries([corr.KERNEL_BWD])
    longs = sorted({("rows", a) for vs in K23_FMA_ROWS.values() for a in vs}
                   | {("cols", a) for vs in K23_FMA_COLS.values() for a in vs})
    body = [f'extern "C" int long_{i}({_BWD_ARGS}) {{ {_BWD_STRUCT} return dtype ? '
            f'launch_{kind}<bf16, {a}>(a) : launch_{kind}<float, {a}>(a); }}'
            for i, (kind, a) in enumerate(longs)]
    shorts = sorted({(kind, a) for vs in K23_FMA_SHORT.values() for kind, a, _ in vs})
    body += [f'extern "C" int short_{i}({_BWD_ARGS}, int n) {{ {_BWD_STRUCT} return dtype ? '
             f'launch_{kind}_short<bf16, {a}>(a, n) : launch_{kind}_short<float, {a}>(a, n); }}'
             for i, (kind, a) in enumerate(shorts)]
    cases = [(key, kind, f"long_{longs.index((kind, a))}",
              f"{'K2' if kind == 'rows' else 'K3'} <{a}>", ())
             for kind, table in (("rows", K23_FMA_ROWS), ("cols", K23_FMA_COLS))
             for key, vs in table.items() for a in vs]
    cases.sort(key=lambda c: list(K23_FMA_ROWS).index(c[0]))  # one shape at a time
    cases += [(key, kind, f"short_{shorts.index((kind, a))}",
               f"{'K2' if kind == 'rows' else 'K3'} few rows <{a}>, {n} column tiles", (n,))
              for key, vs in K23_FMA_SHORT.items() for kind, a, n in vs]
    with tempfile.TemporaryDirectory() as tmp:
        lib = _variant_lib(Path(tmp), body, "correlation_bwd.cu")
        shape = None
        for key, kind, fname, label, extra in cases:
            name, B, H, W, cq, cv, dtype = key
            if key != shape:
                shape = key
                args, rows, ref = _k23_case(cs, corr, B, H, W, cq, cv, dtype, seed=7)
                q, k, v, grid, out, dout = args

                def k2():
                    corr.correlation_bwd_rows(q, k, v, grid, out, dout)

                def k3():
                    corr.correlation_bwd_cols(q, k, v, grid, dout, rows)

                vg = torch.cat([v, grid.expand(B, H * W, 2), v.new_zeros(B, H * W, 6)],
                               dim=-1)[:, None]
                qh, kh, vh = (t.detach().requires_grad_(True) for t in (q[:, None], k[:, None], vg))
                do = torch.cat([dout[..., :cv + 2], dout.new_zeros(B, H * W, 6)],
                               dim=-1)[:, None].to(q.dtype)
                lib_ms, backend = cs.sdpa_ms(qh, kh, vh, iters=10, do=do)
                lib_gms = cs.sdpa_ms(qh, kh, vh, iters=10, do=do, timer=cs.graph_ms)[0]
                print(f"[{card()}] {name}: the package's K2 {cs.cuda_time_ms(k2, 10):.4f} ms "
                      f"({cs.graph_ms(k2, 10):.4f} on the device alone), K3 "
                      f"{cs.cuda_time_ms(k3, 10):.4f} ms ({cs.graph_ms(k3, 10):.4f}); attention "
                      f"backward ({backend or 'bf16'}, TF32 off) {lib_ms:.4f} ms ({lib_gms:.4f})",
                      flush=True)
            fn = getattr(lib, fname)
            fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                           + [ctypes.c_int] * len(extra))
            fn.restype = ctypes.c_int
            HW = H * W
            dq = torch.full((B, HW, cq), float("nan"), device="cuda")
            dk = torch.full((B, HW, cq), float("nan"), device="cuda")
            dv = torch.full((B, HW, cv), float("nan"), device="cuda")
            # a K2 variant writes its own statistics; a K3 variant reads the package's
            stats = torch.empty_like(rows.stats) if kind == "rows" else rows.stats
            amax = torch.empty_like(rows.amax) if kind == "rows" else rows.amax

            def launch():
                err = fn(*(t.data_ptr() for t in (q, k, v, grid, out, dout, dq, dk, dv, stats,
                                                  amax)),
                         B, HW, cq, cv, int(dtype == "bfloat16"),
                         torch.cuda.current_stream().cuda_stream, *extra)
                if err:
                    raise RuntimeError(f"variant {label} failed to launch: {err}")

            launch()
            torch.cuda.synchronize()
            if kind == "rows":
                err = cs._scaled_err([dq], ref[:1])
                same = (torch.equal(stats[..., 0], rows.stats[..., 0])
                        and torch.equal(amax, rows.amax))
            else:
                err, same = cs._scaled_err([dk, dv], ref[1:]), True
            vms = cs.cuda_time_ms(launch, iters=10, warmup=2)
            gms = cs.graph_ms(launch, 10)
            print(f"[{card()}] {name}: {label}: {vms:.4f} ms ({gms:.4f} on the device alone, "
                  f"CUDA graph), {err:.3g} of the largest gradient vs the exact plain backward "
                  f"(limit {cs.BWD_TOL:g}), the package's row max and argmax: {same}",
                  flush=True)
            if not (err <= cs.BWD_TOL and same):
                raise AssertionError(f"variant {label} disagrees with the plain backward")


# (name, B, H, W, Cq, Cv) -> candidate instantiations of the tensor-core K2
# and K3 (ops/csrc/correlation_bwd_mma.cu::dispatch_rows_mma,
# dispatch_cols_mma): (kernel, launcher, template arguments), the package's
# choice first for each kernel. launch_*_mma (own tiles resident): channels
# padded to (CQ, CV), m-tiles a warp, warps a block, blocks a SM, ring
# stages, A fragments in registers; launch_*_stream: column tile, m-tiles,
# warps, blocks a SM, stages.
_C32 = [("rows", "mma", "32, 32, 1, 8, 2, 2, true"), ("rows", "mma", "32, 32, 1, 8, 2, 3, true"),
        ("rows", "mma", "32, 32, 2, 4, 2, 2, true"), ("rows", "mma", "32, 32, 2, 4, 3, 2, true"),
        ("rows", "mma", "32, 32, 1, 4, 3, 3, true"), ("rows", "mma", "32, 32, 1, 8, 1, 2, true"),
        ("rows", "mma", "32, 32, 2, 8, 1, 2, true"),
        ("cols", "mma", "32, 32, 2, 4, 2, 2, true"), ("cols", "mma", "32, 32, 2, 4, 2, 3, true"),
        ("cols", "mma", "32, 32, 1, 8, 2, 2, true"), ("cols", "mma", "32, 32, 2, 4, 3, 2, true"),
        ("cols", "mma", "32, 32, 2, 8, 1, 2, true"), ("cols", "mma", "32, 32, 1, 4, 3, 3, true")]
K23_MMA_VARIANTS = {
    ("C=32, 3d3d grid, B=10", 10, 92, 68, 32, 32): _C32,
    ("C=32, 3d3d grid, B=90", 90, 92, 68, 32, 32): _C32,
    ("C=128, 3d3d grid, B=10", 10, 92, 68, 128, 128): [
        ("rows", "mma", "128, 128, 1, 8, 1, 2, true"), ("rows", "mma", "128, 128, 1, 8, 1, 3, true"),
        ("rows", "mma", "128, 128, 1, 4, 2, 2, true"), ("rows", "mma", "128, 128, 1, 8, 1, 2, false"),
        ("rows", "mma", "128, 128, 1, 4, 2, 2, false"), ("rows", "stream", "128, 1, 4, 2, 2"),
        ("rows", "stream", "128, 1, 8, 1, 2"),
        ("cols", "mma", "128, 128, 1, 8, 1, 2, true"), ("cols", "mma", "128, 128, 1, 8, 1, 3, true"),
        ("cols", "mma", "128, 128, 1, 8, 1, 2, false"), ("cols", "mma", "128, 128, 1, 4, 2, 2, false"),
        ("cols", "stream", "128, 1, 4, 2, 2"), ("cols", "stream", "64, 1, 4, 2, 2")],
    ("Cq=256 Cv=96, 3d3d grid, B=10", 10, 92, 68, 256, 96): [
        ("rows", "mma", "256, 96, 1, 8, 1, 2, false"), ("rows", "mma", "256, 96, 1, 4, 1, 2, false"),
        ("rows", "mma", "256, 128, 1, 8, 1, 2, false"), ("rows", "stream", "128, 1, 4, 2, 2"),
        ("rows", "stream", "128, 1, 8, 1, 2"), ("rows", "stream", "64, 1, 4, 2, 2"),
        ("cols", "mma", "256, 96, 1, 8, 1, 2, false"), ("cols", "mma", "256, 96, 1, 4, 1, 2, false"),
        ("cols", "stream", "128, 1, 4, 2, 2"), ("cols", "stream", "64, 1, 4, 2, 2"),
        ("cols", "stream", "64, 1, 8, 1, 2")],
    ("C=1,024, ResNet grid 5x4, B=10", 10, 5, 4, 1024, 1024): [
        ("rows", "stream", "128, 1, 4, 2, 2"), ("rows", "stream", "128, 1, 2, 4, 2"),
        ("rows", "stream", "64, 1, 2, 4, 2"), ("rows", "stream", "64, 1, 4, 2, 2"),
        ("cols", "stream", "128, 1, 4, 2, 2"), ("cols", "stream", "128, 1, 2, 4, 2"),
        ("cols", "stream", "64, 1, 2, 4, 2"), ("cols", "stream", "64, 1, 4, 2, 2")],
    ("C=1,024, HW=1,000, B=10", 10, 25, 40, 1024, 1024): [
        ("rows", "stream", "128, 1, 4, 2, 2"), ("rows", "stream", "128, 1, 8, 1, 2"),
        ("rows", "stream", "64, 1, 4, 2, 2"),
        ("cols", "stream", "128, 1, 4, 2, 2"), ("cols", "stream", "64, 1, 4, 2, 2"),
        ("cols", "stream", "64, 1, 8, 1, 2")],
}
_MMA_ROWS_ARGS = ("const void* q, const void* k, const void* v, const void* grid, const void* out, "
                  "const void* dout, void* dq, void* stats, void* amax, void* dmain, int B, "
                  "int HW, int Cq, int Cv, int dtype, void* stream")
_MMA_COLS_ARGS = ("const void* q, const void* k, const void* v, const void* grid, "
                  "const void* dmain, const void* stats, const void* amax, void* dk, void* dv, "
                  "int B, int HW, int Cq, int Cv, int dtype, void* stream")


def _exact_buffer(corr, q, k, v, grid):
    """The exact forward's buffer, a few batch rows at a time."""
    import torch

    return torch.cat([corr._plain_buffer(q[i:i + 6], k[i:i + 6], v[i:i + 6], grid)
                      for i in range(0, q.shape[0], 6)])


def k23_mma_variants() -> None:
    import ctypes
    import tempfile

    import torch

    import chip_smoke as cs
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    _build.load_libraries([corr.KERNEL_BWD, corr.KERNEL_BWD_MMA])
    names = sorted({v for vs in K23_MMA_VARIANTS.values() for v in vs})
    body = []
    for i, (kind, launcher, a) in enumerate(names):
        if kind == "rows":
            body.append(f'extern "C" int variant_{i}({_MMA_ROWS_ARGS}) {{ return launch_rows_'
                        f'{launcher}<{a}>(mma_args(q, k, v, grid, out, dout, dmain, stats, amax, '
                        f'dq, nullptr, nullptr, B, HW, Cq, Cv, stream)); }}')
        else:
            body.append(f'extern "C" int variant_{i}({_MMA_COLS_ARGS}) {{ return launch_cols_'
                        f'{launcher}<{a}>(mma_args(q, k, v, grid, nullptr, nullptr, dmain, stats, '
                        f'amax, nullptr, dk, dv, B, HW, Cq, Cv, stream)); }}')
    with tempfile.TemporaryDirectory() as tmp:
        lib = _variant_lib(Path(tmp), body, "correlation_bwd_mma.cu")
        for (name, B, H, W, cq, cv), variants in K23_MMA_VARIANTS.items():
            HW = H * W
            q, k, v, grid = cs._kernel_inputs(B, H, W, cq, cv, "bfloat16", seed=7,
                                              spread32=cq > 32)
            dout = cs._cotangent(B, HW, cv, seed=8)
            out = _exact_buffer(corr, q, k, v, grid)
            # the package's mma.sync pair, asked for by name (the package gives
            # more than 64 positions to its wgmma pair)
            mm = corr.KERNEL_FWD_MMA_SYNC
            dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=mm)
            dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows, kernel=mm)
            torch.cuda.synchronize()
            # the package's pair against the plain backward with its
            # roundings, on the first two batch rows (the variants are then
            # held to the package's bits)
            sl = slice(0, 2)
            ref = corr.fused_correlation_warp_bwd_plain(
                q[sl], k[sl], v[sl], grid, dout[sl], rows.amax[sl].long(), bf16_roundings=True)[:3]
            l2 = cs._rel_l2([dq[sl], dk[sl], dv[sl]], ref)
            del ref
            tol = corr.mma_backward_matched_l2_tol(cq, cv)
            if l2 > tol:
                raise AssertionError(f"{name}: the package's K2, K3 at relative L2 {l2:.3g}")

            def k2():
                corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=mm)

            def k3():
                corr.correlation_bwd_cols(q, k, v, grid, dout, rows, kernel=mm)

            alone = HW <= 64
            vg = torch.cat([v, grid.expand(B, HW, 2), v.new_zeros(B, HW, 6)], dim=-1)[:, None]
            qh, kh, vh = (t.detach().requires_grad_(True) for t in (q[:, None], k[:, None], vg))
            do = torch.cat([dout[..., :cv + 2], dout.new_zeros(B, HW, 6)],
                           dim=-1)[:, None].to(q.dtype)
            timer = cs.graph_ms if alone else cs.cuda_time_ms
            lib_ms = cs.sdpa_ms(qh, kh, vh, iters=10, do=do, timer=timer)[0]
            where = "on the device alone (CUDA graphs)" if alone else "by CUDA events"
            print(f"[{card()}] {name}, {where}: the package's K2 {timer(k2, 10):.4f} ms, K3 "
                  f"{timer(k3, 10):.4f} ms (relative L2 {l2:.3g} vs the plain backward with "
                  f"its roundings on 2 rows, tol {tol:g}); attention backward {lib_ms:.4f} ms",
                  flush=True)
            if alone:
                # the FMA few-rows pair on the same inputs
                dq_f, dk_f = torch.empty_like(dq), torch.empty_like(dk)
                dv_f = torch.empty_like(dv)
                stats_f = torch.empty((B, HW, 3), device=q.device)
                amax_f = torch.empty_like(rows.amax)

                def f2():
                    corr._launch(corr.KERNEL_BWD, corr.KERNEL_BWD_ROWS,
                                 (q, k, v, grid, out, dout, dq_f, stats_f, amax_f), q, v)

                def f3():
                    corr._launch(corr.KERNEL_BWD, corr.KERNEL_BWD_COLS,
                                 (q, k, v, grid, dout, stats_f, amax_f, dk_f, dv_f), q, v)

                print(f"[{card()}] {name}: the FMA pair on the device alone: K2 "
                      f"{cs.graph_ms(f2, 10):.4f} ms, K3 {cs.graph_ms(f3, 10):.4f} ms", flush=True)
            for kind, launcher, a in variants:
                fn = getattr(lib, f"variant_{names.index((kind, launcher, a))}")
                n_ptr = 10 if kind == "rows" else 9
                fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                if kind == "rows":
                    got = [torch.full_like(dq, float("nan")), torch.empty_like(rows.stats),
                           torch.empty_like(rows.amax), torch.empty_like(rows.dmain)]
                    ptrs = (q, k, v, grid, out, dout, *got)
                    want = [dq, rows.stats, rows.amax, rows.dmain]
                else:
                    got = [torch.full_like(dk, float("nan")), torch.full_like(dv, float("nan"))]
                    ptrs = (q, k, v, grid, rows.dmain, rows.stats, rows.amax, *got)
                    want = [dk, dv]

                def launch():
                    err = fn(*(t.data_ptr() for t in ptrs), B, HW, cq, cv, 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {kind} {launcher}<{a}> failed: {err}")

                launch()
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, want))
                if not same:
                    sl_got = [x[sl] for x in got[:1 if kind == "rows" else 2]]
                    sl_want = [x[sl] for x in want[:len(sl_got)]]
                    err = cs._rel_l2(sl_got, sl_want)
                    if err > tol:
                        raise AssertionError(f"variant {kind} {launcher}<{a}> at {name}: "
                                             f"relative L2 {err:.3g} to the package's")
                label = f"{'K2' if kind == 'rows' else 'K3'} {launcher}<{a}>"
                print(f"[{card()}] {name}: {label}: {timer(launch, 10):.4f} ms, equal bits to the "
                      f"package's: {same}", flush=True)
            del q, k, v, grid, dout, out, dq, dk, dv, rows
            torch.cuda.empty_cache()


# (name, B, H, W, Cq, Cv) -> candidate template arguments of launch_rows_wgmma
# (KB, W, CV, WD, CTB, NC, ST, MINB, NH) and of launch_cols_wgmma (KB, W, CV,
# WD, TK, TV, NC, ST, MINB, NH); the package's choice first
K23_WGMMA_VARIANTS = {
    ("C=128, 3d3d grid, B=10", 10, 92, 68, 128, 128): (
        ["2, 64, 128, 64, 2, 2, 3, 1, 64", "2, 64, 128, 64, 2, 2, 3, 1, 32",
         "2, 64, 128, 64, 2, 1, 3, 1, 64"],
        ["2, 64, 128, 64, 2, 2, 1, 3, 1, 64", "2, 64, 128, 64, 1, 1, 2, 3, 1, 64",
         "2, 64, 128, 64, 1, 1, 3, 2, 1, 32"]),
    ("Cq=256 Cv=96, 3d3d grid, B=10", 10, 92, 68, 256, 96): (
        ["4, 64, 96, 32, 2, 2, 2, 1, 64", "4, 64, 96, 32, 2, 2, 2, 1, 32",
         "4, 64, 96, 32, 2, 1, 2, 1, 64"],
        ["4, 64, 96, 32, 4, 3, 1, 2, 1, 16", "4, 64, 96, 32, 2, 2, 1, 3, 1, 64",
         "4, 64, 96, 32, 2, 2, 2, 2, 1, 16"]),
    ("C=256, 3d3d grid, B=10", 10, 92, 68, 256, 256): (
        ["4, 64, 256, 64, 2, 1, 2, 1, 64", "4, 64, 256, 64, 1, 1, 2, 1, 64"],
        ["4, 64, 256, 64, 2, 2, 1, 2, 1, 64", "4, 64, 256, 64, 1, 1, 1, 2, 1, 64"]),
}


# (name, B, H, W, Cq, Cv) -> candidate template arguments of
# launch_rows_narrow and launch_cols_narrow (W, CV, NC, ST, MINB, NH: q's
# block, v's class, consumer warpgroups, ring stages, least blocks a SM, keys
# or rows a pass); the package's choice first
K23_NARROW_VARIANTS = {
    ("C=32, 3d3d grid, B=10", 10, 92, 68, 32, 32): (
        ["32, 32, 4, 3, 1, 64", "32, 32, 2, 3, 2, 64"],
        ["32, 32, 4, 4, 1, 32", "32, 32, 4, 3, 1, 32", "32, 32, 4, 5, 1, 32",
         "32, 32, 4, 6, 1, 32", "32, 32, 3, 4, 1, 64", "32, 32, 2, 4, 2, 32"]),
    ("C=32, 3d3d grid, B=90", 90, 92, 68, 32, 32): (
        ["32, 32, 4, 3, 1, 64", "32, 32, 2, 3, 2, 64"],
        ["32, 32, 4, 4, 1, 32", "32, 32, 4, 5, 1, 32", "32, 32, 3, 3, 1, 64",
         "32, 32, 3, 4, 1, 64"]),
    ("Cq=16 Cv=32, 3d3d grid, B=10", 10, 92, 68, 16, 32): (
        ["16, 32, 4, 3, 1, 64"],
        ["16, 32, 4, 4, 1, 32", "16, 32, 4, 3, 1, 32"]),
    ("C=16, 3d3d grid, B=10", 10, 92, 68, 16, 16): (
        ["16, 16, 4, 3, 1, 64"],
        ["16, 16, 4, 4, 1, 32", "16, 16, 4, 3, 1, 32"]),
    ("C=64, 3d3d grid, B=10", 10, 92, 68, 64, 64): (
        ["64, 64, 4, 3, 1, 32", "64, 64, 3, 3, 1, 64"],
        ["64, 64, 2, 3, 1, 64", "64, 64, 2, 4, 1, 64", "64, 64, 3, 3, 1, 32"]),
}


def k23_wgmma_variants() -> None:
    """The wgmma pair's instantiations against the mma.sync pair's, each
    built from a file that includes the checkout's .cu and held to the
    package's bits, timed in turns by CUDA events through the same C entry."""
    from mapfree_tpu_torch.ops import correlation as corr

    _pair_variants(corr.KERNEL_BWD_WGMMA, "wgmma", K23_WGMMA_VARIANTS)


def k23_narrow_variants() -> None:
    """The narrow pair's instantiations against the mma.sync pair's, as
    k23-wgmma-variants."""
    from mapfree_tpu_torch.ops import correlation as corr

    _pair_variants(corr.KERNEL_BWD_NARROW, "narrow", K23_NARROW_VARIANTS, parts=4)


def _pair_variants(library: str, pair: str, variants: dict, parts: int = 1) -> None:
    """Instantiations of ``library``'s launch_rows_<pair> and
    launch_cols_<pair> (their template arguments: ``variants``) against the
    mma.sync pair, at each shape of ``variants`` (the words after the
    study's name keep the shapes whose names contain one): each held to the
    package's bits (else to the matched tolerance), timed in turns by CUDA
    events through the same C entry, beside the backward of
    scaled_dot_product_attention."""
    import ctypes
    import tempfile

    import torch

    import chip_smoke as cs
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    _build.load_libraries([corr.KERNEL, corr.KERNEL_BWD_MMA, library])
    rows_v = sorted({a for r, _ in variants.values() for a in r})
    cols_v = sorted({a for _, c in variants.values() for a in c})
    body = [f'extern "C" int rows_{i}({_MMA_ROWS_ARGS}) {{ return launch_rows_{pair}<{a}>('
            f'bwd_hopper::make_args(q, k, v, grid, out, dout, dmain, stats, amax, dq, nullptr, '
            f'nullptr, B, HW, Cq, Cv, stream)); }}' for i, a in enumerate(rows_v)]
    body += [f'extern "C" int cols_{i}({_MMA_COLS_ARGS}) {{ return launch_cols_{pair}<{a}>('
             f'bwd_hopper::make_args(q, k, v, grid, nullptr, nullptr, dmain, stats, amax, nullptr, '
             f'dk, dv, B, HW, Cq, Cv, stream)); }}' for i, a in enumerate(cols_v)]
    with tempfile.TemporaryDirectory() as tmp:
        lib = _variant_lib(Path(tmp), body, f"{library}.cu", parts)
        for (name, B, H, W, cq, cv), (r_list, c_list) in variants.items():
            if sys.argv[2:] and not any(w in name for w in sys.argv[2:]):
                continue
            HW = H * W
            q, k, v, grid = cs._kernel_inputs(B, H, W, cq, cv, "bfloat16", seed=7,
                                              spread32=cq > 32)
            dout = cs._cotangent(B, HW, cv, seed=8)
            out = _exact_buffer(corr, q, k, v, grid)
            kernel = corr.backward_kernel(q.dtype, HW, cq, cv)
            dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout)
            dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows)
            torch.cuda.synchronize()
            sl = slice(0, 2)
            ref = corr.fused_correlation_warp_bwd_plain(
                q[sl], k[sl], v[sl], grid, dout[sl], rows.amax[sl].long(), bf16_roundings=True)[:3]
            tol = corr.mma_backward_matched_l2_tol(cq, cv, B * HW)
            l2 = cs._rel_l2([dq[sl], dk[sl], dv[sl]], ref)
            del ref
            print(f"[{card()}] {name}: the package takes the {kernel} pair (relative L2 {l2:.3g} "
                  f"vs the plain backward with its roundings on 2 rows, tol {tol:g})", flush=True)
            if l2 > tol:
                raise AssertionError(f"{name}: the package's K2, K3 at relative L2 {l2:.3g}")
            launches = {}
            for kind, args_list, values in (("K2", r_list, rows_v), ("K3", c_list, cols_v)):
                for a in args_list:
                    fn = getattr(lib, f"{'rows' if kind == 'K2' else 'cols'}_{values.index(a)}")
                    n_ptr = 10 if kind == "K2" else 9
                    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    if kind == "K2":
                        got = [torch.full_like(dq, float("nan")), torch.empty_like(rows.stats),
                               torch.empty_like(rows.amax), torch.empty_like(rows.dmain)]
                        ptrs, want = (q, k, v, grid, out, dout, *got), [dq, rows.stats, rows.amax,
                                                                        rows.dmain]
                    else:
                        got = [torch.full_like(dk, float("nan")), torch.full_like(dv, float("nan"))]
                        ptrs, want = (q, k, v, grid, rows.dmain, rows.stats, rows.amax, *got), [dk, dv]

                    def launch(fn=fn, ptrs=ptrs, label=f"{kind} {pair} <{a}>"):
                        err = fn(*(t.data_ptr() for t in ptrs), B, HW, cq, cv, 1,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{label} failed to launch: cudaError_t {err}")

                    label = f"{kind} {pair} <{a}>"
                    try:
                        launch()
                        torch.cuda.synchronize()
                    except RuntimeError as e:
                        print(f"[{card()}] {name}: {e}", flush=True)
                        continue
                    same = all(torch.equal(x, y) for x, y in zip(got, want))
                    if not same:
                        n = 1 if kind == "K2" else 2
                        err = cs._rel_l2([x[sl] for x in got[:n]], [x[sl] for x in want[:n]])
                        if err > tol:
                            raise AssertionError(f"{label} at {name}: relative L2 {err:.3g} to "
                                                 "the package's")
                    print(f"[{card()}] {name}: {label} gives the package's bits: {same}",
                          flush=True)
                    launches[label] = launch
            other = corr.KERNEL_FWD_MMA_SYNC
            dq_o, rows_o = corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=other)
            dk_o, dv_o = corr.correlation_bwd_cols(q, k, v, grid, dout, rows_o, kernel=other)
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in ((dq_o, dq), (dk_o, dk), (dv_o, dv))]
            print(f"[{card()}] {name}: the mma.sync pair gives the package's bits in dq, dk, dv: "
                  f"{same}", flush=True)
            launches["K2 mma.sync (the package's)"] = \
                lambda: corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=other)
            launches["K3 mma.sync (the package's)"] = \
                lambda: corr.correlation_bwd_cols(q, k, v, grid, dout, rows_o, kernel=other)
            times = {label: [] for label in launches}
            for label in list(launches) + list(launches)[::-1]:
                times[label].append(cs.cuda_time_ms(launches[label], iters=10, warmup=2))
            for label, ts in times.items():
                print(f"[{card()}] {name} (CUDA events): {label} {min(ts):.4f}-{max(ts):.4f} ms",
                      flush=True)
            vg = torch.cat([v, grid.expand(B, HW, 2), v.new_zeros(B, HW, 6)], dim=-1)[:, None]
            qh, kh, vh = (t.detach().requires_grad_(True) for t in (q[:, None], k[:, None], vg))
            do = torch.cat([dout[..., :cv + 2], dout.new_zeros(B, HW, 6)],
                           dim=-1)[:, None].to(q.dtype)
            print(f"[{card()}] {name}: attention backward "
                  f"{cs.sdpa_ms(qh, kh, vh, iters=10, do=do)[0]:.4f} ms", flush=True)
            del q, k, v, grid, dout, out, dq, dk, dv, rows, dq_o, dk_o, dv_o, rows_o, launches
            torch.cuda.empty_cache()


BWD_CHECKOUT = """
import importlib.util
import sys
from pathlib import Path
root, smoke = Path(sys.argv[1]).resolve(), sys.argv[2]
sys.path.insert(0, str(root))
spec = importlib.util.spec_from_file_location("chip_smoke_here", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
import mapfree_tpu_torch
from mapfree_tpu_torch.ops import _build
from mapfree_tpu_torch.ops import correlation as corr
assert Path(mapfree_tpu_torch.__file__).resolve().is_relative_to(root)
_build.load_libraries([lib for lib in corr.LIBRARIES if lib != corr.KERNEL])
for name, B, H, W, cq, cv, dtype in (
        ("bf16, C=32, 3d3d grid, B=10", 10, 92, 68, 32, 32, "bfloat16"),
        ("bf16, C=32, 3d3d grid, B=90", 90, 92, 68, 32, 32, "bfloat16"),
        ("bf16, C=128, 3d3d grid, B=10", 10, 92, 68, 128, 128, "bfloat16"),
        ("float32, 3d3d grid, B=10", 10, 92, 68, 32, 32, "float32"),
        ("float32, C=1,024, 5x4, B=10", 10, 5, 4, 1024, 1024, "float32"),
        ("bf16, C=1,024, 5x4, B=10", 10, 5, 4, 1024, 1024, "bfloat16"),
        ("bf16, Cq=256 Cv=96, 3d3d grid, B=10", 10, 92, 68, 256, 96, "bfloat16")):
    q, k, v, grid = cs._kernel_inputs(B, H, W, cq, cv, dtype, seed=5, spread32=cq > 32)
    dout = cs._cotangent(B, H * W, cv, seed=6)
    out = torch.cat([corr._plain_buffer(q[i:i + 6], k[i:i + 6], v[i:i + 6], grid)
                     for i in range(0, B, 6)])
    dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout)
    dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows)
    sl = slice(0, 2)  # the plain backward's [B, HW, HW] volumes on two rows
    ref = corr.fused_correlation_warp_bwd_plain(q[sl], k[sl], v[sl], grid, dout[sl],
                                                rows.amax[sl].long())[:3]
    errs = cs._scaled_err([dq[sl]], ref[:1]), cs._scaled_err([dk[sl], dv[sl]], ref[1:])
    del ref
    design = corr.backward_design(q.dtype, cq, cv)
    exact_tol = getattr(corr, "mma_backward_exact_tol", lambda cq, cv: corr.MMA_VS_EXACT_TOL)
    tol = exact_tol(cq, cv) if design == corr.DESIGN_MMA else cs.BWD_TOL
    k2 = lambda: corr.correlation_bwd_rows(q, k, v, grid, out, dout)
    k3 = lambda: corr.correlation_bwd_cols(q, k, v, grid, dout, rows)
    t = [cs.cuda_time_ms(f, iters=10, warmup=2) for f in (k2, k3)]
    g = [cs.graph_ms(f, 10) for f in (k2, k3)] if H * W <= 64 else None
    alone = f" (on the device alone {g[0]:.4f}, {g[1]:.4f})" if g else ""
    print(f"[bwd] {name}: design {design}: K2 {t[0]:.4f} ms, K3 {t[1]:.4f} ms{alone}; K2 "
          f"{errs[0]:.3g}, K3 {errs[1]:.3g} of the largest gradient vs the exact plain backward "
          f"on 2 rows (tol {tol:g})", flush=True)
    if max(errs) > tol:
        raise AssertionError(f"{name}: K2, K3 disagree with the exact plain backward")
    del q, k, v, grid, dout, out, dq, dk, dv, rows
    torch.cuda.empty_cache()
"""


def bwd_checkouts(*checkouts) -> None:
    roots = [REPO, *[Path(c) for c in checkouts]]
    for root in roots + roots[::-1]:
        got = subprocess.run([sys.executable, "-c", BWD_CHECKOUT, str(root),
                              str(REPO / "chip_smoke.py")],
                             capture_output=True, text=True, timeout=900)
        for ln in (got.stdout + got.stderr).splitlines():
            if ln.startswith("[bwd]") or "Error" in ln:
                print(f"[{card()}] {root}: {ln}", flush=True)
        if got.returncode:
            sys.exit(f"{root}: exit {got.returncode}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is False")
    studies = {"decode-threads": decode_threads, "bf16-seeds": bf16_seeds,
               "bf16-faults": bf16_faults, "upsample-ab": upsample_ab,
               "sweep-determinism": sweep_determinism, "mesh-faults": mesh_faults,
               "wide-unscaled": wide_unscaled, "k1-variants": k1_variants,
               "k1-wgmma-variants": k1_wgmma_variants,
               "k1-fma-variants": k1_fma_variants, "k1-fma-edits": k1_fma_edits,
               "k23-fma-variants": k23_fma_variants, "k23-mma-variants": k23_mma_variants,
               "k23-wgmma-variants": k23_wgmma_variants,
               "k23-narrow-variants": k23_narrow_variants}
    if sys.argv[1:2] == ["decode-under-load"]:
        decode_under_load(*sys.argv[2:])
        return
    if sys.argv[1:2] == ["f32-checkouts"]:
        f32_checkouts(*sys.argv[2:])
        return
    if sys.argv[1:2] == ["bwd-checkouts"]:
        bwd_checkouts(*sys.argv[2:])
        return
    if sys.argv[1:2] in (["k1-wgmma-variants"], ["k23-wgmma-variants"],
                         ["k23-narrow-variants"]):
        studies[sys.argv[1]]()  # the words after it name shapes
        return
    names = sys.argv[1:] or list(studies)
    for name in names:
        if name not in studies:
            others = ["decode-under-load", "f32-checkouts", "bwd-checkouts"]
            sys.exit(f"unknown study {name!r}; choose from {sorted(studies) + others}")
    for name in names:
        studies[name]()


if __name__ == "__main__":
    main()
