#!/usr/bin/env python3
"""Drive the PyTorch port (mapfree_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels (correlation_fwd: K1; correlation_bwd_narrow,
   correlation_bwd_wgmma, correlation_bwd_mma and correlation_bwd: K2, K3;
   each in two designs, tensor cores for bf16 and float32 FMA, K1's
   tensor-core design in two kernels, wgmma and mma.sync, K2 and K3's in
   three pairs, narrow (up to 64 channels), wgmma and mma.sync, and the
   prologue the mma.sync K2 launches where its operands stream), the Kabsch
   solve (kabsch: the Procrustes head's and the matching solvers' alignment
   where no gradient is recorded), the nvJPEG decoder and the PNG reader's
   host unfilter,
   compiled at once from this checkout's sources with nvcc, with ptxas's
   registers and spills per kernel instantiation;
3. kernel: K1 (the fused correlation softmax-warp), K2 and K3 (its backward
   row and column passes) against their plain PyTorch versions on the card
   (ragged HW, HW < 64, Cq != Cv, 8 to 128 channels, bf16 and float32, a bf16
   shape only the FMA designs take, the mid-window HW=576, the 3d3d shape,
   the max-score cotangent alone, two runs of K2 and K3 for equal bits in
   every case), each case with the design that served it; a tensor-core
   design is held to the plain version with the same bf16 roundings (tight,
   relative L2; for K2 its one sweep, with every column tile of dq on its
   own) and to the exact one (the tolerances the CPU tests derive, wider
   beyond 128 channels), K1's max score to the exact one at float32
   tightness, K2's row statistics to the scores and the forward's max score,
   and K2's dmain and row constant to the plain prologue; the Hopper pair
   of K2 and K3 that takes a case's widths is set beside the mma.sync pair
   on it (bits, hand-offs both ways), and the narrow pair is held by name at
   every class it takes, at B = 10 and 90 on the 3d3d grid, on a tie, NaN
   rows and the max-score cotangent alone; the Kabsch kernel against the
   tensor version (geom/procrustes.py::procrustes_plain) at the shapes the
   main paths give it (the heads' n = 64 and 576, PnP's 262,144 problems,
   the ICP's weighted refine at 64 x 2,048), per problem within
   ops/kabsch.py::vs_plain_tolerances. Then each is timed beside the plain version, one PyTorch
   library call (scaled_dot_product_attention and its backward, timed here
   only) and its bound: K1 at the inference shape (B=64, HW=6,256, C=32,
   bf16) in both designs, and K1, K2, K3 at the training shape (B=10), which
   the tensor-core designs must serve; then K1 at the fusion sweep's batch
   (B = 64 x 9 = 576) and K2, K3 at the fusion train step's (B = 10 x 9 =
   90), held to the plain versions on their first and last two batch rows
   (the plain versions' [B, HW, HW] volumes would not fit the card); then
   every width (Cq = Cv of 126, 128, 136, 256 and 1,024, and 256 / 96, at HW
   20, 70 and 1,000, float32 and bf16): K1, K2 and K3 on the tensor cores
   at every bf16 width that is a multiple of 8 (K2 and K3's own tiles
   resident up to 128 channels and at 256 / 96; wider, and K1 beyond 128,
   the operands streamed in channel chunks of 64, the accumulator in column
   tiles of 128; 136 gives a zero-filled last chunk and a last column tile
   of 8; K1 also at 64 pairs of widths from 8 to 1,024 that reach every
   instantiation), the FMA designs elsewhere (the
   channels in chunks and the accumulator columns in tiles of 128), and K1,
   K2, K3 timed at the ResNet bottleneck's 1,024 channels on its 5x4 grid,
   at 128 channels on the 3d3d grid (K1 at B=10 and 64), K2 and K3 at 64
   (the narrow pair's class) on the 3d3d grid at B=10, at 256 / 96 (the
   FMA designs beside the tensor-core ones there) and at the 256-channel
   ResUNet's 256 (K2 and K3 streamed); then float32 K1, K2, K3 (the FMA
   designs) at the 3d3d shapes (K1 at B=64 and B=10) and at 1,024 channels
   beside float32 attention with TF32 off, its backend named. K1's FMA
   design is also held at the edges of its two kernels (HW 100 below the
   long-rows kernel's row tile, HW 63, 64 and 65 about the few-rows
   kernel's limit, Cq != Cv and a bf16 width that is not a multiple of 8 on
   the few-rows kernel, 1,024 unscaled channels), and two runs of it give
   equal bits; K2 and K3's FMA design at the same edges of its two kernel
   pairs and at HW 20 (Cq = Cv and 16 / 32), at scores near 3,300, and both
   designs (the tensor-core one resident at 32 channels and at 256 / 96,
   streamed at 256) at an exact tie for a row's maximum (the cotangent on the first
   index) and at a NaN row (no fault, the argmax in range, the NaN in the
   gradients); at HW <= 64, where the host's time to issue a call paces
   it, K1, K2, K3 and the library calls are also timed on the device alone
   (CUDA graphs). K2 and K3 take the wgmma pair beyond 64 positions with Cq,
   Cv from 65 to 256 (the mma.sync pair up to 64 channels, where it
   measured faster, at HW <= 64 and wider); at every case of a width the
   wgmma pair takes, both pairs also run by name on the same inputs (the
   wgmma pair held to the matched backward, their bits printed, each pair's
   K2 handed on to the other's K3 and held to it), the wgmma pair is also
   held, asked for by name, at HW 65 and 1,000, Cq = Cv = 24, 1,000 batch
   elements of 70 positions and NaN in the next batch element, and both
   pairs are timed in turns at every driven shape;
4. inference path: the 3d3d model (configs/regression/mapfree/3d3d.yaml over
   configs/mapfree.yaml: ResUNet 3-3-3 bottleneck, 360x270, bf16, batch 64,
   unique refs, planar YUV420 input) with random weights from a seed, driven
   through build_model -> predict -> save_submission on synthetic pairs;
   every pose must be finite with det(R) = 1 and K1 must have launched once
   per batch, in its tensor-core design; then a torch.profiler window over three forwards prints the
   device time by kernel and the device's busy share;
5. training path: the same model at its training batch of 10 (rot_angle_loss
   + trans_l1_loss, Adam 1e-4), on uint8 RGB noise with random poses: timed
   steps through init_state -> make_train_step (ms per step, samples/s, peak
   memory, the loss at each step, a profiler window over three steps), then
   the fit loop with validation passes and checkpoints in a temporary
   directory. Every loss must be finite, K1, K2 and K3 must each have
   launched once per train step (all three in their tensor-core designs) and
   K1 once per validation batch, the
   parameters and BatchNorm statistics must have changed, and the restored
   ``last`` checkpoint must reproduce the validation loss;
6. device parity: a small float32 model on the GPU and the CPU with the
   same weights and batch, the process's TF32 settings on (the float32
   forward and train step turn TF32 off for themselves): the poses, then the
   loss and every gradient of one train step; 8 steps on one batch at
   LR 1e-3 lower the loss on the card; and one bf16 train step of the same
   small model with the kernels (the tensor-core designs) against the same
   step with the plain versions on the card (the forward with K1's bf16
   rounding of P);
7. decode: nvJPEG (data/jpeg.py, data/csrc/jpeg_decode.cu) on the committed
   540x720 fixtures (tests/data/torch_port/) against the JAX package's
   decode of them at 270x360, as planar YUV420 and as uint8 (mean |diff| at
   most 1 level, the largest no larger than the JAX package's own two
   decode paths differ on those files), the zero-fill of a missing file and
   of four that nvJPEG reports as bad input (empty, no JPEG, cut off,
   garbage scan), the wall time of a 64-frame batch, and the same batch
   decoded beside queued work on the card equal to the quiet decode;
8. the user's CLIs from JPEG files: a MapFree tree of fixture copies in a
   temporary directory (DATA_ROOT set by a YAML there), the submission CLI
   (python -m mapfree_tpu_torch.submission's main) at 3d3d.yaml's width,
   bf16, INFER_BATCH 64 over 320 test pairs with random weights, then the
   train CLI (python -m mapfree_tpu_torch.train's main) for one epoch of 8
   steps at batch 10 with one validation and its checkpoints, then the
   submission CLI on that run's last.pt: one line per query frame, finite
   poses, unit quaternions, K1 (tensor cores) once per sweep batch, K1-K3
   in the train CLI, and poses that the checkpoint moved;
9. the QKV path: rotbin_transdirectionbin_scale_qkv.yaml over mapfree.yaml
   (the QKV aggregator, whose K1 takes k and v that differ, and the
   angular-bin head) at full width: the sweep from memory through predict
   (64-pair YUV420 batches with unique refs), 10 timed train steps at batch
   10 with its bin losses, and one float32 train step of the small model
   with the kernels against the plain versions on the card, per tensor;
10. the fusion path: multiframe/3d3d_multi_fusion.yaml over mapfree_multi.yaml
   (F = 9) at full width: the sweep from memory (RGB uint8 [64, 9, 360, 270,
   3] windows with device poses, a final partial batch), a profile window
   over its forward and the line where it first waits for the device, 10
   timed train steps at batch 10 (100 frames through the encoder a step),
   and the float32 kernels-against-plain step of the small model;
11. every config under configs/regression/ (and BLOCK_TYPE 2): one float32
   forward at one block per stage and 96x72 on the card and on the CPU,
   poses within 2e-4, K1 once for each config that takes the fused route;
   then the models wider than every config, at full width (360x270, bf16):
   the ResNet bottleneck (1,024 channels) and a ResUNet with NUM_OUT_LAYERS
   128, each a sweep through build_model -> predict with K1 (tensor cores)
   once per batch and a float32 forward at one block per stage on the card
   and the CPU, one float32 train step of the ResNet model with the kernels
   against the plain versions on the card, and phase 6's bf16 step on the
   128-channel ResUNet with K1-K3 all on the tensor cores; then a ResUNet
   with NUM_OUT_LAYERS 256 at full width (360x270, HW 6,256, Cq = Cv = 256,
   bf16, batch 10): 5 timed train steps (ms per step, samples/s, peak
   memory, K1-K3's ms in a profiler window), K1, K2 and K3 once a step on
   the tensor cores, and one step held to the same step with the plain
   backward after the same K1 forward and with the plain forward too, at
   phase 6's bf16 limits, and K1-K3 on that step's own correlation inputs
   at phase 3's limits;
12. the fusion model's CLIs from JPEG files: a MapFree tree of fixture
   copies with poses_device.txt, the submission CLI over 160 windows, the
   train CLI for 8 steps at batch 10 with one validation, and the submission
   CLI on its last.pt;
13. the feature-matching track (no kernel of its own): (a) the PNG reader
   on the fixture PNGs, bit-exact against their stored arrays with the C
   unfilter and the numpy one, and its ms per 540x720 depth map; (b) the
   essential metric, PnP and Procrustes + ICP solvers on the card against
   the CPU with the same minimal samples (B=4, N=512), and the essential
   solve with TF32 on and off (equal bits); (c) each solver at full width
   (INFER_BATCH 64, 2,048 correspondences, 1,024 hypotheses, the adaptive
   ladder on) on 3 batches of synthetic pairs with outliers and pixel
   noise: accuracy against the truth (medians under 1.5 deg and 0.08 m),
   ms per batch, launches, device busy share, escalations, and every host
   sync of the dispatch (only the adaptive fetch may wait); (d) the
   submission CLI over a MapFree tree of the fixtures with depth PNGs and
   correspondences from known poses, for loftr_emat_dptkitti,
   sg_pnp_dptkitti, sg_procrustes_dptkitti and sift_emat_ingraph (the depth
   net at random weights);
14. the evaluation path (no kernel of its own but K1): (a) a ScanNet test
   split of 80 copies of the 1296x968 JPEG fixtures (views of a textured
   room, tests/data/torch_port/room.py) with 640x480 .pgm depth written
   here in numpy, 132 pairs: nvJPEG on the fixtures against the JAX
   package's cv2 decode of them at 320x240 and its ms per 64 frames, then
   configs/regression/scannet/3d3d.yaml through the ScanNet CLI's main(argv)
   (bf16, INFER_BATCH 64): K1 once per batch, pairs/s; (b) K1 at that
   sweep's shape (B=64, HW=4,800) held to its whole plain version and timed
   beside SDPA and its bound; (c) sift_emat_gt.yaml with FEATURE_MATCHING
   SIFT_TPU through the same CLI and tree: accuracy against the truth, ms
   of SIFT and of the solve on a batch, launches, busy share, keypoints and
   matches, the card's SIFT against the CPU's on two pairs and against
   itself; (d) the 7Scenes CLI with sift_emat_planercnn.yaml without and
   with --triang over a tree of the room rendered here (640x480 PNGs,
   correspondences from the known geometry); (e) the MapFree scorer on
   phase 13's loftr_emat_dptkitti submission.zip and on a zip of the
   ground truth (zero error, precision 1);
15. the tools (no kernel of their own but K1): (a) the depth net's training
   tool (python -m mapfree_tpu_torch.tools.train_depth's main) at full width
   (configs/mapfree.yaml: 720x540, bf16, NUM_BLOCKS 2-2-2) for 20 steps of
   8 pairs over a MapFree train tree of the fixture JPEGs with 16-bit GT
   depth PNGs written here, every logged loss finite; the full-width step
   timed on the card (ms, images/s, peak memory, a profiler window); one
   float32 step of a small depth net on the card against the CPU (phase
   6's tolerances); the submission CLI with sift_emat_ingraph.yaml over
   phase 13's tree on the written depth.pt (no ALLOW_RANDOM); (b) a
   Lightning checkpoint of the 3d3d net at random weights through the
   converter's CLI, and the submission CLI on the .ckpt and on the .pt
   (bit-equal poses); (c) the submission CLI on the .pt with --num_hosts 3
   --host_id 2, 1, 0 (host 0 merges), then single-host: the same files and
   frames, poses within SHARDED_POSE_TOL; (d) render_estimates over a scene
   of 40 query photos at 960x720 on the card (an MP4 where cv2 imports,
   else every frame rendered and counted and one line), render_frames on
   the card against the CPU on the same photos (share of differing
   pixels), ms per frame on both, and render_scene on the card with cv2
   hidden (no MP4, the frames counted, one line);
16. the data mesh (one card here: more than one is not shown): (a)
   make_mesh() holds the visible cards, and the predictor over them gives
   phase 4's poses to the bit; two replicas on the card (the predictor's
   multi-device path) within 2e-4 of one in float32, and a full-width sweep
   through them; (b) the train CLI under one NCCL rank (torchrun's
   environment) for 8 steps of 3d3d at batch 10, bf16, its losses within
   three times the spread of two runs without a process group; (c) two gloo
   ranks sharing the card on one float32 3d3d train step at full width, 5
   rows each of a batch of 10, against one process on the 10: the loss at
   phase 6's limit, the BatchNorm statistics within 1e-5, the gradients (in
   L2 and the median tensor) within three times what the same step on the
   rows in reverse order moves them; the ms per step of (b) and (c);
17. the float32 sweeps (run right after phase 4): 3d3d.yaml with
   TPU.COMPUTE_DTYPE float32 at full width (360x270, batch 64, 3 batches
   after the usual warm-up) and the ResNet-bottleneck model of phase 11
   (1,024 channels on the 5x4 grid) the same way, through predict: K1 once
   per batch in its FMA design, the forward by CUDA events, K1's ms within
   it (a profiler window), pairs/s, and R and t of one batch against the
   same batch through the plain forward on the card within 2e-4;
18. the train steps of the float32 3d3d model and the bf16 ResNet
   bottleneck, at full width (360x270, batch 10, 2 warm-up and 5 timed
   steps through init_state -> make_train_step): 3d3d.yaml in float32
   (K1-K3 all FMA) and the ResNet bottleneck in bf16 (K1-K3 on the tensor
   cores at 1,024 channels; K2 and K3 were the FMA pair before): ms per step, samples/s, peak memory, K1-K3's ms in a profiler
   window, each launched once a step in those designs; one step of each
   against the same step with the plain backward after the same K1 forward
   on the card, at phase 6's float32 and bf16 limits, and with the plain
   forward too (float32: the loss, and the whole gradient and the median
   tensor within three times what the plain versions move by over the keys
   in reverse order, with the BatchNorm outputs that change sign counted;
   bf16: phase 6's limits, and what one float32 ulp in the plain backward's
   dq, dk and dv moves the gradient by printed); and K2, K3 (and the float32
   K1) on the correlation's own inputs in each step at phase 3's limits.

The last line of standard output is {"ok": true, "device": {...}}; a
"kernels" JSON line and the card's name and power limit precede it. With no
CUDA device, or outside a checkout of the repository, it exits nonzero and
prints no result. ``--kernels-only`` stops after phase 3 and prints no
result line (a quick check while working on a kernel).
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import subprocess
import sys
import tempfile
import time
import warnings
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
LOG2E = 1.4426950408889634

# K1's FMA design against its plain version: f32 outputs differ by exp2 of
# log2e-scaled scores and summation order; bf16 cases feed both sides the same
# bf16 inputs and both accumulate in f32. The tensor-core design's two
# tolerances are the package's (ops/correlation.py: MMA_FWD_VS_EXACT_TOL,
# MMA_FWD_VS_MATCHED_L2_TOL); its max score, summed from float32 P, is held
# to the exact plain forward at ATOL["float32"]
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
# (Cq, Cv) of phase 3's wide cases, each at HW 20, 70 and 1,000 in float32
# and bf16 (q and k scaled by _kernel_inputs' spread32; float32 at 1,024
# unscaled too). In bf16, 136 gives the tensor-core K2 and K3 a last channel
# chunk of 8 channels and 56 zeros and a last column tile of 8 columns
WIDE_CHANNELS = ((126, 126), (128, 128), (136, 136), (256, 256), (1024, 1024), (256, 96))
# the ResNet encoder's output grid for 360x270 frames
# (models/encoders.py::encoder_out_hw): 5 x 4
RESNET_GRID = (5, 4)
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
# phase 18's full-width float32 step with the kernels against the plain
# versions forward too: at most this many times what the plain versions move
# by when they sum over the keys in reverse order, in the whole gradient's L2
# norm and the median tensor (as phase 16 (c) holds the mesh to reversing
# the batch's order)
STEP_ORDER_FACTOR = 3.0
# one bf16 train step with K1 and the tensor-core K2 and K3 against the same
# step with the plain backward after the same K1 forward: the two share their
# forward to the bit, so the loss is equal and the gradients differ by what
# K2 and K3 differ. Those round dmain, P and dS to bf16 (at most
# MMA_VS_EXACT_TOL of a gradient's largest entry, about half a per cent in
# L2), the layers below are linear in them, and two runs of one step already
# differ by some 3e-3 in L2 (cuDNN's bf16 weight gradients use atomics): the
# whole gradient is held to MMA_VS_EXACT_TOL in the L2 norm
STEP_BF16_BWD_L2_TOL = 2e-2
# the same step with the plain forward too, which rounds P to bf16 as K1's
# tensor-core design does (fused_correlation_warp_plain(bf16_roundings=True)).
# K1 and that forward agree to some 1e-5 in L2, but every bf16 layer after
# them rounds such a difference up to whole bf16 steps (2^-8), so the loss
# agrees only to a few of those and the gradient, through a loss whose
# rotation term is an arccos, to 10-20 per cent in L2. That share depends on
# the seeds and on the run: on an H100 over six (batch, weight) seeds it was
# 0.083-0.191 with the ResUNet's upsample in float32 and 0.105-0.184 with it
# in bf16 as the JAX package computes it (tools/torch_chip_studies.py
# bf16-seeds), and 0.149 and 0.168 in two runs of this script's seeds
# (PERF.md). Faults planted in K1 (tools/torch_chip_studies.py bf16-faults,
# same seeds) read 1.24-1.29 (accumulator not rescaled), 0.78-1.04 (last key
# tile skipped) and 0.34-0.66 (grid read one key off); the limit lies between
# those and the sound readings. Subtler faults (P left unrounded, the
# denominator summed from the rounded P, a normaliser 1% off) read 0.12-0.26,
# inside the sound spread: this step cannot tell them apart, and phase 3's
# tight check of K1 alone is what holds them. No planted fault moved the loss
# by 1%: its limit only catches a step that is off altogether
STEP_BF16_LOSS_RTOL = 1e-2
STEP_BF16_L2_TOL = 0.25
# the tensor-core pair of K2 and K3 a bf16 train path takes
# (ops/correlation.py::backward_kernel, MMA_SYNC_FASTER): mma.sync at 32
# channels (every config under configs/regression/) and on the ResNet
# encoder's 5x4 grid, wgmma at 128 and 256 channels
BWD_MMA_SYNC = ["mma_sync"]
BWD_WGMMA = ["wgmma"]


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


def graph_ms(fn, iters: int, stream=None) -> float:
    """Mean milliseconds per call of ``fn`` on the device alone: ``iters``
    calls captured in one CUDA graph (on ``stream`` where given), replayed
    between CUDA events. A call that takes the device less time than the
    host takes to issue it is paced by the host in :func:`cuda_time_ms`;
    here it is not."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
    """Every CUDA source at once, one nvcc process each: the kernels' and the
    nvJPEG decoder's (which needs nvjpeg.h and libnvjpeg.so beside the
    toolkit)."""
    from mapfree_tpu_torch.data import jpeg
    from mapfree_tpu_torch.ops import _build
    from mapfree_tpu_torch.ops import correlation as corr

    t0 = time.perf_counter()
    from mapfree_tpu_torch.data import png

    from mapfree_tpu_torch.ops import kabsch

    names = list(corr.LIBRARIES) + [kabsch.LIBRARY, jpeg.LIBRARY, png.LIBRARY]
    _build.load_libraries(list(corr.LIBRARIES) + [kabsch.LIBRARY, jpeg.library_spec(),
                                                  (png.LIBRARY, png.SOURCE_DIR)])
    log(f"[build] {len(names)} libraries in {time.perf_counter() - t0:.2f} s")
    for name in names:
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
                r"\d+(correlation_\w+?_kernel)(?:I((?:f|13__nv_bfloat16|Li\d+E|Lb[01]E)+)E)?",
                line)
            if m:
                tokens = re.findall(r"f|13__nv_bfloat16|Li\d+E|Lb[01]E", m.group(2) or "")
                names = [{"f": "f32", "13__nv_bfloat16": "bf16", "Lb0E": "false",
                          "Lb1E": "true"}.get(tok, tok[2:-1]) for tok in tokens]
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

def _kernel_inputs(B, H, W, cq, cv, dtype, seed, spread32=False):
    """Standard normal q, k, v on the card. With ``spread32`` q and k are
    scaled by (32 / Cq)^(1/4) above 32 channels, so that the scores q . k
    spread as they do at 32 channels; phase 3 also holds float32 K1-K3 to the
    same tolerances on unscaled inputs at 1,024 channels, whose scores reach
    some 100."""
    import torch

    from mapfree_tpu_torch.models.aggregators import _uv_grid

    rng = np.random.default_rng(seed)
    HW = H * W
    dev = torch.device("cuda", 0)
    td = getattr(torch, dtype)
    scale = (32.0 / max(cq, 32)) ** 0.25 if spread32 else 1.0
    q, k = (torch.from_numpy(scale * rng.standard_normal((B, HW, cq), np.float32)).to(dev, td)
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


def forward_case(q, k, v, grid, kernel=None, keep_out=False) -> dict:
    """K1 against its plain version on the same inputs, by the design that
    serves them (in the tensor-core design by the kernel the package picks,
    or ``kernel``). The FMA design is held to the exact plain forward at
    ATOL; the tensor-core design to the plain forward with its bf16 rounding
    of P (relative L2 of warped and pos), to the exact one (a share of each
    output's largest entry) and, in its max score, to the exact one at
    float32 tightness. With ``keep_out`` the result keeps the kernel's
    output (``out``)."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    design = corr.forward_design(q.dtype, q.shape[-1], v.shape[-1])
    if kernel is None:
        kernel = corr.forward_kernel(q.dtype, q.shape[1], q.shape[-1], v.shape[-1])
        out = corr.fused_correlation_warp(q, k, v, grid)
    else:
        out = corr._split(corr._forward_cuda(q, k, v, grid, kernel=kernel), v.shape[-1])
    torch.cuda.synchronize()
    ref = corr.fused_correlation_warp_plain(q, k, v, grid)
    torch.cuda.synchronize()
    res = {"design": design, "kernel": kernel, "max_abs_err": _max_err(out, ref)}
    if keep_out:
        res["out"] = out
    if design == corr.DESIGN_MMA:
        matched = corr.fused_correlation_warp_plain(q, k, v, grid, bf16_roundings=True)
        torch.cuda.synchronize()
        res.update(err=_scaled_err(out[:2], ref[:2]), tol=corr.MMA_FWD_VS_EXACT_TOL,
                   l2=_rel_l2(out[:2], matched[:2]),
                   l2_tol=corr.mma_forward_matched_l2_tol(q.shape[-1], v.shape[-1]),
                   ms_err=_max_err(out[2:], ref[2:]), ms_tol=ATOL["float32"])
    else:
        res.update(err=res["max_abs_err"], tol=ATOL[str(q.dtype).split(".")[-1]])
    return res


def check_forward(res: dict, what: str) -> None:
    """Raise if K1 in a :func:`forward_case` is out of tolerance."""
    if not res["err"] <= res["tol"]:
        raise AssertionError(f"K1 ({res['design']}) disagrees with the exact plain forward in "
                             f"{what}: {res['err']:.3g} > {res['tol']:g}")
    if "l2_tol" in res and not res["l2"] <= res["l2_tol"]:
        raise AssertionError(f"K1 disagrees with the plain forward of the same rounding in "
                             f"{what}: relative L2 {res['l2']:.3g} > {res['l2_tol']:g}")
    if "ms_tol" in res and not res["ms_err"] <= res["ms_tol"]:
        raise AssertionError(f"K1's max score disagrees with the exact plain forward in {what}: "
                             f"{res['ms_err']:.3g} > {res['ms_tol']:g}")


def _forward_line(res: dict) -> str:
    """One case's forward errors, with the design (and kernel) that served it."""
    line = f"K1 design {res['design']}" + (f" ({res['kernel']})" if res.get("kernel") else "") + ": "
    if "l2_tol" in res:
        return line + (f"{res['err']:.3g} of the largest entry vs the exact plain forward "
                       f"(tol {res['tol']:g}); relative L2 {res['l2']:.3g} vs the plain forward "
                       f"with the kernel's bf16 rounding (tol {res['l2_tol']:g}); max score "
                       f"{res['ms_err']:.3g} (tol {res['ms_tol']:g})")
    return line + f"max |kernel - plain| = {res['err']:.3g} (atol {res['tol']:g})"


def backward_case(q, k, v, grid, dout, kernel=None) -> dict:
    """K2 and K3 against their plain versions on the same inputs, by the
    design that serves them (in the tensor-core design by the pair the
    package picks, or ``kernel``), given the exact forward's buffer. Where the
    kernel's first argmax differs from the plain version's, the two scores
    must be equal within float32 summation noise (the two sum q.k in other
    orders); the plain version then routes the max-score cotangent as the
    kernel did, so that the comparison is of the same function. The
    tensor-core design is compared twice: with the plain backward that rounds
    dmain, P and dS to bf16 as it does (relative L2), and with the exact one
    (at the tolerances of its widths and B x HW rows); its prologue's
    outputs are compared too. The Hopper pair that takes the widths (up to
    64 channels the narrow one, beyond the wgmma one) is also set beside the
    mma.sync pair on the same inputs: their bits compared, and each one's K2
    handed on to the other's K3, held to the matched backward."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    design = corr.backward_design(q.dtype, q.shape[-1], v.shape[-1])
    pair = kernel or corr.backward_kernel(q.dtype, q.shape[1], q.shape[-1], v.shape[-1])
    # K2 and K3 take the forward's buffer (1/d and c = dout . out); they get
    # the exact plain forward's, because the plain backward forms c from its
    # own float32 P: K1's tensor-core design rounds P to bf16, which moves c
    # by some 1e-3 relative and would stand between the two backwards
    out = corr._plain_buffer(q, k, v, grid)
    dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=kernel)
    dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows, kernel=kernel)
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
    res = {"design": design, "kernel": pair, "k2_err": _scaled_err([dq], [dq_p]),
           "k3_err": _scaled_err([dk, dv], [dk_p, dv_p]), "argmax_near_ties": moved,
           "dk": dk, "dv": dv, "rows": rows, "tol": BWD_TOL}
    # the statistics K2 hands to K3, against the scores and the forward's max
    # score: the row max (a score as it is in the FMA design; in the
    # tensor-core design recovered from lse = max log2e - log2(1 / d)) and 1 / d
    s = torch.bmm(q.float(), k.float().transpose(1, 2)).amax(dim=-1)
    inv_d = rows.stats[..., 1]
    if design == corr.DESIGN_FMA:
        row_max, max_tol = rows.stats[..., 0], tie_tol
    else:
        # lse carries the float32 roundings of max log2e and of the sum
        row_max = (rows.stats[..., 0] + torch.log2(inv_d)) / LOG2E
        max_tol = tie_tol + 4e-7 * max(1.0, float(s.abs().max()))
    res["stats_err"] = max(float((row_max - s).abs().max()) / max_tol,
                           float((inv_d / out[..., -1] - 1).abs().max()) / 1e-5)
    del s
    # fixed summation orders, no atomics: a second run gives the same bits
    dq2, rows2 = corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=kernel)
    dk2, dv2 = corr.correlation_bwd_cols(q, k, v, grid, dout, rows2, kernel=kernel)
    torch.cuda.synchronize()
    res["same_bits"] = all(torch.equal(a, b) for a, b in (
        (dq, dq2), (dk, dk2), (dv, dv2), (rows.stats, rows2.stats), (rows.amax, rows2.amax)))
    del dq2, rows2, dk2, dv2
    if design == corr.DESIGN_MMA:
        Cq, Cv, n_rows = q.shape[-1], v.shape[-1], q.shape[0] * q.shape[1]
        dq_m, dk_m, dv_m, _ = corr.fused_correlation_warp_bwd_plain(
            q, k, v, grid, dout, amax, bf16_roundings=True)
        torch.cuda.synchronize()
        res.update(tol=corr.mma_backward_exact_tol(Cq, Cv, n_rows),
                   l2_tol=corr.mma_backward_matched_l2_tol(Cq, Cv, n_rows),
                   k2_l2=_rel_l2([dq], [dq_m]), k3_l2=_rel_l2([dk, dv], [dk_m, dv_m]),
                   k2_matched=_scaled_err([dq], [dq_m]),
                   k3_matched=_scaled_err([dk, dv], [dk_m, dv_m]))
        # every column tile of dq (128 columns beyond 128 channels) against the
        # matched plain backward on its own: a tile whose row max or argmax
        # differed from the others' would be scaled or shifted alone
        res["k2_tile_l2"] = max(_rel_l2([dq[..., c:c + 128]], [dq_m[..., c:c + 128]])
                                for c in range(0, Cq, 128))
        # dmain, 1/d and d_ms to the bit, c to summation order
        dmain_p, stats_p = corr.correlation_bwd_prologue_plain(out, dout)
        if not torch.equal(rows.dmain, dmain_p):
            raise AssertionError("K2's bf16 dmain differs from the plain prologue's")
        if not torch.equal(rows.stats[..., [1, 3]], stats_p[..., [1, 3]]):
            raise AssertionError("K2's 1/d or d_ms differs from the plain prologue's")
        res["prologue_c_err"] = _scaled_err([rows.stats[..., 2]], [stats_p[..., 2]])
        if res["prologue_c_err"] > PROLOGUE_TOL:
            raise AssertionError(f"K2's c is off by {res['prologue_c_err']:.3g}")
        pair = _hopper_pair(Cq, Cv)
        if pair is not None:
            res["beside"] = {pair: _pair_beside_mma_sync(
                pair, q, k, v, grid, out, dout, (dq_m, dk_m, dv_m), (dq_p, dk_p, dv_p), dmain_p,
                stats_p)}
    return res


def _hopper_pair(Cq, Cv):
    """The Hopper pair of K2 and K3 whose width classes hold Cq and Cv (the
    narrow one up to 64 channels, the wgmma one beyond), or None."""
    from mapfree_tpu_torch.ops import correlation as corr

    width = corr.hopper_width_class(Cq, Cv)
    if width is None:
        return None
    return (corr.KERNEL_BWD_PAIR_NARROW if width in corr.NARROW_WIDTH_CLASSES
            else corr.KERNEL_FWD_WGMMA)


def _pair_beside_mma_sync(pair, q, k, v, grid, out, dout, matched, exact, dmain_p,
                          stats_p) -> dict:
    """A Hopper pair of K2 and K3 asked for by name on the inputs of a
    :func:`backward_case`: held to both plain backwards (``matched``,
    ``exact``: dq, dk, dv) and the plain prologue, equal bits on two runs,
    its bits against the mma.sync pair's, and each one's K2 handed on to the
    other's K3, held to the matched backward."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    ms = corr.KERNEL_FWD_MMA_SYNC
    runs = []
    for _ in range(2):
        dq_w, rows_w = corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=pair)
        dk_w, dv_w = corr.correlation_bwd_cols(q, k, v, grid, dout, rows_w, kernel=pair)
        runs.append((dq_w, dk_w, dv_w, rows_w.stats, rows_w.amax, rows_w.dmain))
    dq_o, rows_o = corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=ms)
    dk_o, dv_o = corr.correlation_bwd_cols(q, k, v, grid, dout, rows_o, kernel=ms)
    dk_h, dv_h = corr.correlation_bwd_cols(q, k, v, grid, dout, rows_w, kernel=ms)
    dk_r, dv_r = corr.correlation_bwd_cols(q, k, v, grid, dout, rows_o, kernel=pair)
    torch.cuda.synchronize()
    return {
        "as_mma_sync": {key: torch.equal(a, b) for key, a, b in (
            ("dq", dq_w, dq_o), ("dk", dk_w, dk_o), ("dv", dv_w, dv_o),
            ("stats", rows_w.stats, rows_o.stats), ("amax", rows_w.amax, rows_o.amax),
            ("dmain", rows_w.dmain, rows_o.dmain))},
        "l2": _rel_l2([dq_w, dk_w, dv_w], matched),
        "err": max(_scaled_err([dq_w], exact[:1]), _scaled_err([dk_w, dv_w], exact[1:])),
        "same_bits": all(torch.equal(a, b) for a, b in zip(*runs)),
        "prologue": (torch.equal(rows_w.dmain, dmain_p)
                     and torch.equal(rows_w.stats[..., [1, 3]], stats_p[..., [1, 3]])),
        "handoff_l2": max(_rel_l2([dq_w, dk_h, dv_h], matched),
                          _rel_l2([dq_o, dk_r, dv_r], matched))}


def nan_row_case(q, k, v, grid, dout, kernel=None) -> dict:
    """K2 and K3 (the package's pair, or ``kernel``) where batch element 0
    holds a NaN row: they must not fault, K2's argmax stays in [0, HW), the
    NaN reaches element 0's dq row and its dk and dv, and element 1 is held
    to the exact plain backward."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    out = corr._plain_buffer(q, k, v, grid)
    dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=kernel)
    dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows, kernel=kernel)
    torch.cuda.synchronize()  # a read out of bounds faults here
    amax = rows.amax.long()
    if int(amax.min()) < 0 or int(amax.max()) >= q.shape[1]:
        raise AssertionError("K2 wrote an argmax outside [0, HW) for a NaN row")
    ref = corr.fused_correlation_warp_bwd_plain(q[1:], k[1:], v[1:], grid, dout[1:],
                                                amax[1:])[:3]
    torch.cuda.synchronize()
    return {"design": corr.backward_design(q.dtype, q.shape[-1], v.shape[-1]),
            "k2_err": _scaled_err([dq[1:]], ref[:1]),
            "k3_err": _scaled_err([dk[1:], dv[1:]], ref[1:]), "amax": int(amax[0, 0]),
            "dq_finite": bool(torch.isfinite(dq[0, 0]).any()),
            "dkv_finite": bool(torch.isfinite(dk[0]).any() or torch.isfinite(dv[0]).any())}


def handoff_case(q, k, v, grid, dout) -> dict:
    """K2 and K3 given the buffer that K1's tensor-core design writes, as on
    the train path, against the exact plain backward: the K1 -> K2 hand-off.
    K2's row constant c = dout . out then comes from warped with P rounded to
    bf16; the same kernels given the exact buffer show what that adds. Held to
    MMA_VS_EXACT_TOL of each gradient's largest entry; the relative L2 errors
    are reported."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    grads, amax = {}, None
    for source, out in (("k1", corr._forward_cuda(q, k, v, grid)),
                        ("exact", corr._plain_buffer(q, k, v, grid))):
        dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout)
        dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows)
        grads[source] = (dq, dk, dv)
        amax = rows.amax.long() if amax is None else amax  # K2's, as in backward_case
        del out, rows
    torch.cuda.synchronize()
    ref = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, amax)[:3]
    torch.cuda.synchronize()
    res = {"design": corr.backward_design(q.dtype, q.shape[-1], v.shape[-1]),
           "tol": corr.MMA_VS_EXACT_TOL}
    for key, sl in (("k2", slice(0, 1)), ("k3", slice(1, 3))):
        res[key + "_err"] = _scaled_err(grads["k1"][sl], ref[sl])
        res[key + "_exact_l2"] = _rel_l2(grads["k1"][sl], ref[sl])
        res[key + "_exact_l2_given_exact_buffer"] = _rel_l2(grads["exact"][sl], ref[sl])
    return res


def check_backward(res: dict, what: str) -> None:
    """Raise if K2 or K3 of a :func:`backward_case` is out of tolerance, or,
    in the FMA design, if K2's statistics are off (the row max beyond the
    scores' summation noise, 1 / d beyond 1e-5 relative) or a second run
    gives other bits."""
    if "stats_err" in res and not res["stats_err"] <= 1.0:
        raise AssertionError(f"K2's row statistics are off in {what} ({res['stats_err']:.3g} "
                             "of their limits)")
    if res.get("same_bits") is False:
        raise AssertionError(f"two runs of K2 and K3 give other bits in {what}")
    for kernel in ("k2", "k3"):
        if not res[kernel + "_err"] <= res["tol"]:
            raise AssertionError(
                f"{kernel.upper()} disagrees with its plain version in {what}: "
                f"{res[kernel + '_err']:.3g} > {res['tol']:g} of the largest gradient")
        if "l2_tol" in res and not res[kernel + "_l2"] <= res["l2_tol"]:
            raise AssertionError(
                f"{kernel.upper()} disagrees with the plain backward of the same roundings "
                f"in {what}: relative L2 {res[kernel + '_l2']:.3g} > {res['l2_tol']:g}")
    if "k2_tile_l2" in res and not res["k2_tile_l2"] <= res["l2_tol"]:
        raise AssertionError(f"a column tile of K2's dq disagrees with the plain backward of "
                             f"the same roundings in {what}: relative L2 {res['k2_tile_l2']:.3g}")
    for pair, b in res.get("beside", {}).items():
        if not (b["l2"] <= res["l2_tol"] and b["err"] <= res["tol"]):
            raise AssertionError(f"the {pair} K2 and K3 disagree with the plain backwards in "
                                 f"{what}: relative L2 {b['l2']:.3g} to the matched one, "
                                 f"{b['err']:.3g} of the largest gradient to the exact one")
        if not (b["same_bits"] and b["prologue"]):
            raise AssertionError(f"the {pair} K2 and K3 in {what}: equal bits on two runs "
                                 f"{b['same_bits']}, dmain, 1/d and d_ms the plain "
                                 f"prologue's {b['prologue']}")
        if not b["handoff_l2"] <= res["l2_tol"]:
            raise AssertionError(f"the {pair} K2 handed on to the mma.sync K3, or the other "
                                 f"way, disagrees with the plain backward of the same "
                                 f"roundings in {what}: relative L2 {b['handoff_l2']:.3g}")


def _case_line(res: dict) -> str:
    """One case's backward errors, with the design that served it."""
    from mapfree_tpu_torch.ops import correlation as corr

    line = (f"design {res['design']}" + (f" ({res['kernel']})" if res.get("kernel") else "")
            + f"; K2 {res['k2_err']:.3g}, K3 {res['k3_err']:.3g} of the "
            f"largest gradient vs the exact plain backward (tol {res['tol']:g})")
    if res["design"] == corr.DESIGN_MMA:
        line += (f"; vs the plain backward with the kernels' bf16 roundings: relative L2 K2 "
                 f"{res['k2_l2']:.3g}, K3 {res['k3_l2']:.3g} (tol {res['l2_tol']:g}), largest "
                 f"entry K2 {res['k2_matched']:.3g}, K3 {res['k3_matched']:.3g}, worst column "
                 f"tile of dq {res['k2_tile_l2']:.3g}; c {res['prologue_c_err']:.3g} (tol "
                 f"{PROLOGUE_TOL:g})")
    if "same_bits" in res:
        line += (f"; row statistics at {res['stats_err']:.3g} of their limits; two runs of K2 "
                 f"and K3 give equal bits: {res['same_bits']}")
    for pair, b in res.get("beside", {}).items():
        same = [key for key, eq in b["as_mma_sync"].items() if eq]
        line += (f"; the {pair} K2, K3 by name: relative L2 {b['l2']:.3g}, "
                 f"{b['err']:.3g} of the largest gradient vs the exact plain backward, "
                 f"equal bits on two runs {b['same_bits']}, the plain prologue's "
                 f"{b['prologue']}, the mma.sync ones' bits in {same or 'none'}; its K2 handed "
                 f"on to the mma.sync K3 and the other way: relative L2 {b['handoff_l2']:.3g}")
    return line + f"; argmax near-ties {res['argmax_near_ties']}"


def phase_kernel_cases() -> dict:
    """K1, K2, K3 and the Kabsch kernel against their plain versions, per
    case. Returns the cases per kernel."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.ops import kabsch

    cases = {corr.KERNEL: [], corr.KERNEL_BWD_ROWS: [], corr.KERNEL_BWD_COLS: []}

    def record(kernel, name, err, atol, **more):
        cases[kernel].append({"case": name, "max_abs_err": err, "atol": atol,
                              "ok": err <= atol, **more})
        if not err <= atol:
            raise AssertionError(f"{kernel} disagrees with its plain version in case "
                                 f"{name}: {err:.3g} > {atol:g}")

    def record_forward(name, res):
        more = {"design": res["design"], "tensor_core_kernel": res.get("kernel")}
        if res["design"] == corr.DESIGN_MMA:
            more.update(matched_rel_l2=res["l2"], matched_rel_l2_tol=res["l2_tol"],
                        max_score_err=res["ms_err"], max_score_atol=res["ms_tol"])
        check_forward(res, f"case {name}")
        record(corr.KERNEL, name, res["err"], res["tol"], **more)

    def record_backward(name, res):
        for kernel, key in ((corr.KERNEL_BWD_ROWS, "k2"), (corr.KERNEL_BWD_COLS, "k3")):
            more = {"design": res["design"], "tensor_core_kernel": res.get("kernel")}
            if res["design"] == corr.DESIGN_MMA:
                more.update(matched_rel_l2=res[key + "_l2"], matched_rel_l2_tol=res["l2_tol"])
            for pair, b in res.get("beside", {}).items():
                more.update({f"{pair}_rel_l2": b["l2"], f"{pair}_err": b["err"],
                             f"{pair}_has_mma_sync_bits": b["as_mma_sync"],
                             f"{pair}_handoff_rel_l2": b["handoff_l2"]})
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
        # the widest v of K1's tensor-core instantiation of 120 v columns
        "bf16_hw130_q128_v120": (1, 10, 13, 128, 120, "bfloat16"),
        "bf16_hw130_c12_fma": (2, 10, 13, 12, 12, "bfloat16"),
        # HW below one row of 8: the key and the row tile both ragged
        "bf16_hw15": (1, 3, 5, 32, 32, "bfloat16"),
        # Cq and Cv not multiples of 16: zero-padded tensor-core tiles
        "bf16_q24_v40": (2, 10, 13, 24, 40, "bfloat16"),
        # the float32 K1's two kernels (correlation_fwd.cu::dispatch_fma):
        # HW below the long-rows kernel's row tile of 128, the few-rows
        # kernel's largest HW (64), one below and one above it, Cq != Cv and
        # a bf16 width that is not a multiple of 8 on the few-rows kernel
        "f32_hw100": (2, 10, 10, 32, 32, "float32"),
        "f32_hw63": (2, 7, 9, 32, 32, "float32"),
        "f32_hw64": (2, 8, 8, 32, 32, "float32"),
        "f32_hw65": (2, 5, 13, 32, 32, "float32"),
        "f32_hw20_q24_v40": (2, 4, 5, 24, 40, "float32"),
        "bf16_hw20_c12_fma": (2, 4, 5, 12, 12, "bfloat16"),
        # and K2, K3's FMA pairs (correlation_bwd.cu::dispatch_rows,
        # dispatch_cols): the ResNet encoder's grid and Cq != Cv on the
        # few-rows pair
        "f32_hw20": (2, 4, 5, 32, 32, "float32"),
        "f32_hw20_q16_v32": (2, 4, 5, 16, 32, "float32"),
    }.items()):
        q, k, v, grid = _kernel_inputs(B, H, W, cq, cv, dtype, seed=i)
        fwd = forward_case(q, k, v, grid)
        res = backward_case(q, k, v, grid, _cotangent(B, H * W, cv, seed=50 + i))
        expected = corr.DESIGN_FMA if dtype == "float32" or name.endswith("_fma") \
            else corr.DESIGN_MMA
        if fwd["design"] != expected or res["design"] != expected:
            raise AssertionError(f"case {name} was served by the {fwd['design']} (K1) and "
                                 f"{res['design']} (K2, K3) designs, not {expected}")
        log(f"[kernel] {name}: {_forward_line(fwd)}; {_case_line(res)}")
        record_forward(name, fwd)
        record_backward(name, res)
        if name in ("f32_hw130", "bf16_hw130"):
            # the argmax route alone: only the max score has a cotangent
            only = backward_case(q, k, v, grid, _cotangent(B, H * W, cv, 70, ms_only=True))
            log(f"[kernel] {name}, max-score cotangent only: {_case_line(only)}")
            record_backward(name + "_ms_only", only)
        if name in ("f32_hw6256_b2", "f32_hw20_q24_v40"):
            # K1 sums in fixed orders: a second run gives the same bits
            runs = [corr.fused_correlation_warp(q, k, v, grid) for _ in range(2)]
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            log(f"[kernel] {name}: two runs of K1 give equal bits: {same}")
            if not same:
                raise AssertionError(f"two runs of K1 differ in case {name}")
        if name == "bf16_hw6256_b2":
            # K3 sums in a fixed order: a second run gives the same bits
            dout = _cotangent(B, H * W, cv, seed=50 + i)
            dk2, dv2 = corr.correlation_bwd_cols(q, k, v, grid, dout, res["rows"])
            torch.cuda.synchronize()
            same = torch.equal(dk2, res["dk"]) and torch.equal(dv2, res["dv"])
            log(f"[kernel] {name}: two runs of K3 give equal bits: {same}")
            if not same:
                raise AssertionError("two runs of K3 differ")
            # the hand-off on the train path: K2 and K3 given K1's own buffer
            hand = handoff_case(q, k, v, grid, dout)
            log(f"[kernel] {name}, given the tensor-core K1's buffer: K2 {hand['k2_err']:.3g}, "
                f"K3 {hand['k3_err']:.3g} of the largest gradient vs the exact plain backward "
                f"(tol {hand['tol']:g}); relative L2 K2 {hand['k2_exact_l2']:.3g}, K3 "
                f"{hand['k3_exact_l2']:.3g} (given the exact buffer: K2 "
                f"{hand['k2_exact_l2_given_exact_buffer']:.3g}, K3 "
                f"{hand['k3_exact_l2_given_exact_buffer']:.3g})")
            for kernel, key in ((corr.KERNEL_BWD_ROWS, "k2"), (corr.KERNEL_BWD_COLS, "k3")):
                record(kernel, name + "_k1_buffer", hand[key + "_err"], hand["tol"],
                       design=hand["design"], exact_rel_l2=hand[key + "_exact_l2"],
                       exact_rel_l2_given_exact_buffer=hand[
                           key + "_exact_l2_given_exact_buffer"])
        del res

    # every channel width the Pallas kernel takes: the FMA designs tile the
    # channels and the accumulator columns by 128, so these cross one, two
    # and eight tile edges (the ResNet encoder's 256 and 1,024 channels, a
    # ResUNet's 128 with Cv + 2 = 130); the tensor-core K1, K2 and K3 take
    # every bf16 width that is a multiple of 8 (own tiles resident up to 128
    # channels, streamed in chunks of 64 beyond; the accumulator in column
    # tiles of 128 beyond 128); (126, 126) and float32 stay on the FMA
    # designs, at the same tolerances; the last three cases take
    # float32 q and k unscaled at 1,024 channels, where the scores reach some
    # 100
    hw_shapes = {20: (4, 5), 70: (7, 10), 1000: (25, 40)}
    wide = [(cq, cv, HW, dtype, True, 200 + 10 * i + 2 * j + (dtype == "bfloat16"))
            for i, (cq, cv) in enumerate(WIDE_CHANNELS) for j, HW in enumerate(hw_shapes)
            for dtype in ("float32", "bfloat16")]
    wide += [(1024, 1024, HW, "float32", False, 300 + j) for j, HW in enumerate(hw_shapes)]
    for cq, cv, HW, dtype, spread32, seed in wide:
        name = (f"wide_{'f32' if dtype == 'float32' else 'bf16'}"
                f"{'' if spread32 else '_unscaled'}_hw{HW}_q{cq}_v{cv}")
        q, k, v, grid = _kernel_inputs(2, *hw_shapes[HW], cq, cv, dtype, seed=seed,
                                       spread32=spread32)
        fwd = forward_case(q, k, v, grid)
        res = backward_case(q, k, v, grid, _cotangent(2, HW, cv, seed=seed + 500))
        fwd_expected = corr.DESIGN_MMA if (dtype == "bfloat16" and cq % 8 == 0
                                           and cv % 8 == 0) else corr.DESIGN_FMA
        bwd_expected = fwd_expected
        if fwd["design"] != fwd_expected or res["design"] != bwd_expected:
            raise AssertionError(f"case {name} was served by the {fwd['design']} (K1) and "
                                 f"{res['design']} (K2, K3) designs, not "
                                 f"{fwd_expected} and {bwd_expected}")
        log(f"[kernel] {name}: {_forward_line(fwd)}; {_case_line(res)}")
        record_forward(name, fwd)
        record_backward(name, res)
        del q, k, v, res

    # scores near 3,300, as positive features give at 1,024 channels (q = k
    # = 1 + |N(0, 1)|): each row's own key wins by hundreds, so every sum
    # order gives a one-hot P and a max score of 1; a max score taken against
    # a rounded max log2e rather than the row's own P would be off by up to
    # 2^(ulp / 2) - 1, some 1.7e-4 (the few-rows kernel at HW 20, the
    # long-rows one at 70)
    # (and K2, K3 there: P is one-hot and 1 / d is 1, to the bit only
    # where P is taken against the row's own max score)
    for i, (H, W) in enumerate(((4, 5), (7, 10))):
        q, _, v, grid = _kernel_inputs(2, H, W, 1024, 32, "float32", seed=350 + i)
        q = 1.0 + q.abs()
        fwd = forward_case(q, q, v, grid)
        res = backward_case(q, q, v, grid, _cotangent(2, H * W, 32, seed=360 + i))
        if fwd["design"] != corr.DESIGN_FMA or res["design"] != corr.DESIGN_FMA:
            raise AssertionError(f"float32 K1-K3 at HW={H * W} took the {fwd['design']} and "
                                 f"{res['design']} designs")
        log(f"[kernel] f32_large_scores_hw{H * W}_c1024: {_forward_line(fwd)}; "
            f"{_case_line(res)}")
        record_forward(f"f32_large_scores_hw{H * W}_c1024", fwd)
        record_backward(f"f32_large_scores_hw{H * W}_c1024", res)
        del q, v, res

    # an exact tie for row 0's maximum (keys 3 and 5 equal) on each FMA pair
    # of K2 and K3 and on the tensor-core pair, its own tiles resident (C =
    # 32 and 256 / 96) and streamed (C = 256, where the tie lies in both
    # column tiles): the max-score cotangent goes to the first index
    for i, (H, W, cq, cv, dtype) in enumerate(((4, 5, 32, 32, "float32"),
                                               (10, 10, 32, 32, "float32"),
                                               (7, 10, 32, 32, "bfloat16"),
                                               (7, 10, 256, 96, "bfloat16"),
                                               (7, 10, 256, 256, "bfloat16"))):
        name = f"{'f32' if dtype == 'float32' else 'bf16'}_tie_hw{H * W}_q{cq}_v{cv}"
        q, k, v, grid = _kernel_inputs(1, H, W, cq, cv, dtype, seed=370 + i, spread32=True)
        k[:, 5] = k[:, 3]
        q[:, 0] = 3.0 * k[:, 3]
        res = backward_case(q, k, v, grid, _cotangent(1, H * W, cv, seed=380 + i))
        first = int(res["rows"].amax[0, 0])
        log(f"[kernel] {name}: {_case_line(res)}; row 0's argmax {first} (keys 3 and 5 tie)")
        expected = corr.DESIGN_FMA if dtype == "float32" else corr.DESIGN_MMA
        if res["design"] != expected or first != 3:
            raise AssertionError(f"the tie in {name}: design {res['design']}, argmax {first}")
        record_backward(name, res)
        del q, k, v, res

    # a NaN row (q's row 0 of batch element 0), as a step that diverges
    # gives, on each FMA pair and on the tensor-core pair (resident at 32
    # and 256 / 96, streamed at 256): K2 keeps its argmax in [0, HW) (it reads
    # k at it), the NaN reaches that element's gradients, and the other batch
    # element is held to the exact plain backward (the tensor-core pair at
    # its tolerance)
    for i, (H, W, cq, cv, dtype) in enumerate(((4, 5, 32, 32, "float32"),
                                               (10, 10, 32, 32, "float32"),
                                               (7, 10, 32, 32, "bfloat16"),
                                               (7, 10, 256, 96, "bfloat16"),
                                               (7, 10, 256, 256, "bfloat16"))):
        HW = H * W
        name = f"{'f32' if dtype == 'float32' else 'bf16'}_nan_row_hw{HW}_q{cq}_v{cv}"
        q, k, v, grid = _kernel_inputs(2, H, W, cq, cv, dtype, seed=390 + i, spread32=True)
        q[0, 0] = float("nan")
        dout = _cotangent(2, HW, cv, seed=395 + i)
        res = nan_row_case(q, k, v, grid, dout)
        tol = BWD_TOL if dtype == "float32" else corr.mma_backward_exact_tol(cq, cv)
        log(f"[kernel] {name}: design {res['design']}; batch element 1: K2 "
            f"{res['k2_err']:.3g}, K3 {res['k3_err']:.3g} of the largest gradient vs the exact "
            f"plain backward (tol {tol:g}); row 0's argmax {res['amax']}, its dq finite: "
            f"{res['dq_finite']}, element 0's dk, dv finite: {res['dkv_finite']}")
        expected = corr.DESIGN_FMA if dtype == "float32" else corr.DESIGN_MMA
        if res["design"] != expected or res["dq_finite"] or res["dkv_finite"]:
            raise AssertionError(f"the NaN row in {name} did not reach the gradients")
        for kernel, key in ((corr.KERNEL_BWD_ROWS, "k2"), (corr.KERNEL_BWD_COLS, "k3")):
            record(kernel, name, res[key + "_err"], tol, design=res["design"])
        del q, k, v, dout, res

    # K1's tensor-core design at every kind of width it takes: each
    # instantiation, q resident and streamed with a last chunk that is whole
    # or partly zero-filled, one column tile or several with a narrow last
    # one (HW = 70: a ragged second key tile)
    widths = (8, 24, 120, 128, 136, 264, 1016, 1024)
    worst = {"err": 0.0, "l2": 0.0, "ms_err": 0.0}
    for i, (cq, cv) in enumerate((cq, cv) for cq in widths for cv in widths):
        q, k, v, grid = _kernel_inputs(2, 7, 10, cq, cv, "bfloat16", seed=400 + i,
                                       spread32=True)
        fwd = forward_case(q, k, v, grid)
        if fwd["design"] != corr.DESIGN_MMA:
            raise AssertionError(f"K1 at Cq={cq}, Cv={cv} bf16 took the {fwd['design']} design")
        record_forward(f"widths_bf16_hw70_q{cq}_v{cv}", fwd)
        worst = {key: max(val, fwd[key]) for key, val in worst.items()}
    log(f"[kernel] K1 design mma at Cq, Cv in {widths} (64 pairs, HW=70, bf16): worst "
        f"{worst['err']:.3g} of the largest entry vs the exact plain forward, relative L2 "
        f"{worst['l2']:.3g} vs the plain forward with the kernel's rounding, max score "
        f"{worst['ms_err']:.3g}")

    # K1's wgmma kernel at its edges, asked for by name (the package gives it
    # more than 64 positions): HW below one key tile and not a multiple of
    # the row block or the key tile, Cq != Cv, C = 8 (channels zero-filled
    # to a tensor-core depth of 16), Cv + 2 beyond 256 (three column tiles),
    # two column tiles of 128 at C = 256, three consumer warpgroups (the
    # instantiation of large grids, reached here by 1,000 batch elements of
    # 70 positions); each held to both plain forwards, two runs to the same
    # bits and to the mma.sync kernel's bits
    for i, (name, (B, H, W, cq, cv)) in enumerate({
        "wgmma_hw15": (2, 3, 5, 32, 32),
        "wgmma_hw200": (2, 10, 20, 32, 32),
        "wgmma_q16_v32_hw130": (2, 10, 13, 16, 32),
        "wgmma_q256_v96_hw70": (2, 7, 10, 256, 96),
        "wgmma_c8_hw130": (2, 10, 13, 8, 8),
        "wgmma_q32_v264_hw70": (2, 7, 10, 32, 264),
        "wgmma_c256_hw1000": (1, 25, 40, 256, 256),
        "wgmma_c128_hw70_b1000": (1000, 7, 10, 128, 128),
    }.items()):
        q, k, v, grid = _kernel_inputs(B, H, W, cq, cv, "bfloat16", seed=450 + i, spread32=True)
        fwd = forward_case(q, k, v, grid, kernel=corr.KERNEL_FWD_WGMMA, keep_out=True)
        again = corr._forward_cuda(q, k, v, grid, kernel=corr.KERNEL_FWD_WGMMA)
        other = corr._forward_cuda(q, k, v, grid, kernel=corr.KERNEL_FWD_MMA_SYNC)
        torch.cuda.synchronize()
        first = torch.cat(fwd.pop("out"), dim=-1)
        same, as_mma_sync = torch.equal(first, again), torch.equal(first, other)
        log(f"[kernel] {name}: {_forward_line(fwd)}; two runs give equal bits: {same}; the "
            f"mma.sync kernel's bits: {as_mma_sync}")
        record_forward(name, fwd)
        if not (same and as_mma_sync):
            raise AssertionError(f"K1's wgmma kernel in case {name}: equal bits on two runs "
                                 f"{same}, the mma.sync kernel's {as_mma_sync}")
        del q, k, v, fwd, first, again, other

    # NaN in batch element 1's first rows of q, k and v: element 0's last key
    # tile reaches past its HW = 70, where the tensor maps read zeros (never
    # element 1's rows), so element 0 stays finite and held to the plain
    # forwards; element 1 is NaN throughout
    q, k, v, grid = _kernel_inputs(2, 7, 10, 32, 32, "bfloat16", seed=470, spread32=True)
    for t in (q, k, v):
        t[1, :3] = float("nan")
    runs = [corr._split(corr._forward_cuda(q, k, v, grid, kernel=corr.KERNEL_FWD_WGMMA), 32)
            for _ in range(2)]
    torch.cuda.synchronize()
    part = [o[:1] for o in runs[0]]
    finite = all(bool(torch.isfinite(o).all()) for o in part)
    same = all(torch.equal(a[:1], b[:1]) for a, b in zip(*runs))
    nan_1 = all(bool(torch.isnan(o[1]).all()) for o in runs[0])
    ref = corr.fused_correlation_warp_plain(q[:1], k[:1], v[:1], grid)
    matched = corr.fused_correlation_warp_plain(q[:1], k[:1], v[:1], grid, bf16_roundings=True)
    fwd = {"design": corr.DESIGN_MMA, "kernel": corr.KERNEL_FWD_WGMMA,
           "max_abs_err": _max_err(part, ref), "err": _scaled_err(part[:2], ref[:2]),
           "tol": corr.MMA_FWD_VS_EXACT_TOL, "l2": _rel_l2(part[:2], matched[:2]),
           "l2_tol": corr.mma_forward_matched_l2_tol(32, 32), "ms_err": _max_err(part[2:], ref[2:]),
           "ms_tol": ATOL["float32"]}
    log(f"[kernel] wgmma_nan_next_batch_hw70, element 0: {_forward_line(fwd)}; finite: "
        f"{finite}; equal bits on two runs: {same}; element 1 NaN throughout: {nan_1}")
    record_forward("wgmma_nan_next_batch_hw70", fwd)
    if not (finite and same and nan_1):
        raise AssertionError("K1's wgmma kernel let batch element 1's NaN rows reach element 0 "
                             f"(finite {finite}, equal bits {same}, element 1 NaN {nan_1})")

    # K2 and K3's wgmma pair, asked for by name, at the edges the cases above
    # leave (they give it every bf16 shape beyond 64 positions with a width
    # past 64 channels: HW 70, 130, 1,000 and 6,256, Cv of 8 mod 16 at 120,
    # 126 and 136, 256 / 96, 256, ties, NaN rows): one key past a tile (HW
    # 65), the narrowest widths it takes (72 channels, and Cq 16 with Cv 72,
    # zero-filled to its class of 128; there also the max-score cotangent
    # alone), and 1,000 batch elements of 70 positions at 128 channels (some
    # 2,000 blocks); each held to both plain backwards, two runs to the same
    # bits, beside the mma.sync pair (bits printed, hand-offs held)
    for i, (name, (B, H, W, cq, cv)) in enumerate({
        "wgmma_bwd_hw65": (2, 5, 13, 128, 128),
        "wgmma_bwd_c72_hw70": (2, 7, 10, 72, 72),
        "wgmma_bwd_q16_v72_hw1000": (1, 25, 40, 16, 72),
        "wgmma_bwd_c128_hw70_b1000": (1000, 7, 10, 128, 128),
    }.items()):
        q, k, v, grid = _kernel_inputs(B, H, W, cq, cv, "bfloat16", seed=480 + i, spread32=True)
        res = backward_case(q, k, v, grid, _cotangent(B, H * W, cv, seed=490 + i),
                            kernel=corr.KERNEL_FWD_WGMMA)
        log(f"[kernel] {name}: {_case_line(res)}")
        record_backward(name, res)
        if name == "wgmma_bwd_q16_v72_hw1000":
            only = backward_case(q, k, v, grid, _cotangent(B, H * W, cv, 494, ms_only=True),
                                 kernel=corr.KERNEL_FWD_WGMMA)
            log(f"[kernel] {name}, max-score cotangent only: {_case_line(only)}")
            record_backward(name + "_ms_only", only)
            del only
        del q, k, v, grid, res
    # NaN in batch element 1's first rows of q, k and v: element 0's last key
    # tile (K2) and row chunk (K3) reach past its HW = 70, where the tensor
    # maps read zeros, so element 0 stays finite and held to both plain
    # backwards; element 1's gradients are NaN
    q, k, v, grid = _kernel_inputs(2, 7, 10, 128, 128, "bfloat16", seed=495, spread32=True)
    for t in (q, k, v):
        t[1, :3] = float("nan")
    res = nan_next_batch_case(q, k, v, grid, _cotangent(2, 70, 128, seed=496))
    log(f"[kernel] wgmma_bwd_nan_next_batch_hw70_c128, element 0: K2 {res['k2_err']:.3g}, K3 "
        f"{res['k3_err']:.3g} of the largest gradient vs the exact plain backward (tol "
        f"{res['tol']:g}); relative L2 {res['l2']:.3g} vs the matched one (tol "
        f"{res['l2_tol']:g}); finite: {res['finite']}; equal bits on two runs: {res['same_bits']}"
        f"; element 1 NaN: {res['nan_1']}")
    for kernel, key in ((corr.KERNEL_BWD_ROWS, "k2"), (corr.KERNEL_BWD_COLS, "k3")):
        record(kernel, "wgmma_bwd_nan_next_batch_hw70_c128", res[key + "_err"], res["tol"],
               design=corr.DESIGN_MMA, tensor_core_kernel=corr.KERNEL_FWD_WGMMA,
               matched_rel_l2=res["l2"], matched_rel_l2_tol=res["l2_tol"])
    if not (res["finite"] and res["same_bits"] and res["nan_1"] and res["l2"] <= res["l2_tol"]):
        raise AssertionError(f"K2 and K3's wgmma pair let batch element 1's NaN rows reach "
                             f"element 0: {res}")
    narrow_cases(record, record_backward)
    cases[kabsch.LIBRARY] = []
    kabsch_cases(cases[kabsch.LIBRARY])
    return cases


def narrow_cases(record, record_backward) -> None:
    """K2 and K3's narrow pair (ops/csrc/correlation_bwd_narrow.cu), asked
    for by name, at every width class it takes (Cq = Cv = 16, 16 / 32, 24,
    32, 64) and ragged HW (65, 70, 1,000, 6,256): each held to both plain
    backwards, two runs to equal bits, its bits printed against the
    mma.sync pair's and each one's K2 handed on to the other's K3
    (:func:`backward_case`); at the train step's B = 10 and the fusion step's
    B = 90 on the 3d3d grid, held on the first and last batch rows
    (:func:`narrow_batch_case`); an exact tie for a row's max, a NaN row, NaN
    in the next batch element and the max-score cotangent alone. Logs the
    seconds they take."""
    from mapfree_tpu_torch.ops import correlation as corr

    t0 = time.perf_counter()
    nw = corr.KERNEL_BWD_PAIR_NARROW
    for i, (name, (B, H, W, cq, cv)) in enumerate({
        "narrow_bwd_c16_hw65": (2, 5, 13, 16, 16),
        "narrow_bwd_q16_v32_hw1000": (1, 25, 40, 16, 32),
        "narrow_bwd_c24_hw70": (2, 7, 10, 24, 24),
        "narrow_bwd_c32_hw65": (2, 5, 13, 32, 32),
        "narrow_bwd_c32_hw1000": (1, 25, 40, 32, 32),
        "narrow_bwd_c32_hw6256_b2": (2, 92, 68, 32, 32),
        "narrow_bwd_c64_hw1000": (1, 25, 40, 64, 64),
        "narrow_bwd_c8_hw70": (2, 7, 10, 8, 8),
    }.items()):
        q, k, v, grid = _kernel_inputs(B, H, W, cq, cv, "bfloat16", seed=520 + i, spread32=True)
        dout = _cotangent(B, H * W, cv, seed=530 + i)
        res = backward_case(q, k, v, grid, dout, kernel=nw)
        log(f"[kernel] {name}: {_case_line(res)}")
        record_backward(name, res)
        if name == "narrow_bwd_c32_hw1000":
            # the argmax route alone: only the max score has a cotangent
            only = backward_case(q, k, v, grid, _cotangent(B, H * W, cv, 540, ms_only=True),
                                 kernel=nw)
            log(f"[kernel] {name}, max-score cotangent only: {_case_line(only)}")
            record_backward(name + "_ms_only", only)
            del only
        del q, k, v, grid, dout, res
    # an exact tie for row 0's maximum (keys 3 and 5 equal): the max-score
    # cotangent goes to the first
    q, k, v, grid = _kernel_inputs(1, 7, 10, 32, 32, "bfloat16", seed=545, spread32=True)
    k[:, 5] = k[:, 3]
    q[:, 0] = 3.0 * k[:, 3]
    res = backward_case(q, k, v, grid, _cotangent(1, 70, 32, seed=546), kernel=nw)
    first = int(res["rows"].amax[0, 0])
    log(f"[kernel] narrow_bwd_tie_hw70: {_case_line(res)}; row 0's argmax {first} (keys 3 "
        "and 5 tie)")
    if first != 3:
        raise AssertionError(f"the narrow pair's tie: argmax {first}")
    record_backward("narrow_bwd_tie_hw70", res)
    # a NaN row, and NaN in the next batch element's first rows
    q, k, v, grid = _kernel_inputs(2, 7, 10, 32, 32, "bfloat16", seed=547, spread32=True)
    q[0, 0] = float("nan")
    res = nan_row_case(q, k, v, grid, _cotangent(2, 70, 32, seed=548), kernel=nw)
    tol = corr.mma_backward_exact_tol(32, 32)
    log(f"[kernel] narrow_bwd_nan_row_hw70: batch element 1: K2 {res['k2_err']:.3g}, K3 "
        f"{res['k3_err']:.3g} of the largest gradient vs the exact plain backward (tol {tol:g})"
        f"; row 0's argmax {res['amax']}, its dq finite: {res['dq_finite']}, element 0's dk, "
        f"dv finite: {res['dkv_finite']}")
    if res["dq_finite"] or res["dkv_finite"]:
        raise AssertionError("the NaN row did not reach the narrow pair's gradients")
    for kernel, key in ((corr.KERNEL_BWD_ROWS, "k2"), (corr.KERNEL_BWD_COLS, "k3")):
        record(kernel, "narrow_bwd_nan_row_hw70", res[key + "_err"], tol,
               design=corr.DESIGN_MMA, tensor_core_kernel=nw)
    q, k, v, grid = _kernel_inputs(2, 7, 10, 32, 32, "bfloat16", seed=549, spread32=True)
    for t in (q, k, v):
        t[1, :3] = float("nan")
    res = nan_next_batch_case(q, k, v, grid, _cotangent(2, 70, 32, seed=550), kernel=nw)
    log(f"[kernel] narrow_bwd_nan_next_batch_hw70, element 0: K2 {res['k2_err']:.3g}, K3 "
        f"{res['k3_err']:.3g} of the largest gradient vs the exact plain backward (tol "
        f"{res['tol']:g}); relative L2 {res['l2']:.3g} vs the matched one (tol "
        f"{res['l2_tol']:g}); finite: {res['finite']}; equal bits on two runs: {res['same_bits']}"
        f"; element 1 NaN: {res['nan_1']}")
    for kernel, key in ((corr.KERNEL_BWD_ROWS, "k2"), (corr.KERNEL_BWD_COLS, "k3")):
        record(kernel, "narrow_bwd_nan_next_batch_hw70", res[key + "_err"], res["tol"],
               design=corr.DESIGN_MMA, tensor_core_kernel=nw, matched_rel_l2=res["l2"],
               matched_rel_l2_tol=res["l2_tol"])
    if not (res["finite"] and res["same_bits"] and res["nan_1"] and res["l2"] <= res["l2_tol"]):
        raise AssertionError(f"the narrow pair let batch element 1's NaN rows reach element 0: "
                             f"{res}")
    for i, B in enumerate((10, 90)):
        res = narrow_batch_case(B, 92, 68, 32, seed=560 + i)
        for kernel, key in ((corr.KERNEL_BWD_ROWS, "k2"), (corr.KERNEL_BWD_COLS, "k3")):
            record(kernel, f"narrow_bwd_c32_hw6256_b{B}", res[key], res["tol"],
                   design=corr.DESIGN_MMA, tensor_core_kernel=nw,
                   matched_rel_l2=res[key + "_l2"], matched_rel_l2_tol=res["l2_tol"])
    log(f"[kernel] the narrow pair's cases: {time.perf_counter() - t0:.1f} s")


def narrow_batch_case(B, H, W, C, seed) -> dict:
    """The narrow pair over a whole train batch on the 3d3d grid (B = 10, the
    fusion step's 90), given the exact forward's buffer: held to both plain
    backwards on the first and last two batch rows, equal bits on two runs,
    its bits against the mma.sync pair's over the whole batch, and each
    one's K2 handed on to the other's K3, held on the same rows."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    HW = H * W
    nw, ms = corr.KERNEL_BWD_PAIR_NARROW, corr.KERNEL_FWD_MMA_SYNC
    q, k, v, grid = _kernel_inputs(B, H, W, C, C, "bfloat16", seed=seed)
    dout = _cotangent(B, HW, C, seed=seed + 1)
    out = torch.cat([corr._plain_buffer(q[i:i + 6], k[i:i + 6], v[i:i + 6], grid)
                     for i in range(0, B, 6)])
    runs = []
    for pair in (nw, nw, ms):
        dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=pair)
        dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows, kernel=pair)
        runs.append((dq, dk, dv, rows))
    (dq, dk, dv, rows), _, (dq_o, dk_o, dv_o, rows_o) = runs
    dk_h, dv_h = corr.correlation_bwd_cols(q, k, v, grid, dout, rows_o, kernel=nw)
    dk_r, dv_r = corr.correlation_bwd_cols(q, k, v, grid, dout, rows, kernel=ms)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(runs[0][:3], runs[1][:3]))
    as_ms = {key: torch.equal(a, b) for key, a, b in (
        ("dq", dq, dq_o), ("dk", dk, dk_o), ("dv", dv, dv_o), ("stats", rows.stats, rows_o.stats),
        ("amax", rows.amax, rows_o.amax), ("dmain", rows.dmain, rows_o.dmain))}
    res = {"k2": 0.0, "k3": 0.0, "k2_l2": 0.0, "k3_l2": 0.0, "handoff_l2": 0.0,
           "tol": corr.mma_backward_exact_tol(C, C, B * HW),
           "l2_tol": corr.mma_backward_matched_l2_tol(C, C, B * HW)}
    for sl in _batch_slices(B):
        amax = rows.amax[sl].long()
        exact = corr.fused_correlation_warp_bwd_plain(q[sl], k[sl], v[sl], grid, dout[sl], amax)
        matched = corr.fused_correlation_warp_bwd_plain(q[sl], k[sl], v[sl], grid, dout[sl],
                                                        amax, bf16_roundings=True)
        res["k2"] = max(res["k2"], _scaled_err([dq[sl]], exact[:1]))
        res["k3"] = max(res["k3"], _scaled_err([dk[sl], dv[sl]], exact[1:3]))
        res["k2_l2"] = max(res["k2_l2"], _rel_l2([dq[sl]], matched[:1]))
        res["k3_l2"] = max(res["k3_l2"], _rel_l2([dk[sl], dv[sl]], matched[1:3]))
        res["handoff_l2"] = max(res["handoff_l2"],
                                _rel_l2([dk_h[sl], dv_h[sl], dk_r[sl], dv_r[sl]],
                                        [matched[1], matched[2], matched[1], matched[2]]))
        del exact, matched
    log(f"[kernel] narrow_bwd_c32_hw6256_b{B}, rows 0-1 and {B - 2}-{B - 1}: K2 "
        f"{res['k2']:.3g}, K3 {res['k3']:.3g} of the largest gradient vs the exact plain "
        f"backward (tol {res['tol']:g}); relative L2 vs the matched one K2 {res['k2_l2']:.3g}, "
        f"K3 {res['k3_l2']:.3g} (tol {res['l2_tol']:g}); equal bits on two runs: {same}; the "
        f"mma.sync pair's bits over the batch in "
        f"{[key for key, eq in as_ms.items() if eq] or 'none'}; either K2 handed on to the "
        f"other's K3: relative L2 {res['handoff_l2']:.3g}")
    bad = [key for key in ("k2", "k3") if res[key] > res["tol"] or res[key + "_l2"] > res["l2_tol"]]
    if bad or not same or res["handoff_l2"] > res["l2_tol"]:
        raise AssertionError(f"the narrow pair at B={B}: {bad} out of tolerance, equal bits on "
                             f"two runs {same}, hand-offs {res['handoff_l2']:.3g}")
    return res


def nan_next_batch_case(q, k, v, grid, dout, kernel="wgmma") -> dict:
    """A Hopper pair of K2 and K3 (``kernel``) where batch element 1 holds
    NaN rows: element 0 held to the exact plain backward and the matched
    one, finite, equal bits on two runs; element 1's dq not finite."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    out = corr._plain_buffer(q, k, v, grid)
    runs = []
    for _ in range(2):
        dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=kernel)
        dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows, kernel=kernel)
        runs.append((dq, dk, dv, rows.amax))
    torch.cuda.synchronize()
    got = [x[:1] for x in runs[0][:3]]
    amax = runs[0][3][:1].long()
    exact = corr.fused_correlation_warp_bwd_plain(q[:1], k[:1], v[:1], grid, dout[:1], amax)[:3]
    matched = corr.fused_correlation_warp_bwd_plain(q[:1], k[:1], v[:1], grid, dout[:1], amax,
                                                    bf16_roundings=True)[:3]
    Cq, Cv, n_rows = q.shape[-1], v.shape[-1], q.shape[0] * q.shape[1]
    return {"k2_err": _scaled_err(got[:1], exact[:1]), "k3_err": _scaled_err(got[1:], exact[1:]),
            "tol": corr.mma_backward_exact_tol(Cq, Cv, n_rows), "l2": _rel_l2(got, matched),
            "l2_tol": corr.mma_backward_matched_l2_tol(Cq, Cv, n_rows),
            "finite": all(bool(torch.isfinite(x).all()) for x in got),
            "same_bits": all(torch.equal(a[:1], b[:1]) for a, b in zip(runs[0], runs[1])),
            "nan_1": not bool(torch.isfinite(runs[0][0][1]).all())}


# the shapes the main paths give the Kabsch kernel (name, n, N, weighted):
# the heads' N = 3 (6 anchors plus the basis) at 3d3d's sweep batch and
# fusion's 64 x 9, PnP's batch x hypotheses x 4 roots (ops/pnp.py), and the
# ICP's weighted refine (ops/procrustes_ransac.py)
KABSCH_SHAPES = (("head_n64", 64, 3, False), ("head_n576", 576, 3, False),
                 ("pnp_n262144", 64 * 1024 * 4, 3, False), ("refine_n64_N2048", 64, 2048, True))


def kabsch_inputs(name, n, N, weighted, seed) -> tuple:
    """Contiguous float32 CUDA inputs of one of ``KABSCH_SHAPES``: the heads'
    anchors plus the basis as models/heads.py::_procrustes_from_anchors
    forms them, else clouds and their rotated, moved, noisy copies, with a
    third of the weights 0."""
    import torch

    rng = np.random.default_rng(seed)
    if name.startswith("head"):
        xyz = rng.normal(size=(n, 6, 3))
        A, B, w = xyz[:, :3] + np.eye(3), xyz[:, 3:] + np.eye(3), None
    else:
        A = rng.normal(size=(n, N, 3))
        Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        B = A @ Q.T + np.array([0.5, -0.5, 5.0]) + rng.normal(size=A.shape) * 0.05
        w = rng.uniform(size=(n, N)) * (rng.uniform(size=(n, N)) > 1 / 3) if weighted else None
    return tuple(None if x is None else torch.from_numpy(np.ascontiguousarray(x, np.float32))
                 .cuda() for x in (A, B, w))


def kabsch_case(A, B, w=None, exact_h=False) -> dict:
    """The Kabsch kernel (through geom/procrustes.py::procrustes under
    inference_mode: one launch) against the tensor version on the same inputs
    on the card, per problem within ops/kabsch.py::vs_plain_tolerances: the
    largest error over its limit for R and t, det R's distance from 1."""
    import torch

    from mapfree_tpu_torch.geom.procrustes import procrustes, procrustes_plain
    from mapfree_tpu_torch.ops import kabsch

    before = kabsch.launches
    with torch.inference_mode():
        R, t = procrustes(A, B, w)
        R0, t0 = procrustes_plain(A, B, w)
    torch.cuda.synchronize()
    tol_R, tol_t = kabsch.vs_plain_tolerances(A, B, w, exact_h)
    err_R = (R - R0).abs().amax((1, 2)).double().cpu()
    err_t = (t - t0).abs().amax((1, 2)).double().cpu()
    return {"launches": kabsch.launches - before, "max_abs_err_R": float(err_R.max()),
            "max_abs_err_t": float(err_t.max()),
            "err_over_tol_R": float((err_R / tol_R).max()),
            "err_over_tol_t": float((err_t / tol_t).max()),
            "det_err": float((torch.linalg.det(R.double()) - 1.0).abs().max()),
            "tol_R_min": float(tol_R.min())}


def kabsch_cases(cases: list) -> None:
    """The Kabsch kernel's cases: ``KABSCH_SHAPES`` and the CPU tests' svd3
    inputs (H = zeros, identity, rank 2, a repeated singular value, rank 1,
    and 64 random matrices, each exact in float32: A = [I; -I], B = [M^T;
    -M^T] / 2 give H = M)."""
    import torch

    rng = np.random.default_rng(400)
    M = np.concatenate([rng.normal(size=(64, 3, 3)), np.stack([
        np.zeros((3, 3)), np.eye(3), np.diag([1.0, 1.0, 0.0]), np.diag([5.0, 5.0, 5.0]),
        np.outer([1.0, 2.0, 3.0], [4.0, 5.0, 6.0])])]).astype(np.float32)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), M.shape)
    degenerate = (np.concatenate([eye, -eye], axis=1), np.concatenate([M, -M], axis=1) / 2)
    inputs = [(name, kabsch_inputs(name, n, N, weighted, seed=401 + i), False)
              for i, (name, n, N, weighted) in enumerate(KABSCH_SHAPES)]
    inputs.append(("degenerate_h", tuple(torch.from_numpy(x).cuda() for x in degenerate)
                   + (None,), True))
    for name, (A, B, w), exact_h in inputs:
        res = kabsch_case(A, B, w, exact_h)
        ok = (res["launches"] == 1 and res["err_over_tol_R"] <= 1.0
              and res["err_over_tol_t"] <= 1.0 and res["det_err"] < 1e-5)
        log(f"[kernel] kabsch {name} (n={A.shape[0]}, N={A.shape[1]}"
            f"{', weighted' if w is not None else ''}): R {res['max_abs_err_R']:.3g} "
            f"(largest {res['err_over_tol_R']:.3g} of its limit, the least limit "
            f"{res['tol_R_min']:.3g}), t {res['max_abs_err_t']:.3g} ({res['err_over_tol_t']:.3g} "
            f"of its limit), |det R - 1| {res['det_err']:.3g}; {res['launches']} launch")
        cases.append({"case": name, "n": int(A.shape[0]), "N": int(A.shape[1]),
                      "weighted": w is not None, "ok": ok, **res})
        if not ok:
            raise AssertionError(f"the Kabsch kernel disagrees with the tensor version in "
                                 f"case {name}: {res}")


def time_kabsch() -> dict:
    """The Kabsch kernel at ``KABSCH_SHAPES`` beside the tensor version:
    CUDA events around a run of calls, the device alone from a CUDA graph of
    them, the host's time to issue one, and the bound of its bytes (inputs
    read and R, t written once). The 3d3d head's shape at the top level,
    the others under their names."""
    import torch

    from mapfree_tpu_torch.geom.procrustes import procrustes_plain
    from mapfree_tpu_torch.ops import kabsch

    out = {}
    for i, (name, n, N, weighted) in enumerate(KABSCH_SHAPES):
        A, B, w = kabsch_inputs(name, n, N, weighted, seed=410 + i)
        nbytes = _nbytes(A, B, *([w] if weighted else [])) + n * 12 * 4
        bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
        t = {"shape": f"n={n} N={N}{' weighted' if weighted else ''}", "bytes": nbytes,
             "bound_ms": bound_ms, "bound_by": "bytes"}
        for version, fn, iters in (("", kabsch.procrustes_cuda, 200),
                                   ("plain_", procrustes_plain, 20)):
            def call(fn=fn):
                fn(A, B, w)

            with torch.no_grad():
                t[version + "ms"] = cuda_time_ms(call, iters=iters, warmup=3)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    call()
                t[version + "host_ms"] = 1e3 * (time.perf_counter() - t0) / iters
                torch.cuda.synchronize()
                t[version + "device_ms"] = graph_ms(call, iters=iters)
        log(f"[kernel] kabsch {name} ({t['shape']}): kernel_ms={t['ms']:.4f} by events, "
            f"device alone {t['device_ms']:.4f}, host {t['host_ms']:.4f} a call; "
            f"bound_ms={bound_ms:.6f} ({nbytes} bytes), {100 * bound_ms / t['device_ms']:.2f}% "
            f"of its bound on the device alone; tensor version {t['plain_ms']:.3f} ms by events, "
            f"device alone {t['plain_device_ms']:.3f}, host {t['plain_host_ms']:.3f}")
        out[name] = t
    first = out.pop(KABSCH_SHAPES[0][0])
    return {**first, **{name + "_shape": t for name, t in out.items()}}


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


def sdpa_ms(qh, kh, vh, iters: int, do=None, timer=None) -> tuple:
    """Milliseconds of one scaled_dot_product_attention call (its backward
    with the cotangent ``do``) and the backend that ran it: in bf16 as
    PyTorch dispatches it (backend not named); in float32 with TF32 off,
    under the first of flash, efficient, cuDNN and math attention that takes
    the inputs. Timed here only: the port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        o = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
        if do is None:
            return lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
        return lambda: torch.autograd.grad(o, (qh, kh, vh), do, retain_graph=True)

    timer = timer or cuda_time_ms
    if do is not None and timer is graph_ms:
        # autograd runs each backward op on its forward op's stream: the
        # forward goes on the stream the graph captures on
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        inner = call

        def call():
            with torch.cuda.stream(stream):
                return inner()

        timer = functools.partial(graph_ms, stream=stream)
    if qh.dtype != torch.float32:
        return timer(call(), iters=iters), None
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # why the others refused
                try:
                    fn = call()
                    fn()
                except RuntimeError:
                    continue
                return timer(fn, iters=iters), backend.name.lower()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    raise AssertionError("no attention backend takes the float32 inputs")


def time_k1(B, H, W, C, dtype, seed, fma_too=False, spread32=False, cv=None) -> dict:
    """K1 at one shape (Cq = C, Cv = ``cv`` or C): agreement, then its time
    beside the plain version's, one library call's and its bound. With
    ``fma_too`` the FMA design is checked and timed on the same inputs as
    well, beside the design that serves them."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    HW = H * W
    cv = cv or C
    width = f"C={C}" if cv == C else f"Cq={C} Cv={cv}"
    q, k, v, grid = _kernel_inputs(B, H, W, C, cv, dtype, seed=seed, spread32=spread32)
    res = forward_case(q, k, v, grid)
    check_forward(res, f"B={B} HW={HW} {width}")
    log(f"[kernel] K1 B={B} HW={HW} {width} {dtype}: {_forward_line(res)}")
    torch.cuda.empty_cache()

    ms = cuda_time_ms(lambda: corr.fused_correlation_warp(q, k, v, grid), iters=20, warmup=2)
    plain_ms = cuda_time_ms(lambda: corr.fused_correlation_warp_plain(q, k, v, grid),
                            iters=3)
    torch.cuda.empty_cache()
    fma = {}
    if fma_too and res["design"] != corr.DESIGN_FMA:
        # the FMA design's C function on the same inputs, as _forward_cuda
        # would launch it for a shape the tensor-core design does not take
        out = torch.empty((B, HW, cv + 3), dtype=torch.float32, device=q.device)

        def fma_launch():
            corr._launch(corr.KERNEL, corr.KERNEL, (q, k, v, grid, out), q, v)

        fma_launch()
        ref = corr.fused_correlation_warp_plain(q, k, v, grid)
        fma["fma_max_abs_err"] = _max_err(corr._split(out, cv), ref)
        del ref
        if fma["fma_max_abs_err"] > ATOL[dtype]:
            raise AssertionError(f"K1's FMA design disagrees with the plain forward at B={B}")
        fma["fma_ms"] = cuda_time_ms(fma_launch, iters=3)
        del out
        torch.cuda.empty_cache()
    # one library call computing P [v | grid] (padded to 40 columns for the
    # fused attention backends); timed here only, the port never calls it
    vg = torch.cat([v, grid.expand(B, HW, 2), v.new_zeros(B, HW, 6)], dim=-1)[:, None]
    library_ms, backend = sdpa_ms(q[:, None], k[:, None], vg, iters=10)

    device = {}
    if HW <= 64:
        # a call this small is paced by the host's time to issue it: the
        # device's own times, of the kernel and of the library call, from
        # CUDA graphs
        device["device_ms"] = graph_ms(lambda: corr.fused_correlation_warp(q, k, v, grid), 20)
        device["library_device_ms"] = sdpa_ms(q[:, None], k[:, None], vg, iters=20,
                                              timer=graph_ms)[0]
    nbytes = _nbytes(q, k, v, grid) + B * HW * (cv + 3) * 4
    bound_ms, bound_by = k1_bound(B, HW, C, cv, dtype, nbytes)
    fma_line = (f"; the FMA design {fma['fma_ms']:.3f} ms ({fma['fma_ms'] / ms:.1f}x, max "
                f"|kernel - plain| = {fma['fma_max_abs_err']:.3g})" if fma else "")
    device_line = (f"; on the device alone (CUDA graphs) kernel {device['device_ms']:.4f} ms, "
                   f"library {device['library_device_ms']:.4f} ms" if device else "")
    library = f" ({backend}, TF32 off)" if backend else ""
    log(f"[kernel] K1 B={B} HW={HW} {width} {dtype}, design {res['design']}: "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} library_ms={library_ms:.3f}{library} "
        f"bound_ms={bound_ms:.4f} ({bound_by}); kernel at {100 * bound_ms / ms:.1f}% "
        f"of its bound{fma_line}{device_line}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **device,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": res["max_abs_err"],
            "shape": f"B={B} HW={HW} {width} {dtype}", "design": res["design"],
            "kernel": res["kernel"],
            **({"library_backend": backend} if backend else {}),
            **({"matched_rel_l2": res["l2"]} if "l2" in res else {}), **fma}


def time_backward(B, H, W, C, dtype, seed, spread32=False, cv=None, fma_too=False) -> tuple:
    """K2 and K3 at one shape (Cq = C, Cv = ``cv`` or C), each beside its
    plain version and its bound; the library call (the backward of
    scaled_dot_product_attention over [v | grid], without the max-score
    route) stands for the pair. A bf16 shape the tensor-core design takes
    must be served by it. At HW <= 64, where the host's time to issue a call
    paces it, K2, K3 and the library call are also timed on the device
    alone (CUDA graphs). With ``fma_too`` the FMA pair's C functions run on
    the same inputs too, held to the exact plain backward and timed beside."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    HW = H * W
    cv = cv or C
    width = f"C={C}" if cv == C else f"Cq={C} Cv={cv}"
    q, k, v, grid = _kernel_inputs(B, H, W, C, cv, dtype, seed=seed, spread32=spread32)
    dout = _cotangent(B, HW, cv, seed=seed + 1)
    res = backward_case(q, k, v, grid, dout)
    log(f"[kernel] K2, K3 B={B} HW={HW} {width} {dtype}: {_case_line(res)}")
    if (dtype == "bfloat16" and C % 8 == 0 and cv % 8 == 0
            and res["design"] != corr.DESIGN_MMA):
        raise AssertionError(f"B={B} HW={HW} {width} {dtype} is not served by the tensor-core "
                             f"design but by {res['design']}")
    check_backward(res, f"B={B} HW={HW}")
    rows, design = res["rows"], res["design"]
    k2_err, k3_err = res["k2_err"], res["k3_err"]
    del res
    out = torch.cat(corr.fused_correlation_warp(q, k, v, grid), dim=-1)

    def k2_call():
        corr.correlation_bwd_rows(q, k, v, grid, out, dout)

    def k3_call():
        corr.correlation_bwd_cols(q, k, v, grid, dout, rows)

    k2_ms = cuda_time_ms(k2_call, iters=10)
    k3_ms = cuda_time_ms(k3_call, iters=10)
    pair = corr.backward_kernel(q.dtype, HW, C, cv)
    turns = (_pairs_in_turns(q, k, v, grid, out, dout, iters=10)
             if pair and _hopper_pair(C, cv) else {})
    k2_plain = cuda_time_ms(lambda: corr.correlation_bwd_rows_plain(q, k, v, grid, dout), iters=3)
    k3_plain = cuda_time_ms(lambda: corr.correlation_bwd_cols_plain(q, k, v, grid, dout), iters=3)
    torch.cuda.empty_cache()
    fma = {}
    if fma_too and design != corr.DESIGN_FMA:
        # the FMA pair's C functions on the same inputs, as the wrapper would
        # launch them for a shape the tensor-core design does not take, given
        # the exact forward's buffer (as backward_case gives it)
        exact_out = corr._plain_buffer(q, k, v, grid)
        dq_f = torch.empty((B, HW, C), dtype=torch.float32, device=q.device)
        dk_f, dv_f = torch.empty_like(dq_f), torch.empty((B, HW, cv), device=q.device)
        stats_f = torch.empty((B, HW, 3), dtype=torch.float32, device=q.device)
        amax_f = torch.empty((B, HW), dtype=torch.int32, device=q.device)

        def fma_rows():
            corr._launch(corr.KERNEL_BWD, corr.KERNEL_BWD_ROWS,
                         (q, k, v, grid, exact_out, dout, dq_f, stats_f, amax_f), q, v)

        def fma_cols():
            corr._launch(corr.KERNEL_BWD, corr.KERNEL_BWD_COLS,
                         (q, k, v, grid, dout, stats_f, amax_f, dk_f, dv_f), q, v)

        fma_rows()
        fma_cols()
        torch.cuda.synchronize()
        ref = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, amax_f.long())[:3]
        fma["fma_max_abs_err"] = _scaled_err([dq_f, dk_f, dv_f], ref)
        del ref
        if fma["fma_max_abs_err"] > BWD_TOL:
            raise AssertionError(f"K2, K3's FMA pair disagrees with the plain backward at B={B}")
        fma["fma_k2_ms"] = cuda_time_ms(fma_rows, iters=3)
        fma["fma_k3_ms"] = cuda_time_ms(fma_cols, iters=3)
        if HW <= 64:
            fma["fma_k2_device_ms"] = graph_ms(fma_rows, 20)
            fma["fma_k3_device_ms"] = graph_ms(fma_cols, 20)
        del dq_f, dk_f, dv_f, stats_f, amax_f, exact_out
        torch.cuda.empty_cache()

    vg = torch.cat([v, grid.expand(B, HW, 2), v.new_zeros(B, HW, 6)], dim=-1)[:, None]
    qh, kh, vh = (t.detach().requires_grad_(True) for t in (q[:, None], k[:, None], vg))
    do = torch.cat([dout[..., :cv + 2], dout.new_zeros(B, HW, 6)], dim=-1)[:, None].to(q.dtype)
    library_ms, backend = sdpa_ms(qh, kh, vh, iters=10, do=do)
    device = {}
    if HW <= 64:
        device = {"k2_device_ms": graph_ms(k2_call, 20), "k3_device_ms": graph_ms(k3_call, 20),
                  "library_device_ms": sdpa_ms(qh, kh, vh, iters=20, do=do, timer=graph_ms)[0]}

    common = _nbytes(q, k, v, grid, dout, rows.stats, rows.amax)
    k2_bound_ms, k2_by = k2_bound(B, HW, C, cv, dtype, common + _nbytes(out) + B * HW * C * 4)
    k3_bound_ms, k3_by = k3_bound(B, HW, C, cv, dtype, common + B * HW * (C + cv) * 4)
    shape = f"B={B} HW={HW} {width} {dtype}, design {design}"
    for name, ms, plain, bound, by, err, key in (
            ("K2", k2_ms, k2_plain, k2_bound_ms, k2_by, k2_err, "k2_device_ms"),
            ("K3", k3_ms, k3_plain, k3_bound_ms, k3_by, k3_err, "k3_device_ms")):
        alone = (f"; on the device alone (CUDA graphs) {device[key]:.4f} ms, "
                 f"{100 * bound / device[key]:.1f}% of its bound" if device else "")
        log(f"[kernel] {name} {shape}: err {err:.3g}; kernel_ms={ms:.3f} plain_ms={plain:.3f} "
            f"bound_ms={bound:.4f} ({by}), {100 * bound / ms:.1f}% of its bound{alone}")
    library = f" ({backend}, TF32 off)" if backend else ""
    alone = (f"; on the device alone {device['k2_device_ms'] + device['k3_device_ms']:.4f} ms, "
             f"library {device['library_device_ms']:.4f} ms" if device else "")
    fma_line = ""
    if fma:
        fma_line = (f"; the FMA pair {fma['fma_k2_ms']:.3f} + {fma['fma_k3_ms']:.3f} ms "
                    f"({(fma['fma_k2_ms'] + fma['fma_k3_ms']) / (k2_ms + k3_ms):.1f}x, "
                    f"{fma['fma_max_abs_err']:.3g} of the largest gradient vs the exact plain "
                    "backward)")
        if "fma_k2_device_ms" in fma:
            fma_line += (f", on the device alone {fma['fma_k2_device_ms']:.4f} + "
                         f"{fma['fma_k3_device_ms']:.4f} ms")
    log(f"[kernel] K2+K3 {k2_ms + k3_ms:.3f} ms ({pair or 'fma'}); library (attention "
        f"backward) {library_ms:.3f} ms{library}{alone}{fma_line}{_turns_line(turns)}")
    turn_bounds = {"k2": k2_bound_ms, "k3": k3_bound_ms}
    for kernel, t in turns.items():
        if kernel in turn_bounds:
            log(f"[kernel] {kernel.upper()} {shape}, in turns: " + ", ".join(
                f"{key[:-len('_ms_turns')]} {100 * turn_bounds[kernel] / min(ts):.1f}% of its "
                f"bound {turn_bounds[kernel]:.4f} ms at best" for key, ts in t.items()))
    named = {"library_backend": backend} if backend else {}
    both = {"library_ms": library_ms, "library_covers": "K2+K3", "shape": shape,
            "design": design, **named, **fma}
    if device:
        both["library_device_ms"] = device["library_device_ms"]
    k2 = {"ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound_ms, "bound_by": k2_by,
          "max_abs_err": k2_err, "kernel": pair, **both, **turns.get("k2", {}),
          **({"library_ms_turns": turns["library_ms_turns"]} if turns else {}),
          **({"device_ms": device["k2_device_ms"]} if device else {})}
    k3 = {"ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound_ms, "bound_by": k3_by,
          "max_abs_err": k3_err, "kernel": pair, **both, **turns.get("k3", {}),
          **({"library_ms_turns": turns["library_ms_turns"]} if turns else {}),
          **({"device_ms": device["k3_device_ms"]} if device else {})}
    return k2, k3


def _sdpa_backward(q, k, v, grid, dout):
    """The backward of scaled_dot_product_attention over [v | grid] (bf16,
    as PyTorch dispatches it) with dout's columns as its cotangent: the
    library call that stands for K2+K3. Timed only: the port never calls
    it."""
    import torch
    import torch.nn.functional as F

    B, HW, cv = v.shape
    vg = torch.cat([v, grid.expand(B, HW, 2), v.new_zeros(B, HW, 6)], dim=-1)[:, None]
    qh, kh, vh = (t.detach().requires_grad_(True) for t in (q[:, None], k[:, None], vg))
    do = torch.cat([dout[..., :cv + 2], dout.new_zeros(B, HW, 6)], dim=-1)[:, None].to(q.dtype)
    o = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
    return lambda: torch.autograd.grad(o, (qh, kh, vh), do, retain_graph=True)


def _pairs_in_turns(q, k, v, grid, out, dout, iters) -> dict:
    """The pairs of K2 and K3 in the tensor-core design that take these
    widths (the Hopper one, narrow up to 64 channels and wgmma beyond, and
    the mma.sync one), asked for by name, and the library backward (:func:`_sdpa_backward`),
    timed in turns on the same inputs (the list, then again in reverse):
    {"k2": {"<pair>_ms_turns": [..], ...}, "k3": {...}, "library_ms_turns": [..]}."""
    from mapfree_tpu_torch.ops import correlation as corr

    pairs = [_hopper_pair(q.shape[-1], v.shape[-1]), corr.KERNEL_FWD_MMA_SYNC]
    rows = {name: corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=name)[1]
            for name in pairs}
    library = _sdpa_backward(q, k, v, grid, dout)
    got = {key: {f"{name}_ms_turns": [] for name in rows} for key in ("k2", "k3")}
    got["library_ms_turns"] = []
    for name in pairs + [None, None] + pairs[::-1]:
        if name is None:
            got["library_ms_turns"].append(cuda_time_ms(library, iters=iters))
            continue
        got["k2"][f"{name}_ms_turns"].append(cuda_time_ms(
            lambda: corr.correlation_bwd_rows(q, k, v, grid, out, dout, kernel=name),
            iters=iters))
        got["k3"][f"{name}_ms_turns"].append(cuda_time_ms(
            lambda: corr.correlation_bwd_cols(q, k, v, grid, dout, rows[name], kernel=name),
            iters=iters))
    return got


def _turns_line(turns: dict) -> str:
    if not turns:
        return ""
    lib = turns["library_ms_turns"]
    return "; " + ", ".join(
        f"{kernel.upper()} " + ", ".join(
            f"{key[:-len('_ms_turns')].replace('_', '.')} {min(ts):.3f}-{max(ts):.3f} ms"
            for key, ts in t.items())
        for kernel, t in turns.items() if kernel in ("k2", "k3")) + (
        f", library (attention backward) {min(lib):.3f}-{max(lib):.3f} ms (in turns)")


def _batch_slices(B: int, n: int = 2) -> list:
    """The first and the last ``n`` batch rows: where a kernel of the whole
    batch is held to the plain version, whose [B, HW, HW] volume would not
    fit the card for the whole batch."""
    return [slice(0, n), slice(B - n, B)]


def time_k1_batch(B, H, W, C, dtype, seed) -> dict:
    """K1 at a batch whose plain version does not fit the card (the fusion
    sweep's B * F = 576): the kernel over the whole batch, its first and last
    two rows held to the plain version of those rows (the design's two
    tolerances, as :func:`forward_case`), and its time beside its bound, the
    library call's at the whole batch, and the plain version's on two rows."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    HW = H * W
    q, k, v, grid = _kernel_inputs(B, H, W, C, C, dtype, seed=seed)
    out = corr.fused_correlation_warp(q, k, v, grid)
    torch.cuda.synchronize()
    design = corr.forward_design(q.dtype, C, C)
    res = {"design": design, "max_abs_err": 0.0, "err": 0.0, "l2": 0.0, "ms_err": 0.0,
           "tol": corr.MMA_FWD_VS_EXACT_TOL, "l2_tol": corr.MMA_FWD_VS_MATCHED_L2_TOL,
           "ms_tol": ATOL["float32"]}
    for sl in _batch_slices(B):
        part = [o[sl] for o in out]
        ref = corr.fused_correlation_warp_plain(q[sl], k[sl], v[sl], grid)
        matched = corr.fused_correlation_warp_plain(q[sl], k[sl], v[sl], grid,
                                                    bf16_roundings=True)
        res["max_abs_err"] = max(res["max_abs_err"], _max_err(part, ref))
        res["err"] = max(res["err"], _scaled_err(part[:2], ref[:2]))
        res["l2"] = max(res["l2"], _rel_l2(part[:2], matched[:2]))
        res["ms_err"] = max(res["ms_err"], _max_err(part[2:], ref[2:]))
        del ref, matched
    if design != corr.DESIGN_MMA:
        raise AssertionError(f"K1 at B={B} is served by the {design} design")
    check_forward(res, f"B={B} HW={HW}, batch rows 0-1 and {B - 2}-{B - 1}")
    log(f"[kernel] K1 B={B} HW={HW} C={C} {dtype}, rows 0-1 and {B - 2}-{B - 1}: "
        f"{_forward_line(res)}")
    del out
    torch.cuda.empty_cache()
    ms = cuda_time_ms(lambda: corr.fused_correlation_warp(q, k, v, grid), iters=5)
    sl = _batch_slices(B)[0]
    plain_ms = cuda_time_ms(lambda: corr.fused_correlation_warp_plain(q[sl], k[sl], v[sl], grid),
                            iters=3)
    vg = torch.cat([v, grid.expand(B, HW, 2), v.new_zeros(B, HW, 6)], dim=-1)[:, None]
    library_ms, _ = sdpa_ms(q[:, None], k[:, None], vg, iters=5)
    bound_ms, bound_by = k1_bound(B, HW, C, C, dtype, _nbytes(q, k, v, grid) + B * HW * (C + 3) * 4)
    log(f"[kernel] K1 B={B} HW={HW} C={C} {dtype}, design {design}: kernel_ms={ms:.3f} "
        f"library_ms={library_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}); kernel at "
        f"{100 * bound_ms / ms:.1f}% of its bound; plain version on 2 rows {plain_ms:.3f} ms")
    return {"ms": ms, "plain_ms_2_rows": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": res["max_abs_err"],
            "matched_rel_l2": res["l2"], "shape": f"B={B} HW={HW} C={C} {dtype}",
            "design": design, "kernel": corr.forward_kernel(q.dtype, HW, C, C)}


def time_backward_batch(B, H, W, C, dtype, seed) -> tuple:
    """K2 and K3 at a batch whose plain backward does not fit the card (the
    fusion train step's B * F = 90), given the exact forward's buffer and
    held to the plain backward on its first and last two rows as
    :func:`backward_case` holds them; then timed after K1's forward, beside
    their bounds, the library backward's at the whole batch, and the plain
    versions' on two rows."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    HW = H * W
    q, k, v, grid = _kernel_inputs(B, H, W, C, C, dtype, seed=seed)
    dout = _cotangent(B, HW, C, seed=seed + 1)
    design = corr.backward_design(q.dtype, C, C)
    if design != corr.DESIGN_MMA:
        raise AssertionError(f"K2, K3 at B={B} are served by the {design} design")
    # the exact forward's buffer, a few rows at a time, as backward_case
    # gives it (K1's own moves the row constant c by some 1e-3 relative:
    # the hand-off is held in phase 3)
    out = torch.cat([corr._plain_buffer(q[i:i + 6], k[i:i + 6], v[i:i + 6], grid)
                     for i in range(0, B, 6)])
    dq, rows = corr.correlation_bwd_rows(q, k, v, grid, out, dout)
    dk, dv = corr.correlation_bwd_cols(q, k, v, grid, dout, rows)
    torch.cuda.synchronize()
    errs = {"k2": 0.0, "k3": 0.0, "k2_l2": 0.0, "k3_l2": 0.0}
    for sl in _batch_slices(B):
        amax = rows.amax[sl].long()
        # the exact plain backward, and the one with the kernels' roundings,
        # given the argmax K2 took (near-ties are held in phase 3)
        exact = corr.fused_correlation_warp_bwd_plain(q[sl], k[sl], v[sl], grid, dout[sl], amax)
        matched = corr.fused_correlation_warp_bwd_plain(q[sl], k[sl], v[sl], grid, dout[sl],
                                                        amax, bf16_roundings=True)
        errs["k2"] = max(errs["k2"], _scaled_err([dq[sl]], exact[:1]))
        errs["k3"] = max(errs["k3"], _scaled_err([dk[sl], dv[sl]], exact[1:3]))
        errs["k2_l2"] = max(errs["k2_l2"], _rel_l2([dq[sl]], matched[:1]))
        errs["k3_l2"] = max(errs["k3_l2"], _rel_l2([dk[sl], dv[sl]], matched[1:3]))
        del exact, matched
    log(f"[kernel] K2, K3 B={B} HW={HW} C={C} {dtype}, design {design}, rows 0-1 and "
        f"{B - 2}-{B - 1}: K2 {errs['k2']:.3g}, K3 {errs['k3']:.3g} of the largest gradient vs "
        f"the exact plain backward (tol {corr.MMA_VS_EXACT_TOL:g}); relative L2 vs the plain "
        f"backward with the kernels' roundings K2 {errs['k2_l2']:.3g}, K3 {errs['k3_l2']:.3g} "
        f"(tol {corr.MMA_VS_MATCHED_L2_TOL:g})")
    for kernel in ("k2", "k3"):
        if errs[kernel] > corr.MMA_VS_EXACT_TOL or errs[kernel + "_l2"] > corr.MMA_VS_MATCHED_L2_TOL:
            raise AssertionError(f"{kernel.upper()} disagrees with its plain version at B={B}")
    del dq, dk, dv
    torch.cuda.empty_cache()
    out = torch.cat(corr.fused_correlation_warp(q, k, v, grid), dim=-1)  # K1's, as in training

    def k2_call():
        corr.correlation_bwd_rows(q, k, v, grid, out, dout)

    def k3_call():
        corr.correlation_bwd_cols(q, k, v, grid, dout, rows)

    k2_ms = cuda_time_ms(k2_call, iters=5)
    k3_ms = cuda_time_ms(k3_call, iters=5)
    pair = corr.backward_kernel(q.dtype, HW, C, C)
    turns = _pairs_in_turns(q, k, v, grid, out, dout, iters=5)
    sl = _batch_slices(B)[0]
    k2_plain = cuda_time_ms(
        lambda: corr.correlation_bwd_rows_plain(q[sl], k[sl], v[sl], grid, dout[sl]), iters=3)
    k3_plain = cuda_time_ms(
        lambda: corr.correlation_bwd_cols_plain(q[sl], k[sl], v[sl], grid, dout[sl]), iters=3)
    torch.cuda.empty_cache()
    vg = torch.cat([v, grid.expand(B, HW, 2), v.new_zeros(B, HW, 6)], dim=-1)[:, None]
    qh, kh, vh = (t.detach().requires_grad_(True) for t in (q[:, None], k[:, None], vg))
    do = torch.cat([dout[..., :C + 2], dout.new_zeros(B, HW, 6)], dim=-1)[:, None].to(q.dtype)
    library_ms, _ = sdpa_ms(qh, kh, vh, iters=5, do=do)
    common = _nbytes(q, k, v, grid, dout, rows.stats, rows.amax)
    k2_bound_ms, k2_by = k2_bound(B, HW, C, C, dtype, common + _nbytes(out) + B * HW * C * 4)
    k3_bound_ms, k3_by = k3_bound(B, HW, C, C, dtype, common + 2 * B * HW * C * 4)
    shape = f"B={B} HW={HW} C={C} {dtype}, design {design}"
    for name, ms, plain, bound, by in (("K2", k2_ms, k2_plain, k2_bound_ms, k2_by),
                                       ("K3", k3_ms, k3_plain, k3_bound_ms, k3_by)):
        log(f"[kernel] {name} {shape}: kernel_ms={ms:.3f} bound_ms={bound:.4f} ({by}), "
            f"{100 * bound / ms:.1f}% of its bound; plain version on 2 rows {plain:.3f} ms")
    log(f"[kernel] K2+K3 B={B}: {k2_ms + k3_ms:.3f} ms ({pair}); library (attention "
        f"backward) {library_ms:.3f} ms{_turns_line(turns)}")
    for kernel, bound in (("k2", k2_bound_ms), ("k3", k3_bound_ms)):
        log(f"[kernel] {kernel.upper()} {shape}, in turns: " + ", ".join(
            f"{key[:-len('_ms_turns')]} {100 * bound / min(ts):.1f}% of its bound "
            f"{bound:.4f} ms at best" for key, ts in turns[kernel].items()))
    k2 = {"ms": k2_ms, "plain_ms_2_rows": k2_plain, "library_ms": library_ms,
          "library_covers": "K2+K3", "bound_ms": k2_bound_ms, "bound_by": k2_by,
          "max_abs_err": errs["k2"], "shape": shape, "design": design, "kernel": pair,
          **turns["k2"], "library_ms_turns": turns["library_ms_turns"]}
    k3 = {"ms": k3_ms, "plain_ms_2_rows": k3_plain, "library_ms": library_ms,
          "library_covers": "K2+K3", "bound_ms": k3_bound_ms, "bound_by": k3_by,
          "max_abs_err": errs["k3"], "shape": shape, "design": design, "kernel": pair,
          **turns["k3"], "library_ms_turns": turns["library_ms_turns"]}
    return k2, k3


def phase_kernel_timing() -> dict:
    """K1 at the inference shape (batch 64) and K1, K2, K3 at the training
    shape of 3d3d.yaml (batch 10); then K1 at the fusion sweep's batch of
    64 x 9 = 576 pairs and K2, K3 at the fusion train step's 10 x 9 = 90;
    then the wide shapes (the 256-channel ResUNet's among them) and float32
    (the FMA designs); then the Kabsch kernel at the shapes its callers give
    it."""
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.ops import kabsch

    k1 = time_k1(64, 92, 68, 32, "bfloat16", seed=100, fma_too=True)
    k1["train_shape"] = time_k1(10, 92, 68, 32, "bfloat16", seed=101)
    k2, k3 = time_backward(10, 92, 68, 32, "bfloat16", seed=102)
    k1["fusion_shape"] = time_k1_batch(576, 92, 68, 32, "bfloat16", seed=103)
    k2["fusion_shape"], k3["fusion_shape"] = time_backward_batch(90, 92, 68, 32, "bfloat16",
                                                                 seed=104)
    # the wide shapes: the ResNet bottleneck's 1,024 channels at the 5x4 grid
    # of its 360x270 frames (K1 at the sweep's batch, K2 and K3 at the train
    # batch: all three on the tensor cores, the FMA pair beside), a ResUNet's 128
    # channels (NUM_OUT_LAYERS 128) at the 3d3d grid (K1 at the train batch
    # and the sweep's, K2 and K3 on the tensor cores), and Cq != Cv beyond
    # 128 (256 / 96) at the 3d3d grid; K1 beside the FMA design it took
    # before, where that is quick
    H, W = RESNET_GRID
    k1["resnet_shape"] = time_k1(64, H, W, 1024, "bfloat16", seed=105, fma_too=True,
                                 spread32=True)
    k2["resnet_shape"], k3["resnet_shape"] = time_backward(10, H, W, 1024, "bfloat16", seed=106,
                                                           spread32=True, fma_too=True)
    k1["c128_shape"] = time_k1(10, 92, 68, 128, "bfloat16", seed=107, fma_too=True,
                               spread32=True)
    k1["c128_b64_shape"] = time_k1(64, 92, 68, 128, "bfloat16", seed=113, spread32=True)
    k2["c128_shape"], k3["c128_shape"] = time_backward(10, 92, 68, 128, "bfloat16", seed=108,
                                                       spread32=True)
    # 64 channels at the 3d3d grid: the class where the narrow pair serves,
    # in turns with the mma.sync pair and the library's backward
    k2["c64_shape"], k3["c64_shape"] = time_backward(10, 92, 68, 64, "bfloat16", seed=119,
                                                     spread32=True)
    k1["q256_v96_shape"] = time_k1(10, 92, 68, 256, "bfloat16", seed=114, spread32=True, cv=96)
    # float32 (the FMA designs, exact: no TF32) beside the library's float32
    # attention with TF32 off: the 3d3d shapes and the ResNet bottleneck's
    k1["f32_shape"] = time_k1(64, 92, 68, 32, "float32", seed=109)
    k1["f32_train_shape"] = time_k1(10, 92, 68, 32, "float32", seed=115)
    k2["f32_shape"], k3["f32_shape"] = time_backward(10, 92, 68, 32, "float32", seed=110)
    k1["resnet_f32_shape"] = time_k1(64, H, W, 1024, "float32", seed=111, spread32=True)
    k2["resnet_f32_shape"], k3["resnet_f32_shape"] = time_backward(
        10, H, W, 1024, "float32", seed=112, spread32=True)
    # K2 and K3 beyond 128 channels at the 3d3d grid (bf16, Cq 256 / Cv 96:
    # the tensor-core pair with its own tiles resident in shared memory,
    # beside the FMA pair that served it before on the same inputs)
    k2["q256_v96_shape"], k3["q256_v96_shape"] = time_backward(
        10, 92, 68, 256, "bfloat16", seed=116, spread32=True, cv=96, fma_too=True)
    # the 256-channel ResUNet's shape (phase 11's train step): K1 in two
    # column tiles, K2 and K3 the streamed pair (channels in chunks of 64,
    # dq and [dk | dv] in column tiles of 128)
    k1["resunet256_shape"] = time_k1(10, 92, 68, 256, "bfloat16", seed=117, spread32=True)
    k2["resunet256_shape"], k3["resunet256_shape"] = time_backward(
        10, 92, 68, 256, "bfloat16", seed=118, spread32=True)
    # K1's tensor-core design, and which of its kernels, at each driven shape:
    # the wgmma kernel beyond 64 positions, the mma.sync kernel at the ResNet
    # encoder's 5x4 grid
    for t in [k1] + [k1[key] for key in ("train_shape", "fusion_shape", "resnet_shape",
                                         "c128_shape", "c128_b64_shape", "q256_v96_shape",
                                         "resunet256_shape")]:
        want = corr.KERNEL_FWD_MMA_SYNC if t is k1["resnet_shape"] else corr.KERNEL_FWD_WGMMA
        if t["design"] != corr.DESIGN_MMA or t["kernel"] != want:
            raise AssertionError(f"K1 at {t['shape']} is served by the {t['design']} design's "
                                 f"{t['kernel']} kernel, not the {want} kernel")
        log(f"[kernel] K1 at {t['shape']}: the {t['design']} design's {t['kernel']} kernel")
    # K2 and K3's tensor-core pair at each driven shape: wgmma at 128 and
    # 256 channels and at 256 / 96, narrow at 64, mma.sync at 32 (measured
    # faster there) and on the ResNet encoder's 5x4 grid
    for t in (k2, k2["fusion_shape"], k2["resnet_shape"], k2["c128_shape"],
              k2["q256_v96_shape"], k2["resunet256_shape"], k2["c64_shape"]):
        want = (corr.KERNEL_FWD_MMA_SYNC if t is k2 or t is k2["fusion_shape"]
                or t is k2["resnet_shape"] else corr.KERNEL_BWD_PAIR_NARROW
                if t is k2["c64_shape"] else corr.KERNEL_FWD_WGMMA)
        if t["design"] != corr.DESIGN_MMA or t["kernel"] != want:
            raise AssertionError(f"K2, K3 at {t['shape']} are served by the {t['design']} "
                                 f"design's {t['kernel']} pair, not the {want} pair")
    for t in (k1["f32_shape"], k1["f32_train_shape"], k2["f32_shape"],
              k1["resnet_f32_shape"], k2["resnet_f32_shape"]):
        if t["design"] != corr.DESIGN_FMA:
            raise AssertionError(f"{t['shape']} is served by the {t['design']} design")
    return {corr.KERNEL: k1, corr.KERNEL_BWD_ROWS: k2, corr.KERNEL_BWD_COLS: k3,
            kabsch.LIBRARY: time_kabsch()}


# -- phase 4 -----------------------------------------------------------------

def load_cfg(overrides: dict | None = None,
             model_yaml: str | None = "configs/regression/mapfree/3d3d.yaml"):
    """``model_yaml`` over its dataset config (configs/scannet.yaml for the
    ScanNet models, configs/mapfree.yaml then configs/mapfree_multi.yaml for
    the multi-frame ones, configs/mapfree.yaml otherwise; with ``None``
    configs/mapfree.yaml alone, the depth net's training config), then
    dotted ``overrides``."""
    from mapfree_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    model_yaml = model_yaml or ""
    cfg.merge_from_file(str(REPO / ("configs/scannet.yaml" if "/scannet/" in model_yaml
                                    else "configs/mapfree.yaml")))
    if "/multiframe/" in model_yaml:
        cfg.merge_from_file(str(REPO / "configs/mapfree_multi.yaml"))
    if model_yaml:
        cfg.merge_from_file(str(REPO / model_yaml))
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


def phase_main_path() -> dict:
    """The inference sweep. Returns the launches per kernel in the measured
    sweep (:func:`launch_counts`)."""
    import torch

    from mapfree_tpu_torch.models.builder import build_model
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.ops import kabsch
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
    reset_launches()
    with designs_served() as seen:
        t0 = time.perf_counter()
        results = predict(batches, model, times)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts[corr.KERNEL]
    if counts[kabsch.LIBRARY] != len(batches):
        raise AssertionError(f"the Kabsch kernel launched {counts[kabsch.LIBRARY]} times for "
                             f"{len(batches)} batches")
    _expect_designs(seen, {"forward": [corr.DESIGN_MMA]}, "the inference sweep", [corr.KERNEL_FWD_WGMMA])
    if corr.launches[corr.KERNEL_BWD_ROWS] or corr.launches[corr.KERNEL_BWD_COLS]:
        raise AssertionError("the inference sweep launched a backward kernel")
    log(f"[main] {n_pairs} pairs in {len(batches)} batches: {elapsed:.3f} s, "
        f"{n_pairs / elapsed:.1f} pairs/s, {1e3 * elapsed / len(batches):.1f} ms/batch; "
        f"K1 launches {launches}, {corr.DESIGN_MMA} design; Kabsch launches {counts[kabsch.LIBRARY]}; "
        f"stages {times.summary()}")
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
    time_upsample(model, transferred)
    return counts


def time_upsample(model, transferred) -> None:
    """The ResUNet's two bilinear upsamples at the forward's shapes: the
    port's two interpolation matmuls in the compute dtype
    (models/blocks.py::resize_bilinear_align_corners) beside F.interpolate in
    float32, which autocast ran before."""
    import torch
    import torch.nn.functional as F

    from mapfree_tpu_torch.models.blocks import resize_bilinear_align_corners

    enc = model.net.encoder
    seen = []
    hooks = [m.register_forward_pre_hook(lambda _m, args: seen.append(
        (tuple(args[0].shape), args[0].dtype,
         torch.channels_last if args[0].is_contiguous(memory_format=torch.channels_last)
         else torch.contiguous_format)))
        for m in (enc.upconv4, enc.upconv3)]
    try:
        model.dispatch_device(transferred)()
    finally:
        for h in hooks:
            h.remove()
    def issue_us(fn, n=20):
        """Host time to issue one call (the device is left to catch up)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        return us

    total_new = total_old = 0.0
    for shape, dtype, layout in seen:
        x = torch.randn(shape, device="cuda").to(dtype).contiguous(memory_format=layout)
        out = (shape[2] * 2, shape[3] * 2)

        def new_fn():
            return resize_bilinear_align_corners(x, out)

        def old_fn():
            return F.interpolate(x.float(), size=out, mode="bilinear", align_corners=True)

        new, old = cuda_time_ms(new_fn, iters=20), cuda_time_ms(old_fn, iters=20)
        total_new, total_old = total_new + new, total_old + old
        log(f"[main] upsample {list(shape)} {dtype} {str(layout).split('.')[-1]} -> {out}: "
            f"{new:.3f} ms (two matmuls in {dtype}), F.interpolate in float32 {old:.3f} ms; "
            f"host time to issue one call {issue_us(new_fn):.1f} us and "
            f"{issue_us(old_fn):.1f} us")
    log(f"[main] upsamples per forward: {total_new:.3f} ms (F.interpolate in float32 "
        f"{total_old:.3f} ms)")


@contextlib.contextmanager
def designs_served():
    """Inside the block, notes the design the package picks for each launch
    of K1 (``forward_design``) and of K2 and K3 (``backward_design``), the
    kernel of K1's tensor-core design (``forward_kernel``) and the pair of
    K2 and K3's (``backward_kernel``): yields {"forward": set of designs,
    "backward": set of designs, "forward_kernel": set of kernels,
    "backward_kernel": set of kernels}."""
    from mapfree_tpu_torch.ops import correlation as corr

    seen = {"forward": set(), "backward": set(), "forward_kernel": set(),
            "backward_kernel": set()}
    saved = (corr.forward_design, corr.backward_design, corr.forward_kernel,
             corr.backward_kernel)

    def noting(kind, choose):
        def design(*args):
            chosen = choose(*args)
            if chosen is not None:
                seen[kind].add(chosen)
            return chosen
        return design

    corr.forward_design = noting("forward", saved[0])
    corr.backward_design = noting("backward", saved[1])
    corr.forward_kernel = noting("forward_kernel", saved[2])
    corr.backward_kernel = noting("backward_kernel", saved[3])
    try:
        yield seen
    finally:
        (corr.forward_design, corr.backward_design, corr.forward_kernel,
         corr.backward_kernel) = saved


def _expect_designs(seen: dict, expected: dict, what: str, kernels=None,
                    bwd_kernels=None) -> None:
    """Raise unless the designs in ``seen`` are ``expected`` and, where
    ``kernels`` is given, K1's tensor-core kernels are those, where
    ``bwd_kernels`` is, K2 and K3's; log which kernels served the path
    either way."""
    got = {kind: sorted(designs) for kind, designs in seen.items()
           if designs and not kind.endswith("_kernel")}
    if got != expected:
        raise AssertionError(f"{what} ran the designs {got}, expected {expected}")
    served = sorted(seen.get("forward_kernel", ()))
    served_bwd = sorted(seen.get("backward_kernel", ()))
    log(f"[designs] {what}: K1 {got.get('forward')}, its tensor-core kernels {served}; K2, K3 "
        f"{got.get('backward')}, their tensor-core pair {served_bwd}")
    if kernels is not None and served != sorted(kernels):
        raise AssertionError(f"{what} ran K1's kernels {served}, expected {sorted(kernels)}")
    if bwd_kernels is not None and served_bwd != sorted(bwd_kernels):
        raise AssertionError(f"{what} ran K2 and K3's tensor-core pair {served_bwd}, expected "
                             f"{sorted(bwd_kernels)}")


def profile_window(fn, what: str, n: int = 3) -> dict:
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
    launches = sum(r[1] for r in rows) // n
    log(f"[profile] {n} {what}s: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), {len(rows)} kinds of "
        f"kernel, {sum(r[1] for r in rows) // n} launches per {what}; annotation ranges "
        f"left out: {ranges_us / 1e3:.2f} ms")
    for rank, (us, count, key) in enumerate(rows):
        if rank < 15 or "correlation_" in key:  # this package's kernels wherever they rank
            log(f"[profile] {us / 1e3 / n:9.3f} ms/{what} {100 * us / busy:5.1f}%  "
                f"x{count // n:<4d} {key[:90]}")
    return {"launches": launches, "busy_share": busy / wall_us,
            "ms_by_kernel": {key: us / 1e3 / n for us, _, key in rows}}


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


def reset_launches() -> None:
    """Zero the package's launch counts: K1-K3's and the Kabsch kernel's."""
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.ops import kabsch

    corr.reset_launches()
    kabsch.reset_launches()


def launch_counts() -> dict:
    """The package's launches per kernel (K1, K2, K3 and the Kabsch kernel)
    since the last reset, and under "by_function" K1-K3's per C function
    that served them (a function's name begins with its kernel's: which
    design and which tensor-core kernel)."""
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.ops import kabsch

    return {**corr.launches, kabsch.LIBRARY: kabsch.launches,
            "by_function": {fn: n for fn, n in corr.kernel_launches.items() if n}}


def _expect_launches(corr, expected: dict, what: str) -> None:
    got = dict(corr.launches)
    if got != expected:
        raise AssertionError(f"{what}: kernel launches {got}, expected {expected}")


def phase_train_path() -> dict:
    """The training path at full width. Returns each kernel's launches in the
    timed train steps (``train_steps``) and in the fit loop's run
    (``train_loop``)."""
    import torch

    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.ops import kabsch
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
    reset_launches()
    logs = []
    with designs_served() as seen:
        t0 = time.perf_counter()
        for b in dbatches[n_warm:]:
            state, step_logs = train_step(state, b)
            logs.append(step_logs)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    _expect_launches(corr, {corr.KERNEL: n_steps, corr.KERNEL_BWD_ROWS: n_steps,
                            corr.KERNEL_BWD_COLS: n_steps}, f"{n_steps} train steps")
    step_launches = launch_counts()
    # the head's solve records autograd in a train step: the tensor version
    if step_launches[kabsch.LIBRARY]:
        raise AssertionError(f"{n_steps} train steps launched the Kabsch kernel "
                             f"{step_launches[kabsch.LIBRARY]} times")
    all_mma = {"forward": [corr.DESIGN_MMA], "backward": [corr.DESIGN_MMA]}
    _expect_designs(seen, all_mma, f"{n_steps} train steps", [corr.KERNEL_FWD_WGMMA], BWD_MMA_SYNC)
    losses = [float(lg["train/loss"]) for lg in logs]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {n_steps} steps after {n_warm} warm-up: {step_ms:.2f} ms/step, "
        f"{1e3 * bs / step_ms:.1f} samples/s; peak memory {peak_gb:.2f} GB; K1, K2, K3 "
        f"each launched {n_steps} times, all in the {corr.DESIGN_MMA} design")
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
        reset_launches()
        captured = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(captured), designs_served() as seen:
            state = fit_loaders(cfg, train_loader, val_loader, experiment="smoke",
                                weights_dir=tmp, device=dev)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = launch_counts()
        _expect_designs(seen, all_mma, "the fit loop", [corr.KERNEL_FWD_WGMMA], BWD_MMA_SYNC)
        for line in captured.getvalue().splitlines():
            log(f"[fit]   {line}")
        # 8 train steps; validation at steps 4 and 8 over 2 of the 3 batches
        _expect_launches(corr, {corr.KERNEL: 8 + 2 * 2, corr.KERNEL_BWD_ROWS: 8,
                                corr.KERNEL_BWD_COLS: 8}, "the fit loop")
        # the Kabsch kernel in validation's 2 x 2 batches (no_grad), none in
        # the 8 steps
        if launches[kabsch.LIBRARY] != 2 * 2:
            raise AssertionError(f"the fit loop launched the Kabsch kernel "
                                 f"{launches[kabsch.LIBRARY]} times, not once a validation batch")
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
    return {"train_steps": step_launches, "train_loop": launches}


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
def plain_versions_on_the_card(forward: bool = True, reverse_keys: bool = False):
    """Inside the block the correlation Function computes the plain versions
    on CUDA tensors too (and counts no launch for them): the yardstick for a
    whole train step. The plain forward rounds P to bf16 where K1's
    tensor-core design would serve the inputs. With ``forward=False`` K1
    still runs and only the backward is the plain one, so that the two steps
    share their forward to the bit. With ``reverse_keys`` the plain versions
    take the keys (k, v and the grid) in reverse order and put dk and dv
    back: the same function, its sums over keys in another order, which
    moves it by float32 round-off (a control of how far the model carries
    such a difference). Used here only; the port has no such switch."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    def keys(k, v, grid):
        return (k.flip(1), v.flip(1), grid.flip(-2)) if reverse_keys else (k, v, grid)

    saved = corr._forward_cuda, corr.correlation_bwd_rows, corr.correlation_bwd_cols
    if forward:
        # the plain forward with the rounding of the design the kernel would take
        corr._forward_cuda = lambda q, k, v, grid: torch.cat(corr.fused_correlation_warp_plain(
            q, *keys(k, v, grid), bf16_roundings=corr.forward_design(
                q.dtype, q.shape[-1], v.shape[-1]) == corr.DESIGN_MMA), dim=-1)
    corr.correlation_bwd_rows = lambda q, k, v, grid, out, dout: (
        corr.correlation_bwd_rows_plain(q, *keys(k, v, grid), dout)[0], None)
    corr.correlation_bwd_cols = lambda q, k, v, grid, dout, rows: tuple(
        g.flip(1) if reverse_keys else g
        for g in corr.correlation_bwd_cols_plain(q, *keys(k, v, grid), dout))
    try:
        yield
    finally:
        corr._forward_cuda, corr.correlation_bwd_rows, corr.correlation_bwd_cols = saved


@contextlib.contextmanager
def correlation_inputs():
    """Inside the block each backward of the correlation Function on the
    card records its inputs (q, k, v, grid, dout) into the list it yields,
    then runs as it would."""
    from mapfree_tpu_torch.ops import correlation as corr

    got, saved = [], corr.correlation_bwd_rows

    def rows(q, k, v, grid, out, dout):
        got.append((q, k, v, grid, dout))
        return saved(q, k, v, grid, out, dout)

    corr.correlation_bwd_rows = rows
    try:
        yield got
    finally:
        corr.correlation_bwd_rows = saved


def kernels_on_step_inputs(inputs: tuple, what: str) -> dict:
    """K1, K2 and K3 on the correlation's own inputs in a train step (as
    :func:`correlation_inputs` recorded them) against their plain versions,
    each kernel alone, as phase 3 holds them on random inputs: before the
    model's other layers round or carry on what they differ by. K2 and K3
    are held at phase 3's limits; K1 where it runs in its FMA design, as a
    share of each output's largest entry (or of 1) at ATOL's float32 limit,
    the step's features not being of unit size. The tensor-core K1 is only
    printed: phase 3 holds its max score at float32 tightness on scores
    that spread as at 32 channels, and it sums the scores in another order
    than a float32 matrix product, so on unscaled features (the ResNet
    encoder's scores reach the hundreds) its max score moves by their
    round-off."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    q, k, v, grid, dout = inputs
    fwd = forward_case(q, k, v, grid)
    line = _forward_line(fwd)
    if fwd["design"] == corr.DESIGN_FMA:
        fwd["err"] = _scaled_err(corr.fused_correlation_warp(q, k, v, grid),
                                 corr.fused_correlation_warp_plain(q, k, v, grid))
        line = (f"K1 design {fwd['design']}: {fwd['err']:.3g} of each output's largest entry "
                f"vs the exact plain forward (tol {fwd['tol']:g})")
    top = float(torch.bmm(q.float(), k.float().transpose(1, 2)).abs().max())
    res = backward_case(q, k, v, grid, dout)
    log(f"[{what}] the kernels on the step's own correlation inputs (q {tuple(q.shape)} "
        f"{str(q.dtype).split('.')[-1]}, scores up to {top:.4g} in magnitude): {line}"
        f"{'' if fwd['design'] == corr.DESIGN_FMA else ' (printed only)'}; {_case_line(res)}")
    if fwd["design"] == corr.DESIGN_FMA:
        check_forward(fwd, what)
    check_backward(res, what)
    return {"k1_err": fwd["err"], "k2_err": res["k2_err"], "k3_err": res["k3_err"],
            "max_abs_score": top}


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

    reset_launches()
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


def bf16_step_kernels_vs_plain(cfg, batch: dict, what: str,
                               designs: tuple = ("mma", "mma"), control: bool = False,
                               bwd_kernels=None) -> dict:
    """One bf16 train step of ``cfg``'s model on the card with K1, K2 and K3
    in the designs ``designs`` (K1's, then K2 and K3's; the tensor cores by
    default), against the same step with the plain backward after the same
    K1 forward and with the plain versions forward too: the loss and the
    whole gradient in the L2 norm, at phase 6's limits. A second run of the
    kernels' step gives the floor. With ``control`` the plain backward after
    the same K1 forward also runs with its float32 dq, dk and dv each moved
    one unit in the last place (torch.nextafter), and what that moves the
    gradient by is printed: how far the bf16 layers below carry a float32
    round-off in them. Returns the launches of the two kernels' steps."""
    import torch

    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train import init_state, make_train_step
    from mapfree_tpu_torch.train.fit import _device_batch

    bs = int(cfg.TRAINING.BATCH_SIZE)
    loss, grads = {}, {}

    def one_step(name):
        net = build_regression_net(cfg)
        state = init_state(net, cfg, torch.Generator().manual_seed(SEED), device="cuda")
        _, logs = make_train_step(net, cfg)(state, _device_batch(batch, torch.device("cuda"), bs))
        loss[name] = float(logs["train/loss"])
        grads[name] = {k: p.grad.detach().float().cpu() for k, p in net.named_parameters()}

    reset_launches()
    with designs_served() as seen:
        one_step("kernels")
    one_step("again")
    launches = launch_counts()
    _expect_launches(corr, {corr.KERNEL: 2, corr.KERNEL_BWD_ROWS: 2, corr.KERNEL_BWD_COLS: 2},
                     f"{what}: two bf16 train steps on the card")
    _expect_designs(seen, {"forward": [designs[0]], "backward": [designs[1]]},
                    f"{what}: the bf16 train step", bwd_kernels=bwd_kernels)
    with plain_versions_on_the_card(forward=False):
        one_step("plain_backward")
    with plain_versions_on_the_card():
        one_step("plain")
    if control:
        with plain_versions_on_the_card(forward=False):
            rows, cols = corr.correlation_bwd_rows, corr.correlation_bwd_cols
            up = functools.partial(torch.nextafter, other=torch.tensor(float("inf"), device="cuda"))
            corr.correlation_bwd_rows = lambda *a: (up(rows(*a)[0]), None)
            corr.correlation_bwd_cols = lambda *a: tuple(up(g) for g in cols(*a))
            one_step("plain_backward_ulp")
        per_c, l2_c = _grad_errors(grads["plain_backward_ulp"], grads["plain_backward"])
        log(f"[{what}] control: the plain backward after the same K1 forward, its dq, dk and dv "
            f"one float32 ulp up, vs as it is: whole gradient {l2_c:.2e} in L2, worst tensor "
            f"{per_c[0][0]:.2e} at {per_c[0][1]}, median tensor {per_c[len(per_c) // 2][0]:.2e}")

    _, floor = _grad_errors(grads["again"], grads["kernels"])
    per_b, l2_b = _grad_errors(grads["kernels"], grads["plain_backward"])
    per, l2 = _grad_errors(grads["kernels"], grads["plain"])
    rel = abs(loss["kernels"] - loss["plain"]) / abs(loss["plain"])
    log(f"[{what}] bf16 train step, K2 and K3 ({designs[1]}) vs the plain backward after the "
        f"same K1 forward: loss {loss['kernels']:.6f} vs {loss['plain_backward']:.6f}; whole "
        f"gradient {l2_b:.2e} in L2 (tol {STEP_BF16_BWD_L2_TOL:g}); worst tensor "
        f"{per_b[0][0]:.2e} of its largest entry at {per_b[0][1]}, median tensor "
        f"{per_b[len(per_b) // 2][0]:.2e}; a second run of the kernels' step differs by "
        f"{floor:.2e} in L2")
    log(f"[{what}] bf16 train step, kernels vs plain versions on the card, forward too (with "
        f"K1's bf16 rounding of P): loss "
        f"{loss['kernels']:.6f} vs {loss['plain']:.6f} (rel {rel:.2e}, tol "
        f"{STEP_BF16_LOSS_RTOL:g}); whole gradient {l2:.2e} in L2 (tol {STEP_BF16_L2_TOL:g}); "
        f"worst tensor {per[0][0]:.2e} at {per[0][1]}, median tensor "
        f"{per[len(per) // 2][0]:.2e}")
    if loss["kernels"] != loss["plain_backward"]:
        raise AssertionError(f"{what}: two bf16 steps with the same K1 forward differ in the loss")
    if not (np.isfinite(loss["kernels"]) and rel <= STEP_BF16_LOSS_RTOL
            and l2_b <= STEP_BF16_BWD_L2_TOL and l2 <= STEP_BF16_L2_TOL):
        raise AssertionError(f"{what}: the bf16 train step with the kernels disagrees with the "
                             "plain versions")
    return launches


def phase_train_parity_bf16() -> None:
    """One bf16 train step of the small model (:func:`bf16_step_kernels_vs_plain`)."""
    cfg = load_cfg({"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96,
                    "DATASET.WIDTH": 72, "TRAINING.BATCH_SIZE": 4, "TRAINING.LR": 1e-3,
                    "TRAINING.GRAD_CLIP": 1.0, "TPU.COMPUTE_DTYPE": "bfloat16",
                    "TPU.SEED": SEED})
    bf16_step_kernels_vs_plain(cfg, train_batches(1, 4, 96, 72, seed=SEED + 21)[0], "parity",
                               bwd_kernels=BWD_MMA_SYNC)


# -- phase 7 -----------------------------------------------------------------

FIXTURES = REPO / "tests" / "data" / "torch_port"
# the card's decode against the JAX package's outputs on the fixtures: mean
# absolute difference in levels; the largest difference is held to the gap
# between the JAX package's own two decode paths on the same files
# (tests/data/torch_port/decode_gap.json, measured where both run)
DECODE_MEAN_TOL = 1.0


def phase_decode() -> dict:
    """nvJPEG on the fixtures against the JAX package's decode of them, the
    zero-fill of files it cannot decode, and the time of a 64-frame batch."""
    import torch

    from mapfree_tpu_torch.data import jpeg

    dec = jpeg.decoder()
    header, _ = jpeg.nvjpeg_files()
    log(f"[decode] nvJPEG {dec.version}: {dec.library_path} (header {header})")
    paths = [str(p) for p in sorted(FIXTURES.glob("frame_*.jpg"))]
    ref = np.load(FIXTURES / "jax_decode_270x360.npz")
    gap = json.loads((FIXTURES / "decode_gap.json").read_text())
    out = {"library": dec.library_path, "version": dec.version}
    for key in ("yuv420", "uint8"):
        got = jpeg.decode_resize_batch(paths, 270, 360, device="cuda", **{key: True})
        if got.shape != ref[key].shape or got.dtype != ref[key].dtype:
            raise AssertionError(f"decode {key}: {got.dtype}{got.shape}, expected "
                                 f"{ref[key].dtype}{ref[key].shape}")
        diff = np.abs(got.astype(np.int32) - ref[key].astype(np.int32))
        out[key] = {"max_abs": int(diff.max()), "mean_abs": float(diff.mean())}
        log(f"[decode] {len(paths)} fixtures to 270x360 {key} against the JAX package: "
            f"mean |diff| {diff.mean():.4f} (limit {DECODE_MEAN_TOL}), max {diff.max()} "
            f"(limit {gap[key]['max_abs']}, the JAX package's native vs cv2 gap)")
        if diff.mean() > DECODE_MEAN_TOL or diff.max() > gap[key]["max_abs"]:
            raise AssertionError(f"the card's {key} decode disagrees with the JAX package's")
    floats = jpeg.decode_resize_batch(paths, 270, 360, device="cuda")
    u8 = jpeg.decode_resize_batch(paths, 270, 360, device="cuda", uint8=True)
    if floats.dtype != np.float32 or np.abs(floats * 255.0 - u8).max() > 0.5 + 1e-3:
        raise AssertionError("the float output is not the uint8 output before rounding")

    # files nvJPEG cannot decode are zero-filled and counted: a missing and
    # an empty file, one that is no JPEG, one cut off inside its headers and
    # one whose scan is garbage (nvJPEG's statuses 3, 10 and 4)
    good = Path(paths[0]).read_bytes()
    bad = {"empty": b"", "not_jpeg": b"not a JPEG", "cut": good[:200],
           "garbage": good[:1000] + bytes((b * 7 + 13) % 256 for b in good[1000:])}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in bad.items():
            (Path(tmp) / f"{name}.jpg").write_bytes(data)
        batch = [paths[0], str(Path(tmp) / "missing.jpg")] + [
            str(Path(tmp) / f"{name}.jpg") for name in bad]
        jpeg.reset_stats()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = jpeg.decode_resize_batch(batch, 270, 360, device="cuda", yuv420=True)
    if (jpeg.stats["failures"] != len(batch) - 1 or not got[0].any() or got[1:, :360].any()
            or (got[1:, 360:] != 128).any() or not caught):
        raise AssertionError(f"undecodable files: stats {jpeg.stats}, warnings {len(caught)}")
    log(f"[decode] {len(batch) - 1} undecodable files (missing, {', '.join(bad)}) "
        f"zero-filled and counted")

    batch = [paths[i % len(paths)] for i in range(64)]
    for key in ("yuv420", "uint8"):
        jpeg.decode_resize_batch(batch, 270, 360, device="cuda", **{key: True})
        torch.cuda.synchronize()
        n = 5
        t0 = time.perf_counter()
        for _ in range(n):
            jpeg.decode_resize_batch(batch, 270, 360, device="cuda", **{key: True})
        ms = 1e3 * (time.perf_counter() - t0) / n
        out[key].update(ms_per_batch=ms, frames_per_s=64e3 / ms)
        log(f"[decode] 64 frames of 540x720 to 270x360 {key}: {ms:.2f} ms per batch, "
            f"{64e3 / ms:.1f} frames/s (wall, {jpeg.DECODE_THREADS} host threads)")

    # the same batch decoded while the card is busy with other work on this
    # thread's stream, as the loader decodes beside the sweep's forwards:
    # the frames must be those of the quiet decode
    quiet = jpeg.decode_resize_batch(batch, 270, 360, device="cuda", uint8=True)
    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    for _ in range(60):  # some 0.2 s of float32 products queued ahead
        torch.mm(x, x)
    busy = jpeg.decode_resize_batch(batch, 270, 360, device="cuda", uint8=True)
    torch.cuda.synchronize()
    differing = int((busy != quiet).any(axis=(1, 2, 3)).sum())
    log(f"[decode] 64 frames decoded beside 60 queued 4096^2 products: {differing} frames "
        "differ from the quiet decode's")
    if differing:
        raise AssertionError("frames decoded beside other work on the card differ")
    return out


# -- phase 8 -----------------------------------------------------------------

def write_mapfree_tree(root: Path, seed: int, device_poses: bool = False) -> dict:
    """A MapFree scene tree of copies of the fixtures, with random poses:
    ``test`` 4 scenes of seq0/frame_00000 + seq1/frame_00000..00399 (80
    pairs each at the sample factor of 5), ``train`` 2 scenes of 40 pairs
    with overlaps.npz (all inside 3d3d.yaml's 0.4-0.8), ``val`` 1 scene of
    20 pairs. With ``device_poses`` each scene also has poses_device.txt,
    the poses moved by noise of 0.01 (the multi-frame models' tracking).
    Returns {split: {scene: [single-frame query frames in submission
    order]}}."""
    import shutil

    rng = np.random.default_rng(seed)
    frames = sorted(FIXTURES.glob("frame_*.jpg"))
    layout = {"test": (4, 400, False), "train": (2, 40, True), "val": (1, 100, False)}
    queries = {}
    for split, (n_scenes, n_queries, train) in layout.items():
        queries[split] = {}
        for s in range(n_scenes):
            scene = root / split / f"s{s:05d}"
            names = ["seq0/frame_00000.jpg"] + [f"seq1/frame_{i:05d}.jpg"
                                                for i in range(n_queries)]
            intr, poses = [], []
            for j, name in enumerate(names):
                (scene / name).parent.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(frames[(j + s) % len(frames)], scene / name)
                q = rng.normal(size=4)
                q /= np.linalg.norm(q)
                t = rng.normal(size=3)
                intr.append(f"{name} 590.0 590.0 270.0 360.0 540 720")
                poses.append(f"{name} " + " ".join(f"{v:.9f}" for v in np.concatenate([q, t])))
            (scene / "intrinsics.txt").write_text("\n".join(intr) + "\n")
            (scene / "poses.txt").write_text("\n".join(poses) + "\n")
            if device_poses:
                tracked = []
                for line in poses:
                    name, *vals = line.split(" ")
                    qt = np.array(vals, float) + rng.normal(size=7) * 0.01
                    qt[:4] /= np.linalg.norm(qt[:4])
                    tracked.append(f"{name} " + " ".join(f"{v:.9f}" for v in qt))
                (scene / "poses_device.txt").write_text("\n".join(tracked) + "\n")
            if train:
                idxs = np.array([(0, 0, 1, i) for i in range(n_queries)], dtype=np.int64)
                np.savez(scene / "overlaps.npz", idxs=idxs,
                         overlaps=rng.uniform(0.45, 0.75, size=n_queries))
            queries[split][scene.name] = names[1::5]
    return queries


def write_configs(root: Path, query_frames: int = 1) -> tuple:
    """The dataset config with DATA_ROOT set to ``root`` (and
    QUERY_FRAME_COUNT to ``query_frames``) and the run-length config of the
    train CLI, both YAML files in ``root``."""
    text = (REPO / "configs/mapfree.yaml").read_text()
    for line in ("DATA_ROOT: 'data/mapfree/'", "QUERY_FRAME_COUNT: 1"):
        if line not in text:
            raise AssertionError(f"configs/mapfree.yaml has no line {line!r} to set")
    dataset = root / "mapfree.yaml"
    dataset.write_text(text.replace("DATA_ROOT: 'data/mapfree/'", f"DATA_ROOT: '{root}'")
                       .replace("QUERY_FRAME_COUNT: 1", f"QUERY_FRAME_COUNT: {query_frames}"))
    # one epoch of 2 scenes x 40 samples = 8 steps at batch 10, one validation
    # of 2 batches at its end; the model and optimizer are 3d3d.yaml's
    run = root / "run.yaml"
    run.write_text("TRAINING:\n  EPOCHS: 1\n  N_SAMPLES_SCENE: 40\n  VAL_INTERVAL: 1.0\n"
                   "  VAL_BATCHES: 2\n  LOG_INTERVAL: 1\n")
    return dataset, run


def read_submission(path: Path) -> dict:
    """{scene: {frame: (q, t)}} from a submission zip; every line must hold
    9 fields, finite numbers and a unit quaternion."""
    out = {}
    with ZipFile(path) as z:
        for name in z.namelist():
            scene = name[len("pose_"):-len(".txt")]
            out[scene] = {}
            for line in z.read(name).decode().splitlines():
                fields = line.split(" ")
                if len(fields) != 9:
                    raise AssertionError(f"{name}: line of {len(fields)} fields: {line}")
                q, t = np.array(fields[1:5], float), np.array(fields[5:8], float)
                if not (np.all(np.isfinite(q)) and np.all(np.isfinite(t))):
                    raise AssertionError(f"{name}: non-finite pose: {line}")
                if abs(np.linalg.norm(q) - 1.0) > 1e-5:
                    raise AssertionError(f"{name}: quaternion of norm {np.linalg.norm(q)}")
                out[scene][fields[0]] = (q, t)
    return out


def run_submission_cli(argv: list, expected: dict, what: str, tag: str = "cli") -> dict:
    """``mapfree_tpu_torch.submission.main(argv)`` with the counts reset
    before it: one line per query frame, K1's tensor-core design once per
    batch. Returns the poses, the launches and the stage times."""
    from mapfree_tpu_torch import submission
    from mapfree_tpu_torch.data import jpeg
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.utils.timing import StageTimes

    times = StageTimes()
    reset_launches()
    jpeg.reset_stats()
    with designs_served() as seen:
        t0 = time.perf_counter()
        path = submission.main(argv, times=times)
        elapsed = time.perf_counter() - t0
    launches = launch_counts()
    _expect_designs(seen, {"forward": [corr.DESIGN_MMA]}, what, [corr.KERNEL_FWD_WGMMA])
    poses = read_submission(path)
    n_pairs = sum(len(v) for v in expected.values())
    if {s: sorted(p) for s, p in poses.items()} != {s: sorted(q) for s, q in expected.items()}:
        raise AssertionError(f"{what}: submission.zip does not hold one line per query frame")
    n_batches = -(-n_pairs // 64)
    if dict(corr.launches) != {corr.KERNEL: n_batches, corr.KERNEL_BWD_ROWS: 0,
                               corr.KERNEL_BWD_COLS: 0}:
        raise AssertionError(f"{what}: launches {launches} for {n_batches} batches")
    sweep = times.seconds["sweep"]
    log(f"[{tag}] {what}: {n_pairs} pairs from JPEG files in {n_batches} batches: CLI "
        f"{elapsed:.3f} s, sweep {sweep:.3f} s, {n_pairs / sweep:.1f} pairs/s end to end "
        f"from files; {jpeg.stats['images']} frames decoded on the card, "
        f"{jpeg.stats['failures']} failed; K1 launches {launches[corr.KERNEL]}, "
        f"{corr.DESIGN_MMA} design; stages {times.summary()}")
    return {"poses": poses, "launches": launches, "pairs_per_s": n_pairs / sweep,
            "stages": times.summary()}


def phase_clis() -> dict:
    """The sweep through the submission CLI from JPEG files, the train CLI
    for one short epoch, and the submission CLI on that run's checkpoint.
    Returns each kernel's launches per CLI run."""
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train.__main__ import main as train_main

    model_cfg = str(REPO / "configs/regression/mapfree/3d3d.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        queries = write_mapfree_tree(root, seed=SEED + 20)
        dataset_cfg, run_cfg = write_configs(root)
        log(f"[cli] MapFree tree of fixture copies in {time.perf_counter() - t0:.2f} s: "
            + ", ".join(f"{split} {len(q)} scenes, {sum(len(v) for v in q.values())} pairs"
                        for split, q in queries.items()))

        # (b) the sweep, random weights from the config's seed
        common = ["--dataset_config", str(dataset_cfg), "--device", "cuda"]
        random_run = run_submission_cli(
            [model_cfg, *common, "-o", str(root / "random")], queries["test"],
            "submission CLI, random weights")

        # (c) the train CLI: one epoch of 8 steps, one validation, checkpoints
        reset_launches()
        captured = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.chdir(root), contextlib.redirect_stdout(captured), \
                designs_served() as seen:
            state = train_main([model_cfg, str(dataset_cfg), "--config", str(run_cfg),
                                "--experiment", "smoke", "--device", "cuda"])
        elapsed = time.perf_counter() - t0
        train_launches = launch_counts()
        for line in captured.getvalue().splitlines():
            log(f"[cli]   {line}")
        _expect_designs(seen, {"forward": [corr.DESIGN_MMA], "backward": [corr.DESIGN_MMA]},
                        "the train CLI", [corr.KERNEL_FWD_WGMMA], BWD_MMA_SYNC)
        _expect_launches(corr, {corr.KERNEL: 8 + 2, corr.KERNEL_BWD_ROWS: 8,
                                corr.KERNEL_BWD_COLS: 8}, "the train CLI")
        run_dir = root / "weights" / "smoke"
        records = [json.loads(ln) for ln in (run_dir / "scalars.jsonl").read_text().splitlines()]
        losses = [r["train/loss"] for r in records if "train/loss" in r]
        val = [r["val_loss/loss"] for r in records if "val_loss/loss" in r]
        files = sorted(p.name for p in run_dir.glob("*.pt"))
        log(f"[cli] train CLI: {state.step} steps, {len(val)} validation in {elapsed:.2f} s "
            f"(decode, steps, validation, checkpoints); launches {train_launches}; "
            f"losses {' '.join(f'{x:.4f}' for x in losses)}; validation {val}; "
            f"checkpoints {files}")
        if state.step != 8 or len(losses) != 8 or len(val) != 1 \
                or not np.all(np.isfinite(losses + val)):
            raise AssertionError("the train CLI did not take 8 finite steps and one validation")
        if files != ["last.pt", "step_8.pt"]:
            raise AssertionError(f"the train CLI wrote the checkpoints {files}")

        # the submission CLI on that run's last.pt: the trained weights move
        # the poses away from those of the random initialisation
        trained = run_submission_cli(
            [model_cfg, *common, "--checkpoint", str(run_dir / "last.pt"),
             "-o", str(root / "trained")], queries["test"], "submission CLI, last.pt")
    moved = [max(np.abs(trained["poses"][s][f][0] - q).max(),
                 np.abs(trained["poses"][s][f][1] - t).max())
             for s, frames in random_run["poses"].items() for f, (q, t) in frames.items()]
    log(f"[cli] the checkpoint moved the poses: median max |diff| {np.median(moved):.4f}, "
        f"{np.mean(np.array(moved) > 1e-4):.1%} of {len(moved)} frames by more than 1e-4")
    if np.mean(np.array(moved) > 1e-4) < 0.9:
        raise AssertionError("the submission CLI's poses do not depend on the checkpoint")
    return {"submission_cli": random_run["launches"], "train_cli": train_launches,
            "submission_cli_checkpoint": trained["launches"],
            "pairs_per_s": random_run["pairs_per_s"], "stages": random_run["stages"]}


# -- phase 9: the QKV path ------------------------------------------------------

# the card the phases below drive
DEVICE = "cuda"
QKV_YAML = "configs/regression/mapfree/rotbin_transdirectionbin_scale_qkv.yaml"
FUSION_YAML = "configs/regression/mapfree/multiframe/3d3d_multi_fusion.yaml"


def _check_poses(R, t, what: str) -> float:
    """Finite R and t with det(R) = 1; returns max |det(R) - 1|."""
    det = np.linalg.det(np.asarray(R, np.float64))
    if not (np.all(np.isfinite(R)) and np.all(np.isfinite(t))
            and np.abs(det - 1.0).max() < 1e-3):
        raise AssertionError(f"{what}: bad poses, det(R) in [{det.min()}, {det.max()}]")
    return float(np.abs(det - 1.0).max())


def drive_sweep(cfg, batches: list, warm: list, what: str, design: str = "mma",
                kernels=None) -> dict:
    """``predict`` over ``batches`` after a warm-up over ``warm``, with the
    counts reset just before: K1 (in ``design``) once per batch, no backward
    kernel, one finite pose per pair. Then the forward alone on a batch
    already on the device. Returns the numbers, the launches and the model."""
    import torch

    from mapfree_tpu_torch.models.builder import build_model
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.utils.submission import predict
    from mapfree_tpu_torch.utils.timing import StageTimes

    model = build_model(cfg, device=DEVICE)
    predict(warm, model)
    torch.cuda.synchronize()
    n_pairs = sum(len(b["pair_names"]) for b in batches)
    times = StageTimes()
    reset_launches()
    with designs_served() as seen:
        t0 = time.perf_counter()
        results = predict(batches, model, times)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = launch_counts()
    _expect_designs(seen, {"forward": [design]}, what, kernels)
    _expect_launches(corr, {corr.KERNEL: len(batches), corr.KERNEL_BWD_ROWS: 0,
                            corr.KERNEL_BWD_COLS: 0}, f"{what}: {len(batches)} batches")
    poses = [p for ps in results.values() for p in ps]
    if len(poses) != n_pairs or not all(np.all(np.isfinite(p.q)) and np.all(np.isfinite(p.t))
                                        for p in poses):
        raise AssertionError(f"{what}: {len(poses)} finite poses for {n_pairs} pairs")
    R, t, _ = model.predict_batch(batches[-1])
    det_err = _check_poses(R, t, what)
    transferred = model.transfer_batch(batches[0])
    model_ms = cuda_time_ms(lambda: model.dispatch_device(transferred)(), iters=5)
    bs = int(cfg.TPU.INFER_BATCH)
    log(f"[{what}] {n_pairs} pairs in {len(batches)} batches (the last of "
        f"{len(batches[-1]['pair_names'])}): {elapsed:.3f} s, {n_pairs / elapsed:.1f} pairs/s "
        f"from memory; forward {model_ms:.2f} ms per batch of {bs} "
        f"({1e3 * bs / model_ms:.1f} pairs/s model-only); K1 launches {launches[corr.KERNEL]}, "
        f"{design} design; max |det(R) - 1| = {det_err:.2e}; stages "
        f"{times.summary()}")
    return {"launches": launches[corr.KERNEL], "pairs_per_s": n_pairs / elapsed,
            "forward_ms": model_ms, "model": model, "transferred": transferred}


def drive_train_steps(cfg, batches: list, n_warm: int, what: str,
                      designs: tuple = ("mma", "mma"), kernels=None, bwd_kernels=None) -> dict:
    """Train steps through init_state -> make_train_step on batches already
    on the device: ``n_warm`` warm-up steps, then the rest timed with the
    counts reset just before. K1, K2, K3 once per step in the designs
    ``designs`` (K1's, then K2 and K3's; the tensor cores by default), finite
    losses, moved weights. Returns the numbers, K1's, K2's and K3's ms in a
    profiler window and the K1-K3 launches."""
    import torch

    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train import init_state, make_train_step
    from mapfree_tpu_torch.train.fit import _device_batch, _train_keys

    dev = torch.device(DEVICE)
    bs = int(cfg.TRAINING.BATCH_SIZE)
    net = build_regression_net(cfg)
    state = init_state(net, cfg, torch.Generator().manual_seed(SEED), device=dev)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    train_step = make_train_step(net, cfg)
    dbatches = [_device_batch(b, dev, bs, _train_keys(net)) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in dbatches[:n_warm]:
        state, _ = train_step(state, b)
    torch.cuda.synchronize()
    n_steps = len(dbatches) - n_warm
    reset_launches()
    logs = []
    with designs_served() as seen:
        t0 = time.perf_counter()
        for b in dbatches[n_warm:]:
            state, step_logs = train_step(state, b)
            logs.append(step_logs)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    launches = launch_counts()
    _expect_launches(corr, {corr.KERNEL: n_steps, corr.KERNEL_BWD_ROWS: n_steps,
                            corr.KERNEL_BWD_COLS: n_steps}, f"{what}: {n_steps} train steps")
    _expect_designs(seen, {"forward": [designs[0]], "backward": [designs[1]]},
                    f"{what}: the train steps", kernels, bwd_kernels)
    losses = [float(lg["train/loss"]) for lg in logs]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{what}] {n_steps} steps at batch {bs} after {n_warm} warm-up: {step_ms:.2f} ms/step, "
        f"{1e3 * bs / step_ms:.1f} samples/s; peak memory {peak_gb:.2f} GB; K1, K2, K3 each "
        f"launched {n_steps} times, K1 in the {designs[0]} design, K2 and K3 in the "
        f"{designs[1]} design; {cfg.TRAINING.ROT_LOSS} "
        f"+ {cfg.TRAINING.LAMBDA} * {cfg.TRAINING.TRANS_LOSS}: loss per step "
        + " ".join(f"{x:.4f}" for x in losses))
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{what}: non-finite training loss: {losses}")
    after = net.state_dict()
    # the encoder's first weight and first BatchNorm statistics
    first = [next(k for k in after if k.startswith("encoder.") and k.endswith(end))
             for end in ("weight", "running_var")]
    unchanged = [k for k in first if torch.equal(after[k], before[k])]
    if unchanged:
        raise AssertionError(f"{what}: {unchanged} did not change in the train steps")
    batch = dbatches[-1]

    def one_step():
        train_step(state, batch)

    prof = profile_window(one_step, "train step")
    # K2's C function launches the prologue kernel where its operands
    # stream: its time is K2's
    kernel_ms = {name: sum(ms for key, ms in prof["ms_by_kernel"].items() if f"{name}_" in key
                           or (name == corr.KERNEL_BWD_ROWS and "correlation_bwd_prologue" in key))
                 for name in (corr.KERNEL, corr.KERNEL_BWD_ROWS, corr.KERNEL_BWD_COLS)}
    return {"launches": launches, "step_ms": step_ms, "peak_gb": peak_gb,
            "busy_share": prof["busy_share"], "kernel_ms": kernel_ms}


def f32_step_kernels_vs_plain(cfg, batch: dict, what: str, full_width: bool = False) -> dict:
    """One float32 train step of ``cfg``'s model on the card with K1-K3,
    against the same step with the plain versions on the card (same
    weights and batch): the loss, and every gradient per tensor, as phase 6
    holds the 3d3d step. Returns the K1-K3 launches of the kernels' step.

    With ``full_width`` (phase 18: the 3d3d model at 360x270, batch 10) the
    step is held so against the plain backward after the same K1 forward.
    Against the plain versions forward too it is held in the loss and, in
    the whole gradient's L2 norm and the median tensor, within
    STEP_ORDER_FACTOR times what the plain versions move by when they sum
    over the keys in reverse order (``plain_versions_on_the_card`` with
    ``reverse_keys``): two correct forwards differ by float32 round-off,
    and at 10 x 6,256 positions that turns some BatchNorm outputs after the
    correlation (the ReLU inputs of the pre-activation blocks) to the other
    sign, which moves a head weight's gradient by per cent of its largest
    entry. The step counts those sign changes for both pairs of steps. K1
    itself is held on the step's own inputs (:func:`kernels_on_step_inputs`)."""
    import torch

    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train import init_state, make_train_step
    from mapfree_tpu_torch.train.fit import _device_batch, _train_keys

    loss, grads, launches, signs = {}, {}, {}, {}
    bs = int(cfg.TRAINING.BATCH_SIZE)

    def one_step(name):
        net = build_regression_net(cfg)
        hooks = []
        if full_width and name != "plain":  # the sign of every BatchNorm output
            signs[name] = {}
            for mod_name, mod in net.named_modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    hooks.append(mod.register_forward_hook(
                        lambda m, i, o, n=mod_name: signs[name].__setitem__(n, o.detach() > 0)))
        state = init_state(net, cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
        dbatch = _device_batch(batch, torch.device(DEVICE), bs, _train_keys(net))
        reset_launches()
        _, logs = make_train_step(net, cfg)(state, dbatch)
        loss[name] = float(logs["train/loss"])
        launches[name] = launch_counts()
        grads[name] = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
        for hook in hooks:
            hook.remove()

    one_step("kernels")
    with plain_versions_on_the_card(forward=not full_width):
        one_step("plain")
    if full_width:
        with plain_versions_on_the_card():
            one_step("plain_forward_too")
        with plain_versions_on_the_card(reverse_keys=True):
            one_step("plain_reversed")
    expected = {"kernels": (1, 1, 1), "plain": (int(full_width), 0, 0),
                "plain_forward_too": (0, 0, 0), "plain_reversed": (0, 0, 0)}
    for name, got in launches.items():
        want = dict(zip((corr.KERNEL, corr.KERNEL_BWD_ROWS, corr.KERNEL_BWD_COLS),
                        expected[name]))
        if {kernel: got[kernel] for kernel in want} != want:
            raise AssertionError(f"{what}: the float32 step '{name}' launched {got}, not {want}")
    per, l2 = _grad_errors(grads["kernels"], grads["plain"])
    rel = abs(loss["kernels"] - loss["plain"]) / abs(loss["plain"])
    versus = "the plain backward after the same K1 forward" if full_width else \
        "plain versions on the card"
    log(f"[{what}] float32 train step, kernels vs {versus}: loss "
        f"{loss['kernels']:.6f} vs {loss['plain']:.6f} (rel {rel:.2e}, tol {STEP_LOSS_RTOL:g}); "
        f"worst gradient {per[0][0]:.2e} of its tensor's largest entry at {per[0][1]} "
        f"(tol {STEP_GRAD_TOL:g}); whole gradient {l2:.2e} in L2; {len(per)} tensors")
    if not np.isfinite(loss["kernels"]) or rel > STEP_LOSS_RTOL or per[0][0] > STEP_GRAD_TOL:
        raise AssertionError(f"{what}: the train step with the kernels disagrees with the "
                             "plain versions")
    if full_width:
        ref = grads["plain_forward_too"]
        per, l2 = _grad_errors(grads["kernels"], ref)
        per_c, l2_c = _grad_errors(grads["plain_reversed"], ref)
        rel = abs(loss["kernels"] - loss["plain_forward_too"]) / abs(loss["plain_forward_too"])
        median, median_c = per[len(per) // 2][0], per_c[len(per_c) // 2][0]

        def flips(name):
            got = {n: int((m != signs["plain_forward_too"][n]).sum())
                   for n, m in signs[name].items()}
            return sum(got.values()), [n for n, c in got.items() if c]

        n_flip, where = flips("kernels")
        n_flip_c, where_c = flips("plain_reversed")
        total = sum(m.numel() for m in signs["kernels"].values())
        log(f"[{what}] the same, the plain forward too: loss rel {rel:.2e} (tol "
            f"{STEP_LOSS_RTOL:g}); whole gradient {l2:.2e} in L2, median tensor {median:.2e} of "
            f"its largest entry (tol {STEP_ORDER_FACTOR:g} times the control's), worst tensor "
            f"{per[0][0]:.2e} at {per[0][1]}; BatchNorm outputs of the other sign {n_flip} of "
            f"{total}, in {where}. Control, the plain versions over the keys in reverse order: "
            f"whole gradient {l2_c:.2e}, median tensor {median_c:.2e}, worst tensor "
            f"{per_c[0][0]:.2e} at {per_c[0][1]}; BatchNorm outputs of the other sign "
            f"{n_flip_c}, in {where_c}")
        if (rel > STEP_LOSS_RTOL or l2 > STEP_ORDER_FACTOR * l2_c
                or median > STEP_ORDER_FACTOR * median_c):
            raise AssertionError(f"{what}: the train step with the kernels disagrees with the "
                                 "plain versions, forward too, beyond what summation order moves")
    return launches["kernels"]


# batches of the float32 sweeps (phase 17) after the warm-up
F32_SWEEP_BATCHES = 3


def f32_sweep(name: str, extra: dict, seed: int) -> dict:
    """3d3d.yaml with ``extra`` in float32 (TPU.COMPUTE_DTYPE: float32, TF32
    off around the forward) at full width, 360x270, batch 64: the sweep
    through predict after the usual warm-up, K1 once per batch in its FMA
    design (:func:`drive_sweep`); the forward by CUDA events and K1's ms
    within it (a profiler window); R and t of one batch against the same
    batch through the plain forward on the card, within PARITY_ATOL."""
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.utils import submission

    cfg = load_cfg({**extra, "TPU.COMPUTE_DTYPE": "float32", "TPU.SEED": SEED})
    H, W, bs = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, int(cfg.TPU.INFER_BATCH)
    n_warm = submission.MAX_TRANSFERS + submission.DEPTH
    batches = synthetic_batches(F32_SWEEP_BATCHES * bs, bs, H, W, seed=seed)
    what = f"float32 {name}"
    sweep = drive_sweep(cfg, batches, synthetic_batches(n_warm * bs, bs, H, W, seed=seed + 1),
                        what, design=corr.DESIGN_FMA)
    model, transferred = sweep.pop("model"), sweep.pop("transferred")
    prof = profile_window(lambda: model.dispatch_device(transferred)(), f"{name} forward")
    k1_ms = sum(ms for key, ms in prof["ms_by_kernel"].items() if "correlation_fwd" in key)
    R, t, _ = model.predict_batch(batches[0])
    with plain_versions_on_the_card():
        R_p, t_p, _ = model.predict_batch(batches[0])
    err = max(float(np.abs(R - R_p).max()), float(np.abs(t - t_p).max()))
    log(f"[{what}] forward {sweep['forward_ms']:.2f} ms per batch of {bs} (CUDA events), K1 "
        f"{k1_ms:.3f} ms of it (profiler), {sweep['pairs_per_s']:.1f} pairs/s from memory, "
        f"device busy {100 * prof['busy_share']:.1f}%; R, t against the plain forward on the "
        f"card: max |diff| {err:.3g} (atol {PARITY_ATOL:g})")
    if err > PARITY_ATOL:
        raise AssertionError(f"{what}: K1 and the plain forward give other poses")
    del model, transferred
    return {**sweep, "k1_ms": k1_ms, "busy_share": prof["busy_share"], "plain_pose_err": err}


def phase_f32_sweeps() -> dict:
    """Phase 17: the float32 3d3d sweep and the float32 ResNet-bottleneck
    sweep (1,024 channels on the 5x4 grid), K1 in its FMA design."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    launches, numbers = {}, {}
    for i, (name, extra) in enumerate((("3d3d", {}), ("resnet", WIDE_MODELS["resnet"]))):
        numbers[name] = f32_sweep(name, extra, seed=SEED + 170 + 2 * i)
        launches[f"f32_{name}_sweep"] = {corr.KERNEL: numbers[name].pop("launches")}
        torch.cuda.empty_cache()
    return {"launches": launches, "numbers": numbers}


# the train steps of phase 18: warm-up, then timed
FMA_STEPS_WARM, FMA_STEPS_TIMED = 2, 5


def phase_fma_steps() -> dict:
    """Phase 18: the float32 3d3d and the bf16 ResNet train steps at full
    width (360x270, batch 10, random weights from the seed): (a) 3d3d.yaml
    in float32 (TPU.COMPUTE_DTYPE: float32), K1-K3 all in their FMA design;
    (b) the ResNet-bottleneck model of phase 11 in bf16, the default (1,024
    channels on the 5x4 grid), K1-K3 on the tensor cores. Each through init_state -> make_train_step (:func:`drive_train_steps`:
    ms per step, samples/s, peak memory, K1-K3's ms in a profiler window,
    each launched once a step in those designs, finite losses), then one
    step held to the same step with the plain versions on the card: (a) as
    :func:`f32_step_kernels_vs_plain` with ``full_width`` holds it (the plain
    backward's [10, 6,256, 6,256] matrices fit the card), (b) at phase 6's
    bf16 limits with the one-ulp control printed
    (:func:`bf16_step_kernels_vs_plain`); and in each, the kernels on the
    correlation's own inputs in that step at phase 3's limits
    (:func:`kernels_on_step_inputs`)."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    launches, numbers = {}, {}
    # (name, overrides, K1's and K2, K3's designs, K2's and K3's tensor-core
    # kernels: mma.sync on the ResNet encoder's 5x4 grid, none in float32)
    for i, (name, extra, designs, bwd) in enumerate((
            ("f32_3d3d", {"TPU.COMPUTE_DTYPE": "float32"}, (corr.DESIGN_FMA, corr.DESIGN_FMA),
             []),
            ("resnet_bf16", WIDE_MODELS["resnet"], (corr.DESIGN_MMA, corr.DESIGN_MMA),
             BWD_MMA_SYNC))):
        cfg = load_cfg({**extra, "TPU.SEED": SEED})
        H, W, bs = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, int(cfg.TRAINING.BATCH_SIZE)
        batches = train_batches(FMA_STEPS_WARM + FMA_STEPS_TIMED, bs, H, W, seed=SEED + 180 + i)
        what = f"FMA steps, {name}"
        got = drive_train_steps(cfg, batches, FMA_STEPS_WARM, what, designs=designs,
                                bwd_kernels=bwd)
        launches[f"{name}_train"] = got.pop("launches")
        numbers[name] = got
        log(f"[{what}] in a profiler window of three steps: K1 "
            f"{got['kernel_ms'][corr.KERNEL]:.3f} ms, K2 {got['kernel_ms'][corr.KERNEL_BWD_ROWS]:.3f}"
            f" ms, K3 {got['kernel_ms'][corr.KERNEL_BWD_COLS]:.3f} ms a step of "
            f"{got['step_ms']:.2f} ms; device busy {100 * got['busy_share']:.1f}%")
        torch.cuda.empty_cache()
        with designs_served() as seen, correlation_inputs() as inputs:
            if designs[0] == corr.DESIGN_FMA:
                launches[f"{name}_vs_plain"] = f32_step_kernels_vs_plain(
                    cfg, batches[0], what, full_width=True)
            else:
                launches[f"{name}_vs_plain"] = bf16_step_kernels_vs_plain(
                    cfg, batches[0], what, designs=designs, control=True, bwd_kernels=bwd)
        _expect_designs(seen, {"forward": [designs[0]], "backward": [designs[1]]},
                        f"{what}: the step held to the plain versions")
        numbers[name]["on_step_inputs"] = kernels_on_step_inputs(inputs[0], what)
        del inputs
        torch.cuda.empty_cache()
    return {"launches": launches, "numbers": numbers}


def phase_qkv_path() -> dict:
    """The QKV model (rotbin_transdirectionbin_scale_qkv.yaml over
    mapfree.yaml: ResUNet 3-3-3, 32 channels, 360x270, bf16, angular-bin
    head): the sweep from memory through predict (64-pair YUV420 batches
    with unique refs), 10 timed train steps at batch 10 with its bin losses,
    and a float32 step of the small model with the kernels against the plain
    versions. Returns the launches per path."""
    cfg = load_cfg({"TPU.SEED": SEED}, QKV_YAML)
    H, W, bs = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, int(cfg.TPU.INFER_BATCH)
    log(f"[qkv] {QKV_YAML}: {cfg.ENCODER.TYPE} {cfg.ENCODER.NUM_BLOCKS}, "
        f"{cfg.AGGREGATOR.TYPE} (residual {cfg.AGGREGATOR.RESIDUAL_ATT}), {cfg.HEAD.TYPE}, "
        f"{H}x{W}, {cfg.TPU.COMPUTE_DTYPE}")
    sweep = drive_sweep(cfg, synthetic_batches(5 * bs + 23, bs, H, W, seed=SEED + 30),
                        synthetic_batches(2 * bs, bs, H, W, seed=SEED + 31), "qkv")
    del sweep["model"], sweep["transferred"]
    tcfg = load_cfg({"TPU.SEED": SEED}, QKV_YAML)
    train = drive_train_steps(tcfg, train_batches(13, int(tcfg.TRAINING.BATCH_SIZE), H, W,
                                                  seed=SEED + 32), 3, "qkv",
                              bwd_kernels=BWD_MMA_SYNC)
    small = load_cfg({"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96, "DATASET.WIDTH": 72,
                      "TRAINING.BATCH_SIZE": 4, "TRAINING.LR": 1e-3, "TRAINING.GRAD_CLIP": 1.0,
                      "TPU.COMPUTE_DTYPE": "float32", "TPU.SEED": SEED}, QKV_YAML)
    step = f32_step_kernels_vs_plain(small, train_batches(1, 4, 96, 72, seed=SEED + 33)[0], "qkv")
    from mapfree_tpu_torch.ops import correlation as corr

    log(f"[qkv] the float32 comparison step launched {step}")
    return {"launches": {"qkv_sweep": {corr.KERNEL: sweep["launches"]},
                         "qkv_train": train["launches"]},
            "numbers": {**sweep, "step_ms": train["step_ms"], "peak_gb": train["peak_gb"]}}


# -- phase 10: multi-frame fusion --------------------------------------------------

def window_batches(n_pairs: int, batch: int, F: int, H: int, W: int, seed: int,
                   train: bool = False) -> list:
    """Collated multi-frame batches: uint8 RGB noise ``image0`` [B, H, W, 3]
    and windows ``image1`` [B, F, H, W, 3] with random unit w2c device
    poses (``abs_q_1_w2c_device`` [B, F, 4], ``abs_c_1_c2w_device`` [B, F, 3],
    float64 as the dataset yields them); with ``train`` a random
    ``T_0to1``, else the sweep's ``scene_id`` and ``pair_names``."""
    from mapfree_tpu_torch.geom.quaternion import quat2mat

    rng = np.random.default_rng(seed)
    out = []
    for b0 in range(0, n_pairs, batch):
        B = min(batch, n_pairs - b0)
        qd = rng.normal(size=(B, F, 4))
        qd /= np.linalg.norm(qd, axis=-1, keepdims=True)
        b = {"image0": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
             "image1": rng.integers(0, 256, (B, F, H, W, 3), dtype=np.uint8),
             "abs_q_1_w2c_device": qd, "abs_c_1_c2w_device": rng.normal(size=(B, F, 3))}
        if train:
            q = rng.normal(size=(B, 4))
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            T = np.tile(np.eye(4), (B, 1, 1))
            T[:, :3, :3] = quat2mat(q)
            T[:, :3, 3] = rng.normal(size=(B, 3)) * 0.1
            b["T_0to1"] = T
        else:
            b["scene_id"] = [f"s{b0 // batch:05d}"] * B
            b["pair_names"] = [("seq0/frame_00000.jpg", tuple(
                f"seq1/frame_{10 * (b0 + i) + f:05d}.jpg" for f in range(F))) for i in range(B)]
        out.append(b)
    return out


def first_sync(fn) -> str:
    """Where one call of ``fn`` first makes the host wait for the device
    (torch.cuda's sync debug mode set to raise): the innermost line of this
    repository in the traceback, or "none"."""
    import traceback

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if str(REPO) in f.filename and "chip_smoke" not in f.filename]
        where = frames[-1] if frames else traceback.extract_tb(e.__traceback__)[-1]
        return f"{Path(where.filename).relative_to(REPO)}:{where.lineno}: {where.line}"
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return "none"


def phase_fusion_path() -> dict:
    """The fusion model (multiframe/3d3d_multi_fusion.yaml over
    mapfree_multi.yaml: F = 9, ResUNet 3-3-3, 32 channels, 360x270, bf16):
    the sweep from memory (RGB uint8 [64, 9, 360, 270, 3] with device poses,
    a final partial batch), a profile window over its forward and the
    synchronising operations it makes, 10 timed train steps at batch 10 (100
    frames through the encoder per step), and a float32 step of the small
    model with the kernels against the plain versions. Returns the launches
    per path."""
    cfg = load_cfg({"TPU.SEED": SEED}, FUSION_YAML)
    H, W, bs = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, int(cfg.TPU.INFER_BATCH)
    F = int(cfg.DATASET.QUERY_FRAME_COUNT)
    log(f"[fusion] {FUSION_YAML} over mapfree_multi.yaml: F = {F}, {cfg.ENCODER.TYPE} "
        f"{cfg.ENCODER.NUM_BLOCKS}, {H}x{W}, {cfg.TPU.COMPUTE_DTYPE}, batch {bs}: "
        f"{bs * (F + 1)} frames through the encoder and K1 over {bs * F} pairs per batch")
    batches = window_batches(2 * bs + 21, bs, F, H, W, seed=SEED + 40)
    sweep = drive_sweep(cfg, batches, batches[:1], "fusion")
    model, transferred = sweep.pop("model"), sweep.pop("transferred")
    profile_window(lambda: model.dispatch_device(transferred)(), "fusion forward")
    syncs = first_sync(lambda: model.dispatch_device(transferred))
    log(f"[fusion] the forward's dispatch first waits for the device at: {syncs}")
    del model, transferred, batches
    import torch

    torch.cuda.empty_cache()
    tbs = int(cfg.TRAINING.BATCH_SIZE)
    train = drive_train_steps(cfg, window_batches(13 * tbs, tbs, F, H, W, seed=SEED + 41,
                                                  train=True), 3, "fusion",
                              bwd_kernels=BWD_MMA_SYNC)
    torch.cuda.empty_cache()
    small = load_cfg({"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96, "DATASET.WIDTH": 72,
                      "TRAINING.BATCH_SIZE": 4, "TRAINING.LR": 1e-3, "TRAINING.GRAD_CLIP": 1.0,
                      "TPU.COMPUTE_DTYPE": "float32", "TPU.SEED": SEED}, FUSION_YAML)
    step = f32_step_kernels_vs_plain(
        small, window_batches(4, 4, F, 96, 72, seed=SEED + 42, train=True)[0], "fusion")
    from mapfree_tpu_torch.ops import correlation as corr

    log(f"[fusion] the float32 comparison step launched {step}")
    return {"launches": {"fusion_sweep": {corr.KERNEL: sweep["launches"]},
                         "fusion_train": train["launches"]},
            "numbers": {**sweep, "step_ms": train["step_ms"], "peak_gb": train["peak_gb"],
                        "first_sync": syncs}}


# -- phase 11: every regression config on the card against the CPU ------------

def config_batch(cfg, n: int, seed: int) -> dict:
    """A collated batch of ``n`` pairs for ``cfg``'s predictor: YUV420 pairs
    sharing references for the two-view model, RGB windows with device poses
    for the multi-frame ones."""
    H, W = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH
    if cfg.MODEL == "Regression":
        return synthetic_batches(n, n, H, W, seed=seed)[0]
    return window_batches(n, n, int(cfg.DATASET.QUERY_FRAME_COUNT), H, W, seed=seed)[0]


def _fuses(cfg) -> bool:
    """Whether ``cfg``'s aggregator takes the fused route (K1): every
    correlation aggregator but the dustbin and compressed-volume variants,
    which need the whole volume."""
    agg = cfg.AGGREGATOR
    if not cfg.TPU.FUSED_CORRELATION or agg.TYPE == "Concat":
        return False
    return agg.TYPE == "CorrelationVolumeWarpingQKV" or not (agg.DUSTBIN or agg.CV_OUTLAYERS)


def phase_configs() -> dict:
    """One float32 forward of every config under configs/regression/ (and
    of ENCODER.BLOCK_TYPE 2 on the 3d3d model) on the card and on the CPU,
    same weights and batch, at one block per stage and 96x72: poses within
    PARITY_ATOL. Then the models wider than every config
    (:func:`wide_models`). Returns K1's launches per path."""
    import torch

    from mapfree_tpu_torch.models.builder import build_model
    from mapfree_tpu_torch.ops import correlation as corr

    small = {"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96, "DATASET.WIDTH": 72,
             "TPU.INFER_BATCH": 4, "TPU.COMPUTE_DTYPE": "float32", "TPU.SEED": SEED}
    cases = [(str(p.relative_to(REPO)), {}) for p in
             sorted((REPO / "configs/regression").rglob("*.yaml"))]
    cases.append(("configs/regression/mapfree/3d3d.yaml", {"ENCODER.BLOCK_TYPE": 2}))
    reset_launches()
    worst = 0.0
    for i, (model_yaml, extra) in enumerate(cases):
        cfg = load_cfg({**small, **extra}, model_yaml)
        batch = config_batch(cfg, 3, seed=SEED + 50 + i)  # padded to the batch of 4
        out = {}
        for dev in (DEVICE, "cpu"):
            out[dev] = build_model(cfg, device=dev).predict_batch(batch)[:2]
        err = max(float(np.abs(out[DEVICE][j] - out["cpu"][j]).max()) for j in range(2))
        worst = max(worst, err)
        name = model_yaml.split("regression/")[1] + "".join(f" {k} {v}" for k, v in extra.items())
        log(f"[configs] {name}: {cfg.MODEL}, {cfg.ENCODER.TYPE} block {cfg.ENCODER.BLOCK_TYPE}, "
            f"{cfg.AGGREGATOR.TYPE}, {cfg.HEAD.TYPE}: max |GPU - CPU| over R and t "
            f"{err:.3g} (atol {PARITY_ATOL:g})")
        _check_poses(*out[DEVICE], name)
        if err > PARITY_ATOL:
            raise AssertionError(f"{name}: the GPU and CPU forwards disagree")
    launches = launch_counts()
    fused = sum(_fuses(load_cfg({}, model_yaml)) for model_yaml, _ in cases)
    log(f"[configs] {len(cases)} configs within {worst:.3g} of the CPU; K1 launched "
        f"{launches[corr.KERNEL]} times, once for each of the {fused} that take the fused route")
    _expect_launches(corr, {corr.KERNEL: fused, corr.KERNEL_BWD_ROWS: 0,
                            corr.KERNEL_BWD_COLS: 0}, "the configs' forwards")

    wide = wide_models(small)
    return {"launches": {"configs_on_card": launches, **wide.pop("launches")}, "numbers": wide}


# the two models whose correlation is wider than every config under
# configs/regression/: the ResNet encoder with the bottleneck block (1,024
# channels; K1 streams q and k in chunks) and a ResUNet with 128 output
# channels (Cv + 2 = 130; K1 in one column tile of 136 columns)
WIDE_MODELS = {"resnet": {"ENCODER.TYPE": "ResNet", "ENCODER.BLOCK_TYPE": 1},
               "resunet128": {"ENCODER.NUM_OUT_LAYERS": 128}}
# the kernel of K1's tensor-core design that serves each one's sweep: the
# ResNet's 1,024 channels on a 5x4 grid take the mma.sync kernel
# (correlation.FEW_ROWS_HW), the ResUNet's 128 channels the wgmma kernel
WIDE_MODEL_K1 = {"resnet": "mma_sync", "resunet128": "wgmma"}


def wide_models(small: dict) -> dict:
    """The two models of WIDE_MODELS on 3d3d.yaml at full width (360x270,
    bf16, INFER_BATCH 64): the sweep through build_model -> predict with K1
    in its tensor-core design once per batch; each at one block per stage in
    float32 on the card and on the CPU (the ResNet at 192x144, its output
    being 1/64 of the frame), poses within PARITY_ATOL; one float32 train
    step of the ResNet model at full width with the kernels against the
    plain versions on the card, per tensor at phase 6's limits; and one bf16
    train step of the 128-channel ResUNet at phase 6's size (one block per
    stage, 96x72, batch 4) with K1-K3 on the tensor cores against the plain
    backward and the plain versions (:func:`bf16_step_kernels_vs_plain`).
    Returns the launches and the sweeps' numbers."""
    import torch

    from mapfree_tpu_torch.models.builder import build_model
    from mapfree_tpu_torch.models.encoders import encoder_out_channels, encoder_out_hw
    from mapfree_tpu_torch.ops import correlation as corr

    launches, numbers = {}, {}
    for i, (name, extra) in enumerate(WIDE_MODELS.items()):
        cfg = load_cfg({**extra, "TPU.SEED": SEED})
        H, W, bs = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, int(cfg.TPU.INFER_BATCH)
        h, w = encoder_out_hw(cfg.ENCODER, H, W)
        log(f"[configs] {name}: {cfg.ENCODER.TYPE} block {cfg.ENCODER.BLOCK_TYPE} "
            f"{cfg.ENCODER.NUM_BLOCKS}, {encoder_out_channels(cfg.ENCODER)} channels on a "
            f"{h}x{w} grid, {H}x{W}, {cfg.TPU.COMPUTE_DTYPE}, batch {bs}")
        sweep = drive_sweep(cfg, synthetic_batches(2 * bs + 23, bs, H, W, seed=SEED + 91 + i),
                            synthetic_batches(bs, bs, H, W, seed=SEED + 93 + i),
                            f"configs, {name}", design=corr.DESIGN_MMA,
                            kernels=[WIDE_MODEL_K1[name]])
        del sweep["model"], sweep["transferred"]
        torch.cuda.empty_cache()
        launches[f"{name}_sweep"] = {corr.KERNEL: sweep["launches"]}
        numbers[name] = sweep
        size = {"DATASET.HEIGHT": 192, "DATASET.WIDTH": 144} if name == "resnet" else {}
        scfg = load_cfg({**small, **extra, **size})
        batch = config_batch(scfg, 3, seed=SEED + 95 + i)
        out = {dev: build_model(scfg, device=dev).predict_batch(batch)[:2]
               for dev in (DEVICE, "cpu")}
        err = max(float(np.abs(out[DEVICE][j] - out["cpu"][j]).max()) for j in range(2))
        log(f"[configs] {name}, float32 at one block per stage, "
            f"{scfg.DATASET.HEIGHT}x{scfg.DATASET.WIDTH}: max |GPU - CPU| over R and t "
            f"{err:.3g} (atol {PARITY_ATOL:g})")
        _check_poses(*out[DEVICE], name)
        if err > PARITY_ATOL:
            raise AssertionError(f"{name}: the GPU and CPU forwards disagree")
    tcfg = load_cfg({**WIDE_MODELS["resnet"], "TRAINING.BATCH_SIZE": 4, "TRAINING.LR": 1e-3,
                     "TRAINING.GRAD_CLIP": 1.0, "TPU.COMPUTE_DTYPE": "float32", "TPU.SEED": SEED})
    H, W = tcfg.DATASET.HEIGHT, tcfg.DATASET.WIDTH
    with designs_served() as seen:
        step = f32_step_kernels_vs_plain(tcfg, train_batches(1, 4, H, W, seed=SEED + 97)[0],
                                         "configs, resnet")
    _expect_designs(seen, {"forward": [corr.DESIGN_FMA], "backward": [corr.DESIGN_FMA]},
                    "the ResNet float32 train step")
    log(f"[configs] the ResNet float32 comparison step at {H}x{W} launched {step}")
    torch.cuda.empty_cache()
    # a bf16 step of the 128-channel ResUNet with K1-K3 all on the tensor
    # cores, at phase 6's size and limits
    bcfg = load_cfg({**WIDE_MODELS["resunet128"], "ENCODER.NUM_BLOCKS": "1-1-1",
                     "DATASET.HEIGHT": 96, "DATASET.WIDTH": 72, "TRAINING.BATCH_SIZE": 4,
                     "TRAINING.LR": 1e-3, "TRAINING.GRAD_CLIP": 1.0,
                     "TPU.COMPUTE_DTYPE": "bfloat16", "TPU.SEED": SEED})
    launches["resunet128_bf16_steps"] = bf16_step_kernels_vs_plain(
        bcfg, train_batches(1, 4, 96, 72, seed=SEED + 98)[0], "configs, resunet128",
        bwd_kernels=BWD_WGMMA)
    torch.cuda.empty_cache()
    got = resunet256_step()
    launches.update(got.pop("launches"))
    numbers["resunet256_train"] = got
    return {"launches": launches, **numbers}


# the first train step on the card whose K2 and K3 run on the tensor cores
# beyond 128 channels: 3d3d.yaml with a 256-channel ResUNet at full width
# (360x270, HW = 6,256, Cq = Cv = 256, bf16, batch 10)
RESUNET256 = {"ENCODER.NUM_OUT_LAYERS": 256}
RESUNET256_WARM, RESUNET256_TIMED = 2, 5


def resunet256_step() -> dict:
    """Phase 11's 256-channel ResUNet: train steps at batch 10 through
    init_state -> make_train_step (:func:`drive_train_steps`: ms per step,
    samples/s, peak memory, K1-K3's ms in a profiler window, each launched
    once a step on the tensor cores), then one step held to the same step
    with the plain backward after the same K1 forward, and with the plain
    forward too, at phase 6's bf16 limits (:func:`bf16_step_kernels_vs_plain`),
    and K2 and K3 (the streamed pair) on that step's own correlation inputs
    at phase 3's limits (:func:`kernels_on_step_inputs`). Returns the numbers
    and the launches."""
    import torch

    from mapfree_tpu_torch.models.encoders import encoder_out_channels
    from mapfree_tpu_torch.ops import correlation as corr

    cfg = load_cfg({**RESUNET256, "TPU.SEED": SEED})
    H, W, bs = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, int(cfg.TRAINING.BATCH_SIZE)
    what = "configs, resunet256"
    log(f"[{what}] {cfg.ENCODER.TYPE} {cfg.ENCODER.NUM_BLOCKS}, "
        f"{encoder_out_channels(cfg.ENCODER)} channels, {H}x{W}, {cfg.TPU.COMPUTE_DTYPE}, "
        f"batch {bs}")
    batches = train_batches(RESUNET256_WARM + RESUNET256_TIMED, bs, H, W, seed=SEED + 99)
    got = drive_train_steps(cfg, batches, RESUNET256_WARM, what,
                            kernels=[corr.KERNEL_FWD_WGMMA], bwd_kernels=BWD_WGMMA)
    launches = {"resunet256_train": got.pop("launches")}
    log(f"[{what}] in a profiler window of three steps: K1 "
        f"{got['kernel_ms'][corr.KERNEL]:.3f} ms, K2 {got['kernel_ms'][corr.KERNEL_BWD_ROWS]:.3f}"
        f" ms, K3 {got['kernel_ms'][corr.KERNEL_BWD_COLS]:.3f} ms a step of "
        f"{got['step_ms']:.2f} ms; device busy {100 * got['busy_share']:.1f}%")
    torch.cuda.empty_cache()
    with correlation_inputs() as inputs:
        launches["resunet256_vs_plain"] = bf16_step_kernels_vs_plain(cfg, batches[0], what,
                                                                     bwd_kernels=BWD_WGMMA)
    got["on_step_inputs"] = kernels_on_step_inputs(inputs[0], what)
    del inputs
    torch.cuda.empty_cache()
    return {"launches": launches, **got}


# -- phase 12: the fusion model's CLIs from JPEG files ------------------------------

def phase_fusion_clis() -> dict:
    """The fusion model's submission CLI and train CLI over a MapFree tree of
    fixture copies with device-tracking poses (poses_device.txt): the test
    split's 160 windows of 9 frames in batches of 64 (the last of 32), one
    epoch of 8 train steps at batch 10 with one validation, and the
    submission CLI on that run's last.pt. Returns the launches per CLI run."""
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train.__main__ import main as train_main

    model_cfg = str(REPO / FUSION_YAML)
    F = int(load_cfg({}, FUSION_YAML).DATASET.QUERY_FRAME_COUNT)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        queries = write_mapfree_tree(root, seed=SEED + 60, device_poses=True)
        dataset_cfg, run_cfg = write_configs(root, query_frames=F)
        # the query frame of each window: the last of F consecutive frames,
        # every (F + 1)-th frame from frame F
        windows = {s: [f"seq1/frame_{i:05d}.jpg" for i in range(F, 400, F + 1)]
                   for s in queries["test"]}
        log(f"[fusion-cli] MapFree tree of fixture copies with device poses in "
            f"{time.perf_counter() - t0:.2f} s: test {len(windows)} scenes, "
            f"{sum(len(v) for v in windows.values())} windows of {F} frames")
        common = ["--dataset_config", str(dataset_cfg), "--device", DEVICE]
        random_run = run_submission_cli(
            [model_cfg, *common, "-o", str(root / "random")], windows,
            "fusion submission CLI, random weights", tag="fusion-cli")

        reset_launches()
        captured = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.chdir(root), contextlib.redirect_stdout(captured), \
                designs_served() as seen:
            state = train_main([model_cfg, str(dataset_cfg), "--config", str(run_cfg),
                                "--experiment", "fusion", "--device", DEVICE])
        elapsed = time.perf_counter() - t0
        train_launches = launch_counts()
        for line in captured.getvalue().splitlines():
            log(f"[fusion-cli]   {line}")
        _expect_designs(seen, {"forward": [corr.DESIGN_MMA], "backward": [corr.DESIGN_MMA]},
                        "the fusion train CLI", [corr.KERNEL_FWD_WGMMA], BWD_MMA_SYNC)
        # 2 scenes x 40 samples at batch 10; one validation batch of the
        # val scene's 10 windows
        _expect_launches(corr, {corr.KERNEL: 8 + 1, corr.KERNEL_BWD_ROWS: 8,
                                corr.KERNEL_BWD_COLS: 8}, "the fusion train CLI")
        run_dir = root / "weights" / "fusion"
        records = [json.loads(ln) for ln in (run_dir / "scalars.jsonl").read_text().splitlines()]
        losses = [r["train/loss"] for r in records if "train/loss" in r]
        val = [r["val_loss/loss"] for r in records if "val_loss/loss" in r]
        log(f"[fusion-cli] train CLI: {state.step} steps, {len(val)} validation in "
            f"{elapsed:.2f} s (decode of 100 frames a step, steps, validation, checkpoints); "
            f"launches {train_launches}; losses {' '.join(f'{x:.4f}' for x in losses)}; "
            f"validation {val}")
        if state.step != 8 or len(losses) != 8 or len(val) != 1 \
                or not np.all(np.isfinite(losses + val)):
            raise AssertionError("the fusion train CLI did not take 8 finite steps and one "
                                 "validation")
        trained = run_submission_cli(
            [model_cfg, *common, "--checkpoint", str(run_dir / "last.pt"),
             "-o", str(root / "trained")], windows, "fusion submission CLI, last.pt",
            tag="fusion-cli")
    moved = [max(np.abs(trained["poses"][s][f][0] - q).max(),
                 np.abs(trained["poses"][s][f][1] - t).max())
             for s, frames in random_run["poses"].items() for f, (q, t) in frames.items()]
    log(f"[fusion-cli] the checkpoint moved the poses: median max |diff| "
        f"{np.median(moved):.4f}, {np.mean(np.array(moved) > 1e-4):.1%} of {len(moved)} "
        f"windows by more than 1e-4")
    if np.mean(np.array(moved) > 1e-4) < 0.9:
        raise AssertionError("the fusion submission CLI's poses do not depend on the checkpoint")
    return {"launches": {"fusion_submission_cli": random_run["launches"],
                         "fusion_train_cli": train_launches,
                         "fusion_submission_cli_checkpoint": trained["launches"]},
            "numbers": {"pairs_per_s": random_run["pairs_per_s"],
                        "stages": random_run["stages"], "train_cli_s": elapsed}}


# -- phase 13: the feature-matching track ----------------------------------------

MATCH_ROT_TOL_DEG = 1.5  # tests/test_integration.py::TestMatchingSubmission's limits
MATCH_T_TOL_M = 0.08
# the port on the card against the port on the CPU, both handed the same
# minimal samples (and the same for TF32 on and off): float32 solvers whose
# arithmetic differs only in summation order and fused multiply-adds, on
# noise-free pairs (with noise the Gauss-Newton polishes amplify round-off
# differences, ROADMAP.md section 3)
CARD_CPU_R_TOL = 1e-3     # radians
CARD_CPU_T_TOL = 1e-3     # relative to |t|
CARD_CPU_INLIER_TOL = 0   # equal inlier counts
MATCH_K = np.array([[590.0, 0.0, 270.0], [0.0, 590.0, 360.0], [0.0, 0.0, 1.0]], np.float32)
MATCH_H, MATCH_W = 720, 540  # configs/mapfree.yaml


def encode_png16(depth_mm: np.ndarray) -> bytes:
    """A 16-bit gray PNG of ``depth_mm`` (filter type 0), with the stdlib:
    the card's machine has no image library to write one."""
    import struct
    import zlib

    H, W = depth_mm.shape
    raw = np.zeros((H, 1 + 2 * W), np.uint8)
    raw[:, 1:] = depth_mm.astype(">u2").view(np.uint8).reshape(H, 2 * W)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 16, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def matching_png() -> dict:
    """(a) The PNG reader on the fixtures: equal to their stored arrays, bit
    for bit, with the C unfilter and with its numpy version; ms per
    540x720 depth map."""
    from mapfree_tpu_torch.data import png

    stored = np.load(FIXTURES / "png_decoded.npz")
    files = [(FIXTURES / f"depth_{i}.png", stored["depth"][i]) for i in range(4)]
    files.append((FIXTURES / "color_0.png", stored["color"]))
    for path, ref in files:
        for native in (True, False):
            got = png.read_png(path, native=native)
            if got.dtype != ref.dtype or got.shape != ref.shape or not np.array_equal(got, ref):
                raise AssertionError(f"read_png({path.name}, native={native}) differs from "
                                     "its stored array")
    datas = [p.read_bytes() for p, _ in files[:4]]
    t0 = time.perf_counter()
    for _ in range(5):
        for data in datas:
            png.decode_png(data, native=True)
    ms = 1e3 * (time.perf_counter() - t0) / (5 * len(datas))
    t0 = time.perf_counter()
    for data in datas:
        png.decode_png(data, native=False)
    ms_numpy = 1e3 * (time.perf_counter() - t0) / len(datas)
    log(f"[match] PNG reader: 4 depth maps (540x720, 16-bit) and one RGB PNG equal to their "
        f"stored arrays, bit for bit, with the C unfilter and the numpy one; "
        f"{ms:.2f} ms per depth map (inflate + C unfilter), {ms_numpy:.2f} ms with numpy")
    return {"png_ms": ms, "png_numpy_ms": ms_numpy}


def _rotation(rng, max_angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(0.3 * max_angle, max_angle)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def synthetic_matching_batch(B, N, seed, outliers=0.3, noise_px=0.5, hard=0,
                             maps=True):
    """B synthetic pairs seen by MATCH_K at 540x720 with known relative pose
    (X1 = R X0 + t, up to 0.3 rad and 0.3-1 m) and metric depth: N
    correspondences of points 2-8 m away, ``noise_px`` pixel noise, a share
    ``outliers`` of query keypoints replaced by random pixels (0.75 for the
    first ``hard`` pairs). Depth maps hold each point's depth at the floor of
    its (noisy) keypoint. Returns the collated batch and the true (R, t)."""
    rng = np.random.default_rng(seed)
    Kinv = np.linalg.inv(MATCH_K)
    out = {k: [] for k in ("pts0", "pts1", "mask", "R", "t", "d0", "d1")}
    for b in range(B):
        R = _rotation(rng, 0.3)
        t = rng.normal(size=3)
        t *= rng.uniform(0.3, 1.0) / np.linalg.norm(t)
        uv = rng.uniform([0, 0], [MATCH_W, MATCH_H], size=(4 * N, 2))
        z = rng.uniform(2.0, 8.0, size=4 * N)
        X0 = (np.concatenate([uv, np.ones((4 * N, 1))], 1) @ Kinv.T) * z[:, None]
        X1 = X0 @ R.T + t
        uv1 = X1 @ MATCH_K.T
        uv1 = uv1[:, :2] / uv1[:, 2:]
        vis = ((X1[:, 2] > 0.5) & (uv1[:, 0] >= 0) & (uv1[:, 0] < MATCH_W - 1)
               & (uv1[:, 1] >= 0) & (uv1[:, 1] < MATCH_H - 1))
        sel = np.nonzero(vis)[0][:N]
        k0 = uv[sel] + rng.normal(0, noise_px, (len(sel), 2))
        k1 = uv1[sel] + rng.normal(0, noise_px, (len(sel), 2))
        z0, z1 = z[sel], X1[sel, 2]
        n_out = int(round((0.75 if b < hard else outliers) * len(sel)))
        bad = rng.choice(len(sel), n_out, replace=False)
        k1[bad] = rng.uniform([0, 0], [MATCH_W - 1, MATCH_H - 1], size=(n_out, 2))
        z1[bad] = rng.uniform(2.0, 8.0, size=n_out)
        k0 = np.clip(k0, 0, [MATCH_W - 1e-3, MATCH_H - 1e-3])
        k1 = np.clip(k1, 0, [MATCH_W - 1e-3, MATCH_H - 1e-3])
        pad = N - len(sel)
        out["pts0"].append(np.pad(k0, ((0, pad), (0, 0))).astype(np.float32))
        out["pts1"].append(np.pad(k1, ((0, pad), (0, 0))).astype(np.float32))
        out["mask"].append(np.arange(N) < len(sel))
        out["R"].append(R)
        out["t"].append(t)
        for key, k, zz in (("d0", k0, z0), ("d1", k1, z1)):
            if maps:
                d = np.zeros((MATCH_H, MATCH_W), np.float32)
                d[k[:, 1].astype(int), k[:, 0].astype(int)] = zz
                out[key].append(d)
            else:
                out[key].append(np.pad(zz, (0, pad)).astype(np.float32))
    batch = {"pts0": np.stack(out["pts0"]), "pts1": np.stack(out["pts1"]),
             "mask": np.stack(out["mask"]), "K_color0": np.tile(MATCH_K, (B, 1, 1)),
             "K_color1": np.tile(MATCH_K, (B, 1, 1)),
             "depth0": out["d0"] if maps else np.stack(out["d0"]),
             "depth1": out["d1"] if maps else np.stack(out["d1"])}
    return batch, np.stack(out["R"]), np.stack(out["t"])


class _BatchCorrespondences:
    """The correspondences a synthetic batch carries, as the matcher's."""

    @staticmethod
    def get_correspondences(batch):
        return batch["pts0"], batch["pts1"], batch["mask"]


class _FixedSampler:
    """Minimal samples drawn on the CPU from a seeded generator and moved to
    the solve's device: the card and the CPU get the same ones."""

    def __init__(self, seed):
        self.seed = seed

    def __call__(self, tag, mask, n_iters, sample_size):
        import torch

        from mapfree_tpu_torch.ops.ransac import masked_sample_indices

        g = torch.Generator().manual_seed(self.seed + sum(map(ord, tag)))
        return masked_sample_indices(g, mask.cpu(), n_iters, sample_size).to(mask.device)


def _pose_errors(R, t, R_gt, t_gt):
    """Rotation error in degrees and translation error in metres per pair."""
    c = (np.einsum("bij,bij->b", R.astype(np.float64), R_gt) - 1) / 2
    rot = np.degrees(np.arccos(np.clip(c, -1, 1)))
    return rot, np.linalg.norm(t.reshape(-1, 3) - t_gt, axis=-1)


def _solve_all(device, batch, sampler_seed, n_iters):
    """Essential metric, PnP, Procrustes + ICP on ``device`` with samples
    from _FixedSampler(sampler_seed): {solver: (R, t, inliers)} numpy."""
    import torch

    from mapfree_tpu_torch.ops.essential import essential_pose_metric
    from mapfree_tpu_torch.ops.pnp import pnp_pose
    from mapfree_tpu_torch.ops.procrustes_ransac import (dense_cloud_from_depth,
                                                         procrustes_pose)

    T = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()
         if k not in ("depth0", "depth1")}
    d0 = torch.as_tensor(np.stack(batch["depth0"])).to(device)
    d1 = torch.as_tensor(np.stack(batch["depth1"])).to(device)
    pd0 = torch.gather(d0.flatten(1), 1, (torch.floor(T["pts0"][..., 1]).long() * MATCH_W
                                          + torch.floor(T["pts0"][..., 0]).long()))
    pd1 = torch.gather(d1.flatten(1), 1, (torch.floor(T["pts1"][..., 1]).long() * MATCH_W
                                          + torch.floor(T["pts1"][..., 0]).long()))
    clouds = [dense_cloud_from_depth(np.asarray(batch[k][i]), MATCH_K, 1024, seed=i + j)
              for i in range(len(batch["depth0"])) for j, k in enumerate(("depth0", "depth1"))]
    icp = {"icp_cloud0": np.stack([c for c, _ in clouds[0::2]]),
           "icp_mask0": np.stack([m for _, m in clouds[0::2]]),
           "icp_cloud1": np.stack([c for c, _ in clouds[1::2]]),
           "icp_mask1": np.stack([m for _, m in clouds[1::2]])}
    icp = {k: torch.as_tensor(v).to(device) for k, v in icp.items()}
    args = (T["pts0"], T["pts1"], T["mask"])
    K0, K1 = T["K_color0"], T["K_color1"]
    outs = {
        "essential metric": essential_pose_metric(*args, K0, K1, 3.0, pd0, pd1, 0.1,
                                                  _FixedSampler(sampler_seed), n_iters=n_iters),
        "PnP": pnp_pose(*args, pd0, K0, K1, 3.0, _FixedSampler(sampler_seed),
                        n_iters=n_iters, point_depths=True),
        "Procrustes + ICP": procrustes_pose(*args, d0, d1, K0, K1, 0.05,
                                            _FixedSampler(sampler_seed), n_iters=n_iters,
                                            refine=True, **icp),
    }
    return {k: tuple(o[n].cpu().numpy() for n in ("R", "t", "inliers")) for k, o in outs.items()}


def matching_card_vs_cpu() -> dict:
    """(b) The solvers on the card against the same on the CPU, with the
    same injected samples, at B=4, N=512; and the essential solve with TF32
    on and off, which must agree (the solvers switch TF32 off for
    themselves and put the process's flags back)."""
    import torch

    batch, R_gt, t_gt = synthetic_matching_batch(4, 512, SEED + 60, outliers=0.2, noise_px=0.0)
    n_iters = 256
    card = _solve_all("cuda", batch, SEED + 61, n_iters)
    cpu = _solve_all("cpu", batch, SEED + 61, n_iters)
    worst = {}
    for name in card:
        Rc, tc, nc = card[name]
        Rh, th, nh = cpu[name]
        dR = np.arccos(np.clip((np.einsum("bij,bij->b", Rc.astype(np.float64), Rh) - 1) / 2,
                               -1, 1))
        dt = np.linalg.norm(tc - th, axis=-1) / np.maximum(np.linalg.norm(th, axis=-1), 1e-9)
        dn = np.abs(nc.astype(np.int64) - nh.astype(np.int64))
        rot, terr = _pose_errors(Rc, tc, R_gt, t_gt)
        worst[name] = (float(dR.max()), float(dt.max()), int(dn.max()))
        log(f"[match] card vs CPU, {name}, B=4, N=512, {n_iters} hypotheses, the same samples: "
            f"R {dR.max():.3g} rad (limit {CARD_CPU_R_TOL}), t {dt.max():.3g} relative (limit "
            f"{CARD_CPU_T_TOL}), inlier counts differ by {dn.max()} (limit "
            f"{CARD_CPU_INLIER_TOL}); against the truth: rotation {rot.max():.3g} deg, "
            f"translation {terr.max():.3g} m at most")
        if not (dR.max() <= CARD_CPU_R_TOL and dt.max() <= CARD_CPU_T_TOL
                and dn.max() <= CARD_CPU_INLIER_TOL):
            raise AssertionError(f"{name}: the card and the CPU disagree")

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        runs = []
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = flag
            runs.append(_solve_all("cuda", batch, SEED + 61, n_iters)["essential metric"])
            if torch.backends.cuda.matmul.allow_tf32 != flag:
                raise AssertionError("the solver did not put the process's TF32 flag back")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    diff = max(float(np.nanmax(np.abs(a.astype(np.float64) - b))) for a, b in zip(*runs))
    log(f"[match] the essential metric solve with TF32 on and off: largest difference {diff:.3g} "
        "(must be 0: the solver turns TF32 off for itself)")
    if diff != 0.0:
        raise AssertionError("the essential solve depends on the process's TF32 flags")
    return {"card_vs_cpu": worst, "tf32_diff": diff}


def _allowed_sync_lines():
    """(file name, first, last line) of the adaptive ladder's finish, the
    one place of the dispatch that may wait for the device."""
    import inspect

    from mapfree_tpu_torch.ops import essential

    lines, start = inspect.getsourcelines(essential.essential_pose_adaptive_async)
    first = next(i for i, ln in enumerate(lines) if "def _finish" in ln)
    return "essential.py", start + first, start + len(lines)


def dispatch_syncs(model, transferred) -> list:
    """Every place the dispatch of one batch makes the host wait for the
    device (torch's sync debug mode, warning on each), then its finalize:
    sorted "file:line" of the innermost frame of this repository (or of
    the call's own innermost frame), with the thread it ran on."""
    import threading
    import traceback
    import warnings

    import torch

    found = set()

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return  # e.g. the debug mode's own notice that it is a prototype
        stack = traceback.extract_stack()[:-1]
        mine = [f for f in stack if str(REPO) in f.filename and "chip_smoke" not in f.filename]
        where = mine[-1] if mine else stack[-1]
        found.add(f"{Path(where.filename).name}:{where.lineno} "
                  f"({threading.current_thread().name})")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            finalize = model.dispatch_device(transferred)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finalize()
    torch.cuda.synchronize()
    return sorted(found)


def matching_full_width() -> dict:
    """(c) Each solver at full width (INFER_BATCH 64, MAX_CORRESPONDENCES
    2,048, RANSAC_ITERATIONS 1,024, the adaptive ladder on for the essential
    one) on 3 batches of synthetic pairs with 30% outliers and 0.5 px noise
    (4 pairs a batch at 75% for the essential one, which escalate), through
    the predictor's transfer/dispatch split: accuracy against the truth, ms
    per batch, launches and device busy share, escalations, and every host
    sync of the dispatch."""
    import torch

    from mapfree_tpu_torch.models.builder import build_model

    allowed_file, lo, hi = _allowed_sync_lines()
    numbers = {}
    for yaml, tag in (("configs/matching/mapfree/loftr_emat_dptkitti.yaml", "essential"),
                      ("configs/matching/mapfree/sg_pnp_dptkitti.yaml", "pnp"),
                      ("configs/matching/mapfree/sg_procrustes_dptkitti.yaml", "procrustes")):
        cfg = load_cfg({"TPU.SEED": SEED}, yaml)
        B, N = int(cfg.TPU.INFER_BATCH), int(cfg.TPU.MAX_CORRESPONDENCES)
        model = build_model(cfg, device=DEVICE)
        model.model.feature_matching = _BatchCorrespondences()
        made = [synthetic_matching_batch(B, N, SEED + 70 + i, hard=4 if tag == "essential" else 0)
                for i in range(3)]
        transferred = [model.transfer_batch(b) for b, _, _ in made]
        model.dispatch_device(transferred[0])()  # first use: device constants
        torch.cuda.synchronize()
        model.model.escalated_pairs = 0
        rots, terrs = [], []
        t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        results = [model.dispatch_device(tr)() for tr in transferred]
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / len(transferred)
        ms = start.elapsed_time(end) / len(transferred)
        escalated = model.model.escalated_pairs
        for (R, t, _), (_, R_gt, t_gt) in zip(results, made):
            rot, terr = _pose_errors(R, t, R_gt, t_gt)
            rots.append(rot)
            terrs.append(terr)
        rot, terr = np.concatenate(rots), np.concatenate(terrs)
        prof = profile_window(lambda: model.dispatch_device(transferred[1])(),
                              f"{tag} batch", n=1)
        syncs = dispatch_syncs(model, transferred[2])
        bad = [s for s in syncs if not (s.startswith(allowed_file + ":")
                                        and lo <= int(s.split(":")[1].split(" ")[0]) <= hi)]
        log(f"[match] {tag} ({Path(yaml).name}) at B={B}, N={N}, {cfg.TPU.RANSAC_ITERATIONS} "
            f"hypotheses, adaptive {bool(cfg.TPU.ADAPTIVE_RANSAC)}: {ms:.1f} ms per batch by "
            f"CUDA events ({1e3 * wall:.1f} ms wall, {B / wall:.1f} pairs/s); "
            f"{prof['launches']} launches a batch, device busy {prof['busy_share']:.1%}; "
            f"{escalated} of {3 * B} pairs escalated to tier 2; rotation error median "
            f"{np.median(rot):.3f} deg (limit {MATCH_ROT_TOL_DEG}), max {rot.max():.3f}; "
            f"translation error median {np.median(terr):.4f} m (limit {MATCH_T_TOL_M}), max "
            f"{terr.max():.4f}; host syncs in the dispatch: {syncs or 'none'}")
        if not (np.median(rot) < MATCH_ROT_TOL_DEG and np.median(terr) < MATCH_T_TOL_M):
            raise AssertionError(f"{tag}: full-width accuracy out of its limits")
        if bad:
            raise AssertionError(f"{tag}: the dispatch waits for the device at {bad}")
        numbers[tag] = {"ms": ms, "wall_ms": 1e3 * wall, "launches": prof["launches"],
                        "busy": prof["busy_share"], "escalated": escalated,
                        "rot_median_deg": float(np.median(rot)),
                        "t_median_m": float(np.median(terr)), "syncs": syncs}
        del model, transferred, made
        torch.cuda.empty_cache()
    return numbers


def write_matching_tree(root: Path, n_scenes: int = 2, n_queries: int = 320,
                        n_poses: int = 8, seed: int = SEED + 80) -> dict:
    """A MapFree test split for the matching configs: per scene a reference
    frame (identity pose, a fixture JPEG, a fixture depth map as
    ``.dptkitti.png``) and ``n_queries`` query frames, of which every 5th is
    evaluated, with poses from a pool of ``n_poses``; each evaluated query
    gets the reference depth rendered into it (``.dptkitti.png``) and a
    correspondence row of up to 2,048 reference pixels projected into it
    (``correspondences_{LoFTR,SG,SIFT}.npz``). Returns {scene: {frame:
    (R, t)}} of the evaluated queries."""
    import shutil

    from mapfree_tpu_torch.geom.quaternion import mat2quat

    rng = np.random.default_rng(seed)
    stored = np.load(FIXTURES / "png_decoded.npz")["depth"]
    frames = sorted(FIXTURES.glob("frame_*.jpg"))
    Kinv = np.linalg.inv(MATCH_K)
    vv, uu = np.mgrid[0:MATCH_H, 0:MATCH_W]
    truth = {}
    for s in range(n_scenes):
        scene = root / "test" / f"s{s:05d}"
        (scene / "seq0").mkdir(parents=True)
        (scene / "seq1").mkdir(parents=True)
        shutil.copyfile(frames[s % 4], scene / "seq0/frame_00000.jpg")
        shutil.copyfile(FIXTURES / f"depth_{s % 4}.png", scene / "seq0/frame_00000.dptkitti.png")
        D0 = stored[s % 4].astype(np.float64) / 1000.0
        X0 = (np.stack([uu, vv, np.ones_like(uu)], -1).reshape(-1, 3) @ Kinv.T) * D0.reshape(-1, 1)
        grid = np.zeros((MATCH_H, MATCH_W), bool)
        grid[4::9, 4::9] = True
        grid = grid.reshape(-1)
        pool = []
        for _ in range(n_poses):
            R = _rotation(rng, 0.2)
            t = rng.normal(size=3)
            t *= rng.uniform(0.2, 0.5) / np.linalg.norm(t)
            X1 = X0 @ R.T + t
            uv1 = X1 @ MATCH_K.T
            uv1 = uv1[:, :2] / uv1[:, 2:]
            vis = ((X1[:, 2] > 0.1) & (uv1[:, 0] >= 0) & (uv1[:, 0] < MATCH_W - 1)
                   & (uv1[:, 1] >= 0) & (uv1[:, 1] < MATCH_H - 1))
            depth1 = np.zeros((MATCH_H, MATCH_W))
            order = np.argsort(-X1[vis, 2])  # nearest written last
            ui, vi = uv1[vis, 0].astype(int)[order], uv1[vis, 1].astype(int)[order]
            depth1[vi, ui] = X1[vis, 2][order]
            pick = np.nonzero(vis & grid)[0]
            pick = pick[np.linspace(0, len(pick) - 1, min(2048, len(pick))).astype(int)]
            corr = np.concatenate([np.stack([uu.reshape(-1)[pick], vv.reshape(-1)[pick]], -1),
                                   uv1[pick]], 1).astype(np.float32)
            png_bytes = encode_png16(np.round(depth1 * 1000.0).astype(np.uint16))
            pool.append((R, t, corr, png_bytes))
        names = ["seq0/frame_00000.jpg"] + [f"seq1/frame_{i:05d}.jpg" for i in range(n_queries)]
        table = np.full((n_queries, 2048, 4), np.nan, np.float32)
        intr, poses = [], []
        truth[scene.name] = {}
        for j, name in enumerate(names):
            intr.append(f"{name} 590.0 590.0 270.0 360.0 540 720")
            if j == 0:
                q, t = np.array([1.0, 0, 0, 0]), np.zeros(3)
            else:
                i = j - 1
                R, t, corr, png_bytes = pool[i % n_poses]
                q = mat2quat(R).reshape(-1)
                if i % 5 == 0:
                    shutil.copyfile(frames[(i + s) % 4], scene / name)
                    (scene / name.replace(".jpg", ".dptkitti.png")).write_bytes(png_bytes)
                    table[i, :len(corr)] = corr
                    truth[scene.name][name] = (R, t)
            poses.append(f"{name} " + " ".join(f"{v:.9f}" for v in np.concatenate([q, t])))
        (scene / "intrinsics.txt").write_text("\n".join(intr) + "\n")
        (scene / "poses.txt").write_text("\n".join(poses) + "\n")
        np.savez(scene / "correspondences_SG.npz", correspondences=table)
        for other in ("LoFTR", "SIFT"):
            shutil.copyfile(scene / "correspondences_SG.npz",
                            scene / f"correspondences_{other}.npz")
    return truth


def matching_clis(root: Path) -> dict:
    """(d) The submission CLI (its main(argv)) over a MapFree tree of the
    fixtures in ``root`` for loftr_emat_dptkitti, sg_pnp_dptkitti,
    sg_procrustes_dptkitti and sift_emat_ingraph (the depth net at random
    weights, ALLOW_RANDOM): one line per query, accuracy against the truth
    (for the in-graph config the rotation only: random depth gives no metric
    scale), pairs/s and the stage times. Each config's submission.zip stays
    in ``root/<config>/`` (phase 14 scores one)."""
    from mapfree_tpu_torch import submission
    from mapfree_tpu_torch.geom.quaternion import quat2mat
    from mapfree_tpu_torch.utils.timing import StageTimes

    numbers = {}
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    truth = write_matching_tree(root)
    dataset_cfg, _ = write_configs(root)
    n_pairs = sum(len(v) for v in truth.values())
    log(f"[match] MapFree tree for the matching configs in {time.perf_counter() - t0:.2f} s: "
        f"{len(truth)} scenes, {n_pairs} pairs, depth PNGs and correspondences")
    ingraph = root / "sift_emat_ingraph.yaml"
    ingraph.write_text((REPO / "configs/matching/mapfree/sift_emat_ingraph.yaml").read_text()
                       + "  ALLOW_RANDOM: true\n")
    for cfg_path in ("configs/matching/mapfree/loftr_emat_dptkitti.yaml",
                     "configs/matching/mapfree/sg_pnp_dptkitti.yaml",
                     "configs/matching/mapfree/sg_procrustes_dptkitti.yaml", ingraph):
        path = Path(cfg_path) if Path(cfg_path).is_absolute() else REPO / cfg_path
        times = StageTimes()
        t0 = time.perf_counter()
        out = submission.main([str(path), "--dataset_config", str(dataset_cfg),
                               "--device", DEVICE, "-o", str(root / path.stem)], times=times)
        elapsed = time.perf_counter() - t0
        poses = read_submission(out)
        if {s: sorted(p) for s, p in poses.items()} != {s: sorted(p) for s, p in truth.items()}:
            raise AssertionError(f"{path.name}: submission.zip does not hold one line per query")
        rot, terr = [], []
        for s, frames in truth.items():
            for f, (R_gt, t_gt) in frames.items():
                q, t = poses[s][f]
                r, e = _pose_errors(quat2mat(q)[None], t[None], R_gt[None], t_gt[None])
                rot.append(r[0])
                terr.append(e[0])
        sweep = times.seconds["sweep"]
        name = path.stem
        metric = "ingraph" not in name
        log(f"[match] CLI {name}: {n_pairs} pairs, CLI {elapsed:.2f} s, sweep {sweep:.3f} s, "
            f"{n_pairs / sweep:.1f} pairs/s from files; rotation error median "
            f"{np.median(rot):.4f} deg, translation error median {np.median(terr):.4f} m"
            f"{'' if metric else ' (random depth net: no metric scale)'}; stages "
            f"{times.summary()}")
        if np.median(rot) >= MATCH_ROT_TOL_DEG or (metric and np.median(terr) >= MATCH_T_TOL_M):
            raise AssertionError(f"{name}: the CLI's poses are out of the accuracy limits")
        numbers[name] = {"pairs_per_s": n_pairs / sweep, "stages": times.summary(),
                         "rot_median_deg": float(np.median(rot)),
                         "t_median_m": float(np.median(terr))}
    return numbers


def phase_matching(root: Path) -> dict:
    """Phase 13: the feature-matching track (no kernel of its own); its
    MapFree tree and submissions go to ``root``."""
    numbers = {"png": matching_png()}
    numbers["card_vs_cpu"] = matching_card_vs_cpu()
    numbers["full_width"] = matching_full_width()
    numbers["clis"] = matching_clis(root)
    return {"launches": {}, "numbers": numbers}


# -- phase 14: the evaluation path -------------------------------------------------

SCANNET_FRAMES = 80       # copies of the 4 ScanNet fixtures, each its own file
# 3 batches of INFER_BATCH 64, the last partial, and 6 7Scenes queries: cut
# from 6 batches and 12 queries to keep the script's running time as the
# phases before it grew
SCANNET_PAIRS = 2 * 64 + 4
SEVENSCENES_REFS, SEVENSCENES_QUERIES = 4, 6
# the card's SIFT against the port's CPU SIFT: tests/test_torch_sift.py's
# per-keypoint tolerance (the blurs sum in other orders: equal masks, scores
# to 1e-6, the valid keypoints as sets to 1e-3 px (scores that tie to
# round-off may swap slots), at least 95% of the descriptors to 1e-4 in
# every entry. The rest are printed with their largest L2 difference: a
# gradient sample across an orientation bin edge moves one entry, and a
# near-tie of the 36-bin orientation histogram's argmax rotates the whole
# descriptor by 10 degrees (0.61 in L2 once in 1,734 on an H100)
SIFT_SCORE_TOL = 1e-6
SIFT_KP_TOL = 1e-3
SIFT_DESC_ENTRY_TOL = 1e-4
SIFT_DESC_EXACT_SHARE = 0.95
# the decode of the 1296x968 fixtures to 320x240 against the JAX package's
# cv2 branch, mean |diff| in levels: nvJPEG read 1.07 on an H100 (its IDCT
# and chroma upsampling against libjpeg's on these fine colour textures;
# phase 7's smooth frames read 0.72), a decode whose resize sampled one
# source pixel off reads 2.21 (cv2 on the same files), and the JAX package's
# own two paths differ by 0.12 (tests/data/torch_port/scannet_decode_gap.json):
# the limit lies between the sound reading and the fault. The largest
# difference is printed only (40 on the card: single texels at colour edges)
SCANNET_DECODE_MEAN_TOL = 1.5


def room():
    """tests/data/torch_port/room.py: the textured room of the ScanNet
    fixtures, rendered at any size with its depth, and trees of it."""
    import importlib.util

    name = "torch_port_room"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, FIXTURES / "room.py")
        sys.modules[name] = module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    return sys.modules[name]


def write_scannet_tree(root: Path) -> tuple:
    """A ScanNet test split of SCANNET_FRAMES copies of the 1296x968 fixtures
    (frame k shows view k % 4), 640x480 ``.pgm`` depth rendered from the
    room, SCANNET_PAIRS pairs; and its dataset config. Returns (dataset
    config, the frames' colour paths)."""
    import shutil

    frames = [k % 4 for k in range(SCANNET_FRAMES)]
    pairs = [(p % SCANNET_FRAMES, (7 * p + 3) % SCANNET_FRAMES) for p in range(SCANNET_PAIRS)]
    paths = []

    def write_color(k, path):
        shutil.copyfile(FIXTURES / f"scannet_{frames[k]}.jpg", path)
        paths.append(str(path))

    room().write_scannet_room(root, 640, 480, frames, pairs, write_color)
    text = (REPO / "configs/scannet.yaml").read_text()
    for line in ("DATA_ROOT: data/scannet/", "NPZ_ROOT: data/scannet_indices/scene_data"):
        if line not in text:
            raise AssertionError(f"configs/scannet.yaml has no line {line!r} to set")
    dataset = root / "scannet.yaml"
    dataset.write_text(text.replace("DATA_ROOT: data/scannet/", f"DATA_ROOT: {root}")
                       .replace("NPZ_ROOT: data/scannet_indices/scene_data",
                                f"NPZ_ROOT: {root / 'indices'}"))
    return dataset, paths


def scannet_decode(paths: list) -> dict:
    """nvJPEG on the 1296x968 fixtures to 320x240 (uint8, what the RPR
    sweep's loader asks for) against the JAX package's cv2 decode of them
    (tests/data/torch_port/jax_decode_scannet_320x240.npz), and the wall
    time of a 64-frame batch of the tree's files."""
    import torch

    from mapfree_tpu_torch.data import jpeg

    fixtures = [str(FIXTURES / f"scannet_{i}.jpg") for i in range(4)]
    ref = np.load(FIXTURES / "jax_decode_scannet_320x240.npz")["uint8"]
    own = json.loads((FIXTURES / "scannet_decode_gap.json").read_text())
    got = jpeg.decode_resize_batch(fixtures, 320, 240, device="cuda", uint8=True)
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"decode: {got.dtype}{got.shape}, expected {ref.dtype}{ref.shape}")
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    gap = {"uint8": {"max_abs": int(diff.max()), "mean_abs": float(diff.mean())},
           "what": "nvJPEG (data/jpeg.py) against the cv2 branch of mapfree_tpu/data/io.py, "
                   "on scannet_0..3.jpg (1296x968) at 320x240"}
    log(f"[eval] decode gap: {json.dumps(gap)} (mean limit {SCANNET_DECODE_MEAN_TOL}); the "
        f"JAX package's own native vs cv2 gap on these files: {json.dumps(own['uint8'])}")
    if diff.mean() > SCANNET_DECODE_MEAN_TOL:
        raise AssertionError("the card's decode of the ScanNet fixtures disagrees with the "
                             "JAX package's")
    batch = paths[:64]
    jpeg.decode_resize_batch(batch, 320, 240, device="cuda", uint8=True)
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        jpeg.decode_resize_batch(batch, 320, 240, device="cuda", uint8=True)
    ms = 1e3 * (time.perf_counter() - t0) / n
    log(f"[eval] nvJPEG: 64 frames of 1296x968 to 320x240 uint8: {ms:.2f} ms per batch, "
        f"{64e3 / ms:.1f} frames/s (wall, {jpeg.DECODE_THREADS} host threads)")
    return {"gap": gap, "ms_per_batch": ms}


def eval_scannet_rpr(root: Path, dataset: Path) -> dict:
    """(a) configs/regression/scannet/3d3d.yaml through the ScanNet CLI's
    main(argv) (random weights from TPU.SEED; bf16, INFER_BATCH 64, 320x240,
    K1 at HW = 60 x 80 = 4,800): K1 once per batch in its tensor-core
    design, a finite metric per pair, pairs/s and the stage times."""
    from mapfree_tpu_torch.benchmark import scannet as cli
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.utils.timing import StageTimes

    times = StageTimes()
    yaml = REPO / "configs/regression/scannet/3d3d.yaml"
    n_batches = -(-SCANNET_PAIRS // int(load_cfg(model_yaml=str(yaml.relative_to(REPO)))
                                        .TPU.INFER_BATCH))
    reset_launches()
    with designs_served() as seen, contextlib.chdir(root):
        t0 = time.perf_counter()
        agg = cli.main([str(yaml), "--dataset_config", str(dataset), "--device", DEVICE],
                       times=times)
        elapsed = time.perf_counter() - t0
    launches = launch_counts()
    _expect_designs(seen, {"forward": [corr.DESIGN_MMA]}, "the ScanNet RPR sweep", [corr.KERNEL_FWD_WGMMA])
    if launches[corr.KERNEL] != n_batches or launches[corr.KERNEL_BWD_ROWS] \
            or launches[corr.KERNEL_BWD_COLS]:
        raise AssertionError(f"the ScanNet RPR sweep launched {launches}, expected K1 "
                             f"{n_batches} times")
    if any(v.shape != (SCANNET_PAIRS,) or not np.isfinite(v).all() for v in agg.values()):
        raise AssertionError("the ScanNet RPR sweep's metrics are not one finite value a pair")
    if not (root / "results/scannet/3d3d.npz").is_file():
        raise AssertionError("the ScanNet CLI wrote no results/scannet/3d3d.npz")
    sweep = times.seconds["sweep"]
    log(f"[eval] ScanNet CLI, 3d3d.yaml (random weights): {SCANNET_PAIRS} pairs in {n_batches} "
        f"batches, CLI {elapsed:.2f} s, sweep {sweep:.3f} s, {SCANNET_PAIRS / sweep:.1f} pairs/s "
        f"from files; K1 launches {launches[corr.KERNEL]} ({corr.DESIGN_MMA}); median R_err "
        f"{np.median(agg['R_err']):.2f} deg; stages {times.summary()}")
    return {"pairs_per_s": SCANNET_PAIRS / sweep, "stages": times.summary(),
            "launches": {corr.KERNEL: launches[corr.KERNEL]}}


def _sift_cfg(dataset: Path):
    from mapfree_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    cfg.merge_from_file(str(dataset))
    cfg.merge_from_file(str(REPO / "configs/matching/scannet/sift_emat_gt.yaml"))
    cfg.FEATURE_MATCHING = "SIFT_TPU"
    return cfg


def sift_card_vs_cpu(gray) -> dict:
    """The card's SIFT against the port's CPU SIFT on the same gray images
    (two pairs), at the CPU tests' tolerance; and two runs on the card of
    the whole batch, which must give the same bits."""
    import torch

    from mapfree_tpu_torch.ops.sift import sift_detect_describe

    small = gray[:4]
    card = {k: v.cpu().numpy() for k, v in sift_detect_describe(small, 2048).items()}
    cpu = {k: v.numpy() for k, v in sift_detect_describe(small.cpu(), 2048).items()}
    if not np.array_equal(card["mask"], cpu["mask"]):
        raise AssertionError("SIFT on the card and on the CPU keep other slots")
    score_err = float(np.abs(card["scores"] - cpu["scores"]).max())
    kp_err = desc_l2 = 0.0
    exact = n = swapped = 0
    for b in range(4):
        m = cpu["mask"][b]
        kc, kg = cpu["keypoints"][b][m], card["keypoints"][b][m]
        # as sets: scores that tie to round-off may take each other's slot
        d = np.abs(kc[:, None] - kg[None]).max(-1)
        nearest = d.argmin(1)
        if len(set(nearest.tolist())) != len(kc):
            raise AssertionError("SIFT on the card and on the CPU find other keypoints")
        kp_err = max(kp_err, float(d[np.arange(len(kc)), nearest].max()))
        swapped += int((nearest != np.arange(len(kc))).sum())
        dg, dc = card["descriptors"][b][m][nearest], cpu["descriptors"][b][m]
        desc_l2 = max(desc_l2, float(np.linalg.norm(dg - dc, axis=-1).max()))
        exact += int((np.abs(dg - dc).max(-1) <= SIFT_DESC_ENTRY_TOL).sum())
        n += int(m.sum())
    log(f"[eval] SIFT card vs CPU, 2 pairs (4 images, {n} valid keypoints, {swapped} in "
        f"each other's slots): scores {score_err:.3g} (limit {SIFT_SCORE_TOL}), keypoints "
        f"{kp_err:.3g} px (limit {SIFT_KP_TOL}), descriptors within {SIFT_DESC_ENTRY_TOL} for "
        f"{exact} of {n} (limit {SIFT_DESC_EXACT_SHARE:.0%}), the others at most {desc_l2:.3g} "
        f"in L2")
    if not (score_err <= SIFT_SCORE_TOL and kp_err <= SIFT_KP_TOL
            and exact >= SIFT_DESC_EXACT_SHARE * n):
        raise AssertionError("SIFT on the card disagrees with SIFT on the CPU")
    runs = [sift_detect_describe(gray, 2048) for _ in range(2)]
    torch.cuda.synchronize()
    differ = sum(int((a != b).any(-1).sum()) if a.dim() == 3 else int((a != b).sum())
                 for a, b in ((runs[0][k], runs[1][k]) for k in runs[0]))
    log(f"[eval] SIFT twice on the card over {gray.shape[0]} images: {differ} slots differ "
        "(the histograms sum in a fixed order: must be 0)")
    if differ:
        raise AssertionError("SIFT on the card gives other bits on a second run")
    return {"card_vs_cpu": {"scores": score_err, "keypoints_px": kp_err, "swapped": swapped,
                            "descriptors_exact": exact / n, "descriptor_l2": desc_l2},
            "repeat_differ": differ}


def eval_sift(root: Path, dataset: Path) -> dict:
    """(c) configs/matching/scannet/sift_emat_gt.yaml with FEATURE_MATCHING
    SIFT_TPU (on-device SIFT, the matcher, the metric essential solve on the
    .pgm depth) through the ScanNet CLI over the tree: accuracy against the
    truth; then on one batch of 64 pairs: ms of SIFT (both views) and of the
    solve by CUDA events, the dispatch's launches and device busy share,
    keypoints per image and matches per pair; and the card's SIFT against
    the CPU's."""
    import torch

    from mapfree_tpu_torch.benchmark import scannet as cli
    from mapfree_tpu_torch.data import DataModule
    from mapfree_tpu_torch.models.builder import build_model
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.ops.sift import rgb_to_gray, sift_detect_describe
    from mapfree_tpu_torch.utils.timing import StageTimes

    yaml = root / "sift_tpu_emat_gt.yaml"
    text = (REPO / "configs/matching/scannet/sift_emat_gt.yaml").read_text()
    if "FEATURE_MATCHING: SIFT\n" not in text:
        raise AssertionError("sift_emat_gt.yaml has no line FEATURE_MATCHING: SIFT to set")
    yaml.write_text(text.replace("FEATURE_MATCHING: SIFT\n", "FEATURE_MATCHING: SIFT_TPU\n"))
    times = StageTimes()
    reset_launches()
    with contextlib.chdir(root):
        t0 = time.perf_counter()
        agg = cli.main([str(yaml), "--dataset_config", str(dataset), "--device", DEVICE],
                       times=times)
        elapsed = time.perf_counter() - t0
    if any(corr.launches.values()):
        raise AssertionError(f"the SIFT sweep launched a correlation kernel: {corr.launches}")
    rot, terr = np.nanmedian(agg["R_err"]), np.nanmedian(agg["t_err_euc"])
    failures = float(np.isnan(agg["R_err"]).mean())
    sweep = times.seconds["sweep"]
    log(f"[eval] ScanNet CLI, sift_emat_gt.yaml with SIFT_TPU: {SCANNET_PAIRS} pairs, CLI "
        f"{elapsed:.2f} s, sweep {sweep:.3f} s, {SCANNET_PAIRS / sweep:.1f} pairs/s from files; "
        f"median R_err {rot:.3f} deg (limit {MATCH_ROT_TOL_DEG}), t_err_euc {terr:.4f} m (limit "
        f"{MATCH_T_TOL_M}), failures {failures:.1%}; stages {times.summary()}")
    if not (rot < MATCH_ROT_TOL_DEG and terr < MATCH_T_TOL_M):
        raise AssertionError("the SIFT_TPU sweep's poses are out of the accuracy limits")

    cfg = _sift_cfg(dataset)
    bs = int(cfg.TPU.INFER_BATCH)
    batch = next(iter(DataModule(cfg, device=DEVICE).test_dataloader(batch_size=bs)))
    model = build_model(cfg, device=DEVICE)
    fm = model.model.feature_matching
    img0 = torch.as_tensor(np.asarray(batch["image0"])).to(DEVICE)
    img1 = torch.as_tensor(np.asarray(batch["image1"])).to(DEVICE)
    sift_ms = cuda_time_ms(lambda: fm.correspond(img0, img1), iters=3)
    gray = rgb_to_gray(torch.cat([img0, img1]))
    kps = sift_detect_describe(gray, fm.num_features)["mask"].sum(1).float()
    matches = fm.correspond(img0, img1)[2].sum(1).float()
    transferred = model.transfer_batch(batch)
    model.dispatch_device(transferred)()
    prof = profile_window(lambda: model.dispatch_device(transferred)(), "SIFT_TPU batch", n=1)
    # the solve alone, on the correspondences SIFT gave
    pts0, pts1, mask = (t.cpu().numpy() for t in fm.correspond(img0, img1))
    model.model.feature_matching = _BatchCorrespondences()
    held = dict(batch, pts0=pts0, pts1=pts1, mask=mask)
    solve_in = model.transfer_batch(held)
    solve_ms = cuda_time_ms(lambda: model.dispatch_device(solve_in)(), iters=2)
    log(f"[eval] SIFT_TPU on a batch of {bs} pairs (640x480): SIFT and matching {sift_ms:.1f} ms, "
        f"the essential solve {solve_ms:.1f} ms (CUDA events); the whole dispatch "
        f"{prof['launches']} launches, device busy {prof['busy_share']:.1%}; keypoints per "
        f"image {kps.mean().item():.0f} (min {kps.min().item():.0f}), matches per pair "
        f"{matches.mean().item():.0f} (min {matches.min().item():.0f})")
    numbers = {"pairs_per_s": SCANNET_PAIRS / sweep, "stages": times.summary(),
               "rot_median_deg": float(rot), "t_median_m": float(terr), "failures": failures,
               "sift_ms": sift_ms, "solve_ms": solve_ms, "launches": prof["launches"],
               "busy": prof["busy_share"], "keypoints_per_image": kps.mean().item(),
               "matches_per_pair": matches.mean().item()}
    numbers.update(sift_card_vs_cpu(gray))
    return numbers


def eval_sevenscenes(root: Path) -> dict:
    """(d) The 7Scenes CLI's main(argv) with sift_emat_planercnn.yaml over a
    7Scenes tree of the room (640x480 PNG frames and ``prcnn`` depth
    rendered here, correspondences_SIFT_<pairs>.npz from the known
    geometry), without and with --triang: every query localised within the
    phase's limits, results.npy and the pose files written, and where
    matplotlib does not import no plot and the line that says so."""
    import importlib.util

    from mapfree_tpu_torch.benchmark import sevenscenes as cli
    from mapfree_tpu_torch.ops import correlation as corr

    t0 = time.perf_counter()
    pairs_txt = "test_pairs.5nn.5cm10m.vlad.minmax.txt"  # configs/sevenscenes.yaml's
    room().write_7scenes_room(root, "chess", 640, 480, SEVENSCENES_REFS, SEVENSCENES_QUERIES,
                              pairs_txt, "prcnn")
    text = (REPO / "configs/sevenscenes.yaml").read_text()
    if "DATA_ROOT: data/sevenscenes" not in text or pairs_txt not in text:
        raise AssertionError("configs/sevenscenes.yaml has no DATA_ROOT or test pairs to set")
    dataset = root / "sevenscenes.yaml"
    dataset.write_text(text.replace("DATA_ROOT: data/sevenscenes", f"DATA_ROOT: {root}"))
    log(f"[eval] 7Scenes tree: {SEVENSCENES_REFS + SEVENSCENES_QUERIES} frames rendered, "
        f"{SEVENSCENES_REFS * SEVENSCENES_QUERIES} pairs, {time.perf_counter() - t0:.2f} s")
    plots = importlib.util.find_spec("matplotlib") is not None
    numbers = {}
    for triang in (False, True):
        out = root / ("triang" if triang else "median")
        reset_launches()
        t0 = time.perf_counter()
        cli.main([str(REPO / "configs/matching/sevenscenes/sift_emat_planercnn.yaml"),
                  str(dataset), "-odir", str(out), "--device", DEVICE]
                 + (["--triang"] if triang else []))
        elapsed = time.perf_counter() - t0
        if any(corr.launches.values()):
            raise AssertionError("the 7Scenes sweep launched a correlation kernel")
        res = np.load(out / "results.npy", allow_pickle=True).item()["chess"]
        t_err = np.array([r["abs_t_err"] for r in res.values() if r is not None])
        r_err = np.array([r["abs_r_err"] for r in res.values() if r is not None])
        report = (out / "test_results.txt").read_text()
        jpgs = sorted(p.name for p in out.glob("*.jpg"))
        tag = "--triang" if triang else "median"
        log(f"[eval] 7Scenes CLI {tag}: {len(t_err)} of {SEVENSCENES_QUERIES} queries localised "
            f"in {elapsed:.2f} s, median {np.median(t_err):.4f} m / {np.median(r_err):.3f} deg "
            f"(limits {MATCH_T_TOL_M} m, {MATCH_ROT_TOL_DEG} deg); plots {jpgs or 'none'}")
        if len(t_err) != SEVENSCENES_QUERIES or not (np.median(t_err) < MATCH_T_TOL_M
                                                    and np.median(r_err) < MATCH_ROT_TOL_DEG):
            raise AssertionError(f"7Scenes {tag}: queries not localised within the limits")
        if not (out / "pose_chess.txt").is_file():
            raise AssertionError(f"7Scenes {tag}: no pose_chess.txt")
        if not plots and (jpgs or "matplotlib is not installed" not in report):
            raise AssertionError(f"7Scenes {tag}: without matplotlib, plots {jpgs} and no line "
                                 "saying so")
        numbers[tag] = {"s": elapsed, "t_median_m": float(np.median(t_err)),
                        "r_median_deg": float(np.median(r_err)), "plots": jpgs}
    return numbers


def eval_scorer(mapfree_root: Path) -> dict:
    """(e) The MapFree scorer's main(argv) on phase 13's submission.zip of
    loftr_emat_dptkitti.yaml, and on a zip of the ground-truth poses, which
    must score zero error and precision 1."""
    from mapfree_tpu_torch.benchmark import mapfree as cli

    zip_path = mapfree_root / "loftr_emat_dptkitti" / "submission.zip"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = cli.main([str(zip_path), "--dataset_path", str(mapfree_root)])
    if got is None or json.loads(out.getvalue()) != json.loads(json.dumps(got)):
        raise AssertionError("the scorer printed no JSON of its metrics")
    pose_key = next(k for k in got if k.startswith("Precision @ Pose"))
    log(f"[eval] MapFree scorer on phase 13's loftr_emat_dptkitti submission: {json.dumps(got)}")
    if not (all(np.isfinite(v) for v in got.values()) and got["Estimates for % of frames"] == 1.0
            and got[pose_key] >= 0.9):
        raise AssertionError("the scorer's metrics of phase 13's submission are off")
    gt_zip = mapfree_root / "ground_truth.zip"
    with ZipFile(gt_zip, "w") as z:
        for scene in sorted(p for p in (mapfree_root / "test").iterdir() if p.is_dir()):
            lines = [ln + " 1.0" for ln in (scene / "poses.txt").read_text().splitlines()
                     if ln.startswith("seq1/")]
            z.writestr(f"pose_{scene.name}.txt", "\n".join(lines))
    with contextlib.redirect_stdout(io.StringIO()):
        gt = cli.main([str(gt_zip), "--dataset_path", str(mapfree_root)])
    log(f"[eval] MapFree scorer on the ground truth: {json.dumps(gt)}")
    if not (gt["Average Median Translation Error"] < 1e-6
            and gt["Average Median Rotation Error"] < 1e-3
            and gt["Average Median Reprojection Error"] < 1e-3
            and gt[pose_key] == 1.0 and gt["Precision @ VCRE < 90px"] == 1.0):
        raise AssertionError("the ground truth does not score zero error and precision 1")
    return {"phase13_loftr_emat": got, "ground_truth": gt}


def phase_evaluation(root: Path, mapfree_root: Path) -> dict:
    """Phase 14: the evaluation path (the ScanNet and 7Scenes CLIs, SIFT on
    the card, the MapFree scorer) and K1 at the ScanNet RPR shape."""
    numbers = {}
    t0 = time.perf_counter()
    scannet = root / "scannet"
    scannet.mkdir()
    dataset, paths = write_scannet_tree(scannet)
    log(f"[eval] ScanNet tree: {SCANNET_FRAMES} frames (copies of the 4 1296x968 fixtures), "
        f"{SCANNET_PAIRS} pairs, 640x480 .pgm depth, {time.perf_counter() - t0:.2f} s")
    numbers["decode"] = scannet_decode(paths)
    numbers["scannet_rpr"] = eval_scannet_rpr(scannet, dataset)
    k1 = time_k1(64, 60, 80, 32, "bfloat16", seed=SEED + 105)
    numbers["sift"] = eval_sift(scannet, dataset)
    (root / "sevenscenes").mkdir()
    numbers["sevenscenes"] = eval_sevenscenes(root / "sevenscenes")
    numbers["scorer"] = eval_scorer(mapfree_root)
    launches = {"scannet_cli": numbers["scannet_rpr"].pop("launches")}
    return {"launches": launches, "numbers": numbers, "k1_scannet_shape": k1}


# -- phase 15: the depth net's training tool, the converter, the sharded sweep, the renderer

DEPTH_TRAIN_STEPS = 20
DEPTH_BATCH = 8          # pairs a step: 16 views of 720x540
DEPTH_LOG_EVERY = 5
# the sharded sweep against the single-host sweep: the same files and
# frames, and each pose within this (the rotation angle in radians, t
# relative to max(1, |t|)): a host's batches hold other scenes' pairs, so
# their unique-ref buckets (the encoder's batch) differ, and cuDNN may pick
# another engine for another shape, which moves a pose by bf16 round-off
# (the random weights' near-degenerate Kabsch solves amplify it)
SHARDED_POSE_TOL = 2e-2
# the card's frames against the CPU's: the fill is float64 operation for
# operation on both, the triangle setup is the same numpy, so no pixel should
# differ; the limit allows a pixel centre within round-off of an edge
RENDER_PIXEL_SHARE_TOL = 1e-4
RENDER_FRAMES = 40       # query frames of the rendered scene (every 5th of 200)
RENDER_CPU_FRAMES = 3


def write_depth_tree(root: Path, n_scenes: int = 2, n_queries: int = 40) -> dict:
    """A MapFree train split of fixture JPEG copies (540x720) with 16-bit GT
    depth PNGs (``.gt.png``, the fixtures' depth maps encoded here with
    zlib), all pairs with overlaps inside configs/mapfree.yaml's limits."""
    import shutil

    rng = np.random.default_rng(SEED + 150)
    frames = sorted(FIXTURES.glob("frame_*.jpg"))
    stored = np.load(FIXTURES / "png_decoded.npz")["depth"]
    pngs = [encode_png16(d) for d in stored]
    for s in range(n_scenes):
        scene = root / "train" / f"s{s:05d}"
        names = ["seq0/frame_00000.jpg"] + [f"seq1/frame_{i:05d}.jpg" for i in range(n_queries)]
        intr, poses = [], []
        for j, name in enumerate(names):
            (scene / name).parent.mkdir(parents=True, exist_ok=True)
            k = (j + s) % len(frames)
            shutil.copyfile(frames[k], scene / name)
            (scene / name.replace(".jpg", ".gt.png")).write_bytes(pngs[k])
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            intr.append(f"{name} 590.0 590.0 270.0 360.0 540 720")
            poses.append(f"{name} " + " ".join(f"{v:.9f}" for v in np.concatenate(
                [q, rng.normal(size=3)])))
        (scene / "intrinsics.txt").write_text("\n".join(intr) + "\n")
        (scene / "poses.txt").write_text("\n".join(poses) + "\n")
        np.savez(scene / "overlaps.npz",
                 idxs=np.array([(0, 0, 1, i) for i in range(n_queries)], dtype=np.int64),
                 overlaps=rng.uniform(0.3, 0.6, size=n_queries))
    return {"pairs": n_scenes * n_queries}


def depth_card_vs_cpu() -> dict:
    """One float32 step of a small depth net (one block per stage, 96x72,
    batch 2 pairs) on the card and on the CPU, same weights and batch: the
    loss and every gradient (phase 6's tolerances: ReLU inputs within
    round-off of zero flip branches between the two)."""
    import torch

    from mapfree_tpu_torch.tools import train_depth

    cfg = load_cfg({"DEPTH_NET.NUM_BLOCKS": "1-1-1", "TPU.COMPUTE_DTYPE": "float32",
                    "TPU.SEED": SEED}, model_yaml=None)
    rng = np.random.default_rng(SEED + 151)
    images = rng.integers(0, 256, (4, 96, 72, 3), dtype=np.uint8)
    gt = rng.uniform(0.5, 8.0, (4, 96, 72)).astype(np.float32)
    gt[:, :8] = 0.0
    loss, grads = {}, {}
    for name, dev in (("card", DEVICE), ("cpu", "cpu")):
        net = train_depth.build_net(cfg).to(dev)
        step = train_depth.make_step(net, torch.optim.Adam(net.parameters(), lr=1e-4))
        loss[name] = float(step(torch.from_numpy(images).to(dev), torch.from_numpy(gt).to(dev)))
        grads[name] = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
    per, l2 = _grad_errors(grads["card"], grads["cpu"])
    rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    median = per[len(per) // 2][0]
    log(f"[depth] float32 depth step, GPU vs CPU: loss {loss['card']:.6f} vs {loss['cpu']:.6f} "
        f"(rel {rel:.2e}, tol {STEP_LOSS_RTOL:g}); whole gradient {l2:.2e} in L2 (tol "
        f"{STEP_CPU_L2_TOL:g}); median tensor {median:.2e} of its largest entry (tol "
        f"{STEP_CPU_MEDIAN_TOL:g}); worst tensor {per[0][0]:.2e} at {per[0][1]}")
    if rel > STEP_LOSS_RTOL or l2 > STEP_CPU_L2_TOL or median > STEP_CPU_MEDIAN_TOL:
        raise AssertionError("the GPU and CPU depth train steps disagree")
    return {"loss_rel": rel, "grad_l2": l2, "grad_median": median}


def depth_step_timing(root: Path) -> dict:
    """The full-width depth step (configs/mapfree.yaml: 720x540, bf16, 2-2-2)
    on one loader batch of the tree already on the card: ms per step by CUDA
    events, images/s, peak memory, and a profiler window."""
    import torch

    from mapfree_tpu_torch.data import MapFreeDataset, collate
    from mapfree_tpu_torch.tools import train_depth

    cfg = load_cfg({"DATASET.DATA_ROOT": str(root), "DATASET.ESTIMATED_DEPTH": "gt"},
                   model_yaml=None)
    dataset = MapFreeDataset(cfg, "train", device=DEVICE)
    images, gt = train_depth.fold_batch(collate(dataset.getitems(list(range(DEPTH_BATCH)))))
    images, gt = torch.from_numpy(images).to(DEVICE), torch.from_numpy(gt).to(DEVICE)
    net = train_depth.build_net(cfg).to(DEVICE)
    step = train_depth.make_step(net, torch.optim.Adam(net.parameters(), lr=1e-4))
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: step(images, gt), iters=10, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_window(lambda: step(images, gt), "depth step")
    n = images.shape[0]
    log(f"[depth] full-width step ({n} views of {tuple(images.shape[1:3])}, {images.dtype}, "
        f"bf16, NUM_BLOCKS {cfg.DEPTH_NET.NUM_BLOCKS}): {ms:.2f} ms per step, "
        f"{1e3 * n / ms:.1f} images/s, peak {peak:.2f} GB, device busy "
        f"{100 * prof['busy_share']:.1f}%, {prof['launches']} launches per step")
    return {"ms_per_step": ms, "images_per_s": 1e3 * n / ms, "peak_gb": peak,
            "busy_share": prof["busy_share"], "launches_per_step": prof["launches"]}


def depth_training(root: Path, mapfree_root: Path) -> dict:
    """(a) The training tool's CLI at full width, the card against the CPU on
    a small step, and the in-graph sweep on the written .pt."""
    import re

    import torch

    from mapfree_tpu_torch import submission
    from mapfree_tpu_torch.tools import train_depth

    tree = root / "depth"
    t0 = time.perf_counter()
    n_pairs = write_depth_tree(tree)["pairs"]
    dataset_cfg, _ = write_configs(tree)
    log(f"[depth] MapFree train tree with GT depth PNGs in {time.perf_counter() - t0:.2f} s: "
        f"{n_pairs} pairs")
    out = root / "depth.pt"
    captured = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        path, last = train_depth.main([
            str(dataset_cfg), "--data_root", str(tree), "--depth_suffix", "gt",
            "--steps", str(DEPTH_TRAIN_STEPS), "--batch", str(DEPTH_BATCH), "--lr", "1e-4",
            "--out", str(out), "--log_every", str(DEPTH_LOG_EVERY), "--device", DEVICE])
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    text = captured.getvalue()
    losses = [float(x) for x in re.findall(r"\[train_depth s\d+\] log-L1=(\S+)", text)]
    for line in text.splitlines():
        log(f"[depth]   {line}")
    log(f"[depth] train_depth CLI: {DEPTH_TRAIN_STEPS} steps at batch {DEPTH_BATCH} "
        f"({2 * DEPTH_BATCH} views) in {elapsed:.2f} s (build, nvJPEG and PNG loading, steps, "
        f"save): {1e3 * elapsed / DEPTH_TRAIN_STEPS:.1f} ms per step end to end, "
        f"{2 * DEPTH_BATCH * DEPTH_TRAIN_STEPS / elapsed:.1f} images/s; peak {peak:.2f} GB; "
        f"losses {losses}")
    if (len(losses) != DEPTH_TRAIN_STEPS // DEPTH_LOG_EVERY or not np.all(np.isfinite(losses))
            or not path.is_file()):
        raise AssertionError("the depth training tool did not log finite losses and write "
                             "its checkpoint")
    numbers = {"cli_s": elapsed, "cli_ms_per_step": 1e3 * elapsed / DEPTH_TRAIN_STEPS,
               "losses": losses, "cli_peak_gb": peak}
    numbers["step"] = depth_step_timing(tree)
    numbers["card_vs_cpu"] = depth_card_vs_cpu()

    # the in-graph matching config on the trained weights, over phase 13's tree
    ingraph = root / "sift_emat_ingraph_trained.yaml"
    ingraph.write_text((REPO / "configs/matching/mapfree/sift_emat_ingraph.yaml").read_text()
                       + f"  CHECKPOINT: '{path}'\n")
    t0 = time.perf_counter()
    zip_path = submission.main([str(ingraph), "--dataset_config",
                                str(mapfree_root / "mapfree.yaml"), "--device", DEVICE,
                                "-o", str(root / "ingraph_trained")])
    elapsed = time.perf_counter() - t0
    trained = read_submission(zip_path)
    random = read_submission(mapfree_root / "sift_emat_ingraph" / "submission.zip")
    if {s: sorted(p) for s, p in trained.items()} != {s: sorted(p) for s, p in random.items()}:
        raise AssertionError("the in-graph sweep on the trained .pt misses query frames")
    moved = [np.abs(trained[s][f][1] - t).max() for s, fr in random.items()
             for f, (_, t) in fr.items()]
    n = len(moved)
    log(f"[depth] sift_emat_ingraph on the trained depth.pt (no ALLOW_RANDOM): {n} finite "
        f"poses in {elapsed:.2f} s; the translation moved from the random-weight run's "
        f"(phase 13) on {np.mean(np.array(moved) > 1e-6):.1%} of the frames")
    if np.mean(np.array(moved) > 1e-6) < 0.5:
        raise AssertionError("the in-graph sweep's poses do not depend on the trained depth net")
    numbers["ingraph_s"] = elapsed
    return numbers


def write_lightning_ckpt(path: Path, cfg, seed: int) -> None:
    """A Lightning-style checkpoint of the config's net at random weights:
    ``model.``-prefixed tensors, an optimizer state, loop counters."""
    import torch

    from mapfree_tpu_torch.models.blocks import init_weights
    from mapfree_tpu_torch.models.regression import build_regression_net

    net = build_regression_net(cfg)
    init_weights(net, torch.Generator().manual_seed(seed))
    state = net.state_dict()
    params = [k for k, _ in net.named_parameters()]
    torch.save({
        "epoch": 7, "global_step": 3000, "pytorch-lightning_version": "1.6.0",
        "state_dict": {f"model.{k}": v for k, v in state.items()},
        "optimizer_states": [{
            "state": {i: {"step": torch.tensor(3000.0), "exp_avg": torch.zeros_like(state[k]),
                          "exp_avg_sq": torch.zeros_like(state[k])}
                      for i, k in enumerate(params)},
            "param_groups": [{"lr": 1e-4, "betas": (0.9, 0.999), "eps": 1e-6,
                              "params": list(range(len(params)))}]}],
    }, path)


def _zip_files(path: Path) -> dict:
    with ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _pose_differences(a: dict, b: dict) -> np.ndarray:
    """Per frame of ``b``: 0 where the two poses are equal, else max(rotation
    angle between them in radians, |t_a - t_b| / max(1, |t_b|))."""
    from mapfree_tpu_torch.geom.quaternion import quat2mat

    out = []
    for s, frames in b.items():
        for f, (q, t) in frames.items():
            qa, ta = a[s][f]
            if np.array_equal(qa, q) and np.array_equal(ta, t):
                out.append(0.0)
                continue
            R = quat2mat(qa).T @ quat2mat(q)
            angle = np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))
            out.append(max(angle, np.abs(ta - t).max() / max(1.0, np.abs(t).max())))
    return np.array(out)


def converter_and_sharded_sweep(root: Path) -> dict:
    """(b) A Lightning checkpoint of the 3d3d net through the converter's
    CLI, and the submission CLI on both; (c) the sharded sweep on the .pt
    for 3 hosts (2, 1, then 0, which merges), then single-host."""
    from mapfree_tpu_torch import submission
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.tools.convert_weights import main as convert_main

    model_cfg = str(REPO / "configs/regression/mapfree/3d3d.yaml")
    tree = root / "sweep"
    queries = write_mapfree_tree(tree, seed=SEED + 160)["test"]
    dataset_cfg, _ = write_configs(tree)
    ckpt, pt = root / "ref.ckpt", root / "converted.pt"
    write_lightning_ckpt(ckpt, load_cfg(), SEED + 161)
    t0 = time.perf_counter()
    convert_main([str(ckpt), str(pt), "--config", model_cfg, "--dataset_config",
                  str(REPO / "configs/mapfree.yaml"), "--device", DEVICE])
    log(f"[convert] Lightning checkpoint of 3d3d ({ckpt.stat().st_size / 1e6:.1f} MB with its "
        f"optimizer state) -> {pt.name} ({pt.stat().st_size / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.2f} s")
    common = [model_cfg, "--dataset_config", str(dataset_cfg), "--device", DEVICE]
    runs = {}
    from_ckpt = run_submission_cli(common + ["--checkpoint", str(ckpt), "-o", str(root / "ckpt")],
                                   queries, "submission CLI, Lightning .ckpt", tag="convert")
    from_pt = run_submission_cli(common + ["--checkpoint", str(pt), "-o", str(root / "pt")],
                                 queries, "submission CLI, converted .pt", tag="convert")
    runs["convert_ckpt_cli"], runs["convert_pt_cli"] = from_ckpt["launches"], from_pt["launches"]
    a, b = _zip_files(root / "ckpt" / "submission.zip"), _zip_files(root / "pt" / "submission.zip")
    moved = _pose_differences(from_pt["poses"], from_ckpt["poses"])
    log(f"[convert] the .pt's submission against the .ckpt's: {len(a)} scene files, "
        f"{'bit-equal' if a == b else 'DIFFERENT'}; {np.mean(moved == 0):.1%} of the poses "
        f"equal, largest difference {moved.max():.2e}")
    if a != b:
        raise AssertionError("the converted checkpoint gives other poses than the Lightning one")

    # (c) the sharded sweep, host 0 last (it merges); then single-host
    n_pairs = sum(len(v) for v in queries.values())
    reset_launches()
    t0 = time.perf_counter()
    for host in (2, 1, 0):
        out = submission.main(common + ["--checkpoint", str(pt), "--num_hosts", "3",
                                        "--host_id", str(host), "-o", str(root / "hosts")])
    sharded_s = time.perf_counter() - t0
    runs["sharded_cli"] = launch_counts()
    scenes = sorted(queries)
    expected = sum(-(-sum(len(queries[s]) for s in scenes[h::3]) // 64) for h in range(3))
    if runs["sharded_cli"][corr.KERNEL] != expected:
        raise AssertionError(f"the sharded sweep launched K1 {runs['sharded_cli']} times, "
                             f"expected {expected}")
    single = run_submission_cli(common + ["--checkpoint", str(pt), "-o", str(root / "single")],
                                queries, "submission CLI, single host", tag="sharded")
    runs["single_host_cli"] = single["launches"]
    merged, one = read_submission(out), single["poses"]
    if {s: sorted(p) for s, p in merged.items()} != {s: sorted(p) for s, p in one.items()}:
        raise AssertionError("the merged zip does not hold the single-host zip's frames")
    errs = _pose_differences(merged, one)
    equal = _zip_files(out) == _zip_files(root / "single" / "submission.zip")
    log(f"[sharded] 3 hosts (each its own CLI run, host 0 merging): {n_pairs} pairs in "
        f"{sharded_s:.2f} s, {n_pairs / sharded_s:.1f} pairs/s over the three runs "
        f"(model builds included); K1 {runs['sharded_cli'][corr.KERNEL]} launches; merged zip "
        f"against the single-host zip: {'bit-equal' if equal else 'not bit-equal'}, "
        f"{np.mean(np.array(errs) == 0):.1%} of the poses equal, largest difference "
        f"{max(errs):.2e} (limit {SHARDED_POSE_TOL:g})")
    if max(errs) > SHARDED_POSE_TOL:
        raise AssertionError("the sharded sweep's poses disagree with the single-host sweep's")
    numbers = {"sharded_pairs_per_s": n_pairs / sharded_s, "sharded_bit_equal": equal,
               "sharded_max_err": max(errs), "single_pairs_per_s": single["pairs_per_s"],
               "convert_pairs_per_s": from_pt["pairs_per_s"]}
    return {"launches": runs, "numbers": numbers}


def write_render_tree(root: Path) -> Path:
    """A MapFree val scene of RENDER_FRAMES query photos (every 5th of 200
    frames; fixture JPEG copies, 540x720) on a smooth trajectory, and a
    submission zip of noisy estimates for all but every 7th of them."""
    import shutil

    from mapfree_tpu_torch.geom.quaternion import mat2quat

    rng = np.random.default_rng(SEED + 170)
    frames = sorted(FIXTURES.glob("frame_*.jpg"))
    scene = root / "val" / "s00000"
    names = ["seq0/frame_00000.jpg"] + [f"seq1/frame_{i:05d}.jpg" for i in range(5 * RENDER_FRAMES)]
    poses, lines = [], []
    for j, name in enumerate(names):
        a = 0.02 * j
        R = _rotation(np.random.default_rng(j), 0.15) if j else np.eye(3)
        c = np.array([np.sin(a), 0.1 * np.cos(3 * a), 0.5 * a]) if j else np.zeros(3)
        q, t = mat2quat(R).reshape(-1), -R @ c  # world-to-camera, as poses.txt holds
        poses.append(f"{name} " + " ".join(f"{v:.9f}" for v in np.concatenate([q, t])))
        if name.startswith("seq1") and (j - 1) % 5 == 0:
            (scene / name).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(frames[j % len(frames)], scene / name)
            if (j - 1) % 35:
                qe = q + rng.normal(size=4) * 0.02
                qe /= np.linalg.norm(qe)
                te = t + rng.normal(size=3) * 0.1
                lines.append(f"{name} " + " ".join(f"{v:.6f}" for v in np.concatenate([qe, te]))
                             + f" {rng.uniform(0, 100):.1f}")
    (scene / "seq0").mkdir(parents=True, exist_ok=True)
    shutil.copyfile(frames[0], scene / names[0])
    (scene / "poses.txt").write_text("\n".join(poses) + "\n")
    with ZipFile(root / "submission.zip", "w") as z:
        z.writestr("pose_s00000.txt", "\n".join(lines))
    return root / "submission.zip"


@contextlib.contextmanager
def cv2_hidden():
    """Inside the block ``import cv2`` raises ImportError, as on a machine
    without it."""
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def render(root: Path) -> dict:
    """(d) render_estimates on the card (an MP4 where cv2 imports; else the
    frames counted and one line), its frames on the card against the CPU's
    on the same photos, and the scene once more with cv2 hidden."""
    import itertools
    from io import TextIOWrapper

    import torch

    from mapfree_tpu_torch.benchmark.utils import load_poses, subsample_poses
    from mapfree_tpu_torch.visualisation import render_estimates
    from mapfree_tpu_torch.visualisation.render_scene import render_frames

    tree = root / "render"
    zip_path = write_render_tree(tree)
    captured = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rendered = render_estimates.main([str(zip_path), "--dataset_path", str(tree),
                                          "--split", "val", "-o", str(root / "renders"),
                                          "--device", DEVICE])
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    for line in captured.getvalue().splitlines():
        log(f"[render]   {line}")
    mp4 = root / "renders" / "s00000.mp4"
    said_no_cv2 = any(line.startswith("render_scene: cv2 is not installed")
                   for line in captured.getvalue().splitlines())
    if rendered != {"s00000": RENDER_FRAMES} or mp4.exists() == said_no_cv2:
        raise AssertionError(f"render_estimates rendered {rendered}, MP4 written: "
                             f"{mp4.exists()}")
    log(f"[render] render_estimates CLI on the card: {RENDER_FRAMES} frames of 960x720 with "
        f"their query photos (nvJPEG) in {elapsed:.2f} s, {1e3 * elapsed / RENDER_FRAMES:.1f} "
        f"ms per frame end to end")

    scene = tree / "val" / "s00000"
    with (scene / "poses.txt").open() as f:
        gt = subsample_poses(load_poses(f), 5)
    with ZipFile(zip_path) as z, z.open("pose_s00000.txt") as f:
        est = load_poses(TextIOWrapper(f, encoding="utf-8"), load_confidence=True)
    paths = {k: scene / "seq1" / f"frame_{k:05d}.jpg" for k in gt}
    paths = {k: p for k, p in paths.items() if p.exists()}
    photos = dict(zip(paths, render_estimates.read_photos(list(paths.values()), DEVICE)))

    def frames_on(device, n):
        out, t = [], time.perf_counter()
        for frame, _ in itertools.islice(render_frames(gt, est, scene_images=photos,
                                                       device=device), n):
            out.append(frame.cpu().numpy())
        return out, 1e3 * (time.perf_counter() - t) / n

    card, card_ms = frames_on(DEVICE, RENDER_FRAMES)
    cpu, cpu_ms = frames_on("cpu", RENDER_CPU_FRAMES)
    differing = sum(int((a != b).any(-1).sum()) for a, b in zip(card, cpu))
    share = differing / (RENDER_CPU_FRAMES * card[0].shape[0] * card[0].shape[1])
    log(f"[render] render_frames: {card_ms:.1f} ms per 960x720 frame on the card "
        f"({RENDER_FRAMES} frames), {cpu_ms:.1f} ms on the CPU ({RENDER_CPU_FRAMES} frames, "
        f"{torch.get_num_threads()} threads); the first {RENDER_CPU_FRAMES} frames differ in "
        f"{differing} pixels, a share of {share:.2e} (limit {RENDER_PIXEL_SHARE_TOL:g})")
    if share > RENDER_PIXEL_SHARE_TOL:
        raise AssertionError("the card's frames differ from the CPU's")
    if not all(f.any() for f in card) or len({f.tobytes() for f in card}) < RENDER_FRAMES // 2:
        raise AssertionError("the card's frames are blank or repeat")

    from mapfree_tpu_torch.visualisation.render_scene import render_scene

    captured = io.StringIO()
    with cv2_hidden(), contextlib.redirect_stdout(captured):
        n = render_scene(gt, est, root / "no_cv2.mp4", scene_images=photos, device=DEVICE)
    lines = captured.getvalue().splitlines()
    for line in lines:
        log(f"[render]   {line}")
    if n != RENDER_FRAMES or (root / "no_cv2.mp4").exists() or len(lines) != 1:
        raise AssertionError("render_scene without cv2 did not render, count and say so")
    return {"cli_ms_per_frame": 1e3 * elapsed / RENDER_FRAMES, "card_ms_per_frame": card_ms,
            "cpu_ms_per_frame": cpu_ms, "pixel_share_differing": share}


def phase_tools(root: Path, mapfree_root: Path) -> dict:
    """Phase 15: the depth net's training tool, the converter's CLI, the
    multi-host sweep and the renderer through their main(argv); phase 13's
    tree is ``mapfree_root``."""
    numbers = {"depth": depth_training(root, mapfree_root)}
    swept = converter_and_sharded_sweep(root)
    numbers["sweeps"] = swept["numbers"]
    numbers["render"] = render(root)
    return {"launches": swept["launches"], "numbers": numbers}



# -- phase 16: the data mesh -------------------------------------------------------

MESH_JOIN_LIMIT_S = 300   # the two ranks of (c), from spawn to exit
MESH_STATS_TOL = 1e-5     # BatchNorm statistics, as a share of max(1, the largest entry)
MESH_TIMED_STEPS = 3
# phase 16 (c)'s gradients: at most this many times what reversing the
# batch's order moves the single-process step's, in the whole gradient's L2
# norm, the median tensor and the worst tensor (each as a share of its
# largest entry). tools/torch_chip_studies.py mesh-faults plants faults of
# the mesh in the ranks and shows that each fails these limits.
MESH_NOISE_FACTOR = 3.0


def _mesh_rank(rank, world, port, out_dir, cfg, batch, n_timed):
    """One of phase 16 (c)'s ranks: a gloo group over tcp://localhost, the
    card shared with the other rank; one float32 train step on this rank's
    block of ``batch`` (rank 0 writes its loss, gradients and BatchNorm
    statistics), then ``n_timed`` more, timed."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.parallel import make_mesh
    from mapfree_tpu_torch.train import init_state, make_train_step
    from mapfree_tpu_torch.train.fit import _device_batch, _train_keys
    from mapfree_tpu_torch.utils.data import data_to_device

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=timedelta(minutes=3))
    try:
        net = build_regression_net(cfg)
        state = init_state(net, cfg, torch.Generator().manual_seed(SEED), device="cuda")
        mesh = make_mesh(cfg)  # the ranks' current devices: cuda:0 twice
        step = make_train_step(net, cfg, mesh=mesh)
        # the training keys of the whole batch in float32, then this rank's block
        whole = _device_batch(batch, torch.device("cpu"), int(cfg.TRAINING.BATCH_SIZE),
                              _train_keys(net))
        dbatch = data_to_device(whole, mesh=mesh)[0]
        reset_launches()
        state, logs = step(state, dbatch)
        result = {"loss": float(logs["train/loss"]), "rows": int(dbatch["image0"].shape[0]),
                  "mesh": repr(mesh), "step_launches": dict(corr.launches),
                  "grads": {k: p.grad.detach().cpu() for k, p in net.named_parameters()},
                  "stats": {k: b.detach().cpu() for k, b in net.named_buffers()}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_timed):
            step(state, dbatch)
        torch.cuda.synchronize()
        result["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / max(1, n_timed)
        result["launches"] = dict(corr.launches)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_predictor() -> dict:
    """(a) make_mesh() holds the visible cards; the predictor built over its
    devices drops a one-device mesh and gives phase 4's poses to the bit on
    phase 4's first batch; the predictor over two replicas on the one card
    (the multi-device path: a block of rows each) within PARITY_ATOL of one
    replica in float32, and through predict at full width with K1 once per
    replica and batch."""
    import torch

    from mapfree_tpu_torch.models.builder import build_model
    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.parallel import make_mesh
    from mapfree_tpu_torch.utils.submission import predict

    mesh = make_mesh()
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if list(mesh.devices.flat) != cards or mesh.group is not None:
        raise AssertionError(f"make_mesh() is {mesh}, not the visible cards {cards}")
    cfg = load_cfg({"TPU.SEED": SEED})
    H, W, bs = cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH, int(cfg.TPU.INFER_BATCH)
    batches = synthetic_batches(2 * bs + 23, bs, H, W, seed=SEED + 1)  # phase 4's first ones
    phase4 = build_model(cfg, device="cuda")
    on_mesh = build_model(cfg, devices=list(mesh.devices.flat))
    if len(cards) == 1 and on_mesh.mesh is not None:
        raise AssertionError("the predictor kept a one-device mesh")
    ref, got = phase4.predict_batch(batches[0]), on_mesh.predict_batch(batches[0])
    equal = all(np.array_equal(a, b) for a, b in zip(ref[:2], got[:2]))
    log(f"[mesh] make_mesh(): {mesh}; the predictor over it: batch {on_mesh.batch_size}, mesh "
        f"{on_mesh.mesh}; poses equal to phase 4's predictor's to the bit: {equal}")
    if not equal:
        raise AssertionError("the predictor over the default mesh moved phase 4's poses")
    del phase4, on_mesh

    two = [torch.device("cuda", 0)] * 2
    small = load_cfg({"ENCODER.NUM_BLOCKS": "1-1-1", "DATASET.HEIGHT": 96, "DATASET.WIDTH": 72,
                      "TPU.INFER_BATCH": 6, "TPU.COMPUTE_DTYPE": "float32", "TPU.SEED": SEED})
    batch = config_batch(small, 5, seed=SEED + 61)
    one_r = build_model(small, device="cuda").predict_batch(batch)
    two_r = build_model(small, devices=two).predict_batch(batch)
    err = max(float(np.abs(a - b).max()) for a, b in zip(one_r[:2], two_r[:2]))
    log(f"[mesh] two replicas on the card, float32, 5 pairs in blocks of 3: max |two - one| "
        f"over R and t {err:.3g} (atol {PARITY_ATOL:g})")
    if err > PARITY_ATOL:
        raise AssertionError("the predictor over two replicas disagrees with one")

    model = build_model(cfg, devices=two)
    predict(batches[:1], model)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = predict(batches, model)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = launch_counts()
    n_pairs = sum(len(b["pair_names"]) for b in batches)
    poses = [p for ps in results.values() for p in ps]
    log(f"[mesh] two replicas on the card at full width: {n_pairs} pairs in {len(batches)} "
        f"batches, {n_pairs / elapsed:.1f} pairs/s; K1 launches {launches[corr.KERNEL]}")
    _expect_launches(corr, {corr.KERNEL: 2 * len(batches), corr.KERNEL_BWD_ROWS: 0,
                            corr.KERNEL_BWD_COLS: 0}, "the two-replica sweep")
    if len(poses) != n_pairs or not all(np.all(np.isfinite(p.q)) and np.all(np.isfinite(p.t))
                                        for p in poses):
        raise AssertionError("the two-replica sweep gave non-finite or missing poses")
    return {"two_replica_sweep": launches, "two_replica_pairs_per_s": n_pairs / elapsed}


def mesh_train_cli() -> dict:
    """(b) the train CLI under one NCCL rank (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT set, as torchrun sets them): 8 steps of 3d3d
    at full width, batch 10, bf16, over phase 8's kind of tree, against two
    runs without a process group: each step's loss within three times the
    largest difference between those two runs (cuDNN's bf16 weight
    gradients sum with atomics, so two runs differ), and K1-K3 once per step
    (K1 also once per validation batch)."""
    import os

    import torch
    import torch.distributed as dist

    from mapfree_tpu_torch.ops import correlation as corr
    from mapfree_tpu_torch.train.__main__ import main as train_main

    model_cfg = str(REPO / "configs/regression/mapfree/3d3d.yaml")
    bs = int(load_cfg().TRAINING.BATCH_SIZE)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_mapfree_tree(root, seed=SEED + 62)
        dataset_cfg, run_cfg = write_configs(root)
        for tag in ("single_a", "single_b", "nccl_rank"):
            env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())} \
                if tag == "nccl_rank" else {}
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            reset_launches()
            captured = io.StringIO()
            try:
                with contextlib.chdir(root), contextlib.redirect_stdout(captured):
                    state = train_main([model_cfg, str(dataset_cfg), "--config", str(run_cfg),
                                        "--experiment", tag, "--device", "cuda"])
                torch.cuda.synchronize()
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            if dist.is_initialized():
                raise AssertionError("the train CLI left its process group behind")
            records = [json.loads(ln) for ln in
                       (root / "weights" / tag / "scalars.jsonl").read_text().splitlines()]
            steps = [r for r in records if "train/loss" in r]
            runs[tag] = {"losses": [r["train/loss"] for r in steps], "step": state.step,
                         "launches": launch_counts(),
                         "ms_per_step": 1e3 * bs / steps[-1]["train/samples_per_sec"]}
            log(f"[mesh] train CLI, {tag}: {state.step} steps, losses "
                + " ".join(f"{x:.5f}" for x in runs[tag]["losses"])
                + f"; {runs[tag]['ms_per_step']:.2f} ms per step over the run (fit's rate); "
                f"launches {runs[tag]['launches']}")
            _expect_launches(corr, {corr.KERNEL: 8 + 2, corr.KERNEL_BWD_ROWS: 8,
                                    corr.KERNEL_BWD_COLS: 8}, f"the train CLI, {tag}")
    a, b, c = (np.array(runs[t]["losses"]) for t in ("single_a", "single_b", "nccl_rank"))
    if not (len(a) == len(b) == len(c) == 8 and np.all(np.isfinite(c))):
        raise AssertionError("the train CLI runs did not log 8 finite losses each")
    spread = float(np.abs(a - b).max())
    diff = float(np.abs(c - a).max())
    limit = max(3.0 * spread, 1e-6 * float(np.abs(a).max()))
    log(f"[mesh] one NCCL rank against no process group: largest loss difference {diff:.3g}; "
        f"two runs without a group differ by up to {spread:.3g}; limit {limit:.3g}")
    if diff > limit:
        raise AssertionError("the train CLI under one NCCL rank strays from the single process")
    return {"launches": runs["nccl_rank"]["launches"], "spread": spread, "diff": diff,
            "ms_per_step": {t: r["ms_per_step"] for t, r in runs.items()}}


def mesh_step_inputs() -> tuple:
    """Phase 16 (c)'s float32 3d3d config at full width and its batch of
    BATCH_SIZE (10) rows."""
    cfg = load_cfg({"TPU.COMPUTE_DTYPE": "float32", "TPU.SEED": SEED})
    batch = train_batches(1, int(cfg.TRAINING.BATCH_SIZE), cfg.DATASET.HEIGHT,
                          cfg.DATASET.WIDTH, seed=SEED + 63)[0]
    return cfg, batch


def spawn_mesh_ranks(cfg, batch, n_timed=MESH_TIMED_STEPS, rank_fn=None) -> list:
    """Run ``rank_fn`` (:func:`_mesh_rank`, or a function that plants a
    fault and calls it) in two spawned processes over a gloo group, within
    MESH_JOIN_LIMIT_S; each rank's result."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        ctx = mp.start_processes(rank_fn or _mesh_rank, nprocs=2, join=False,
                                 start_method="spawn",
                                 args=(2, _free_port(), out_dir, cfg, batch, n_timed))
        deadline = time.monotonic() + MESH_JOIN_LIMIT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"the two ranks still ran after {MESH_JOIN_LIMIT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        ranks = [torch.load(Path(out_dir) / f"rank{r}.pt") for r in range(2)]
    log(f"[mesh] two gloo ranks on the card: {time.perf_counter() - t0:.1f} s from spawn "
        f"to exit; {ranks[0]['mesh']}; rows per rank {[r['rows'] for r in ranks]}")
    return ranks


def single_mesh_step(cfg, rows) -> tuple:
    """One float32 train step in one process on ``rows``: (loss, gradients,
    BatchNorm statistics, (state, step, device batch))."""
    import torch

    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.train import init_state, make_train_step
    from mapfree_tpu_torch.train.fit import _device_batch, _train_keys

    net = build_regression_net(cfg)
    state = init_state(net, cfg, torch.Generator().manual_seed(SEED), device="cuda")
    step = make_train_step(net, cfg)
    dbatch = _device_batch(rows, torch.device("cuda"), int(cfg.TRAINING.BATCH_SIZE),
                           _train_keys(net))
    state, logs = step(state, dbatch)
    return (float(logs["train/loss"]),
            {k: p.grad.detach().cpu() for k, p in net.named_parameters()},
            {k: b.detach().cpu() for k, b in net.named_buffers()}, (state, step, dbatch))


def mesh_control(cfg, batch, single) -> dict:
    """How far round-off alone moves the single-process step's gradients:
    the same step on the batch in reverse order (the same function, its
    sums in other orders: cuDNN's, BatchNorm's), against ``single`` (the
    step on ``batch``). The synced BatchNorm sums in yet another order."""
    loss, grads = single[:2]
    loss_r, grads_r, _, _ = single_mesh_step(
        cfg, {k: np.ascontiguousarray(v[::-1]) for k, v in batch.items()})
    per, l2 = _grad_errors(grads_r, grads)
    control = {"loss_rel": abs(loss_r - loss) / abs(loss), "l2": l2,
               "median": per[len(per) // 2][0], "worst": per[0][0], "worst_at": per[0][1]}
    log(f"[mesh] float32 step, one process x 10 rows, against the same on the rows in reverse "
        f"order: loss rel {control['loss_rel']:.2e}; whole gradient {l2:.2e} in L2, median "
        f"tensor {control['median']:.2e}, worst {control['worst']:.2e} at {per[0][1]}")
    return control


def mesh_verdict(r0, single, control, what="2 ranks x 5 rows") -> dict:
    """Rank 0 of the two against the single-process step on the same rows:
    the loss within STEP_LOSS_RTOL (phase 6's), the BatchNorm statistics
    within MESH_STATS_TOL, and the gradients within MESH_NOISE_FACTOR times
    ``control`` (:func:`mesh_control`) in the whole gradient's L2 norm, the
    median tensor and the worst tensor. Returns the readings, their limits
    and ``ok``."""
    loss, grads, stats = single[:3]
    per, l2 = _grad_errors(r0["grads"], grads)
    stat_err = max((float((r0["stats"][k].double() - v.double()).abs().max())
                    / max(1.0, float(v.abs().max())), k)
                   for k, v in stats.items() if v.is_floating_point())
    got = {"loss_rel": abs(r0["loss"] - loss) / abs(loss), "l2": l2,
           "median": per[len(per) // 2][0], "worst": per[0][0], "stats": stat_err[0]}
    limits = {"loss_rel": STEP_LOSS_RTOL, "stats": MESH_STATS_TOL,
              **{k: MESH_NOISE_FACTOR * control[k] + 1e-6 for k in ("l2", "median", "worst")}}
    ok = all(got[k] <= limits[k] for k in limits)
    log(f"[mesh] float32 step, {what} vs one process x 10 rows: loss {r0['loss']:.6f} "
        f"vs {loss:.6f} (rel {got['loss_rel']:.2e}, tol {STEP_LOSS_RTOL:g}); whole gradient "
        f"{l2:.2e} in L2 (limit {limits['l2']:.3g}); median tensor {got['median']:.2e} of its "
        f"largest entry (limit {limits['median']:.3g}); worst tensor {got['worst']:.2e} at "
        f"{per[0][1]} (limit {limits['worst']:.3g}); worst BatchNorm statistic "
        f"{stat_err[0]:.2e} at {stat_err[1]} (tol {MESH_STATS_TOL:g}); "
        f"{'within' if ok else 'OUT OF'} limits")
    return {"got": got, "limits": limits, "ok": ok}


def mesh_two_ranks() -> dict:
    """(c) two gloo ranks share the card on one float32 3d3d train step at
    full width, 5 rows each of a global batch of 10, against one process on
    the same 10 rows (:func:`mesh_verdict`, against :func:`mesh_control`
    measured here). Then each side's ms per step over MESH_TIMED_STEPS
    steps."""
    import torch

    from mapfree_tpu_torch.ops import correlation as corr

    cfg, batch = mesh_step_inputs()
    ranks = spawn_mesh_ranks(cfg, batch)
    single = single_mesh_step(cfg, batch)
    state, step, dbatch = single[3]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_TIMED_STEPS):
        step(state, dbatch)
    torch.cuda.synchronize()
    single_ms = 1e3 * (time.perf_counter() - t0) / MESH_TIMED_STEPS
    del state, step, dbatch
    control = mesh_control(cfg, batch, single)
    verdict = mesh_verdict(ranks[0], single, control)
    r0 = ranks[0]
    log(f"[mesh] launches per rank in its first step {[r['step_launches'] for r in ranks]}")
    log(f"[mesh] float32 3d3d step at batch 10: {single_ms:.2f} ms in one process, "
        f"{r0['ms_per_step']:.2f} ms per step on rank 0 of two sharing the card (gloo)")
    for r in ranks:
        if r["step_launches"] != {corr.KERNEL: 1, corr.KERNEL_BWD_ROWS: 1,
                                  corr.KERNEL_BWD_COLS: 1}:
            raise AssertionError(f"a rank's step launched {r['step_launches']}")
    if not verdict["ok"]:
        raise AssertionError("the two ranks' step disagrees with the single-process step")
    launches = {name: sum(r["launches"][name] for r in ranks) for name in ranks[0]["launches"]}
    return {"launches": launches, "single_ms": single_ms, "rank_ms": r0["ms_per_step"]}


def phase_mesh() -> dict:
    """Phase 16: the data mesh on the one card (a), the train CLI under one
    NCCL rank (b), two gloo ranks sharing the card on one train step (c).
    More than one card is not shown here: the machine has one."""
    predictor = mesh_predictor()
    cli = mesh_train_cli()
    ranks = mesh_two_ranks()
    return {"launches": {"mesh_two_replica_sweep": predictor.pop("two_replica_sweep"),
                         "mesh_train_cli_nccl_rank": cli.pop("launches"),
                         "mesh_two_gloo_ranks": ranks.pop("launches")},
            "numbers": {**predictor, **cli, **ranks}}


def timed(name: str, phase, *args):
    """Run one phase and log its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


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
    timed("build", phase_build)
    cases = timed("kernel cases", phase_kernel_cases)
    if "--kernels-only" in sys.argv[1:]:
        # a quick check while working on a kernel; prints no result line
        phase_kernel_timing()
        log(f"[done] kernels only, {time.perf_counter() - t_start:.1f} s")
        return
    timing = timed("kernel timing", phase_kernel_timing)
    sweep_launches = timed("inference path", phase_main_path)
    f32_sweeps = timed("float32 sweeps", phase_f32_sweeps)
    train_launches = timed("training path", phase_train_path)
    timed("device parity", phase_device_parity)
    timed("train parity", phase_train_parity)
    timed("bf16 train parity", phase_train_parity_bf16)
    timed("decode", phase_decode)
    cli_launches = timed("CLIs", phase_clis)
    # the QKV, fusion and other RPR paths, the matching track, the
    # evaluation path, the tools and the mesh: each phase resets the counts
    # just before each path it drives and reads them just after
    later = {"f32_sweeps": f32_sweeps,
             "qkv": timed("QKV path", phase_qkv_path),
             "fusion": timed("fusion path", phase_fusion_path),
             "configs": timed("configs", phase_configs),
             "fusion_clis": timed("fusion CLIs", phase_fusion_clis)}
    with tempfile.TemporaryDirectory() as tmp:
        later["matching"] = timed("matching", phase_matching, Path(tmp) / "mapfree")
        later["evaluation"] = timed("evaluation", phase_evaluation, Path(tmp),
                                    Path(tmp) / "mapfree")
        (Path(tmp) / "tools").mkdir()
        later["tools"] = timed("tools", phase_tools, Path(tmp) / "tools",
                               Path(tmp) / "mapfree")
    later["mesh"] = timed("mesh", phase_mesh)
    later["fma_steps"] = timed("FMA train steps", phase_fma_steps)

    from mapfree_tpu_torch.ops import correlation as corr

    # K1 at the ScanNet RPR sweep's shape (phase 14 b) beside its other shapes
    timing[corr.KERNEL]["scannet_shape"] = later["evaluation"].pop("k1_scannet_shape")

    # launches by kernel and run, and by the C function that served them
    from mapfree_tpu_torch.ops import kabsch

    by_path = {name: {} for name in list(corr.launches) + [kabsch.LIBRARY]}
    by_fn: dict = {}
    runs = {**train_launches, "inference_sweep": sweep_launches}
    runs.update({run: cli_launches[run]
                 for run in ("submission_cli", "train_cli", "submission_cli_checkpoint")})
    for phase in later.values():
        runs.update(phase["launches"])
    for run, counts in runs.items():
        for name, n in counts.items():
            if name == "by_function":
                for fn, m in n.items():
                    by_fn.setdefault(fn, {})[run] = m
            elif n:
                by_path[name][run] = n
    # every bf16 train path took, for all its launches, the tensor-core pair
    # of K2 and K3 that backward_kernel gives its width: wgmma at 128 and 256
    # channels, mma.sync at 32 (every published config) and on the ResNet
    # encoder's 5x4 grid
    for suffix, pair_runs in (
            ("_wgmma", ("resunet128_bf16_steps", "resunet256_train", "resunet256_vs_plain")),
            ("_mma", ("train_loop", "train_cli", "qkv_train", "fusion_train", "fusion_train_cli",
                      "mesh_train_cli_nccl_rank", "resnet_bf16_train", "resnet_bf16_vs_plain"))):
        for name in (corr.KERNEL_BWD_ROWS, corr.KERNEL_BWD_COLS):
            for run in pair_runs:
                want, got = by_path[name].get(run), by_fn.get(name + suffix, {}).get(run)
                if not want or got != want:
                    raise AssertionError(f"{run}: {name} launched {want} times, {got} of them "
                                         f"by {name + suffix}")
    # the Kabsch kernel on every run that counted it, zeros too: one a batch
    # on the sweeps and validation, none in a train step (autograd records)
    kabsch_by_path = {run: counts[kabsch.LIBRARY] for run, counts in runs.items()
                      if kabsch.LIBRARY in counts}
    log(f"[kabsch] launches by path {json.dumps(kabsch_by_path)}")
    paths = {name: phase.get("numbers", {}) for name, phase in later.items()}
    log("[paths] " + json.dumps({"card": smi, **paths}, default=str))
    kernels = []
    # the main path's source first (the mma.sync pair, which the 32-channel
    # train steps take), then the rest
    bwd_sources = ["correlation_bwd_mma.cu", "correlation_bwd_narrow.cu",
                   "correlation_bwd_wgmma.cu"]
    for name, sources, replaces, tc_kernels in (
            (corr.KERNEL, ["correlation_fwd.cu"], 60,
             [corr.KERNEL_FWD_WGMMA, corr.KERNEL_FWD_MMA_SYNC]),
            (corr.KERNEL_BWD_ROWS, bwd_sources + ["correlation_bwd.cu"], 109,
             list(corr.BWD_KERNELS)),
            (corr.KERNEL_BWD_COLS, bwd_sources + ["correlation_bwd.cu"], 148,
             list(corr.BWD_KERNELS))):
        t = timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "designs": [corr.DESIGN_MMA, corr.DESIGN_FMA],
            # each tensor-core design's kernels (correlation.forward_kernel,
            # correlation.backward_kernel): K1 two, K2 and K3 three pairs
            "tensor_core_kernels": tc_kernels,
            "source": f"mapfree_tpu_torch/ops/csrc/{sources[0]}",
            "sources": [f"mapfree_tpu_torch/ops/csrc/{src}" for src in sources],
            "replaces": f"mapfree_tpu/ops/correlation.py:{replaces}",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "launches_by_kernel_and_path": {fn: r for fn, r in sorted(by_fn.items())
                                            if fn.startswith(name)},
            "card": smi,
            **t,
            "cases": cases[name],
        })
    kernels.append({
        "name": kabsch.LIBRARY,
        "route": "cuda where autograd records nothing (geom/procrustes.py::procrustes_route)",
        "source": "mapfree_tpu_torch/ops/csrc/kabsch.cu",
        "sources": ["mapfree_tpu_torch/ops/csrc/kabsch.cu"],
        # no TPU kernel: the JAX package's solve is plain JAX
        "replaces": None,
        "plain_version": "mapfree_tpu_torch/geom/procrustes.py::procrustes_plain",
        "launches": sum(kabsch_by_path.values()),
        "launches_by_path": kabsch_by_path,
        "card": smi,
        **timing[kabsch.LIBRARY],
        "cases": cases[kabsch.LIBRARY],
    })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
