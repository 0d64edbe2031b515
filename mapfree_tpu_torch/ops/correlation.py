"""Fused correlation-volume softmax-warp: the hand-written CUDA kernels K1
(forward), K2 and K3 (backward) behind one ``torch.autograd.Function``.

They replace the TPU kernels of ``mapfree_tpu/ops/correlation.py``:
``_kernel`` (the forward ``pallas_call`` of ``fused_correlation_warp``) and
``_bwd_rows_kernel`` / ``_bwd_cols_kernel`` (the two ``pallas_call``s of
``_fcw_bwd``, its ``custom_vjp``). For q, k [B, HW, Cq] and v [B, HW, Cv] the
forward returns, without materialising the [B, HW, HW] correlation volume,

    warped [B, HW, Cv] = softmax(q k^T) v
    pos    [B, HW, 2]  = softmax(q k^T) grid     (soft-argmax position)
    max    [B, HW, 1]  = max_j softmax(q k^T)    (= 1 / denominator)

all float32, with the uv grid cast to v's dtype first, as the TPU kernel does.
The backward gives dq, dk, dv in the inputs' types (the grid gets none); the
max-score cotangent enters at the FIRST argmax of each row, as on the TPU.

Bounds: at the 3d3d inference shape (B=64, HW=6,256, C=32, bf16) K1 does
3.3e11 FLOP of products and 2.5e9 exponentials against ~0.13 GB of inputs and
outputs, so it is bound by operations (about 0.6 ms of exponentials on an
H100), not by memory; K2 and K3 at the training shape (B=10) are bound the
same way, near 0.1 ms each. The kernels keep every score on chip. The CUDA
sources ``csrc/correlation_fwd.cu``, ``csrc/correlation_bwd.cu`` (K2 and
K3's FMA design), ``csrc/correlation_bwd_mma.cu``,
``csrc/correlation_bwd_narrow.cu`` and ``csrc/correlation_bwd_wgmma.cu``
(their tensor-core design's three pairs) state the arithmetic and the design.

K1 exists in two hand-written designs, and :func:`forward_design` says which
one serves a (dtype, Cq, Cv):

- ``"mma"``: bf16 inputs with Cq and Cv multiples of 8, at any width (every
  config under ``configs/regression/``, the 128- and 256-channel ResUNets and
  the ResNet encoder's 256 and 1,024 channels). Both products run on the
  tensor cores from bf16 tiles in shared memory; the online softmax works on
  the score accumulators, and P goes from them to the second product's
  operand in registers, rounded to bf16 relative to the row's running max
  after each tile of ``FWD_KEY_TILE`` keys. The denominator is summed from
  the float32 P, so the max score (1 / denominator) is not rounded.
  :func:`forward_kernel` picks one of its two kernels, which give the same
  bits: beyond ``FEW_ROWS_HW`` positions with Cq up to ``WGMMA_MAX_CQ`` the
  Hopper kernel (warpgroup products, ``wgmma``, on tiles that TMA copies
  bring in; a producer warp and two or three consumer warpgroups; beyond 128
  v channels column tiles of 128 that each recompute the scores in the same
  order), else the ``mma.sync`` kernel (cp.async copies; q and k streamed in
  channel chunks beyond 128). ``fused_correlation_warp_plain(...,
  bf16_roundings=True)`` rounds at the same place at every width.
- ``"fma"``: float32 inputs (exact float32 arithmetic, no TF32) and bf16
  widths that are not multiples of 8 (widened to float32), at any Cq >= 1
  and Cv >= 0: fused multiply-adds on float32 register tiles. The C function
  picks one of two kernels by shape. Beyond 64 rows (the 3d3d grid) a block
  of 128 query rows walks the keys in tiles of 128, 8 x 8 scores a thread
  from float4 reads of k and q tiles that asynchronous copies bring in
  transposed, P through shared memory once, and P . [v | grid] 8 x 4 a
  thread; v columns beyond 32 (64) in column tiles that each recompute the
  scores in the same order. Up to 64 rows (the ResNet encoder's 5 x 4 grid)
  a block takes one batch element at its real HW and a tile of [v | grid]
  columns, and sums all scores once.

K2 and K3 exist in two hand-written designs too, and :func:`backward_design`
says which one serves a (dtype, Cq, Cv):

- ``"mma"``: bf16 inputs with Cq and Cv multiples of 8, at any width (every
  config under ``configs/regression/``, the 128- and 256-channel ResUNets and
  the ResNet encoder's 1,024 channels). Operands stay bf16 in shared memory,
  brought in by 16-byte asynchronous copies into a ring of stages; every
  product runs on the tensor cores (``mma.sync`` m16n8k16, float32
  accumulators); P and dS go from the first products' accumulators to the
  second products' operands in registers. K2 walks the keys once, with an
  online row max moved lazily (by 2^8 in P) every ``BWD_KEY_TILE`` keys:
  it rounds dS' = e (dP - c), e = exp(s - m) relative to the row's running
  reference m, to bf16, and scales the sum by exp(m - max) / d at the end.
  Where a block's own tiles fit shared memory (Cq and Cv up to 128, and Cq
  up to 256 with Cv up to 96) K2 forms dmain (the cotangent of [warped |
  pos] in bf16) and c = dout . out for its own rows; wider, q and k, dmain
  and [v | grid] stream in channel chunks, the accumulator is cut into
  column tiles of 128, and a prologue kernel launched by K2's C function
  (counted as K2) forms dmain and c. So dmain, P and dS are rounded to bf16 where the other
  design keeps float32; ``bf16_roundings=True`` makes the plain backward
  round at the same places. The design has three pairs of kernels, which
  round at the same places and hand on the same statistics (any K2
  serves any K3), and :func:`backward_kernel` picks one: beyond
  ``FEW_ROWS_HW`` positions with Cq and Cv up to ``WGMMA_MAX_CQ`` a Hopper
  pair (warpgroup products on tiles that TMA copies bring in, no prologue
  kernel): up to 64 channels the narrow pair
  (``csrc/correlation_bwd_narrow.cu``: no producer, warp 0 loads the first
  stages and the last warp done with a stage has it refilled; four consumer
  warpgroups at 128 registers, two at 64 channels in K3, each issuing a
  pass's first products beside the previous pass's second ones) where it
  measured faster than the mma.sync pair (outside ``MMA_SYNC_FASTER``),
  from 65 channels the wgmma pair (``csrc/correlation_bwd_wgmma.cu``: a
  producer warpgroup and one or two consumer warpgroups, the accumulator in
  column tiles that each recompute the same scores); else the ``mma.sync``
  pair described above (the ResNet encoder's 5 x 4 grid and its 1,024
  channels, and the narrow widths of ``MMA_SYNC_FASTER``).
- ``"fma"``: float32 inputs (exact float32 arithmetic, no TF32) and any other
  bf16 shape, at any width. Beyond 64 rows a block of 128 query rows (K2) or
  keys (K3) walks the other side in tiles of 64, with two 8 x 4 register
  tiles a thread (the scores and dP) and channel chunks through a ring of
  asynchronous copies; K2 takes one sweep with an online row max. Up to 64
  rows a block takes one batch element at its real HW and a tile of output
  columns, and sums all scores once.

Every design is a kernel of this package; none gives way to another or to
the plain version.

The Function saves q, k, v, the grid and the forward's output buffer (8.8 MB
at the training shape): with it the softmax VJP's row constant is
c = dout . out and the denominator's reciprocal is the saved max score, so
K2 sweeps the keys once in either design.

For a tensor on the CPU :func:`fused_correlation_warp` computes the plain
versions (:func:`fused_correlation_warp_plain` forward,
:func:`fused_correlation_warp_bwd_plain` backward, through the same
Function); for a CUDA tensor it launches the kernels or raises. ``launches``
counts launches per kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from mapfree_tpu_torch.ops._build import load_library

KERNEL = "correlation_fwd"          # K1: the library and its one function
KERNEL_BWD = "correlation_bwd"      # the library of K2 and K3's FMA design
KERNEL_BWD_MMA = "correlation_bwd_mma"   # ... and of their tensor-core design's mma.sync pair
KERNEL_BWD_WGMMA = "correlation_bwd_wgmma"   # ... and of its wgmma pair
KERNEL_BWD_NARROW = "correlation_bwd_narrow"   # ... and of its narrow wgmma pair (up to 64 channels)
KERNEL_BWD_ROWS = "correlation_bwd_rows"   # K2
KERNEL_BWD_COLS = "correlation_bwd_cols"   # K3
LIBRARIES = (KERNEL, KERNEL_BWD, KERNEL_BWD_MMA, KERNEL_BWD_WGMMA,
             KERNEL_BWD_NARROW)
DESIGN_MMA = "mma"   # bf16 operands on the tensor cores
DESIGN_FMA = "fma"   # float32 tiles, scalar fused multiply-adds
# the "mma" design against the exact plain backward, as a share of each
# gradient's largest magnitude: what rounding dmain, P and dS to bf16 costs.
# tests/test_torch_correlation_mma.py derives it on the CPU from the plain
# backward with the kernels' roundings (K2's one sweep; HW=130 and HW=1,020,
# C=32: up to 6.2e-3), pins it, and shows the factor of 2 at 128 channels
# (7.7e-3); chip_smoke.py holds the kernels to it.
MMA_VS_EXACT_TOL = 2e-2
# the "mma" kernels against the plain backward with the same roundings, as
# the relative L2 error of each gradient: float32 sums in another order,
# exp2 of log2e-scaled scores, and the rare entry of P or dS whose two
# float32 values straddle a bf16 rounding boundary (one bf16 step, 2^-8 of
# that entry; the same test derives how often and how much: up to 5.7e-4 at
# C = 32 and 6.4e-4 at 128 channels, HW 130 and 1,020)
MMA_VS_MATCHED_L2_TOL = 1.5e-3
# the same beyond 128 channels (Cq or Cv): the same test adds score noise of
# 1e-6 of the largest score, as at C = 32, at (136, 136), (256, 256), (1,024,
# 1,024) and 256 / 96, HW 20 and 70 (B = 2: few rows, so one flipped
# rounding in a peaked row is a larger share of the L2 norm), scaled and
# unscaled, two seeds: up to 2.9e-3 in L2 (1,024 unscaled at HW 70), which
# this holds 2.8 times over. Up to 128 channels the C = 32 constant holds
# (1.0e-3 unscaled at HW 70, where 32 channels read 9.2e-4 too)
MMA_VS_MATCHED_L2_TOL_WIDE = 8e-3
# MMA_VS_EXACT_TOL beyond 128 channels: on unscaled inputs the rows are
# peaked and dS = P (dP - c) cancels at the argmax, where dP from the bf16
# dmain misses c by 2^-9 of it; the same cases read up to 2.7e-2 of a
# gradient's largest entry (256 / 96 at HW 20; 1.0e-2 scaled; 7.7e-3 at 128)
MMA_VS_EXACT_TOL_WIDE = 6e-2
# MMA_VS_MATCHED_L2_TOL and MMA_VS_EXACT_TOL keep their factor of 2 over
# the CPU readings where a call has MMA_TOL_MANY_ROWS rows (B x HW) or more
# and Cq, Cv of MMA_TOL_MIN_WIDTH or more. The same test derives both over
# the shapes phase 3 and the cuda tests give the pair up to 128 channels (HW
# 65, 70, 130, 1,000 and 1,020, 8 to 128 channels, q and k scaled as there,
# eight seeds): with fewer rows one flipped rounding is a larger share of
# the L2 norm (up to 1.3e-3), and at 8 and 16 channels dS cancels further at
# the argmax (up to 2.1e-2 of a gradient's largest entry). Those shapes take
# these, each between 2x and 20x of its largest reading there; the C = 32
# constants above are not widened
MMA_VS_MATCHED_L2_TOL_EDGE = 3e-3
MMA_VS_EXACT_TOL_EDGE = 5e-2
MMA_TOL_MANY_ROWS = 1000
MMA_TOL_MIN_WIDTH = 24
# keys per step of the tensor-core K2's online row max (the .cu's TKG, which
# a test reads): the group of the plain backward's one-sweep arithmetic
BWD_KEY_TILE = 16
# how far a row's largest score may pass K2's reference before it moves, in
# log2 units of P (the .cu's LAZY_GAP: P up to 2^8)
BWD_LAZY_GAP_LOG2 = 8.0
# keys per tile of K1's online softmax: the tile of the plain forward with
# the "mma" design's roundings. Both of that design's kernels take it (a test
# reads each one's constant from the .cu: FWD_KEY_TILES)
FWD_KEY_TILE = 64
# the two kernels of K1's "mma" design (forward_kernel picks): warpgroup
# products with TMA copies (sm_90a), and mma.sync with cp.async copies
KERNEL_FWD_WGMMA = "wgmma"
KERNEL_FWD_MMA_SYNC = "mma_sync"
# each kernel's key tile and the name of its constant in the .cu
FWD_KEY_TILES = {KERNEL_FWD_WGMMA: ("TKW", FWD_KEY_TILE), KERNEL_FWD_MMA_SYNC: ("TK", FWD_KEY_TILE)}
# the wgmma kernels keep q (K1; K2 and K3: q and v) resident up to this many channels
WGMMA_MAX_CQ = 256
# the pair of K2 and K3 built for the narrow widths (Cq and Cv up to 64)
KERNEL_BWD_PAIR_NARROW = "narrow"
# the three pairs of K2 and K3 in their "mma" design (backward_kernel picks),
# by name: the library and the suffix of their C functions
BWD_KERNELS = {KERNEL_FWD_WGMMA: (KERNEL_BWD_WGMMA, "_wgmma"),
               KERNEL_FWD_MMA_SYNC: (KERNEL_BWD_MMA, "_mma"),
               KERNEL_BWD_PAIR_NARROW: (KERNEL_BWD_NARROW, "_narrow")}
# the width classes (Cq, Cv) of the narrow pair's instantiations, in the
# order of csrc/correlation_bwd_narrow.cu::dispatch_rows_narrow, and of the
# wgmma pair's, in the order of csrc/correlation_bwd_wgmma.cu::
# dispatch_rows_wgmma: a width takes the first class of the two lists that
# holds it
NARROW_WIDTH_CLASSES = ((16, 16), (16, 32), (32, 32), (64, 64))
WGMMA_WIDTH_CLASSES = ((128, 128), (256, 96), (256, 256))
# the narrow classes where tools/torch_chip_studies.py k23-narrow-variants
# measured the mma.sync pair faster than the narrow one in the same call
# (NVIDIA H100 80GB HBM3, 700 W; the times beside that dispatch and in
# PERF.md): C = 32, the narrow K2 0.3862-0.3971 ms against 0.4101-0.4126 at
# B = 10 but 3.3324-3.4130 against 3.1828-3.2134 at B = 90, its K3
# 0.4441-0.4481 against 0.3863-0.3878; 16 / 32 and 16 the same way. At C =
# 64 the narrow pair is ahead: K2 0.5816-0.5829 against 0.7324-0.7345, K3
# 0.6390-0.6405 against 0.8280-0.8288 at B = 10. The wgmma pair is ahead at
# all its classes
MMA_SYNC_FASTER = {(16, 16), (16, 32), (32, 32)}
# up to this many positions (the ResNet encoder's 5 x 4 grid) K1's "mma"
# design takes the mma.sync kernel, and K2 and K3's the mma.sync pair: a
# 64-row warpgroup product would leave most of its rows empty
# (tools/torch_chip_studies.py k1-wgmma-variants)
FEW_ROWS_HW = 64
# K1's "mma" design against the exact plain forward, as a share of each
# output's largest magnitude (or of 1 where that is smaller): what rounding P
# to bf16 costs (2^-9 of each weight, up to about 2^-9 max |v| in a peaked
# row). tests/test_torch_correlation_fwd_mma.py derives it on the CPU (HW=130
# and HW=1,020, C=32), pins it, and shows it covers 128 to 1,024 channels;
# chip_smoke.py holds the kernel to it.
MMA_FWD_VS_EXACT_TOL = 1e-2
# K1's "mma" design against the plain forward with the same rounding, as the
# relative L2 error of warped and of pos: float32 scores summed in another
# order, exp2 of log2e-scaled scores, and the rare weight whose two float32
# values straddle a bf16 rounding boundary (2^-8 of that weight; over a few
# hundred rows one such flip in a peaked row is 1e-4 in L2, the same test
# derives it). The max score comes from float32 sums alone and is held to the
# exact plain forward at the float32 kernel's tolerance
MMA_FWD_VS_MATCHED_L2_TOL = 5e-4
# the same where the design is wider than the C = 32 derivation reaches (Cq
# above 128 or Cv above 120): with unscaled inputs at 128 to 1,024 channels
# the scores spread wider, rows are more peaked, and one flip moves a row
# further (up to 3.4e-4 in L2 over 40 rows against 1.2e-4 at C = 32); the
# same test derives it at HW 20 and 70. MMA_FWD_VS_EXACT_TOL covers every
# width with its margin and stays the one constant
MMA_FWD_VS_MATCHED_L2_TOL_WIDE = 1e-3
# kernel launches since the last reset_launches(), per kernel
launches = {KERNEL: 0, KERNEL_BWD_ROWS: 0, KERNEL_BWD_COLS: 0}
# the same launches per C function (which design and which of its kernels
# served each; a function's name begins with its kernel's)
kernel_launches: dict = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    kernel_launches.clear()


def forward_design(dtype, Cq: int, Cv: int) -> str:
    """Which hand-written design of K1 serves these inputs on the card:
    ``DESIGN_MMA`` for bf16 with Cq and Cv multiples of 8 (at any width),
    ``DESIGN_FMA`` for float32 and every other shape."""
    if dtype == torch.bfloat16 and Cq % 8 == 0 and Cv % 8 == 0 and Cq >= 8 and Cv >= 8:
        return DESIGN_MMA
    return DESIGN_FMA


def forward_kernel(dtype, HW: int, Cq: int, Cv: int) -> Optional[str]:
    """Which kernel of K1's "mma" design serves these inputs on the card:
    ``KERNEL_FWD_WGMMA`` beyond ``FEW_ROWS_HW`` positions with Cq up to
    ``WGMMA_MAX_CQ``, else ``KERNEL_FWD_MMA_SYNC``; None where the "fma"
    design serves them."""
    if forward_design(dtype, Cq, Cv) != DESIGN_MMA:
        return None
    if HW <= FEW_ROWS_HW or Cq > WGMMA_MAX_CQ:
        return KERNEL_FWD_MMA_SYNC
    return KERNEL_FWD_WGMMA


def mma_forward_matched_l2_tol(Cq: int, Cv: int) -> float:
    """K1's "mma" design against the plain forward with its rounding, as the
    relative L2 error of warped and of pos, at these widths."""
    if Cq <= 128 and Cv <= 120:
        return MMA_FWD_VS_MATCHED_L2_TOL
    return MMA_FWD_VS_MATCHED_L2_TOL_WIDE


def backward_design(dtype, Cq: int, Cv: int) -> str:
    """Which hand-written design of K2 and K3 serves these inputs on the
    card: ``DESIGN_MMA`` for bf16 with Cq and Cv multiples of 8 (at any
    width), ``DESIGN_FMA`` for float32 and every other shape. K2 and K3
    always take the same design."""
    if dtype == torch.bfloat16 and all(c % 8 == 0 and c >= 8 for c in (Cq, Cv)):
        return DESIGN_MMA
    return DESIGN_FMA


def hopper_width_class(Cq: int, Cv: int) -> Optional[tuple]:
    """The class of a Hopper pair's instantiations that takes these widths:
    the narrow pair's (``NARROW_WIDTH_CLASSES``) up to 64 channels, the
    wgmma pair's (``WGMMA_WIDTH_CLASSES``) beyond, or None beyond them."""
    return next(((cq, cv) for cq, cv in NARROW_WIDTH_CLASSES + WGMMA_WIDTH_CLASSES
                 if Cq <= cq and Cv <= cv), None)


def backward_kernel(dtype, HW: int, Cq: int, Cv: int) -> Optional[str]:
    """Which pair of K2 and K3 in their "mma" design serves these inputs on
    the card: beyond ``FEW_ROWS_HW`` positions ``KERNEL_BWD_PAIR_NARROW`` at
    ``NARROW_WIDTH_CLASSES`` and ``KERNEL_FWD_WGMMA`` at
    ``WGMMA_WIDTH_CLASSES``, outside ``MMA_SYNC_FASTER``; else
    ``KERNEL_FWD_MMA_SYNC``; None where the "fma" design serves them. Every
    pair's K2 hands on the same statistics, so any serves any K3."""
    if backward_design(dtype, Cq, Cv) != DESIGN_MMA:
        return None
    width = hopper_width_class(Cq, Cv)
    if HW <= FEW_ROWS_HW or width is None or width in MMA_SYNC_FASTER:
        return KERNEL_FWD_MMA_SYNC
    return KERNEL_BWD_PAIR_NARROW if width in NARROW_WIDTH_CLASSES else KERNEL_FWD_WGMMA


def _edge_shape(Cq: int, Cv: int, rows: Optional[int]) -> bool:
    """Where the C = 32 constants lack their factor of 2 (``rows`` = B x HW
    given): few rows or narrow channels, up to 128 channels."""
    return rows is not None and (rows < MMA_TOL_MANY_ROWS or min(Cq, Cv) < MMA_TOL_MIN_WIDTH)


def mma_backward_matched_l2_tol(Cq: int, Cv: int, rows: Optional[int] = None) -> float:
    """K2 and K3's "mma" design against the plain backward with its
    roundings, as the relative L2 error of each gradient, at these widths
    (and, given, ``rows`` = B x HW)."""
    if Cq > 128 or Cv > 128:
        return MMA_VS_MATCHED_L2_TOL_WIDE
    return MMA_VS_MATCHED_L2_TOL_EDGE if _edge_shape(Cq, Cv, rows) else MMA_VS_MATCHED_L2_TOL


def mma_backward_exact_tol(Cq: int, Cv: int, rows: Optional[int] = None) -> float:
    """K2 and K3's "mma" design against the exact plain backward, as a share
    of each gradient's largest entry (or of 1), at these widths (and, given,
    ``rows`` = B x HW)."""
    if Cq > 128 or Cv > 128:
        return MMA_VS_EXACT_TOL_WIDE
    return MMA_VS_EXACT_TOL_EDGE if _edge_shape(Cq, Cv, rows) else MMA_VS_EXACT_TOL


def dmain_width(Cv: int) -> int:
    """Columns of the bf16 cotangent the "mma" design reads: Cv + 2 rounded
    up to the tensor cores' depth of 16 (rows of a multiple of 32 bytes)."""
    return -(-(Cv + 2) // 16) * 16


class RowPass(NamedTuple):
    """What K2 leaves for K3. ``stats`` [B, HW, 3] float32 (the row's max
    score, not scaled, 1 / denominator relative to it, c) in the "fma"
    design; [B, HW, 4] (log2 of the row's softmax normaliser, 1 /
    denominator, c, the max-score cotangent) in the "mma" design, which also
    hands on ``dmain`` [B, HW, dmain_width(Cv)] bf16. ``amax`` [B, HW] int32
    is each row's first argmax."""
    stats: torch.Tensor
    amax: torch.Tensor
    dmain: Optional[torch.Tensor] = None


def _kernel_fn(library: str, name: str, n_pointers: int):
    """The C function ``name`` of ``library``: ``n_pointers`` pointers, then
    B, HW, Cq, Cv, dtype as ints, then the stream."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load_library(library), name)
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_inputs(q, k, v, grid):
    if q.dim() != 3 or k.shape != q.shape:
        raise ValueError(f"q and k must be [B, HW, Cq] of one shape, got "
                         f"{list(q.shape)} and {list(k.shape)}")
    B, HW, _ = q.shape
    if v.dim() != 3 or tuple(v.shape[:2]) != (B, HW):
        raise ValueError(f"v must be [B, HW, Cv] = [{B}, {HW}, Cv], got {list(v.shape)}")
    if tuple(grid.shape) != (HW, 2):
        raise ValueError(f"grid must be [HW, 2] = [{HW}, 2], got {list(grid.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")


def _check_cuda(q, k, v, grid):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("grid", grid)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(library, name, pointers, q, v, counted=None):
    """Call the C function ``name`` and count one launch of the kernel
    ``counted`` (``name`` itself unless given)."""
    B, HW, Cq = q.shape
    Cv = v.shape[-1]
    fn = _kernel_fn(library, name, len(pointers))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in pointers), B, HW, Cq, Cv,
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel failed to launch: cudaError_t {err} "
                           f"(B={B}, HW={HW}, Cq={Cq}, Cv={Cv}, {q.dtype})")
    launches[counted or name] += 1
    kernel_launches[name] = kernel_launches.get(name, 0) + 1


def _check_aligned(**tensors):
    """The "mma" design copies 16 bytes at a time."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be aligned to 16 bytes for the tensor-core "
                             f"kernels (data_ptr() % 16 = {t.data_ptr() % 16})")


# -- plain versions ------------------------------------------------------------

def _plain_buffer(q, k, v, grid):
    """The dense math of the forward as one [B, HW, Cv + 3] float32 buffer:
    softmax(q k^T), P [v | grid], max P; materialises the [B, HW, HW] volume."""
    B, HW, _ = q.shape
    with torch.autocast(q.device.type, enabled=False):
        vg = torch.cat([v, grid.to(v.dtype).expand(B, HW, 2)], dim=-1).float()
        s = torch.bmm(q.float(), k.float().transpose(1, 2))
        p = torch.softmax(s, dim=-1)
        return torch.cat([torch.bmm(p, vg), p.amax(dim=-1, keepdim=True)], dim=-1)


def _tiled_buffer(q, k, v, grid, bf16_roundings, key_tile):
    """The forward's [B, HW, Cv + 3] float32 buffer by K1's online softmax:
    key tiles of ``key_tile`` in order, a running row max m, P = exp(s - m)
    in float32, the denominator and the accumulator rescaled by
    exp(m_old - m_new) in float32. With ``bf16_roundings`` P is rounded to
    bf16 before its product with [v | grid], as the "mma" design rounds it;
    the denominator is summed from the unrounded P either way."""
    B, HW, _ = q.shape
    with torch.autocast(q.device.type, enabled=False):
        vg = torch.cat([v, grid.to(v.dtype).expand(B, HW, 2)], dim=-1).float()
        qf, kf = q.float(), k.float()
        m = qf.new_full((B, HW, 1), float("-inf"))
        d = qf.new_zeros((B, HW, 1))
        acc = qf.new_zeros((B, HW, vg.shape[-1]))
        for j0 in range(0, HW, key_tile):
            s = torch.bmm(qf, kf[:, j0:j0 + key_tile].transpose(1, 2))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)  # 0 on the first tile
            p = torch.exp(s - m_new)
            d = d * alpha + p.sum(dim=-1, keepdim=True)
            if bf16_roundings:
                p = _round_bf16(p)
            acc = acc * alpha + torch.bmm(p, vg[:, j0:j0 + key_tile])
            m = m_new
        inv = 1.0 / d
        return torch.cat([acc * inv, inv], dim=-1)


def _split(out, Cv):
    return out[..., :Cv], out[..., Cv:Cv + 2], out[..., Cv + 2:]


def fused_correlation_warp_plain(q, k, v, grid, bf16_roundings=False, key_tile=None):
    """Plain forward: (warped, pos, max_score), float32.

    By default the exact dense softmax (the CPU route and the parity tests).
    With ``bf16_roundings`` it is K1's "mma" arithmetic: the online softmax
    over key tiles of ``key_tile`` (default ``FWD_KEY_TILE``) with P rounded
    to bf16 relative to each row's running max, the kernel's yardstick on
    the card. ``key_tile`` alone gives the same tiled arithmetic without the
    rounding. The exact version's autograd gradient splits a tie's max-score
    cotangent evenly; the kernels' and
    :func:`fused_correlation_warp_bwd_plain`'s goes to the first maximum."""
    _check_inputs(q, k, v, grid)
    if bf16_roundings or key_tile is not None:
        buf = _tiled_buffer(q, k, v, grid, bf16_roundings, key_tile or FWD_KEY_TILE)
    else:
        buf = _plain_buffer(q, k, v, grid)
    return _split(buf, v.shape[-1])


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def _bwd_plain_terms(q, k, v, grid, dout, argmax, bf16_roundings=False):
    """P, dS, dmain and the argmax used: the shared part of the plain
    backward. With ``bf16_roundings`` the three are rounded to bf16 where the
    "mma" kernels round them: dmain before the product with [v | grid], P
    before the product that gives dv, dS (formed in float32 from the float32
    P, dP and c) once before the product that gives dk; dq takes K2's one
    sweep instead (:func:`_rows_one_sweep`). The row
    constant c stays float32 and comes from the unrounded cotangent, as the
    prologue kernel forms it from dout . out."""
    _check_inputs(q, k, v, grid)
    B, HW, _ = q.shape
    Cv = v.shape[-1]
    vg = torch.cat([v, grid.to(v.dtype).expand(B, HW, 2)], dim=-1).float()
    dmain = dout[..., :Cv + 2].float()
    d_ms = dout[..., Cv + 2:].float()
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    if argmax is None:
        argmax = s.argmax(dim=-1)  # the first of equal maxima
    p = torch.softmax(s, dim=-1)
    dP = torch.bmm(dmain, vg.transpose(1, 2))
    dP.scatter_add_(2, argmax[..., None], d_ms)
    c = (dP * p).sum(dim=-1, keepdim=True)
    if not bf16_roundings:
        return p, p * (dP - c), dmain, argmax
    dmain = _round_bf16(dmain)
    dP = torch.bmm(dmain, vg.transpose(1, 2))
    dP.scatter_add_(2, argmax[..., None], d_ms)
    return _round_bf16(p), _round_bf16(p * (dP - c)), dmain, argmax


def correlation_bwd_prologue_plain(out, dout):
    """Plain version of the "mma" design's prologue kernel. From the
    forward's buffer ``out`` and its cotangent ``dout`` [B, HW, Cv + 3]
    float32: dmain [B, HW, dmain_width(Cv)] bf16, the cotangent of
    [warped | pos] rounded to bf16 and padded with zeros, and stats
    [B, HW, 4] float32 = (0, 1 / denominator, c, max-score cotangent) with
    c = dout . out; K2 fills the first column (the log2 of the row's
    softmax normaliser)."""
    Cv = out.shape[-1] - 3
    dmain = dout.new_zeros((*dout.shape[:-1], dmain_width(Cv)), dtype=torch.bfloat16)
    dmain[..., :Cv + 2] = dout[..., :Cv + 2].to(torch.bfloat16)
    c = (dout.float() * out.float()).sum(dim=-1)
    stats = torch.stack([torch.zeros_like(c), out[..., Cv + 2].float(), c,
                         dout[..., Cv + 2].float()], dim=-1)
    return dmain, stats


def _rows_one_sweep(q, k, v, grid, dout, argmax, key_tile, bf16_roundings):
    """dq by the tensor-core K2's arithmetic: one sweep over key groups of
    ``key_tile`` (the kernel's ``BWD_KEY_TILE``) with a reference m per row that moves to the row's largest
    score so far once that passes it by 2^BWD_LAZY_GAP_LOG2 in P (the sum
    rescaled by exp(m_old - m_new) then), dS' = exp(s - m) (dP - c) with dP
    from dmain alone (rounded to bf16, as dmain is, with ``bf16_roundings``)
    summed against k, and at the end dq = (exp(m - M) acc + d_ms k_amax) / d
    with M the row's max and 1 / d = max P. The row constant c comes from the
    unrounded cotangent, as from dout . out."""
    B, HW, _ = q.shape
    Cv = v.shape[-1]
    vg = torch.cat([v, grid.to(v.dtype).expand(B, HW, 2)], dim=-1).float()
    kf = k.float()
    dmain = dout[..., :Cv + 2].float()
    d_ms = dout[..., Cv + 2:].float()
    s = torch.bmm(q.float(), kf.transpose(1, 2))
    if argmax is None:
        argmax = s.argmax(dim=-1)
    M = s.amax(dim=-1, keepdim=True)
    p = torch.softmax(s, dim=-1)
    dP = torch.bmm(dmain, vg.transpose(1, 2))
    c = ((dP.scatter_add(2, argmax[..., None], d_ms)) * p).sum(dim=-1, keepdim=True)
    inv_d = p.amax(dim=-1, keepdim=True)
    if bf16_roundings:
        dP = torch.bmm(_round_bf16(dmain), vg.transpose(1, 2))
    gap = BWD_LAZY_GAP_LOG2 * math.log(2.0)
    m = s.new_full((B, HW, 1), float("-inf"))
    best = m.clone()
    acc = s.new_zeros((B, HW, kf.shape[-1]))
    for j0 in range(0, HW, key_tile):
        sj = s[..., j0:j0 + key_tile]
        best = torch.maximum(best, sj.amax(dim=-1, keepdim=True))
        moved = best > m + gap
        m_new = torch.where(moved, best, m)
        acc = torch.where(moved, acc * torch.exp(m - m_new), acc)
        ds = torch.exp(sj - m_new) * (dP[..., j0:j0 + key_tile] - c)
        if bf16_roundings:
            ds = _round_bf16(ds)
        acc = acc + torch.bmm(ds, kf[:, j0:j0 + key_tile])
        m = m_new
    k_amax = kf.gather(1, argmax[..., None].expand(B, HW, kf.shape[-1]))
    return (acc * torch.exp(m - M) + d_ms * k_amax) * inv_d, argmax


def correlation_bwd_rows_plain(q, k, v, grid, dout, argmax=None, bf16_roundings=False):
    """Plain version of K2: dq [B, HW, Cq] float32 and the argmax [B, HW].
    With ``bf16_roundings`` dq takes the tensor-core K2's one-sweep
    arithmetic (:func:`fused_correlation_warp_bwd_plain`)."""
    with torch.autocast(q.device.type, enabled=False):
        if bf16_roundings:
            _check_inputs(q, k, v, grid)
            return _rows_one_sweep(q, k, v, grid, dout, argmax, BWD_KEY_TILE, True)
        _, dS, _, argmax = _bwd_plain_terms(q, k, v, grid, dout, argmax)
        return torch.bmm(dS, k.float()), argmax


def correlation_bwd_cols_plain(q, k, v, grid, dout, argmax=None, bf16_roundings=False):
    """Plain version of K3: dk [B, HW, Cq] and dv [B, HW, Cv] float32."""
    with torch.autocast(q.device.type, enabled=False):
        p, dS, dmain, _ = _bwd_plain_terms(q, k, v, grid, dout, argmax, bf16_roundings)
        return (torch.bmm(dS.transpose(1, 2), q.float()),
                torch.bmm(p.transpose(1, 2), dmain[..., :v.shape[-1]]))


def fused_correlation_warp_bwd_plain(q, k, v, grid, dout, argmax=None, bf16_roundings=False):
    """The dense arithmetic of K2 and K3, written out.

    Args:
        q, k, v, grid: the forward's inputs.
        dout: [B, HW, Cv + 3] float32 cotangent of the forward's buffer
            (warped, pos, max score).
        argmax: optional [B, HW] int64 column that takes each row's max-score
            cotangent; by default the first maximum of the float32 scores.
        bf16_roundings: the "mma" design's arithmetic (the yardstick for
            those kernels): dmain, P and dS rounded to bf16 where K3 rounds
            them, and dq by K2's one sweep over groups of ``BWD_KEY_TILE``
            keys, dS rounded relative to each row's running reference; the
            default is the exact float32 arithmetic.
    Returns:
        dq [B, HW, Cq], dk [B, HW, Cq], dv [B, HW, Cv] float32, and the
        argmax [B, HW] int64 used.
    """
    with torch.autocast(q.device.type, enabled=False):
        p, dS, dmain, argmax = _bwd_plain_terms(q, k, v, grid, dout, argmax, bf16_roundings)
        if bf16_roundings:
            dq, _ = _rows_one_sweep(q, k, v, grid, dout, argmax, BWD_KEY_TILE, True)
        else:
            dq = torch.bmm(dS, k.float())
        dk = torch.bmm(dS.transpose(1, 2), q.float())
        dv = torch.bmm(p.transpose(1, 2), dmain[..., :v.shape[-1]])
    return dq, dk, dv, argmax


# -- kernels ---------------------------------------------------------------------

def _forward_cuda(q, k, v, grid, kernel=None):
    """K1 on CUDA tensors by the design :func:`forward_design` names (in the
    "mma" design by the kernel :func:`forward_kernel` names, or ``kernel``
    where a test asks for one); each counts as one launch of K1."""
    B, HW, Cq = q.shape
    Cv = v.shape[-1]
    out = torch.empty((B, HW, Cv + 3), dtype=torch.float32, device=q.device)
    if forward_design(q.dtype, Cq, Cv) == DESIGN_MMA:
        _check_aligned(q=q, k=k, v=v)
        if grid.data_ptr() % 4:  # the grid goes in 4 bytes (one key) at a time
            raise ValueError(f"grid must be aligned to 4 bytes for the tensor-core "
                             f"kernels (data_ptr() % 4 = {grid.data_ptr() % 4})")
        kernel = kernel or forward_kernel(q.dtype, HW, Cq, Cv)
        if kernel not in FWD_KEY_TILES:
            raise ValueError(f"K1's tensor-core design has no kernel {kernel!r}")
        name = KERNEL + ("_wgmma" if kernel == KERNEL_FWD_WGMMA else "_mma")
        _launch(KERNEL, name, (q, k, v, grid, out), q, v, counted=KERNEL)
    else:
        _launch(KERNEL, KERNEL, (q, k, v, grid, out), q, v)
    return out


def _backward_pair(q, v, kernel):
    """The library and C-function suffix of the "mma" design's pair that
    serves these inputs (``backward_kernel``), or of ``kernel`` where a test
    asks for one by name."""
    _, HW, Cq = q.shape
    kernel = kernel or backward_kernel(q.dtype, HW, Cq, v.shape[-1])
    if kernel not in BWD_KERNELS:
        raise ValueError(f"K2 and K3's tensor-core design has no kernel {kernel!r}")
    return BWD_KERNELS[kernel]


def correlation_bwd_rows(q, k, v, grid, out, dout, kernel=None):
    """K2 on CUDA tensors: dq [B, HW, Cq] float32 and the :class:`RowPass`
    that K3 takes, by the design :func:`backward_design` names (in the "mma"
    design by the pair :func:`backward_kernel` names, or ``kernel``). In the
    mma.sync pair at the widths whose operands stream one call runs the
    prologue kernel, then the row pass; it counts as one launch of K2."""
    B, HW, Cq = q.shape
    Cv = v.shape[-1]
    dq = torch.empty((B, HW, Cq), dtype=torch.float32, device=q.device)
    amax = torch.empty((B, HW), dtype=torch.int32, device=q.device)
    if backward_design(q.dtype, Cq, Cv) == DESIGN_MMA:
        stats = torch.empty((B, HW, 4), dtype=torch.float32, device=q.device)
        dmain = torch.empty((B, HW, dmain_width(Cv)), dtype=torch.bfloat16, device=q.device)
        _check_aligned(q=q, k=k, v=v, dq=dq, stats=stats, dmain=dmain)
        library, suffix = _backward_pair(q, v, kernel)
        _launch(library, KERNEL_BWD_ROWS + suffix,
                (q, k, v, grid, out, dout, dq, stats, amax, dmain), q, v,
                counted=KERNEL_BWD_ROWS)
        return dq, RowPass(stats, amax, dmain)
    stats = torch.empty((B, HW, 3), dtype=torch.float32, device=q.device)
    _launch(KERNEL_BWD, KERNEL_BWD_ROWS, (q, k, v, grid, out, dout, dq, stats, amax), q, v)
    return dq, RowPass(stats, amax)


def correlation_bwd_cols(q, k, v, grid, dout, rows: RowPass, kernel=None):
    """K3 on CUDA tensors: dk [B, HW, Cq] and dv [B, HW, Cv] float32, from
    what K2 left (``rows``, from either of the "mma" design's K2 kernels),
    by the same design as K2 and the pair :func:`backward_kernel` names (or
    ``kernel``)."""
    B, HW, Cq = q.shape
    dk = torch.empty((B, HW, Cq), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, HW, v.shape[-1]), dtype=torch.float32, device=q.device)
    if backward_design(q.dtype, Cq, v.shape[-1]) == DESIGN_MMA:
        if rows.dmain is None:
            raise ValueError("the tensor-core column pass needs the row pass's bf16 dmain")
        _check_aligned(q=q, k=k, v=v, dmain=rows.dmain, stats=rows.stats, dk=dk, dv=dv)
        library, suffix = _backward_pair(q, v, kernel)
        _launch(library, KERNEL_BWD_COLS + suffix,
                (q, k, v, grid, rows.dmain, rows.stats, rows.amax, dk, dv), q, v,
                counted=KERNEL_BWD_COLS)
        return dk, dv
    _launch(KERNEL_BWD, KERNEL_BWD_COLS,
            (q, k, v, grid, dout, rows.stats, rows.amax, dk, dv), q, v)
    return dk, dv


class _FusedCorrelationWarp(torch.autograd.Function):
    """Returns the one [B, HW, Cv + 3] buffer, so that the backward gets one
    dense cotangent; the wrapper slices it outside."""

    @staticmethod
    def forward(ctx, q, k, v, grid):
        out = _plain_buffer(q, k, v, grid) if q.device.type == "cpu" \
            else _forward_cuda(q, k, v, grid)
        ctx.save_for_backward(q, k, v, grid, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, grid, out = ctx.saved_tensors
        # the cotangent may be an expanded zero or a strided view
        dout = dout.to(torch.float32).contiguous()
        if q.device.type == "cpu":
            dq, dk, dv, _ = fused_correlation_warp_bwd_plain(q, k, v, grid, dout)
        else:
            dq, rows = correlation_bwd_rows(q, k, v, grid, out, dout)
            dk, dv = correlation_bwd_cols(q, k, v, grid, dout, rows)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def fused_correlation_warp(q, k, v, grid):
    """Softmax cross-view warp without materialising the correlation volume.

    Args:
        q: [B, HW, Cq] query features (view 0).
        k: [B, HW, Cq] key features (view 1).
        v: [B, HW, Cv] value features warped into view 0's frame.
        grid: [HW, 2] uv grid appended to the values (soft-argmax position).
    Returns:
        warped [B, HW, Cv], pos [B, HW, 2], max_score [B, HW, 1], float32:
        views into one [B, HW, Cv + 3] buffer. Differentiable in q, k and v.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_correlation_warp runs on CPU or CUDA, not {q.device}")
    _check_inputs(q, k, v, grid)
    if q.device.type == "cuda":
        grid = grid.to(device=q.device, dtype=v.dtype)
        _check_cuda(q, k, v, grid)
    return _split(_FusedCorrelationWarp.apply(q, k, v, grid.detach()), v.shape[-1])
