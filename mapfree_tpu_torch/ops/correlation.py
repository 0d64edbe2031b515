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
sources ``csrc/correlation_fwd.cu`` and ``csrc/correlation_bwd.cu`` state the
arithmetic and the design.

The Function saves q, k, v, the grid and the forward's output buffer (8.8 MB
at the training shape): with it the softmax VJP's row constant is
c = dout . out, so K2 sweeps the keys twice instead of three times.

For a tensor on the CPU :func:`fused_correlation_warp` computes the plain
versions (:func:`fused_correlation_warp_plain` forward,
:func:`fused_correlation_warp_bwd_plain` backward, through the same
Function); for a CUDA tensor it launches the kernels or raises. ``launches``
counts launches per kernel.
"""

from __future__ import annotations

import ctypes

import torch

from mapfree_tpu_torch.ops._build import load_library

KERNEL = "correlation_fwd"          # K1: the library and its one function
KERNEL_BWD = "correlation_bwd"      # the library of K2 and K3
KERNEL_BWD_ROWS = "correlation_bwd_rows"   # K2
KERNEL_BWD_COLS = "correlation_bwd_cols"   # K3
LIBRARIES = (KERNEL, KERNEL_BWD)
# kernel launches since the last reset_launches(), per kernel
launches = {KERNEL: 0, KERNEL_BWD_ROWS: 0, KERNEL_BWD_COLS: 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def _launch(library, name, pointers, q, v):
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
    launches[name] += 1


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


def _split(out, Cv):
    return out[..., :Cv], out[..., Cv:Cv + 2], out[..., Cv + 2:]


def fused_correlation_warp_plain(q, k, v, grid):
    """Plain forward: (warped, pos, max_score), float32. Its autograd
    gradient splits a tie's max-score cotangent evenly; the kernels' and
    :func:`fused_correlation_warp_bwd_plain`'s goes to the first maximum."""
    _check_inputs(q, k, v, grid)
    return _split(_plain_buffer(q, k, v, grid), v.shape[-1])


def _bwd_plain_terms(q, k, v, grid, dout, argmax):
    """P, dS, dmain and the argmax used: the shared part of the plain backward."""
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
    return p, p * (dP - c), dmain, argmax


def correlation_bwd_rows_plain(q, k, v, grid, dout, argmax=None):
    """Plain version of K2: dq [B, HW, Cq] float32 and the argmax [B, HW]."""
    with torch.autocast(q.device.type, enabled=False):
        _, dS, _, argmax = _bwd_plain_terms(q, k, v, grid, dout, argmax)
        return torch.bmm(dS, k.float()), argmax


def correlation_bwd_cols_plain(q, k, v, grid, dout, argmax=None):
    """Plain version of K3: dk [B, HW, Cq] and dv [B, HW, Cv] float32."""
    with torch.autocast(q.device.type, enabled=False):
        p, dS, dmain, _ = _bwd_plain_terms(q, k, v, grid, dout, argmax)
        return (torch.bmm(dS.transpose(1, 2), q.float()),
                torch.bmm(p.transpose(1, 2), dmain[..., :v.shape[-1]]))


def fused_correlation_warp_bwd_plain(q, k, v, grid, dout, argmax=None):
    """The dense arithmetic of K2 and K3, written out.

    Args:
        q, k, v, grid: the forward's inputs.
        dout: [B, HW, Cv + 3] float32 cotangent of the forward's buffer
            (warped, pos, max score).
        argmax: optional [B, HW] int64 column that takes each row's max-score
            cotangent; by default the first maximum of the float32 scores.
    Returns:
        dq [B, HW, Cq], dk [B, HW, Cq], dv [B, HW, Cv] float32, and the
        argmax [B, HW] int64 used.
    """
    with torch.autocast(q.device.type, enabled=False):
        p, dS, dmain, argmax = _bwd_plain_terms(q, k, v, grid, dout, argmax)
        dq = torch.bmm(dS, k.float())
        dk = torch.bmm(dS.transpose(1, 2), q.float())
        dv = torch.bmm(p.transpose(1, 2), dmain[..., :v.shape[-1]])
    return dq, dk, dv, argmax


# -- kernels ---------------------------------------------------------------------

def _forward_cuda(q, k, v, grid):
    B, HW, _ = q.shape
    out = torch.empty((B, HW, v.shape[-1] + 3), dtype=torch.float32, device=q.device)
    _launch(KERNEL, KERNEL, (q, k, v, grid, out), q, v)
    return out


def correlation_bwd_rows(q, k, v, grid, out, dout):
    """K2 on CUDA tensors: dq [B, HW, Cq] float32, the per-row statistics
    [B, HW, 3] float32 (row max in the log2 domain, 1 / denominator, c) and
    the first argmax [B, HW] int32."""
    B, HW, Cq = q.shape
    dq = torch.empty((B, HW, Cq), dtype=torch.float32, device=q.device)
    stats = torch.empty((B, HW, 3), dtype=torch.float32, device=q.device)
    amax = torch.empty((B, HW), dtype=torch.int32, device=q.device)
    _launch(KERNEL_BWD, KERNEL_BWD_ROWS, (q, k, v, grid, out, dout, dq, stats, amax), q, v)
    return dq, stats, amax


def correlation_bwd_cols(q, k, v, grid, dout, stats, amax):
    """K3 on CUDA tensors: dk [B, HW, Cq] and dv [B, HW, Cv] float32, from
    the statistics K2 wrote."""
    B, HW, Cq = q.shape
    dk = torch.empty((B, HW, Cq), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, HW, v.shape[-1]), dtype=torch.float32, device=q.device)
    _launch(KERNEL_BWD, KERNEL_BWD_COLS, (q, k, v, grid, dout, stats, amax, dk, dv), q, v)
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
            dq, stats, amax = correlation_bwd_rows(q, k, v, grid, out, dout)
            dk, dv = correlation_bwd_cols(q, k, v, grid, dout, stats, amax)
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
