"""Fused correlation-volume softmax-warp: the hand-written CUDA kernel K1.

Replaces the TPU kernel ``mapfree_tpu/ops/correlation.py::_kernel`` (the
forward ``pallas_call`` of ``fused_correlation_warp``). For q, k [B, HW, Cq]
and v [B, HW, Cv] it returns, without materialising the [B, HW, HW]
correlation volume,

    warped [B, HW, Cv] = softmax(q k^T) v
    pos    [B, HW, 2]  = softmax(q k^T) grid     (soft-argmax position)
    max    [B, HW, 1]  = max_j softmax(q k^T)    (= 1 / denominator)

all float32, with the uv grid cast to v's dtype first, as the TPU kernel does.

Bound at the 3d3d main path (B=64, HW=6,256, C=32, bf16): 3.3e11 FLOP of
products and 2.5e9 exponentials against ~0.13 GB of inputs and outputs, so
it is bound by operations (about 0.6 ms of exponentials on an H100), not by
memory; the kernel keeps every score on chip. The CUDA source
``csrc/correlation_fwd.cu`` states the arithmetic and the design.

For a tensor on the CPU :func:`fused_correlation_warp` computes the plain
version (:func:`fused_correlation_warp_plain`); for a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from mapfree_tpu_torch.ops._build import load_library

KERNEL = "correlation_fwd"
# kernel launches since the last reset (set it to 0 to start a count)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = load_library(KERNEL).correlation_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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


def fused_correlation_warp_plain(q, k, v, grid):
    """The dense math of the same function: softmax(q k^T), P [v | grid],
    max P — float32, materialising the [B, HW, HW] volume."""
    _check_inputs(q, k, v, grid)
    B, HW, _ = q.shape
    Cv = v.shape[-1]
    with torch.autocast(q.device.type, enabled=False):
        vg = torch.cat([v, grid.to(v.dtype).expand(B, HW, 2)], dim=-1).float()
        s = torch.bmm(q.float(), k.float().transpose(1, 2))
        p = torch.softmax(s, dim=-1)
        out = torch.bmm(p, vg)
        max_score = p.amax(dim=-1, keepdim=True)
    return out[..., :Cv], out[..., Cv:], max_score


def fused_correlation_warp(q, k, v, grid):
    """Softmax cross-view warp without materialising the correlation volume.

    Args:
        q: [B, HW, Cq] query features (view 0).
        k: [B, HW, Cq] key features (view 1).
        v: [B, HW, Cv] value features warped into view 0's frame.
        grid: [HW, 2] uv grid appended to the values (soft-argmax position).
    Returns:
        warped [B, HW, Cv], pos [B, HW, 2], max_score [B, HW, 1], float32:
        views into one [B, HW, Cv + 3] buffer.
    """
    global launches
    if q.device.type == "cpu":
        return fused_correlation_warp_plain(q, k, v, grid)
    if q.device.type != "cuda":
        raise ValueError(f"fused_correlation_warp runs on CPU or CUDA, not {q.device}")
    _check_inputs(q, k, v, grid)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, not {q.dtype}")
    grid = grid.to(device=q.device, dtype=v.dtype)
    for name, t in (("q", q), ("k", k), ("v", v), ("grid", grid)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, HW, Cq = q.shape
    Cv = v.shape[-1]
    out = torch.empty((B, HW, Cv + 3), dtype=torch.float32, device=q.device)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), grid.data_ptr(),
                 out.data_ptr(), B, HW, Cq, Cv, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel failed to launch: cudaError_t {err} "
                           f"(B={B}, HW={HW}, Cq={Cq}, Cv={Cv}, {q.dtype})")
    launches += 1
    return out[..., :Cv], out[..., Cv:Cv + 2], out[..., Cv + 2:]
