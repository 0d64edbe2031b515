"""The Kabsch kernel (``csrc/kabsch.cu``): batched Procrustes alignment, one
problem a thread, in one launch.

``geom/procrustes.py::procrustes`` hands it the calls that record no
gradient on CUDA (see ``procrustes_route`` there); its tensor version
``procrustes_plain`` is the kernel's yardstick. ``launches`` counts the
kernel's launches since the last :func:`reset_launches`.
"""

from __future__ import annotations

import ctypes

import torch

from mapfree_tpu_torch.ops._build import load_library

LIBRARY = "kabsch"  # csrc/kabsch.cu: the library and its one C function

# kernel launches since the last reset_launches()
launches = 0
_fn = None


def reset_launches() -> None:
    global launches
    launches = 0


def vs_plain_tolerances(A, B, weights=None, exact_h: bool = False):
    """Per problem, how far the kernel's R and t may lie from
    ``procrustes_plain``'s on the same inputs ([n] float64 each, on the CPU):
    the limits that the card's checks hold it to.

    Both run float32, in other orders: the tensor version's sums and 3x3
    products are ATen reductions and cuBLAS batched products, the kernel's a
    fixed serial order. A rounding of H = A_c^T B_c moves R by about itself
    times sigma_0 / sigma_1 (a host emulation of the kernel's arithmetic moved
    R by at most 2.3e-7 times it against the tensor version on the CPU), so R
    agrees to 1e-5 where sigma_0 / sigma_1 <= 10 and to 1e-6 times it beyond.
    t = b_mean - a_mean R^T adds |a_mean|_1 times R's limit and the means'
    own rounding, sums of N terms in other orders (~sqrt(N) x 6e-8 relative:
    2.7e-6 at N = 2,048), held to 1e-5 times max(1, |b_mean|). Where H is
    exact in float32 (``exact_h``: matrices of small integers or halves) both
    take the same rounded steps, and R agrees to 1e-5 whatever the gap."""
    A, B = A.detach().double().cpu(), B.detach().double().cpu()
    w = (torch.ones(A.shape[:2], dtype=torch.float64) if weights is None
         else weights.detach().double().cpu())
    wsum = w.sum(1, keepdim=True)[..., None]
    a_mean = (A * w[..., None]).sum(1, keepdim=True) / wsum
    b_mean = (B * w[..., None]).sum(1, keepdim=True) / wsum
    H = ((A - a_mean) * w[..., None]).transpose(1, 2) @ (B - b_mean)
    S = torch.linalg.svdvals(H)
    gap = torch.where(S[:, 1] > 0, S[:, 0] / S[:, 1], torch.full_like(S[:, 0], float("inf")))
    tol_R = torch.full_like(gap, 1e-5) if exact_h else 1e-5 * torch.clamp(gap / 10, min=1.0)
    tol_t = tol_R * a_mean.abs().sum((1, 2)) + 1e-5 * torch.clamp(b_mean.abs().amax((1, 2)),
                                                                   min=1.0)
    return tol_R, tol_t


def _kabsch_fn():
    global _fn
    if _fn is None:
        fn = load_library(LIBRARY).kabsch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def procrustes_cuda(A, B, weights=None):
    """The kernel on contiguous float32 CUDA tensors: A, B [n, N, 3], weights
    [n, N] or None. Returns R [n, 3, 3] and t [n, 1, 3]; counts one launch."""
    global launches
    inputs = {"A": A, "B": B} if weights is None else {"A": A, "B": B, "weights": weights}
    for name, x in inputs.items():
        if x.device.type != "cuda" or x.device != A.device:
            raise ValueError(f"{name} is on {x.device}; the kernel takes tensors on one CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, {name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if A.dim() != 3 or A.shape[-1] != 3 or B.shape != A.shape or A.shape[1] < 1:
        raise ValueError(f"A and B must be [n, N, 3] of one shape with N >= 1, got "
                         f"{list(A.shape)} and {list(B.shape)}")
    n, N = A.shape[0], A.shape[1]
    if weights is not None and tuple(weights.shape) != (n, N):
        raise ValueError(f"weights must be [n, N] = [{n}, {N}], got {list(weights.shape)}")
    R = torch.empty((n, 3, 3), dtype=torch.float32, device=A.device)
    t = torch.empty((n, 1, 3), dtype=torch.float32, device=A.device)
    if n == 0:
        return R, t
    fn = _kabsch_fn()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), B.data_ptr(), None if weights is None else weights.data_ptr(),
                 R.data_ptr(), t.data_ptr(), n, N, stream)
    if err != 0:
        raise RuntimeError(f"kabsch kernel failed to launch: cudaError_t {err} (n={n}, N={N})")
    launches += 1
    return R, t
