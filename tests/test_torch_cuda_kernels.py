"""PyTorch port: the CUDA kernels K1, K2 and K3 on the card against their
plain PyTorch versions (``mapfree_tpu_torch/ops/correlation.py``), through the
wrapper and the autograd Function a model calls.

Every case needs a card (``cuda`` marker) and skips without one; the file
imports no JAX and nothing of the JAX package, so that it runs on a machine
with a card and PyTorch alone:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

The plain versions are what the CPU route computes, and the CPU tests hold
them against the JAX package (``tests/test_torch_ops.py``,
``test_torch_correlation_bwd.py``, ``test_torch_correlation_wide.py``).
"""

import numpy as np
import pytest
import torch

from mapfree_tpu_torch.models.aggregators import _uv_grid
from mapfree_tpu_torch.ops import correlation as pt_corr

from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where there is none (decided at run
    time, never at import, so every test process collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _qkv(B=2, H=10, W=13, C=32, seed=0, cv=None):
    rng = np.random.default_rng(seed)
    HW = H * W
    q, k = (rng.normal(size=(B, HW, C)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, HW, cv or C)).astype(np.float32)
    return q, k, v, _uv_grid(H, W).numpy()


def _to(device, dtype, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype) for a in arrays]


@pytest.mark.cuda
def test_k1_cuda_kernel_matches_plain(cuda_device):
    """The CUDA kernel against its plain version on the card: f32 with a
    ragged HW and Cq != Cv (the FMA design; tolerance 5e-5 for exp2 of
    scaled scores and another summation order), and bf16 inputs (the
    tensor-core design, which rounds P to bf16: MMA_FWD_VS_EXACT_TOL of each
    output's largest entry against the exact plain forward, the max score at
    the float32 tolerance)."""
    for cq, td, atol in ((32, torch.float32, 5e-5), (16, torch.float32, 5e-5),
                         (32, torch.bfloat16, pt_corr.MMA_FWD_VS_EXACT_TOL)):
        q, k, v, grid = _qkv()
        args = _to(cuda_device, td, q[..., :cq], k[..., :cq], v)
        g = torch.from_numpy(grid).to(cuda_device)
        before = pt_corr.launches[pt_corr.KERNEL]
        out = pt_corr.fused_correlation_warp(*args, g)
        torch.cuda.synchronize()
        assert pt_corr.launches[pt_corr.KERNEL] == before + 1
        ref = pt_corr.fused_correlation_warp_plain(*args, g)
        for i, (o, r) in enumerate(zip(out, ref)):
            if td == torch.bfloat16:
                tol = atol * max(1.0, float(r.abs().max())) if i < 2 else 5e-5
            else:
                tol = atol
            torch.testing.assert_close(o, r, atol=tol, rtol=0)


# (Cq, Cv, H, W, B): the tensor-core K1 beyond the widths it took before:
# the 128-channel ResUNet (Cv + 2 = 130, q resident, one column tile) on a
# ragged grid, and the ResNet bottleneck's 1,024 channels on its 5x4 grid (q
# and k streamed in channel chunks, eight column tiles of the accumulator)
WIDE_CASES = [(128, 128, 10, 13, 2), (1024, 1024, 4, 5, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("cq,cv,H,W,B", WIDE_CASES,
                         ids=[f"q{c[0]}_v{c[1]}_hw{c[2] * c[3]}" for c in WIDE_CASES])
def test_k1_cuda_wide_tensor_cores_match_plain(cuda_device, cq, cv, H, W, B):
    """bf16 at 128 and 1,024 channels goes to the tensor-core design in one
    launch, held to the plain forward with its bf16 rounding of P (relative
    L2 of warped and pos, ``mma_forward_matched_l2_tol``), to the exact one
    (MMA_FWD_VS_EXACT_TOL of each output's largest entry) and, in the max
    score, to the exact one at the float32 tolerance. q and k are scaled by
    (32 / C)^(1/4), so that their scores spread as at 32 channels."""
    assert pt_corr.forward_design(torch.bfloat16, cq, cv) == pt_corr.DESIGN_MMA
    q, k, v, grid = _qkv(B, H, W, cq, seed=cq + H * W, cv=cv)
    scale = (32.0 / cq) ** 0.25
    args = _to(cuda_device, torch.bfloat16, scale * q, scale * k, v)
    g = torch.from_numpy(grid).to(cuda_device)
    before = dict(pt_corr.launches)
    out = pt_corr.fused_correlation_warp(*args, g)
    torch.cuda.synchronize()
    assert pt_corr.launches[pt_corr.KERNEL] == before[pt_corr.KERNEL] + 1
    exact = pt_corr.fused_correlation_warp_plain(*args, g)
    matched = pt_corr.fused_correlation_warp_plain(*args, g, bf16_roundings=True)
    l2_tol = pt_corr.mma_forward_matched_l2_tol(cq, cv)
    for o, r, m in zip(out[:2], exact[:2], matched[:2]):
        assert torch.isfinite(o).all()
        torch.testing.assert_close(
            o, r, atol=pt_corr.MMA_FWD_VS_EXACT_TOL * max(1.0, float(r.abs().max())), rtol=0)
        assert float((o - m).norm() / m.norm()) <= l2_tol
    torch.testing.assert_close(out[2], exact[2], atol=5e-5, rtol=0)


# (name, B, H, W, Cq, Cv, dtype, scale of q and k, atol): K1's FMA design at
# the edges of its two kernels (ops/csrc/correlation_fwd.cu::dispatch_fma):
# the 3d3d grid (ragged last row and key tiles), HW below the long-rows
# kernel's row tile of 128, the few-rows kernel's largest HW (64) with one
# below and one above, Cq != Cv on each kernel, the ResNet bottleneck's 1,024
# channels on its 5x4 grid scaled by (32 / C)^(1/4) and unscaled (scores up
# to some 150), and a bf16 width that is not a multiple of 8 on each kernel.
# tests/test_torch_correlation_f32.py holds the plain forward to the JAX
# kernel at the same shapes.
FMA_EDGES = [
    ("3d3d_hw6256", 2, 92, 68, 32, 32, torch.float32, 1.0, 5e-5),
    ("hw100_below_row_tile", 2, 10, 10, 32, 32, torch.float32, 1.0, 5e-5),
    ("hw63", 2, 7, 9, 32, 32, torch.float32, 1.0, 5e-5),
    ("hw64", 2, 8, 8, 32, 32, torch.float32, 1.0, 5e-5),
    ("hw65", 2, 5, 13, 32, 32, torch.float32, 1.0, 5e-5),
    ("hw130_q16_v32", 2, 10, 13, 16, 32, torch.float32, 1.0, 5e-5),
    ("hw20_q24_v40", 2, 4, 5, 24, 40, torch.float32, 1.0, 5e-5),
    ("hw20_c1024_scaled", 2, 4, 5, 1024, 1024, torch.float32, (32 / 1024) ** 0.25, 5e-5),
    ("hw20_c1024_unscaled", 2, 4, 5, 1024, 1024, torch.float32, 1.0, 5e-5),
    ("hw20_c12_bf16", 2, 4, 5, 12, 12, torch.bfloat16, 1.0, 1e-3),
    ("hw130_c12_bf16", 2, 10, 13, 12, 12, torch.bfloat16, 1.0, 1e-3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,H,W,cq,cv,td,scale,atol", FMA_EDGES,
                         ids=[c[0] for c in FMA_EDGES])
def test_k1_cuda_fma_edges_match_plain(cuda_device, name, B, H, W, cq, cv, td, scale, atol):
    """K1's FMA design in one launch against the exact plain forward on the
    same inputs (float32: 5e-5 for exp2 of log2e-scaled scores and another
    summation order; bf16 inputs, widened to float32 on both sides: 1e-3);
    a second run gives the same bits (fixed summation orders, no atomics)."""
    assert pt_corr.forward_design(td, cq, cv) == pt_corr.DESIGN_FMA
    q, k, v, grid = _qkv(B, H, W, cq, seed=len(name) + H * W + cq, cv=cv)
    args = _to(cuda_device, td, scale * q, scale * k, v)
    g = torch.from_numpy(grid).to(cuda_device)
    before = pt_corr.launches[pt_corr.KERNEL]
    out = pt_corr.fused_correlation_warp(*args, g)
    torch.cuda.synchronize()
    assert pt_corr.launches[pt_corr.KERNEL] == before + 1
    ref = pt_corr.fused_correlation_warp_plain(*args, g)
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all()
        torch.testing.assert_close(o, r, atol=atol, rtol=0)
    again = pt_corr.fused_correlation_warp(*args, g)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(4, 5), (7, 10)], ids=["hw20", "hw70"])
def test_k1_cuda_fma_max_score_at_large_scores(cuda_device, H, W):
    """K1's FMA design where the scores are near 3,300 (1,024 channels,
    q = k = 1 + |N(0, 1)|, as positive features give): each row's own key
    wins by hundreds, so P is one-hot, warped is that key's v and the max
    score 1. A max score taken against a rounded max log2e instead of the
    row's own P is off by up to 2^(ulp / 2) - 1, some 1.7e-4 here, which the
    5e-5 of the other cases would not see at scores near 100."""
    rng = np.random.default_rng(H * W)
    q = 1.0 + np.abs(rng.normal(size=(2, H * W, 1024))).astype(np.float32)
    v = rng.normal(size=(2, H * W, 32)).astype(np.float32)
    args = _to(cuda_device, torch.float32, q, q, v)
    g = torch.from_numpy(_uv_grid(H, W).numpy()).to(cuda_device)
    assert pt_corr.forward_design(torch.float32, 1024, 32) == pt_corr.DESIGN_FMA
    out = pt_corr.fused_correlation_warp(*args, g)
    ref = pt_corr.fused_correlation_warp_plain(*args, g)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, atol=5e-5, rtol=0)
    torch.testing.assert_close(out[2], torch.ones_like(out[2]), atol=5e-5, rtol=0)


def _torch_grads(fn, q, k, v, grid, w, dtype, device):
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype).requires_grad_(True)
               for a in (q, k, v))
    out = fn(q, k, v, torch.from_numpy(grid).to(device))
    loss = sum((o * torch.from_numpy(ww).to(device)).sum() for o, ww in zip(out, w))
    loss.backward()
    return [t.grad for t in (q, k, v)]


@pytest.mark.cuda
def test_cuda_backward_kernels_match_plain(cuda_device):
    """K2 and K3 on the card against the plain backward, through the
    Function, by the design that serves the inputs. The FMA design (float32):
    1e-4 of each gradient's largest magnitude (same inputs, f32 sums in
    another order, exp2 of log2e-scaled scores). The tensor-core design
    (bf16) takes the card check's two tolerances: the relative L2
    ``MMA_VS_MATCHED_L2_TOL`` against the plain backward with the same bf16
    roundings and ``MMA_VS_EXACT_TOL`` of the largest magnitude against the
    exact one, each widened by the Function's rounding of its gradients to
    bf16 (2^-8 of an entry)."""
    for cq, td in ((32, torch.float32), (16, torch.float32), (32, torch.bfloat16),
                   (16, torch.bfloat16)):
        q, k, v, grid = _qkv(seed=9)
        rng = np.random.default_rng(9)
        # fixed random weights on the three outputs: every cotangent is nonzero
        w = [rng.normal(size=(2, 130, n)).astype(np.float32) for n in (32, 2, 1)]
        q, k = q[..., :cq], k[..., :cq]
        before = dict(pt_corr.launches)
        grads = _torch_grads(pt_corr.fused_correlation_warp, q, k, v, grid, w, td, cuda_device)
        torch.cuda.synchronize()
        for name in pt_corr.launches:
            assert pt_corr.launches[name] == before[name] + 1
        args = _to(cuda_device, td, q, k, v)
        dout = torch.cat([torch.from_numpy(x) for x in w], dim=-1).to(cuda_device)
        grid_t = torch.from_numpy(grid).to(cuda_device)
        ref = pt_corr.fused_correlation_warp_bwd_plain(*args, grid_t, dout)[:3]
        if td == torch.float32:
            assert pt_corr.backward_design(td, cq, 32) == pt_corr.DESIGN_FMA
            for g, r in zip(grads, ref):
                torch.testing.assert_close(
                    g, r, atol=1e-4 * max(1.0, float(r.abs().max())), rtol=0)
            continue
        assert pt_corr.backward_design(td, cq, 32) == pt_corr.DESIGN_MMA
        matched = pt_corr.fused_correlation_warp_bwd_plain(
            *args, grid_t, dout, bf16_roundings=True)[:3]
        for g, r, m in zip(grads, ref, matched):
            tol = (pt_corr.MMA_VS_EXACT_TOL + 2 ** -8) * max(1.0, float(r.abs().max()))
            torch.testing.assert_close(g.float(), r, atol=tol, rtol=0)
            rel_l2 = float((g.float() - m).norm() / m.norm())
            assert rel_l2 <= pt_corr.MMA_VS_MATCHED_L2_TOL + 2 ** -8, rel_l2
