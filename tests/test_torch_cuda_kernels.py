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


# (name, B, H, W, Cq, Cv, nan): K1's wgmma kernel at its edges, asked for by
# name (the package gives it more than 64 positions): HW below one key tile
# and not a multiple of the row block (128) or the key tile (64), Cq != Cv,
# C = 8 (channels zero-filled to a depth of 16), Cv + 2 beyond 256 (three
# column tiles of 128), and NaN in batch element 1's first rows of q, k and
# v (element 0's last key tile reaches past its HW, where the tensor maps
# read zeros, never element 1's rows)
K1_WGMMA_EDGES = [
    ("hw15", 2, 3, 5, 32, 32, False),
    ("hw200_ragged_rows_and_keys", 2, 10, 20, 32, 32, False),
    ("q16_v32_hw130", 2, 10, 13, 16, 32, False),
    ("q256_v96_hw70", 2, 7, 10, 256, 96, False),
    ("c8_hw130", 2, 10, 13, 8, 8, False),
    ("q32_v264_hw70", 2, 7, 10, 32, 264, False),
    ("nan_next_batch_hw70", 2, 7, 10, 32, 32, True),
]


def _k1_wgmma_inputs(name, B, H, W, cq, cv, nan, device):
    """bf16 q, k, v (NaN in batch element 1's first three rows where asked)
    and the bf16 grid for one edge case."""
    HW = H * W
    rng = np.random.default_rng(len(name) + HW + cq + cv)
    scale = (32.0 / max(cq, 32)) ** 0.25
    q, k = (scale * rng.normal(size=(B, HW, cq)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, HW, cv)).astype(np.float32)
    if nan:
        for a in (q, k, v):
            a[1, :3] = np.nan
    return _to(device, torch.bfloat16, q, k, v), _uv_grid(H, W).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,H,W,cq,cv,nan", K1_WGMMA_EDGES,
                         ids=[c[0] for c in K1_WGMMA_EDGES])
def test_k1_cuda_wgmma_kernel_at_its_edges(cuda_device, name, B, H, W, cq, cv, nan):
    """The wgmma kernel of K1's tensor-core design, one counted launch a
    call: warped and pos within mma_forward_matched_l2_tol (relative L2) of
    the plain forward with its rounding of P and MMA_FWD_VS_EXACT_TOL of the
    largest magnitude of the exact one, the max score within 5e-5 of it; two
    runs give the same bits, and so does the mma.sync kernel. With NaN in
    batch element 1, element 0 stays finite and held so, element 1 is NaN."""
    args, g = _k1_wgmma_inputs(name, B, H, W, cq, cv, nan, cuda_device)
    before = pt_corr.launches[pt_corr.KERNEL]
    runs = [pt_corr._forward_cuda(*args, g, kernel=pt_corr.KERNEL_FWD_WGMMA) for _ in range(2)]
    other = pt_corr._forward_cuda(*args, g, kernel=pt_corr.KERNEL_FWD_MMA_SYNC)
    torch.cuda.synchronize()
    assert pt_corr.launches[pt_corr.KERNEL] == before + 3
    keep = slice(0, 1) if nan else slice(None)
    first = runs[0][keep]
    assert torch.equal(first, runs[1][keep]) and torch.equal(first, other[keep])
    if nan:
        assert torch.isnan(runs[0][1]).all()
    kept = [a[keep] for a in args]
    out = pt_corr._split(first, cv)
    exact = pt_corr.fused_correlation_warp_plain(*kept, g)
    matched = pt_corr.fused_correlation_warp_plain(*kept, g, bf16_roundings=True)
    l2_tol = pt_corr.mma_forward_matched_l2_tol(cq, cv)
    for got, r, m in zip(out[:2], exact[:2], matched[:2]):
        assert torch.isfinite(got).all()
        assert float((got - m).norm() / m.norm()) <= l2_tol
        torch.testing.assert_close(
            got, r, atol=pt_corr.MMA_FWD_VS_EXACT_TOL * max(1.0, float(r.abs().max())), rtol=0)
    torch.testing.assert_close(out[2], exact[2], atol=5e-5, rtol=0)


@pytest.mark.parametrize("name,B,H,W,cq,cv,nan", K1_WGMMA_EDGES,
                         ids=[c[0] for c in K1_WGMMA_EDGES])
def test_k1_wgmma_edges_plain_twin(name, B, H, W, cq, cv, nan):
    """The CPU twin of the card case: on the same inputs the plain forward
    with the kernel's rounding stays within half of MMA_FWD_VS_EXACT_TOL of
    the exact one (the max score within 5e-5), NaN in batch element 1 stays
    there in both, and the package's kernel for the shape is the one
    forward_kernel names (the mma.sync kernel at 64 positions or fewer)."""
    args, g = _k1_wgmma_inputs(name, B, H, W, cq, cv, nan, "cpu")
    exact = pt_corr.fused_correlation_warp_plain(*args, g)
    matched = pt_corr.fused_correlation_warp_plain(*args, g, bf16_roundings=True)
    keep = slice(0, 1) if nan else slice(None)
    if nan:
        assert all(bool(torch.isnan(o[1]).all()) for o in exact + matched)
    for m, r in zip(matched[:2], exact[:2]):
        m, r = m[keep], r[keep]
        assert torch.isfinite(m).all()
        assert float((m - r).abs().max()) <= pt_corr.MMA_FWD_VS_EXACT_TOL / 2 * max(
            1.0, float(r.abs().max()))
    assert float((matched[2][keep] - exact[2][keep]).abs().max()) < 5e-5
    want = (pt_corr.KERNEL_FWD_MMA_SYNC if H * W <= pt_corr.FEW_ROWS_HW
            else pt_corr.KERNEL_FWD_WGMMA)
    assert pt_corr.forward_kernel(torch.bfloat16, H * W, cq, cv) == want


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
    roundings (``bf16_roundings=True``: K2's one sweep) and
    ``MMA_VS_EXACT_TOL`` of the largest magnitude against the exact one, each
    widened by the Function's rounding of its gradients to bf16 (2^-8 of an
    entry)."""
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


# (name, B, H, W, Cq, Cv, dtype, inputs): K2 and K3's FMA design at the edges
# of its two kernel pairs (ops/csrc/correlation_bwd.cu::dispatch_rows,
# dispatch_cols): the 3d3d grid (ragged row and key tiles), HW 20 and the
# few-rows pair's largest HW (64) with one below and one above, HW below one
# long-rows tile of 128, Cq != Cv on each pair, 1,024 channels on the ResNet
# encoder's 5x4 grid scaled by (32 / C)^(1/4) and unscaled, scores near 3,300
# on each pair, an exact tie for row 0's maximum on each pair, and a bf16
# width that is not a multiple of 8 on each pair. inputs: ("normal", scale
# of q and k), ("large", _) for q = k = 1 + |N(0, 1)|, ("tie", _) for keys 3
# and 5 equal and row 0's maximum. tests/test_torch_correlation_bwd_f32.py
# holds the plain backward to the JAX package's at the same shapes.
K23_FMA_EDGES = [
    ("3d3d_hw6256", 2, 92, 68, 32, 32, torch.float32, ("normal", 1.0)),
    ("hw20", 2, 4, 5, 32, 32, torch.float32, ("normal", 1.0)),
    ("hw63", 2, 7, 9, 32, 32, torch.float32, ("normal", 1.0)),
    ("hw64", 2, 8, 8, 32, 32, torch.float32, ("normal", 1.0)),
    ("hw65", 2, 5, 13, 32, 32, torch.float32, ("normal", 1.0)),
    ("hw100_below_row_tile", 2, 10, 10, 32, 32, torch.float32, ("normal", 1.0)),
    ("hw130_q16_v32", 2, 10, 13, 16, 32, torch.float32, ("normal", 1.0)),
    ("hw20_q24_v40", 2, 4, 5, 24, 40, torch.float32, ("normal", 1.0)),
    ("hw20_c1024_scaled", 2, 4, 5, 1024, 1024, torch.float32, ("normal", (32 / 1024) ** 0.25)),
    ("hw20_c1024_unscaled", 2, 4, 5, 1024, 1024, torch.float32, ("normal", 1.0)),
    ("hw20_c1024_large_scores", 2, 4, 5, 1024, 32, torch.float32, ("large", 1.0)),
    ("hw70_c1024_large_scores", 2, 7, 10, 1024, 32, torch.float32, ("large", 1.0)),
    ("hw20_tie", 1, 4, 5, 32, 32, torch.float32, ("tie", 1.0)),
    ("hw100_tie", 1, 10, 10, 32, 32, torch.float32, ("tie", 1.0)),
    ("hw20_c12_bf16", 2, 4, 5, 12, 12, torch.bfloat16, ("normal", 1.0)),
    ("hw130_c12_bf16", 2, 10, 13, 12, 12, torch.bfloat16, ("normal", 1.0)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,H,W,cq,cv,td,inputs", K23_FMA_EDGES,
                         ids=[c[0] for c in K23_FMA_EDGES])
def test_k23_cuda_fma_edges_match_plain(cuda_device, name, B, H, W, cq, cv, td, inputs):
    """K2 and K3's FMA design, one launch each, given the exact forward's
    buffer, against the exact plain backward on the same inputs with K2's
    argmax, within 1e-4 of each gradient's largest magnitude (or of 1):
    float32 sums in another order, exp2 of log2e-scaled scores, the row
    constant from the forward's buffer. K2's argmax is a maximum of the
    float32 scores and, on a tie, the first; a second run of each gives the
    same bits (fixed summation orders, no atomics)."""
    assert pt_corr.backward_design(td, cq, cv) == pt_corr.DESIGN_FMA
    HW = H * W
    rng = np.random.default_rng(len(name) + HW + cq)
    kind, scale = inputs
    if kind == "large":
        q = 1.0 + np.abs(rng.normal(size=(B, HW, cq))).astype(np.float32)
        k = q.copy()
    else:
        q, k = (scale * rng.normal(size=(B, HW, cq)).astype(np.float32) for _ in range(2))
    if kind == "tie":
        k[:, 5] = k[:, 3]
        q[:, 0] = 3.0 * k[:, 3]
    v = rng.normal(size=(B, HW, cv)).astype(np.float32)
    dout = torch.from_numpy(rng.normal(size=(B, HW, cv + 3)).astype(np.float32)).to(cuda_device)
    args = _to(cuda_device, td, q, k, v)
    g = _uv_grid(H, W).to(cuda_device, td)
    out = pt_corr._plain_buffer(*args, g)
    before = dict(pt_corr.launches)
    runs = []
    for _ in range(2):
        dq, rows = pt_corr.correlation_bwd_rows(*args, g, out, dout)
        dk, dv = pt_corr.correlation_bwd_cols(*args, g, dout, rows)
        runs.append((dq, dk, dv, rows.stats, rows.amax))
    torch.cuda.synchronize()
    assert pt_corr.launches[pt_corr.KERNEL_BWD_ROWS] == before[pt_corr.KERNEL_BWD_ROWS] + 2
    assert pt_corr.launches[pt_corr.KERNEL_BWD_COLS] == before[pt_corr.KERNEL_BWD_COLS] + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    dq, dk, dv, stats, amax = runs[0]
    s = torch.bmm(args[0].float(), args[1].float().transpose(1, 2))
    top = s.amax(dim=-1)
    amax = amax.long()
    gap = (top - s.gather(2, amax[..., None])[..., 0]).abs()
    assert float(gap.max()) <= 4e-6 * float(s.abs().max())
    if kind == "tie":
        assert int(amax[0, 0]) == 3
    # the row max (a score as it is) and 1 / d relative to it
    torch.testing.assert_close(stats[..., 0], top, atol=4e-6 * float(s.abs().max()), rtol=0)
    torch.testing.assert_close(stats[..., 1], out[..., cv + 2], atol=0, rtol=1e-5)
    ref = pt_corr.fused_correlation_warp_bwd_plain(*args, g, dout, amax)[:3]
    for got, r in zip((dq, dk, dv), ref):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, r, atol=1e-4 * max(1.0, float(r.abs().max())), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(4, 5), (10, 10), (92, 68)],
                         ids=["few_rows_hw20", "long_rows_hw100", "long_rows_3d3d"])
def test_k23_cuda_fma_nan_row_stays_in_bounds(cuda_device, H, W):
    """A NaN row, as a float32 step that diverges gives (q's row 0 of batch
    element 0): K2 and K3's FMA design run without a device fault, K2's
    argmax stays in [0, HW) (the long-rows K2 reads k at it), the NaN
    reaches that element's dq row and its dk and dv, and the other element
    agrees with the exact plain backward within 1e-4 of its largest
    gradient."""
    HW = H * W
    q, k, v = (np.random.default_rng(HW + i).normal(size=(2, HW, 32)).astype(np.float32)
               for i in range(3))
    q[0, 0] = np.nan
    dout = torch.from_numpy(np.random.default_rng(HW + 3).normal(size=(2, HW, 35))
                            .astype(np.float32)).to(cuda_device)
    args = _to(cuda_device, torch.float32, q, k, v)
    g = _uv_grid(H, W).to(cuda_device)
    out = pt_corr._plain_buffer(*args, g)
    dq, rows = pt_corr.correlation_bwd_rows(*args, g, out, dout)
    dk, dv = pt_corr.correlation_bwd_cols(*args, g, dout, rows)
    torch.cuda.synchronize()
    amax = rows.amax.long()
    assert 0 <= int(amax.min()) and int(amax.max()) < HW
    assert not torch.isfinite(dq[0, 0]).any()
    assert not torch.isfinite(dk[0]).any() and not torch.isfinite(dv[0]).any()
    ref = pt_corr.fused_correlation_warp_bwd_plain(*(a[1:] for a in args), g, dout[1:],
                                                   amax[1:])[:3]
    for got, r in zip((dq[1:], dk[1:], dv[1:]), ref):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, r, atol=1e-4 * max(1.0, float(r.abs().max())), rtol=0)


# (name, B, H, W, Cq, Cv, inputs): the tensor-core K2 and K3 at the edges of
# their streamed design (ops/csrc/correlation_bwd_mma.cu::dispatch_rows_mma,
# dispatch_cols_mma): 136 channels (streamed: a last channel chunk of 8 and
# 56 zeros, a last column tile of 8 columns), Cq != Cv beyond 128 (256 / 96,
# own tiles resident), 1,024 channels at HW 70, a ragged HW of 1,000 beyond
# 128 channels and 130 at 32, and an exact tie for row 0's maximum, resident
# (C = 32, 256 / 96) and streamed (C = 256). q and k are scaled by (32 /
# Cq)^(1/4): the scores spread as at 32 channels.
K23_MMA_EDGES = [
    ("c136_hw70_chunk_and_tile_edges", 2, 7, 10, 136, 136, "normal"),
    ("q256_v96_hw70", 2, 7, 10, 256, 96, "normal"),
    ("c1024_hw70", 2, 7, 10, 1024, 1024, "normal"),
    ("c256_hw1000_ragged", 1, 25, 40, 256, 256, "normal"),
    ("c32_hw130_ragged", 2, 10, 13, 32, 32, "normal"),
    ("c32_hw70_tie", 1, 7, 10, 32, 32, "tie"),
    ("q256_v96_hw70_tie", 1, 7, 10, 256, 96, "tie"),
    ("c256_hw70_tie", 1, 7, 10, 256, 256, "tie"),
]


def _k23_mma_inputs(name, B, H, W, cq, cv, kind, device, nan_row=False):
    """bf16 q, k, v, the grid and a float32 cotangent for one edge case."""
    HW = H * W
    rng = np.random.default_rng(len(name) + HW + cq)
    scale = (32.0 / max(cq, 32)) ** 0.25
    q, k = (scale * rng.normal(size=(B, HW, cq)).astype(np.float32) for _ in range(2))
    if kind == "tie":
        k[:, 5] = k[:, 3]
        q[:, 0] = 3.0 * k[:, 3]
    if nan_row:
        q[0, 0] = np.nan
    v = rng.normal(size=(B, HW, cv)).astype(np.float32)
    dout = torch.from_numpy(rng.normal(size=(B, HW, cv + 3)).astype(np.float32)).to(device)
    args = _to(device, torch.bfloat16, q, k, v)
    return args, _uv_grid(H, W).to(device, torch.bfloat16), dout


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,H,W,cq,cv,kind", K23_MMA_EDGES, ids=[c[0] for c in K23_MMA_EDGES])
def test_k23_cuda_tensor_cores_at_their_edges(cuda_device, name, B, H, W, cq, cv, kind):
    """The tensor-core K2 and K3, one launch each, given the exact forward's
    buffer: dq, dk, dv within mma_backward_matched_l2_tol (relative L2) of
    the plain backward with their roundings and mma_backward_exact_tol of the
    largest magnitude of the exact one, with K2's argmax; two runs of each
    give the same bits; K2's argmax is a maximum of the float32 scores (on a
    tie the first), its lse gives back the row max, and its dmain, 1 / d and
    d_ms are the plain prologue's to the bit (c to summation order)."""
    assert pt_corr.backward_design(torch.bfloat16, cq, cv) == pt_corr.DESIGN_MMA
    args, g, dout = _k23_mma_inputs(name, B, H, W, cq, cv, kind, cuda_device)
    out = pt_corr._plain_buffer(*args, g)
    before = dict(pt_corr.launches)
    runs = []
    for _ in range(2):
        dq, rows = pt_corr.correlation_bwd_rows(*args, g, out, dout)
        dk, dv = pt_corr.correlation_bwd_cols(*args, g, dout, rows)
        runs.append((dq, dk, dv, rows.stats, rows.amax, rows.dmain))
    torch.cuda.synchronize()
    assert pt_corr.launches[pt_corr.KERNEL_BWD_ROWS] == before[pt_corr.KERNEL_BWD_ROWS] + 2
    assert pt_corr.launches[pt_corr.KERNEL_BWD_COLS] == before[pt_corr.KERNEL_BWD_COLS] + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    dq, dk, dv, stats, amax, dmain = runs[0]
    s = torch.bmm(args[0].float(), args[1].float().transpose(1, 2))
    top, amax = s.amax(dim=-1), amax.long()
    scale = float(s.abs().max())
    assert float((top - s.gather(2, amax[..., None])[..., 0]).abs().max()) <= 4e-6 * scale
    if kind == "tie":
        assert int(amax[0, 0]) == 3
    row_max = (stats[..., 0] + torch.log2(stats[..., 1])) / 1.4426950408889634
    torch.testing.assert_close(row_max, top, atol=4e-6 * scale + 4e-7 * max(1.0, scale), rtol=0)
    dmain_p, stats_p = pt_corr.correlation_bwd_prologue_plain(out, dout)
    assert torch.equal(dmain, dmain_p) and torch.equal(stats[..., [1, 3]], stats_p[..., [1, 3]])
    torch.testing.assert_close(stats[..., 2], stats_p[..., 2], rtol=0,
                               atol=1e-5 * max(1.0, float(stats_p[..., 2].abs().max())))
    exact = pt_corr.fused_correlation_warp_bwd_plain(*args, g, dout, amax)[:3]
    matched = pt_corr.fused_correlation_warp_bwd_plain(
        *args, g, dout, amax, bf16_roundings=True)[:3]
    l2_tol = pt_corr.mma_backward_matched_l2_tol(cq, cv)
    tol = pt_corr.mma_backward_exact_tol(cq, cv)
    for got, r, m in zip((dq, dk, dv), exact, matched):
        assert torch.isfinite(got).all()
        assert float((got - m).norm() / m.norm()) <= l2_tol
        torch.testing.assert_close(got, r, atol=tol * max(1.0, float(r.abs().max())), rtol=0)


@pytest.mark.parametrize("name,B,H,W,cq,cv,kind", K23_MMA_EDGES, ids=[c[0] for c in K23_MMA_EDGES])
def test_k23_tensor_core_edges_plain_twin(name, B, H, W, cq, cv, kind):
    """The CPU twin of the card case: on the same inputs the plain backward
    with the kernels' roundings stays within half of mma_backward_exact_tol
    of the exact one, the two take the same argmax (on a tie the first), and
    the CPU route (the Function on CPU tensors) is the exact backward."""
    args, g, dout = _k23_mma_inputs(name, B, H, W, cq, cv, kind, "cpu")
    exact = pt_corr.fused_correlation_warp_bwd_plain(*args, g, dout)
    matched = pt_corr.fused_correlation_warp_bwd_plain(
        *args, g, dout, bf16_roundings=True)
    assert torch.equal(exact[3], matched[3])
    if kind == "tie":
        assert int(exact[3][0, 0]) == 3
    tol = pt_corr.mma_backward_exact_tol(cq, cv) / 2
    for m, r in zip(matched[:3], exact[:3]):
        assert float((m - r).abs().max()) <= tol * max(1.0, float(r.abs().max()))
    qt, kt, vt = (a.clone().requires_grad_(True) for a in args)
    torch.cat(pt_corr.fused_correlation_warp(qt, kt, vt, g), dim=-1).backward(dout)
    for t, r in zip((qt, kt, vt), exact[:3]):
        assert torch.equal(t.grad, r.bfloat16())


K23_MMA_NAN = [("c32_hw70", 7, 10, 32, 32), ("q256_v96_hw70", 7, 10, 256, 96),
               ("c256_hw70", 7, 10, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,H,W,cq,cv", K23_MMA_NAN, ids=[c[0] for c in K23_MMA_NAN])
def test_k23_cuda_tensor_cores_nan_row_stays_in_bounds(cuda_device, name, H, W, cq, cv):
    """A NaN row (q's row 0 of batch element 0) on the tensor-core pair,
    resident (C = 32, 256 / 96) and streamed (C = 256): no device fault, K2's argmax in [0, HW) (K2 reads
    k at it), the NaN in that element's dq row and its dk and dv, and the
    other element within mma_backward_exact_tol of the exact plain backward."""
    args, g, dout = _k23_mma_inputs(name, 2, H, W, cq, cv, "normal", cuda_device, nan_row=True)
    out = pt_corr._plain_buffer(*args, g)
    dq, rows = pt_corr.correlation_bwd_rows(*args, g, out, dout)
    dk, dv = pt_corr.correlation_bwd_cols(*args, g, dout, rows)
    torch.cuda.synchronize()
    amax = rows.amax.long()
    assert 0 <= int(amax.min()) and int(amax.max()) < H * W
    assert not torch.isfinite(dq[0, 0]).any()
    assert not torch.isfinite(dk[0]).any() and not torch.isfinite(dv[0]).any()
    ref = pt_corr.fused_correlation_warp_bwd_plain(*(a[1:] for a in args), g, dout[1:],
                                                   amax[1:])[:3]
    tol = pt_corr.mma_backward_exact_tol(cq, cv)
    for got, r in zip((dq[1:], dk[1:], dv[1:]), ref):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, r, atol=tol * max(1.0, float(r.abs().max())), rtol=0)


@pytest.mark.parametrize("name,H,W,cq,cv", K23_MMA_NAN, ids=[c[0] for c in K23_MMA_NAN])
def test_k23_tensor_core_nan_row_plain_twin(name, H, W, cq, cv):
    """The CPU twin: the plain backward with the kernels' roundings carries
    the NaN row into element 0's dq row, dk and dv and leaves element 1
    within half of mma_backward_exact_tol of the exact backward."""
    args, g, dout = _k23_mma_inputs(name, 2, H, W, cq, cv, "normal", "cpu", nan_row=True)
    matched = pt_corr.fused_correlation_warp_bwd_plain(
        *args, g, dout, bf16_roundings=True)
    assert not torch.isfinite(matched[0][0, 0]).any()
    assert not torch.isfinite(matched[1][0]).any() and not torch.isfinite(matched[2][0]).any()
    exact = pt_corr.fused_correlation_warp_bwd_plain(*(a[1:] for a in args), g, dout[1:])
    tol = pt_corr.mma_backward_exact_tol(cq, cv) / 2
    for m, r in zip(matched[:3], exact[:3]):
        assert torch.isfinite(m[1:]).all()
        assert float((m[1:] - r).abs().max()) <= tol * max(1.0, float(r.abs().max()))


# (name, B, H, W, Cq, Cv, kind): the wgmma pair of K2 and K3
# (ops/csrc/correlation_bwd_wgmma.cu), asked for by name (the package gives
# it more than 64 positions): HW one key past a tile (65), ragged (70, 130)
# and past 1,000, Cq != Cv, C = 8 (channels zero-filled to a depth of 16), a
# Cv of 8 mod 16 (24, 120: the grid's depth step apart from v's last 8
# columns in K2, shared with them in K3), 136 (a column tile of 8), 256 / 96
# and 256 (column tiles of 128), 1,000 batch elements of 70 positions, a NaN
# row, NaN in the next batch element's first rows (element 0's last tiles
# reach past its HW, where the tensor maps read zeros), an exact tie for
# row 0's maximum and the max-score cotangent alone. q and k scaled by
# (32 / max(Cq, 32))^(1/4), as _k23_mma_inputs does.
K23_WGMMA_EDGES = [
    ("hw65", 2, 5, 13, 32, 32, "normal"),
    ("hw70", 2, 7, 10, 32, 32, "normal"),
    ("hw130", 2, 10, 13, 32, 32, "normal"),
    ("hw1000", 1, 25, 40, 32, 32, "normal"),
    ("q16_v32_hw130", 2, 10, 13, 16, 32, "normal"),
    ("c8_hw130", 2, 10, 13, 8, 8, "normal"),
    ("c24_hw70", 2, 7, 10, 24, 24, "normal"),
    ("c120_hw70", 2, 7, 10, 120, 120, "normal"),
    ("c136_hw70", 2, 7, 10, 136, 136, "normal"),
    ("q256_v96_hw70", 2, 7, 10, 256, 96, "normal"),
    ("c256_hw1000", 1, 25, 40, 256, 256, "normal"),
    ("c128_hw70_b1000", 1000, 7, 10, 128, 128, "normal"),
    ("nan_row_hw70", 2, 7, 10, 32, 32, "nan_row"),
    ("nan_next_batch_hw70", 2, 7, 10, 32, 32, "nan_next"),
    ("tie_hw70", 1, 7, 10, 32, 32, "tie"),
    ("max_score_only_hw130", 2, 10, 13, 32, 32, "ms_only"),
]


def _k23_wgmma_inputs(name, B, H, W, cq, cv, kind, device):
    """bf16 q, k, v, the grid and a float32 cotangent for one wgmma edge case,
    and the batch elements the plain backward is held to (all but the one
    that holds NaN)."""
    args, g, dout = _k23_mma_inputs(name, B, H, W, cq, cv, "tie" if kind == "tie" else "normal",
                                    device, nan_row=kind == "nan_row")
    keep = slice(None)
    if kind == "nan_row":
        keep = slice(1, None)
    if kind == "nan_next":
        for a in args:
            a[1, :3] = float("nan")
        keep = slice(0, 1)
    if kind == "ms_only":
        dout[..., :cv + 2] = 0.0
    return args, g, dout, keep


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,H,W,cq,cv,kind", K23_WGMMA_EDGES,
                         ids=[c[0] for c in K23_WGMMA_EDGES])
def test_k23_cuda_wgmma_pair_at_its_edges(cuda_device, name, B, H, W, cq, cv, kind):
    """The wgmma K2 and K3, one counted launch each a call, given the exact
    forward's buffer: dq, dk, dv within mma_backward_matched_l2_tol
    (relative L2) of the plain backward with their roundings and
    mma_backward_exact_tol of the largest magnitude of the exact one (with
    B x HW rows), with K2's argmax; two runs give the same bits; the argmax
    is a maximum (on a tie the first), lse gives back the row max, dmain, 1/d
    and d_ms are the plain prologue's to the bit; either pair's K2 hands on
    to the other's K3 within the matched tolerance. A NaN row reaches its
    element's gradients, NaN in element 1 leaves element 0 finite."""
    args, g, dout, keep = _k23_wgmma_inputs(name, B, H, W, cq, cv, kind, cuda_device)
    HW = H * W
    out = torch.cat([pt_corr._plain_buffer(*(a[i:i + 100] for a in args), g)
                     for i in range(0, B, 100)])
    before = dict(pt_corr.launches)
    runs = []
    for _ in range(2):
        dq, rows = pt_corr.correlation_bwd_rows(*args, g, out, dout, kernel="wgmma")
        dk, dv = pt_corr.correlation_bwd_cols(*args, g, dout, rows, kernel="wgmma")
        runs.append((dq, dk, dv, rows.stats, rows.amax, rows.dmain))
    torch.cuda.synchronize()
    assert pt_corr.launches[pt_corr.KERNEL_BWD_ROWS] == before[pt_corr.KERNEL_BWD_ROWS] + 2
    assert pt_corr.launches[pt_corr.KERNEL_BWD_COLS] == before[pt_corr.KERNEL_BWD_COLS] + 2
    assert all(torch.equal(a[keep], b[keep]) for a, b in zip(*runs))
    dq, dk, dv, stats, amax, dmain = runs[0]
    amax = amax.long()
    assert 0 <= int(amax.min()) and int(amax.max()) < HW
    if kind == "nan_row":
        assert not torch.isfinite(dq[0, 0]).any()
        assert not torch.isfinite(dk[0]).any() and not torch.isfinite(dv[0]).any()
    if kind == "nan_next":
        assert not torch.isfinite(dq[1]).all()
    if kind == "tie":
        assert int(amax[0, 0]) == 3
    a_kept = [a[keep] for a in args]
    s = torch.bmm(a_kept[0].float(), a_kept[1].float().transpose(1, 2))
    top, scale = s.amax(dim=-1), float(s.abs().max())
    assert float((top - s.gather(2, amax[keep][..., None])[..., 0]).abs().max()) <= 4e-6 * scale
    row_max = (stats[keep][..., 0] + torch.log2(stats[keep][..., 1])) / 1.4426950408889634
    torch.testing.assert_close(row_max, top, atol=4e-6 * scale + 4e-7 * max(1.0, scale), rtol=0)
    dmain_p, stats_p = pt_corr.correlation_bwd_prologue_plain(out, dout)
    assert torch.equal(dmain[keep], dmain_p[keep])
    assert torch.equal(stats[keep][..., [1, 3]], stats_p[keep][..., [1, 3]])
    exact = pt_corr.fused_correlation_warp_bwd_plain(*a_kept, g, dout[keep], amax[keep])[:3]
    matched = pt_corr.fused_correlation_warp_bwd_plain(
        *a_kept, g, dout[keep], amax[keep], bf16_roundings=True)[:3]
    rows_n = B * HW
    l2_tol = pt_corr.mma_backward_matched_l2_tol(cq, cv, rows_n)
    tol = pt_corr.mma_backward_exact_tol(cq, cv, rows_n)
    for got, r, m in zip((dq[keep], dk[keep], dv[keep]), exact, matched):
        assert torch.isfinite(got).all()
        assert float((got - m).norm() / m.norm().clamp_min(1e-30)) <= l2_tol
        torch.testing.assert_close(got, r, atol=tol * max(1.0, float(r.abs().max())), rtol=0)
    for k2, k3 in (("wgmma", "mma_sync"), ("mma_sync", "wgmma")):
        dq2, rows2 = pt_corr.correlation_bwd_rows(*args, g, out, dout, kernel=k2)
        dk2, dv2 = pt_corr.correlation_bwd_cols(*args, g, dout, rows2, kernel=k3)
        torch.cuda.synchronize()
        for got, m in zip((dq2[keep], dk2[keep], dv2[keep]), matched):
            assert float((got - m).norm() / m.norm().clamp_min(1e-30)) <= l2_tol, (k2, k3)


@pytest.mark.parametrize("name,B,H,W,cq,cv,kind", K23_WGMMA_EDGES,
                         ids=[c[0] for c in K23_WGMMA_EDGES])
def test_k23_wgmma_edges_plain_twin(name, B, H, W, cq, cv, kind):
    """The CPU twin of the card case: on the same inputs the plain backward
    with the kernels' roundings stays within half of mma_backward_exact_tol
    (with B x HW rows) of the exact one on the elements without NaN, the two
    take the same argmax (on a tie the first), NaN stays in its element, and
    the package gives the shape the pair measured faster at its width class
    (MMA_SYNC_FASTER)."""
    args, g, dout, keep = _k23_wgmma_inputs(name, B, H, W, cq, cv, kind, "cpu")
    exact = pt_corr.fused_correlation_warp_bwd_plain(*(a[keep] for a in args), g, dout[keep])
    matched = pt_corr.fused_correlation_warp_bwd_plain(*args, g, dout, bf16_roundings=True)
    assert torch.equal(exact[3], matched[3][keep])
    if kind == "tie":
        assert int(exact[3][0, 0]) == 3
    if kind == "nan_row":
        assert not torch.isfinite(matched[0][0, 0]).any()
    if kind == "nan_next":
        assert not torch.isfinite(matched[0][1]).all()
    tol = pt_corr.mma_backward_exact_tol(cq, cv, B * H * W) / 2
    for m, r in zip(matched[:3], exact[:3]):
        m = m[keep]
        assert torch.isfinite(m).all()
        assert float((m - r).abs().max()) <= tol * max(1.0, float(r.abs().max()))
    want = (pt_corr.KERNEL_FWD_MMA_SYNC if pt_corr.wgmma_width_class(cq, cv)
            in pt_corr.MMA_SYNC_FASTER else pt_corr.KERNEL_FWD_WGMMA)
    assert pt_corr.backward_kernel(torch.bfloat16, H * W, cq, cv) == want
