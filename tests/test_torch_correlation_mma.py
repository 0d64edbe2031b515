"""PyTorch port: what surrounds the tensor-core design of the backward
correlation kernels K2 and K3 and can be checked without a card.

The kernels round dmain, P and dS to bf16; ``bf16_roundings=True`` makes the
plain backward round at the same places. Here that version is held against
the exact plain backward (which ``tests/test_torch_correlation_bwd.py`` holds
against the JAX package), which derives the tolerances the card check
(``chip_smoke.py``) uses; the plain prologue, the design dispatch and the
build digest are tested beside it. The kernels themselves run on the card
only.
"""

import numpy as np
import pytest
import torch

from mapfree_tpu_torch.models.aggregators import _uv_grid
from mapfree_tpu_torch.ops import _build
from mapfree_tpu_torch.ops import correlation as corr

from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _inputs(B, H, W, cq, cv, seed):
    """bf16 q, k, v and grid, a float32 cotangent of the [B, HW, Cv + 3] buffer."""
    rng = np.random.default_rng(seed)
    HW = H * W
    q, k = (torch.from_numpy(rng.standard_normal((B, HW, cq), np.float32)).bfloat16()
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((B, HW, cv), np.float32)).bfloat16()
    dout = torch.from_numpy(rng.standard_normal((B, HW, cv + 3), np.float32))
    return q, k, v, _uv_grid(H, W).bfloat16(), dout


def _scaled_err(out, ref):
    """max |out - ref| relative to max(1, max |ref|), the card check's measure."""
    return float((out - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _rel_l2(out, ref):
    return float((out - ref).norm() / ref.norm())


# (name, B, H, W): C = 32, a ragged HW = 130 and HW = 1,020
ROUNDING_CASES = [("hw130", 2, 10, 13), ("hw1020", 1, 34, 30)]


@pytest.mark.parametrize("name,B,H,W", ROUNDING_CASES, ids=[c[0] for c in ROUNDING_CASES])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_roundings_cost_what_the_loose_tolerance_allows(name, B, H, W, seed):
    """The plain backward with the kernels' roundings against the exact one:
    each of dmain, P and dS carries 2^-9 relative, and dP - c cancels where a
    row's softmax is peaked, so a gradient moves by 0.2-0.7% of its largest
    entry. MMA_VS_EXACT_TOL is pinned between 2x and 20x of what is seen."""
    q, k, v, grid, dout = _inputs(B, H, W, 32, 32, seed)
    exact = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout)
    rounded = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, bf16_roundings=True)
    assert torch.equal(exact[3], rounded[3])  # the argmax is taken before any rounding
    for got, ref in zip(rounded[:3], exact[:3]):
        err = _scaled_err(got, ref)
        assert corr.MMA_VS_EXACT_TOL / 20 <= err <= corr.MMA_VS_EXACT_TOL / 2, err
        # and the matched comparison is the sharper one: the roundings alone
        # move a gradient further in L2 than it allows
        assert _rel_l2(got, ref) > corr.MMA_VS_MATCHED_L2_TOL


def _rounded_backward_with_score_noise(q, k, v, grid, dout, noise, gen):
    """The arithmetic of ``bf16_roundings=True`` written out, with the float32
    scores disturbed by ``noise`` x max |s| before the softmax: what another
    summation order does to them."""
    B, HW, _ = q.shape
    Cv = v.shape[-1]
    rnd = lambda x: x.bfloat16().float()  # noqa: E731
    vg = torch.cat([v, grid.expand(B, HW, 2)], dim=-1).float()
    dmain, d_ms = dout[..., :Cv + 2], dout[..., Cv + 2:]
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    amax = s.argmax(dim=-1)
    dP = torch.bmm(dmain, vg.transpose(1, 2)).scatter_add_(2, amax[..., None], d_ms)
    c = (dP * torch.softmax(s, dim=-1)).sum(dim=-1, keepdim=True)
    if noise:
        s = s + noise * float(s.abs().max()) * torch.randn(s.shape, generator=gen)
    p = torch.softmax(s, dim=-1)
    dm = rnd(dmain)
    dP = torch.bmm(dm, vg.transpose(1, 2)).scatter_add_(2, amax[..., None], d_ms)
    P, dS = rnd(p), rnd(p * (dP - c))
    return (torch.bmm(dS, k.float()), torch.bmm(dS.transpose(1, 2), q.float()),
            torch.bmm(P.transpose(1, 2), dm[..., :Cv]))


@pytest.mark.parametrize("name,B,H,W", ROUNDING_CASES, ids=[c[0] for c in ROUNDING_CASES])
def test_score_noise_flips_few_bf16_roundings(name, B, H, W):
    """Two float32 evaluations of P and dS that differ by summation order
    (1e-6 of the largest score, several ulp) round to different bf16 values
    in about one entry in a thousand, each by 2^-8 of the entry. That is what
    the kernels are allowed against the plain backward with the same
    roundings: MMA_VS_MATCHED_L2_TOL holds it with a factor of 2 to spare."""
    q, k, v, grid, dout = _inputs(B, H, W, 32, 32, seed=2)
    gen = torch.Generator().manual_seed(0)
    ref = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, bf16_roundings=True)
    same = _rounded_backward_with_score_noise(q, k, v, grid, dout, 0.0, gen)
    noisy = _rounded_backward_with_score_noise(q, k, v, grid, dout, 1e-6, gen)
    for a, b, r in zip(same, noisy, ref[:3]):
        assert _rel_l2(a, r) < 1e-6  # the written-out arithmetic is the package's
        err = _rel_l2(b, r)
        assert 0 < err <= corr.MMA_VS_MATCHED_L2_TOL / 2, err


def test_roundings_are_off_by_default_and_parts_match_the_whole():
    q, k, v, grid, dout = _inputs(2, 5, 7, 16, 8, seed=3)
    for rounded in (False, True):
        dq, dk, dv, amax = corr.fused_correlation_warp_bwd_plain(
            q, k, v, grid, dout, bf16_roundings=rounded)
        dq2, amax2 = corr.correlation_bwd_rows_plain(q, k, v, grid, dout,
                                                     bf16_roundings=rounded)
        dk2, dv2 = corr.correlation_bwd_cols_plain(q, k, v, grid, dout,
                                                   bf16_roundings=rounded)
        assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
        assert torch.equal(amax, amax2)
    default = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout)
    exact = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, bf16_roundings=False)
    assert all(torch.equal(a, b) for a, b in zip(default, exact))
    assert not torch.equal(default[0], dq)  # the last loop pass rounded


def test_cpu_function_takes_the_exact_backward():
    """On CPU tensors the Function's gradient is the exact plain backward,
    whatever design the same inputs would get on the card."""
    q, k, v, grid, dout = _inputs(1, 4, 6, 8, 8, seed=4)
    assert corr.backward_design(q.dtype, 8, 8) == corr.DESIGN_MMA
    qt, kt, vt = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = torch.cat(corr.fused_correlation_warp(qt, kt, vt, grid), dim=-1)
    out.backward(dout)
    ref = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout)[:3]
    for g, r in zip((qt.grad, kt.grad, vt.grad), ref):
        assert g.dtype == torch.bfloat16 and torch.equal(g, r.bfloat16())


@pytest.mark.parametrize("cv,width", [(8, 16), (14, 16), (16, 32), (32, 48), (64, 80),
                                      (120, 128), (128, 144)])
def test_dmain_width_is_the_next_multiple_of_16(cv, width):
    assert corr.dmain_width(cv) == width
    assert width % 16 == 0 and 0 <= width - (cv + 2) < 16


@pytest.mark.parametrize("cv", [8, 16, 32])
def test_plain_prologue(cv):
    """c = dout . out over all Cv + 3 columns equals sum_j dP_ij P_ij of the
    plain backward (out = P [v | grid] and the max score is P at the argmax);
    dmain is the bf16 cotangent of [warped | pos] padded with zeros; the
    statistics carry 1 / denominator and the max-score cotangent."""
    q, k, v, grid, dout = _inputs(2, 6, 9, 16, cv, seed=5 + cv)
    out = corr._plain_buffer(q, k, v, grid)
    dmain, stats = corr.correlation_bwd_prologue_plain(out, dout)
    assert dmain.dtype == torch.bfloat16 and stats.dtype == torch.float32
    assert tuple(dmain.shape) == (2, 54, corr.dmain_width(cv))
    assert tuple(stats.shape) == (2, 54, 4)
    assert torch.equal(dmain[..., :cv + 2], dout[..., :cv + 2].bfloat16())
    assert float(dmain[..., cv + 2:].abs().max()) == 0.0

    p, _, dm, amax = corr._bwd_plain_terms(q, k, v, grid, dout, None)
    vg = torch.cat([v, grid.expand(2, 54, 2)], dim=-1).float()
    dP = torch.bmm(dm, vg.transpose(1, 2)).scatter_add_(2, amax[..., None], dout[..., cv + 2:])
    c = (dP * p).sum(dim=-1)
    np.testing.assert_allclose(stats[..., 2].numpy(), c.numpy(),
                               atol=1e-5 * max(1.0, float(c.abs().max())))
    assert float(stats[..., 0].abs().max()) == 0.0  # the row max is K2's to fill
    assert torch.equal(stats[..., 1], p.amax(dim=-1))  # max P = 1 / denominator
    assert torch.equal(stats[..., 3], dout[..., cv + 2])


DESIGN_CASES = [
    (torch.bfloat16, 32, 32, corr.DESIGN_MMA),   # every config under configs/regression/
    (torch.bfloat16, 16, 32, corr.DESIGN_MMA),   # CV_HALF_CHANNELS
    (torch.bfloat16, 8, 8, corr.DESIGN_MMA),
    (torch.bfloat16, 128, 128, corr.DESIGN_MMA),
    (torch.bfloat16, 64, 24, corr.DESIGN_MMA),
    (torch.bfloat16, 12, 32, corr.DESIGN_FMA),   # not a multiple of 8
    (torch.bfloat16, 32, 4, corr.DESIGN_FMA),
    (torch.bfloat16, 136, 32, corr.DESIGN_FMA),  # wider than the tensor-core tiles
    (torch.float32, 32, 32, corr.DESIGN_FMA),    # float32 stays exact: no TF32
    (torch.float32, 16, 16, corr.DESIGN_FMA),
]


@pytest.mark.parametrize("dtype,cq,cv,design", DESIGN_CASES,
                         ids=[f"{str(d).split('.')[-1]}_q{a}_v{b}" for d, a, b, _ in DESIGN_CASES])
def test_backward_design_dispatch(dtype, cq, cv, design):
    assert corr.backward_design(dtype, cq, cv) == design


def test_misaligned_operand_is_refused():
    t = torch.zeros(64, dtype=torch.bfloat16)
    corr._check_aligned(q=t)
    if t.data_ptr() % 16 == 0:
        with pytest.raises(ValueError, match="q must be aligned to 16 bytes"):
            corr._check_aligned(q=t[1:])


def test_build_digest_follows_included_headers(tmp_path):
    """A library is named by its source, the headers it includes (also through
    another header) and the flags: editing a header must not load a stale
    build. No compiler is needed for the name."""
    (tmp_path / "kernel.cu").write_text('#include <cuda.h>\n#include "tiles.cuh"\nint x;\n')
    (tmp_path / "tiles.cuh").write_text('  # include "inner.cuh"\nint y;\n')
    (tmp_path / "inner.cuh").write_text("int z;\n")
    (tmp_path / "unrelated.cuh").write_text("int w;\n")
    src = tmp_path / "kernel.cu"
    assert sorted(p.name for p in _build.source_files(src)) == \
        ["inner.cuh", "kernel.cu", "tiles.cuh"]
    first = _build.source_digest(src)
    assert _build.source_digest(src) == first
    (tmp_path / "unrelated.cuh").write_text("int w2;\n")
    assert _build.source_digest(src) == first
    (tmp_path / "inner.cuh").write_text("int z2;\n")
    second = _build.source_digest(src)
    assert second != first
    (tmp_path / "kernel.cu").write_text('#include "tiles.cuh"\nint x2;\n')
    assert _build.source_digest(src) not in (first, second)


def test_backward_source_includes_the_shared_tile_header():
    files = {p.name for p in _build.source_files(_build.CSRC_DIR / "correlation_bwd.cu")}
    assert files == {"correlation_bwd.cu", "mma_tile.cuh"}
