"""PyTorch port: what surrounds the tensor-core design of the backward
correlation kernels K2 and K3 and can be checked without a card.

The kernels round dmain, P and dS to bf16; ``bf16_roundings=True`` makes the
plain backward round at the same places, with dq by the tensor-core K2's one
sweep over ``BWD_KEY_TILE`` keys (dS rounded relative to each row's running
reference, not to its max). Here that version is held against
the exact plain backward (which ``tests/test_torch_correlation_bwd.py`` holds
against the JAX package), which derives the tolerances the card check
(``chip_smoke.py``) uses; the plain prologue, the design dispatch and the
build digest are tested beside it. The kernels themselves run on the card
only.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mapfree_tpu_torch.config import cfg as default_cfg

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
    """The plain backward with the kernels' roundings (K2's one sweep, K3's
    P and dS rounded against the row's max) against the exact one: each of
    dmain, P and dS carries 2^-9 relative, and dP - c cancels where a row's
    softmax is peaked, so a gradient moves by 0.2-0.7% of its largest entry
    (3.1e-3 to 6.2e-3 here). MMA_VS_EXACT_TOL is pinned between 2x and 20x of
    what is seen."""
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


@pytest.mark.parametrize("name,B,H,W", ROUNDING_CASES, ids=[c[0] for c in ROUNDING_CASES])
def test_score_noise_flips_few_bf16_roundings(name, B, H, W):
    """Two float32 evaluations of the scores that differ by summation order
    (1e-6 of the largest score, several ulp) make P, dS and K2's dS' round to
    other bf16 values in about one entry in a thousand, each by 2^-8 of the
    entry. That is what the kernels are allowed against the plain backward
    with the same roundings (K2's one sweep): at most 5.7e-4 in L2, so
    MMA_VS_MATCHED_L2_TOL holds it with a factor of 2 to spare, pinned
    between 2x and 20x."""
    q, k, v, grid, dout = _inputs(B, H, W, 32, 32, seed=2)
    gen = torch.Generator().manual_seed(0)
    ref = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, bf16_roundings=True)
    same = _one_sweep_with_score_noise(q, k, v, grid, dout, 0.0, gen)
    noisy = _one_sweep_with_score_noise(q, k, v, grid, dout, 1e-6, gen)
    errs = []
    for a, b, r in zip(same, noisy, ref[:3]):
        assert _rel_l2(a, r) < 1e-6  # the written-out arithmetic is the package's
        errs.append(_rel_l2(b, r))
        assert 0 < errs[-1] <= corr.MMA_VS_MATCHED_L2_TOL / 2, errs
    assert max(errs) >= corr.MMA_VS_MATCHED_L2_TOL / 20, errs


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
    (torch.bfloat16, 136, 32, corr.DESIGN_MMA),  # channels streamed in chunks, 2 column tiles
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


def test_tensor_core_backward_source_is_its_own_library():
    """The tensor-core K2 and K3 build from correlation_bwd_mma.cu (with
    mma_tile.cuh), a library of their own beside the FMA design's, so that
    the two compile in parallel; the wrapper names each design's library."""
    files = {p.name for p in _build.source_files(BWD_SOURCE)}
    assert files == {"correlation_bwd_mma.cu", "mma_tile.cuh"}
    assert corr.KERNEL_BWD_MMA in corr.LIBRARIES and corr.KERNEL_BWD in corr.LIBRARIES
    assert "_mma(" not in (_build.CSRC_DIR / "correlation_bwd.cu").read_text()


REPO = Path(__file__).resolve().parent.parent
BWD_SOURCE = _build.CSRC_DIR / "correlation_bwd_mma.cu"


def _regression_widths():
    """(config, dtype, Cq, Cv) of K2 and K3 for every config under configs/regression/."""
    out = []
    for path in sorted((REPO / "configs" / "regression").rglob("*.yaml")):
        cfg = default_cfg.clone()
        cfg.merge_from_file(str(path))
        C = int(cfg.ENCODER.NUM_OUT_LAYERS)
        cq = C // 2 if cfg.AGGREGATOR.CV_HALF_CHANNELS else C
        out.append((str(path.relative_to(REPO / "configs" / "regression")),
                    getattr(torch, cfg.TPU.COMPUTE_DTYPE), cq, C))
    return out


def test_every_regression_config_takes_the_tensor_core_backward():
    widths = _regression_widths()
    assert len(widths) == 23
    assert {(cq, cv) for _, _, cq, cv in widths} == {(32, 32), (16, 32)}
    for name, dtype, cq, cv in widths:
        assert dtype == torch.bfloat16, name
        assert corr.backward_design(dtype, cq, cv) == corr.DESIGN_MMA, name
        assert corr.backward_design(torch.float32, cq, cv) == corr.DESIGN_FMA, name


WIDE_DESIGN_CASES = [(120, 120), (128, 128), (136, 136), (256, 256), (256, 96), (1024, 1024),
                     (32, 256), (136, 8)]


@pytest.mark.parametrize("cq,cv", WIDE_DESIGN_CASES, ids=[f"q{a}_v{b}" for a, b in WIDE_DESIGN_CASES])
def test_wide_bf16_backward_takes_the_tensor_cores(cq, cv):
    """The ResUNet at 128 and 256 channels, the ResNet encoder's 256 and
    1,024, and widths whose last channel chunk or column tile is narrow: all
    on the tensor cores in bf16 (K2 and K3 together), on the FMA design in
    float32; the matched and exact tolerances widen beyond 128 channels."""
    assert corr.backward_design(torch.bfloat16, cq, cv) == corr.DESIGN_MMA
    assert corr.backward_design(torch.float32, cq, cv) == corr.DESIGN_FMA
    wide = cq > 128 or cv > 128
    assert corr.mma_backward_matched_l2_tol(cq, cv) == (
        corr.MMA_VS_MATCHED_L2_TOL_WIDE if wide else corr.MMA_VS_MATCHED_L2_TOL)
    assert corr.mma_backward_exact_tol(cq, cv) == (
        corr.MMA_VS_EXACT_TOL_WIDE if wide else corr.MMA_VS_EXACT_TOL)


def test_tensor_core_backward_takes_every_bf16_multiple_of_8():
    widths = range(8, 1025, 8)
    assert all(corr.backward_design(torch.bfloat16, cq, cv) == corr.DESIGN_MMA
               for cq in widths for cv in widths)
    for cq, cv in ((8, 12), (12, 8), (1020, 1024), (1024, 1020), (1, 8)):
        assert corr.backward_design(torch.bfloat16, cq, cv) == corr.DESIGN_FMA


def test_kernel_key_tile_and_gap_are_the_plain_versions():
    """The .cu's TKG (keys a step of K2's online max) and LAZY_GAP (8 / log2e
    in raw score units) are the plain one-sweep's BWD_KEY_TILE and
    BWD_LAZY_GAP_LOG2."""
    src = BWD_SOURCE.read_text()
    assert re.findall(r"constexpr int TKG = (\d+);", src) == [str(corr.BWD_KEY_TILE)]
    gap = re.findall(r"constexpr float LAZY_GAP = ([\d.]+)f / LOG2E;", src)
    assert [float(g) for g in gap] == [corr.BWD_LAZY_GAP_LOG2]


@pytest.mark.parametrize("key_tile", [16, 64, 7])
@pytest.mark.parametrize("name,B,H,W", ROUNDING_CASES, ids=[c[0] for c in ROUNDING_CASES])
def test_one_sweep_without_rounding_is_the_exact_backward(name, B, H, W, key_tile):
    """K2's one sweep in float32 (key groups, the lazily moved reference,
    the final exp(m - M) / d and the max-score cotangent at the argmax) is the
    exact dq to float32 round-off, whatever the group size, and takes the
    exact backward's argmax."""
    q, k, v, grid, dout = _inputs(B, H, W, 32, 32, seed=6)
    exact = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout)
    dq, amax = corr._rows_one_sweep(q, k, v, grid, dout, None, key_tile, False)
    assert _rel_l2(dq, exact[0]) < 2e-6
    assert torch.equal(amax, exact[3])


def test_one_sweep_parts_match_the_whole():
    q, k, v, grid, dout = _inputs(2, 5, 7, 16, 8, seed=7)
    dq, _, _, amax = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout,
                                                          bf16_roundings=True)
    dq2, amax2 = corr.correlation_bwd_rows_plain(q, k, v, grid, dout, bf16_roundings=True)
    assert torch.equal(dq, dq2) and torch.equal(amax, amax2)
    assert torch.equal(dq, corr._rows_one_sweep(q, k, v, grid, dout, None,
                                                corr.BWD_KEY_TILE, True)[0])
    # the argmax given takes the max-score cotangent
    other = (amax + 1) % amax.shape[-1]
    moved = corr.correlation_bwd_rows_plain(q, k, v, grid, dout, other, bf16_roundings=True)[0]
    assert not torch.equal(moved, dq)


def _one_sweep_with_score_noise(q, k, v, grid, dout, noise, gen):
    """The tensor-core pair's arithmetic written out (K2's dq in one sweep
    over BWD_KEY_TILE keys with the lazy reference, dS' rounded relative to
    it; K3's P and dS rounded relative to the row's max), with the float32
    scores disturbed by ``noise`` x max |s| after the argmax and c are taken:
    what another summation order does to them."""
    B, HW, _ = q.shape
    Cv = v.shape[-1]
    rnd = lambda x: x.bfloat16().float()  # noqa: E731
    vg = torch.cat([v, grid.expand(B, HW, 2)], dim=-1).float()
    dmain, d_ms = dout[..., :Cv + 2], dout[..., Cv + 2:]
    qf, kf = q.float(), k.float()
    s = torch.bmm(qf, kf.transpose(1, 2))
    amax = s.argmax(dim=-1)
    dP = torch.bmm(dmain, vg.transpose(1, 2)).scatter_add_(2, amax[..., None], d_ms)
    c = (dP * torch.softmax(s, dim=-1)).sum(dim=-1, keepdim=True)
    if noise:
        s = s + noise * float(s.abs().max()) * torch.randn(s.shape, generator=gen)
    p = torch.softmax(s, dim=-1)
    dm = rnd(dmain)
    dP0 = torch.bmm(dm, vg.transpose(1, 2))
    P, dS = rnd(p), rnd(p * (dP0.scatter_add(2, amax[..., None], d_ms) - c))
    M, inv_d = s.amax(dim=-1, keepdim=True), p.amax(dim=-1, keepdim=True)
    gap = corr.BWD_LAZY_GAP_LOG2 * math.log(2.0)
    m = torch.full_like(M, -math.inf)
    best, acc = m.clone(), torch.zeros_like(qf)
    for j0 in range(0, HW, corr.BWD_KEY_TILE):
        sj = s[..., j0:j0 + corr.BWD_KEY_TILE]
        best = torch.maximum(best, sj.amax(dim=-1, keepdim=True))
        m_new = torch.where(best > m + gap, best, m)
        acc = torch.where(best > m + gap, acc * torch.exp(m - m_new), acc)
        ds = rnd(torch.exp(sj - m_new) * (dP0[..., j0:j0 + corr.BWD_KEY_TILE] - c))
        acc = acc + torch.bmm(ds, kf[:, j0:j0 + corr.BWD_KEY_TILE])
        m = m_new
    k_amax = kf.gather(1, amax[..., None].expand_as(kf))
    return ((acc * torch.exp(m - M) + d_ms * k_amax) * inv_d,
            torch.bmm(dS.transpose(1, 2), qf), torch.bmm(P.transpose(1, 2), dm[..., :Cv]))


@pytest.mark.parametrize("name,B,H,W", ROUNDING_CASES, ids=[c[0] for c in ROUNDING_CASES])
def test_score_noise_flips_few_one_sweep_roundings(name, B, H, W):
    """The same derivation at 128 channels (Cq = Cv), the widest that
    MMA_VS_MATCHED_L2_TOL and MMA_VS_EXACT_TOL serve: at the shapes and seeds
    they were derived on at C = 32 (and one more seed each), the score noise
    reads up to 6.4e-4 in L2 and the roundings up to 7.7e-3 of a gradient's
    largest entry, so both constants keep their factor of 2 there."""
    errs, exact_errs = [], []
    for seed in (2, 3):
        q, k, v, grid, dout = _inputs(B, H, W, 128, 128, seed)
        gen = torch.Generator().manual_seed(0)
        ref = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, bf16_roundings=True)
        noisy = _one_sweep_with_score_noise(q, k, v, grid, dout, 1e-6, gen)
        errs += [_rel_l2(b, r) for b, r in zip(noisy, ref[:3])]
    for seed in (0, 1):
        q, k, v, grid, dout = _inputs(B, H, W, 128, 128, seed)
        exact = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout)
        ref = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, bf16_roundings=True)
        exact_errs += [_scaled_err(a, r) for a, r in zip(ref[:3], exact[:3])]
    assert 0 < max(errs) <= corr.MMA_VS_MATCHED_L2_TOL / 2, errs
    assert max(exact_errs) <= corr.MMA_VS_EXACT_TOL / 2, exact_errs
    assert corr.mma_backward_matched_l2_tol(128, 128) == corr.MMA_VS_MATCHED_L2_TOL
    assert corr.mma_backward_exact_tol(128, 128) == corr.MMA_VS_EXACT_TOL


def test_one_sweep_rounding_differs_from_rounding_against_the_max():
    """Rounding dS' relative to the running reference (K2's one sweep)
    instead of dS relative to the row's max (as K3 rounds it) moves dq by
    more than MMA_VS_MATCHED_L2_TOL: the matched comparison needs the
    one-sweep arithmetic."""
    q, k, v, grid, dout = _inputs(2, 10, 13, 32, 32, seed=2)
    _, dS, _, _ = corr._bwd_plain_terms(q, k, v, grid, dout, None, bf16_roundings=True)
    against_the_max = torch.bmm(dS, k.float())
    one = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, bf16_roundings=True)
    assert _rel_l2(one[0], against_the_max) > corr.MMA_VS_MATCHED_L2_TOL
    assert torch.equal(one[1], torch.bmm(dS.transpose(1, 2), q.float()))


def _wide_inputs(cq, cv, H, W, seed, scaled):
    """bf16 inputs at B = 2 (phase 3's wide cases in chip_smoke.py), q and k
    scaled by (32 / Cq)^(1/4) before their rounding to bf16 so that the scores
    spread as at 32 channels, or unscaled."""
    rng = np.random.default_rng(seed)
    HW = H * W
    scale = (32.0 / cq) ** 0.25 if scaled else 1.0
    q, k = (torch.from_numpy(scale * rng.standard_normal((2, HW, cq), np.float32)).bfloat16()
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, HW, cv), np.float32)).bfloat16()
    dout = torch.from_numpy(rng.standard_normal((2, HW, cv + 3), np.float32))
    return q, k, v, _uv_grid(H, W).bfloat16(), dout


# (Cq, Cv, H, W): the widths the tensor-core pair takes beyond 128 channels
# and the 128-channel ResUNet, at HW = 20 (the ResNet bottleneck's 5 x 4
# grid) and 70
WIDE_CASES = [(cq, cv, H, W) for cq, cv in ((128, 128), (136, 136), (256, 256), (1024, 1024),
                                            (256, 96))
              for H, W in ((4, 5), (7, 10))]


def _wide_readings(cq, cv, H, W):
    """Over scaled and unscaled inputs and two seeds: the largest relative L2
    of the noisy arithmetic against the package's matched backward, and the
    largest share of a gradient's largest entry between the matched and the
    exact backward."""
    noise, exact = 0.0, 0.0
    for scaled in (True, False):
        for seed in (0, 1):
            q, k, v, grid, dout = _wide_inputs(cq, cv, H, W, seed, scaled)
            gen = torch.Generator().manual_seed(0)
            ref = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout, bf16_roundings=True)
            noisy = _one_sweep_with_score_noise(q, k, v, grid, dout, 1e-6, gen)
            noise = max(noise, max(_rel_l2(a, r) for a, r in zip(noisy, ref[:3])))
            ex = corr.fused_correlation_warp_bwd_plain(q, k, v, grid, dout)
            exact = max(exact, max(_scaled_err(a, r) for a, r in zip(ref[:3], ex[:3])))
    return noise, exact


def test_wide_readings_derive_the_wide_tolerances():
    """Peaked rows (unscaled inputs) carry a flipped rounding further and
    make dS cancel at the argmax, and at HW 20 and 70 one flip is a larger
    share of the norm: beyond 128 channels the matched noise reads up to
    2.9e-3 in L2 and the roundings up to 2.7e-2 of a gradient's largest
    entry, past half of the C = 32 constants. So these shapes take
    MMA_VS_MATCHED_L2_TOL_WIDE and MMA_VS_EXACT_TOL_WIDE, pinned as the C = 32
    ones are: between 2x and 20x of the largest reading. At 128 channels the
    C = 32 constants hold every reading (the matched noise up to 1.0e-3 at
    HW 70 against 1.5e-3; so few rows read as high at 32 channels too, 9.2e-4
    on these inputs, and at the derivation's shapes 128 channels keep the
    factor of 2: test_score_noise_flips_few_one_sweep_roundings)."""
    wide = {"noise": 0.0, "exact": 0.0}
    for cq, cv, H, W in WIDE_CASES:
        noise, exact = _wide_readings(cq, cv, H, W)
        if cq <= 128 and cv <= 128:
            assert noise <= corr.MMA_VS_MATCHED_L2_TOL and exact <= corr.MMA_VS_EXACT_TOL / 2
            continue
        wide = {"noise": max(wide["noise"], noise), "exact": max(wide["exact"], exact)}
    assert wide["noise"] > corr.MMA_VS_MATCHED_L2_TOL / 2
    assert wide["exact"] > corr.MMA_VS_EXACT_TOL / 2
    for key, tol in (("noise", corr.MMA_VS_MATCHED_L2_TOL_WIDE),
                     ("exact", corr.MMA_VS_EXACT_TOL_WIDE)):
        assert tol / 20 <= wide[key] <= tol / 2, (key, wide[key])
