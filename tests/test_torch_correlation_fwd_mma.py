"""PyTorch port: what surrounds the tensor-core design of the forward
correlation kernel K1 and can be checked without a card.

The kernel rounds P to bf16 before its product with [v | grid], relative to
each row's running max after each key tile; ``bf16_roundings=True`` makes the
plain forward do the same. Here that version is held against the exact plain
forward (which ``tests/test_torch_ops.py`` holds against the JAX package),
which derives the tolerances the card check (``chip_smoke.py``) uses; the
design dispatch, the key tile and the build digest are tested beside it. The
kernel itself runs on the card only. No JAX here.
"""

import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from mapfree_tpu_torch.config import cfg as default_cfg
from mapfree_tpu_torch.models.aggregators import _uv_grid
from mapfree_tpu_torch.ops import _build
from mapfree_tpu_torch.ops import correlation as corr

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
FWD_SOURCE = _build.CSRC_DIR / "correlation_fwd.cu"


def _inputs(B, H, W, cq, cv, seed):
    """bf16 q, k, v and the bf16 uv grid."""
    rng = np.random.default_rng(seed)
    HW = H * W
    q, k = (torch.from_numpy(rng.standard_normal((B, HW, cq), np.float32)).bfloat16()
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((B, HW, cv), np.float32)).bfloat16()
    return q, k, v, _uv_grid(H, W).bfloat16()


def _scaled_err(out, ref):
    """max |out - ref| relative to max(1, max |ref|), the card check's measure."""
    return float((out - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _rel_l2(out, ref):
    return float((out - ref).norm() / ref.norm())


# (name, B, H, W): C = 32, a ragged HW = 130 and HW = 1,020
ROUNDING_CASES = [("hw130", 2, 10, 13), ("hw1020", 1, 34, 30)]
CASE_IDS = [c[0] for c in ROUNDING_CASES]


@pytest.mark.parametrize("name,B,H,W", ROUNDING_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_rounding_costs_what_the_exact_tolerance_allows(name, B, H, W, seed):
    """The plain forward with the kernel's rounding against the exact one:
    each weight of P carries up to 2^-9 relative, so warped and pos move by
    about 1e-3 of their largest entry. MMA_FWD_VS_EXACT_TOL is pinned between
    2x and 20x of what is seen. The max score comes from the float32 P alone
    and moves by float32 round-off only."""
    q, k, v, grid = _inputs(B, H, W, 32, 32, seed)
    exact = corr.fused_correlation_warp_plain(q, k, v, grid)
    rounded = corr.fused_correlation_warp_plain(q, k, v, grid, bf16_roundings=True)
    for got, ref in zip(rounded[:2], exact[:2]):
        err = _scaled_err(got, ref)
        assert corr.MMA_FWD_VS_EXACT_TOL / 20 <= err <= corr.MMA_FWD_VS_EXACT_TOL / 2, err
    assert _scaled_err(rounded[2], exact[2]) < 2e-6


@pytest.mark.parametrize("name,B,H,W", ROUNDING_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("key_tile", [16, corr.FWD_KEY_TILE, 4096])
def test_tiled_arithmetic_without_rounding_is_the_exact_softmax(name, B, H, W, key_tile):
    """The running max, the float32 rescale and the denominator summed over
    tiles give the exact softmax to float32 round-off, whatever the tile: so
    what the tolerances measure is the bf16 rounding alone."""
    q, k, v, grid = _inputs(B, H, W, 32, 32, seed=2)
    exact = corr.fused_correlation_warp_plain(q, k, v, grid)
    tiled = corr.fused_correlation_warp_plain(q, k, v, grid, key_tile=key_tile)
    for got, ref in zip(tiled, exact):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert _scaled_err(got, ref) < 2e-6


def _rounded_forward_with_score_noise(q, k, v, grid, noise, gen):
    """The arithmetic of ``bf16_roundings=True`` written out, with the float32
    scores disturbed by ``noise`` x max |s|: what another summation order and
    another exponential do to them."""
    B, HW, _ = q.shape
    vg = torch.cat([v, grid.expand(B, HW, 2)], dim=-1).float()
    s_all = torch.bmm(q.float(), k.float().transpose(1, 2))
    if noise:
        s_all = s_all + noise * float(s_all.abs().max()) * torch.randn(s_all.shape, generator=gen)
    m = torch.full((B, HW, 1), float("-inf"))
    d = torch.zeros((B, HW, 1))
    acc = torch.zeros((B, HW, vg.shape[-1]))
    for j0 in range(0, HW, corr.FWD_KEY_TILE):
        s = s_all[..., j0:j0 + corr.FWD_KEY_TILE]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        d = d * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.bmm(p.bfloat16().float(), vg[:, j0:j0 + corr.FWD_KEY_TILE])
        m = m_new
    return acc[..., :-2] / d, acc[..., -2:] / d, 1.0 / d


@pytest.mark.parametrize("name,B,H,W", ROUNDING_CASES, ids=CASE_IDS)
def test_score_noise_flips_few_bf16_roundings(name, B, H, W):
    """Two float32 evaluations of P that differ by summation order (1e-6 of
    the largest score, several ulp) round to different bf16 values at a few
    weights, each by 2^-8 of the weight; over a few hundred rows one such
    flip at a peaked row moves warped by 1e-4 in L2. That is what the kernel
    is allowed against the plain forward with the same rounding:
    MMA_FWD_VS_MATCHED_L2_TOL is pinned between 2x and 20x of it. The max
    score moves by float32 noise alone, within the float32 kernel's 5e-5."""
    q, k, v, grid = _inputs(B, H, W, 32, 32, seed=2)
    gen = torch.Generator().manual_seed(0)
    ref = corr.fused_correlation_warp_plain(q, k, v, grid, bf16_roundings=True)
    same = _rounded_forward_with_score_noise(q, k, v, grid, 0.0, gen)
    noisy = _rounded_forward_with_score_noise(q, k, v, grid, 1e-6, gen)
    for a, b, r in zip(same[:2], noisy[:2], ref[:2]):
        assert _rel_l2(a, r) < 1e-6  # the written-out arithmetic is the package's
        err = _rel_l2(b, r)
        assert corr.MMA_FWD_VS_MATCHED_L2_TOL / 20 <= err <= corr.MMA_FWD_VS_MATCHED_L2_TOL / 2, err
    assert float((noisy[2] - ref[2]).abs().max()) < 5e-5


def _wide_inputs(cq, cv, H, W, seed, scaled):
    """bf16 inputs at B = 2 (phase 3's wide cases in chip_smoke.py), q and k
    scaled by (32 / Cq)^(1/4) before their rounding to bf16, so that the
    scores spread as at 32 channels, or unscaled (a score's spread grows as
    sqrt(Cq))."""
    rng = np.random.default_rng(seed)
    HW = H * W
    scale = (32.0 / cq) ** 0.25 if scaled else 1.0
    q, k = (torch.from_numpy(scale * rng.standard_normal((2, HW, cq), np.float32)).bfloat16()
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((2, HW, cv), np.float32)).bfloat16()
    return q, k, v, _uv_grid(H, W).bfloat16()


# (Cq, Cv, H, W): the widths the tensor-core forward takes from 128 channels
# on, at HW = 20 (the ResNet bottleneck's 5 x 4 grid) and 70
WIDE_CASES = [(cq, cv, H, W) for cq, cv in ((128, 128), (256, 256), (1024, 1024), (256, 96))
              for H, W in ((4, 5), (7, 10))]
WIDE_IDS = [f"q{c[0]}_v{c[1]}_hw{c[2] * c[3]}" for c in WIDE_CASES]


@pytest.mark.parametrize("cq,cv,H,W", WIDE_CASES, ids=WIDE_IDS)
@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "unscaled"])
def test_wide_rounding_stays_within_the_exact_tolerance(cq, cv, H, W, scaled):
    """At 128 to 1,024 channels, scaled and unscaled, the rounding of P costs
    at most half of MMA_FWD_VS_EXACT_TOL (the C = 32 constant covers these
    widths with its margin: no wide constant), and the max score moves by
    float32 round-off well inside the card's 5e-5."""
    q, k, v, grid = _wide_inputs(cq, cv, H, W, cq + cv + H * W, scaled)
    exact = corr.fused_correlation_warp_plain(q, k, v, grid)
    rounded = corr.fused_correlation_warp_plain(q, k, v, grid, bf16_roundings=True)
    for got, ref in zip(rounded[:2], exact[:2]):
        assert _scaled_err(got, ref) <= corr.MMA_FWD_VS_EXACT_TOL / 2
    assert _scaled_err(rounded[2], exact[2]) < 5e-5 / 2


def _wide_noise_reading(cq, cv, H, W, scaled, seed):
    q, k, v, grid = _wide_inputs(cq, cv, H, W, seed, scaled)
    gen = torch.Generator().manual_seed(0)
    ref = corr.fused_correlation_warp_plain(q, k, v, grid, bf16_roundings=True)
    noisy = _rounded_forward_with_score_noise(q, k, v, grid, 1e-6, gen)
    return max(_rel_l2(a, r) for a, r in zip(noisy[:2], ref[:2]))


def test_wide_score_noise_derives_the_wide_l2_tolerance():
    """The same score noise as at C = 32 (1e-6 of the largest score) over the
    wide cases at B = 2, two seeds each: unscaled inputs give peaked rows, in which one flip
    of a bf16 rounding moves warped further, up to some 3e-4 in L2 over 40
    rows, beyond half of MMA_FWD_VS_MATCHED_L2_TOL. So the wide shapes take
    MMA_FWD_VS_MATCHED_L2_TOL_WIDE, pinned as the C = 32 one is: between 2x
    and 20x of the largest reading. (The max score is not read here: 1e-6 of
    an unscaled 1,024-channel score of some 150 is far more than float32
    sums in another order move it; the test above bounds it.)"""
    readings = [_wide_noise_reading(cq, cv, H, W, scaled, seed)
                for cq, cv, H, W in WIDE_CASES for scaled in (True, False) for seed in (0, 1)]
    worst = max(readings)
    assert corr.MMA_FWD_VS_MATCHED_L2_TOL / 2 < worst
    tol = corr.MMA_FWD_VS_MATCHED_L2_TOL_WIDE
    assert tol / 20 <= worst <= tol / 2, worst


def test_rounded_version_defaults_and_the_cpu_route():
    """bf16_roundings takes FWD_KEY_TILE unless told otherwise; the default
    is the exact dense softmax, which is also what the Function computes on
    CPU tensors whatever design the card would take."""
    q, k, v, grid = _inputs(2, 5, 7, 16, 8, seed=3)
    rounded = corr.fused_correlation_warp_plain(q, k, v, grid, bf16_roundings=True)
    tiled = corr.fused_correlation_warp_plain(q, k, v, grid, bf16_roundings=True,
                                              key_tile=corr.FWD_KEY_TILE)
    assert all(torch.equal(a, b) for a, b in zip(rounded, tiled))
    exact = corr.fused_correlation_warp_plain(q, k, v, grid)
    assert not torch.equal(rounded[0], exact[0])
    assert corr.forward_design(q.dtype, 16, 8) == corr.DESIGN_MMA
    fused = corr.fused_correlation_warp(q, k, v, grid)
    assert all(torch.equal(a, b) for a, b in zip(fused, exact))


def _regression_widths():
    """(config, dtype, Cq, Cv) of K1 for every config under configs/regression/."""
    out = []
    for path in sorted((REPO / "configs" / "regression").rglob("*.yaml")):
        cfg = default_cfg.clone()
        cfg.merge_from_file(str(path))
        C = int(cfg.ENCODER.NUM_OUT_LAYERS)
        cq = C // 2 if cfg.AGGREGATOR.CV_HALF_CHANNELS else C
        out.append((str(path.relative_to(REPO / "configs" / "regression")),
                    getattr(torch, cfg.TPU.COMPUTE_DTYPE), cq, C))
    return out


def test_every_regression_config_takes_the_tensor_core_forward():
    widths = _regression_widths()
    assert len(widths) == 23
    assert {(cq, cv) for _, _, cq, cv in widths} == {(32, 32), (16, 32)}
    for name, dtype, cq, cv in widths:
        assert dtype == torch.bfloat16, name
        assert corr.forward_design(dtype, cq, cv) == corr.DESIGN_MMA, name
        # in float32 the same widths keep the exact FMA kernel
        assert corr.forward_design(torch.float32, cq, cv) == corr.DESIGN_FMA, name


DESIGN_CASES = [
    (torch.bfloat16, 32, 32, corr.DESIGN_MMA),   # the 3d3d main path
    (torch.bfloat16, 16, 32, corr.DESIGN_MMA),   # CV_HALF_CHANNELS
    (torch.bfloat16, 8, 8, corr.DESIGN_MMA),
    (torch.bfloat16, 128, 120, corr.DESIGN_MMA),
    (torch.bfloat16, 64, 24, corr.DESIGN_MMA),
    (torch.bfloat16, 128, 128, corr.DESIGN_MMA),  # a 128-channel ResUNet: Cv + 2 = 130
    (torch.bfloat16, 136, 32, corr.DESIGN_MMA),  # q and k streamed in channel chunks
    (torch.bfloat16, 256, 256, corr.DESIGN_MMA),  # the ResNet encoder's basic block
    (torch.bfloat16, 1024, 1024, corr.DESIGN_MMA),  # the ResNet bottleneck
    (torch.bfloat16, 256, 96, corr.DESIGN_MMA),  # Cq != Cv, both beyond one tile's reach
    (torch.bfloat16, 12, 12, corr.DESIGN_FMA),   # not a multiple of 8
    (torch.bfloat16, 32, 4, corr.DESIGN_FMA),
    (torch.float32, 32, 32, corr.DESIGN_FMA),    # float32 stays exact: no TF32
]


@pytest.mark.parametrize("dtype,cq,cv,design", DESIGN_CASES,
                         ids=[f"{str(d).split('.')[-1]}_q{a}_v{b}" for d, a, b, _ in DESIGN_CASES])
def test_forward_design_dispatch(dtype, cq, cv, design):
    assert corr.forward_design(dtype, cq, cv) == design


def test_tensor_core_forward_takes_every_bf16_multiple_of_8():
    """Every Cq and Cv that are multiples of 8 from 8 to 1,024 go to the
    tensor cores in bf16; other bf16 widths and float32 keep the FMA design."""
    widths = range(8, 1025, 8)
    assert all(corr.forward_design(torch.bfloat16, cq, cv) == corr.DESIGN_MMA
               for cq in widths for cv in widths)
    for cq, cv in ((8, 12), (12, 8), (1020, 1024), (1024, 1020), (1, 8)):
        assert corr.forward_design(torch.bfloat16, cq, cv) == corr.DESIGN_FMA
    assert all(corr.forward_design(torch.float32, c, c) == corr.DESIGN_FMA for c in widths)


def test_matched_l2_tolerance_by_width():
    """The C = 32 constant holds where the design reached before (Cq up to
    128, Cv up to 120); the wide constant beyond."""
    for cq, cv in ((32, 32), (16, 32), (128, 120), (64, 64)):
        assert corr.mma_forward_matched_l2_tol(cq, cv) == corr.MMA_FWD_VS_MATCHED_L2_TOL
    for cq, cv in ((128, 128), (136, 32), (1024, 1024), (256, 96)):
        assert corr.mma_forward_matched_l2_tol(cq, cv) == corr.MMA_FWD_VS_MATCHED_L2_TOL_WIDE


def test_kernel_key_tile_is_the_plain_versions_tile():
    """The .cu's TK is the tile of the plain version's roundings."""
    tiles = re.findall(r"constexpr int TK = (\d+);", FWD_SOURCE.read_text())
    assert tiles == [str(corr.FWD_KEY_TILE)]


@pytest.mark.parametrize("kernel", sorted(corr.FWD_KEY_TILES))
def test_each_tensor_core_kernel_key_tile_matches_the_cu(kernel):
    """Each kernel of K1's tensor-core design names its key tile in the .cu
    (FWD_KEY_TILES), and it is the tile the plain version's roundings take,
    so that one bf16_roundings yardstick serves both kernels."""
    name, tile = corr.FWD_KEY_TILES[kernel]
    tiles = re.findall(rf"constexpr int {name} = (\d+);", FWD_SOURCE.read_text())
    assert tiles == [str(tile)]
    assert tile == corr.FWD_KEY_TILE


@pytest.mark.parametrize("kernel", sorted(corr.FWD_KEY_TILES))
@pytest.mark.parametrize("name,B,H,W", ROUNDING_CASES, ids=CASE_IDS)
def test_each_kernel_tile_rounding_holds_the_constants(kernel, name, B, H, W):
    """The plain forward rounding P at each kernel's key tile, against the
    exact forward within half of MMA_FWD_VS_EXACT_TOL, its max score at the
    float32 tolerance; and against the default bf16_roundings to the bit
    (one tile for both kernels)."""
    tile = corr.FWD_KEY_TILES[kernel][1]
    q, k, v, grid = _inputs(B, H, W, 32, 32, seed=7)
    exact = corr.fused_correlation_warp_plain(q, k, v, grid)
    rounded = corr.fused_correlation_warp_plain(q, k, v, grid, bf16_roundings=True,
                                                key_tile=tile)
    for got, ref in zip(rounded[:2], exact[:2]):
        assert _scaled_err(got, ref) <= corr.MMA_FWD_VS_EXACT_TOL / 2
    assert _scaled_err(rounded[2], exact[2]) < 5e-5
    default = corr.fused_correlation_warp_plain(q, k, v, grid, bf16_roundings=True)
    assert all(torch.equal(a, b) for a, b in zip(rounded, default))


# (path, HW, Cq, Cv) -> the kernel of K1's tensor-core design that serves it:
# the 3d3d grid (360x270 frames, stride 4: 92 x 68) for the sweep, the train
# step and the fusion sweep's 576 rows; ScanNet's 320x240 (80 x 60); the
# 128- and 256-channel ResUNets; 256 / 96; the ResNet encoder's 5x4 grid
DRIVEN_K1 = [
    ("3d3d", 6256, 32, 32, corr.KERNEL_FWD_WGMMA),
    ("cv_half_channels", 6256, 16, 32, corr.KERNEL_FWD_WGMMA),
    ("scannet", 4800, 32, 32, corr.KERNEL_FWD_WGMMA),
    ("resunet128", 6256, 128, 128, corr.KERNEL_FWD_WGMMA),
    ("q256_v96", 6256, 256, 96, corr.KERNEL_FWD_WGMMA),
    ("resunet256", 6256, 256, 256, corr.KERNEL_FWD_WGMMA),
    ("resnet_bottleneck", 20, 1024, 1024, corr.KERNEL_FWD_MMA_SYNC),
    ("hw64_few_rows", 64, 32, 32, corr.KERNEL_FWD_MMA_SYNC),
    ("hw65", 65, 32, 32, corr.KERNEL_FWD_WGMMA),
    ("q264_streamed", 6256, 264, 32, corr.KERNEL_FWD_MMA_SYNC),
]


@pytest.mark.parametrize("name,HW,cq,cv,kernel", DRIVEN_K1, ids=[c[0] for c in DRIVEN_K1])
def test_forward_kernel_at_the_driven_shapes(name, HW, cq, cv, kernel):
    """The kernel forward_kernel picks, which _forward_cuda launches: the
    wgmma kernel beyond FEW_ROWS_HW positions with Cq up to WGMMA_MAX_CQ,
    the mma.sync kernel on the few-rows grids and for wider q; none in
    float32 or at a bf16 width the FMA design takes."""
    assert corr.forward_kernel(torch.bfloat16, HW, cq, cv) == kernel
    assert corr.forward_kernel(torch.float32, HW, cq, cv) is None
    assert corr.forward_kernel(torch.bfloat16, HW, cq + 4, cv) is None


def test_forward_cuda_refuses_an_unknown_kernel():
    """A tensor-core kernel asked for by a name the design lacks raises
    before anything is launched (no fallback)."""
    q, k, v, grid = _inputs(1, 3, 5, 32, 32, seed=1)
    with pytest.raises(ValueError, match="no kernel"):
        corr._forward_cuda(q, k, v, grid, kernel="wmma")


def test_forward_build_follows_the_shared_tile_header(tmp_path):
    """K1's source includes mma_tile.cuh and hopper_tile.cuh, so editing
    either header rebuilds K1 (mma_tile.cuh rebuilds K2 and K3 too)."""
    files = {p.name for p in _build.source_files(FWD_SOURCE)}
    assert files == {"correlation_fwd.cu", "mma_tile.cuh", "hopper_tile.cuh"}
    for name in files:
        shutil.copy(_build.CSRC_DIR / name, tmp_path / name)
    src = tmp_path / "correlation_fwd.cu"
    assert _build.source_digest(src) == _build.source_digest(FWD_SOURCE)
    for name in ("mma_tile.cuh", "hopper_tile.cuh"):
        header = tmp_path / name
        saved = header.read_text()
        header.write_text(saved + "\n// edited\n")
        assert _build.source_digest(src) != _build.source_digest(FWD_SOURCE)
        header.write_text(saved)
    assert _build.source_digest(src) == _build.source_digest(FWD_SOURCE)
