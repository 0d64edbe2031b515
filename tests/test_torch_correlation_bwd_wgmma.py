"""PyTorch port: what surrounds the wgmma pair of K2 and K3's tensor-core
design (``ops/csrc/correlation_bwd_wgmma.cu``) and can be checked without a
card: which pair ``backward_kernel`` gives every path, the pair's constants
against the plain backward's, its width classes against the .cu's
dispatch, its library and build digest, and the refusal of a pair the
design lacks. The kernels themselves run on the card only
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``). No JAX here.
"""

import re
import shutil
from pathlib import Path

import pytest
import torch

from mapfree_tpu_torch.config import cfg as default_cfg
from mapfree_tpu_torch.models.encoders import encoder_out_hw
from mapfree_tpu_torch.ops import _build
from mapfree_tpu_torch.ops import correlation as corr

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
WGMMA_SOURCE = _build.CSRC_DIR / "correlation_bwd_wgmma.cu"
MMA_SOURCE = _build.CSRC_DIR / "correlation_bwd_mma.cu"
REGRESSION = sorted((REPO / "configs" / "regression").rglob("*.yaml"))


def _train_shape(path):
    """(dtype, HW, Cq, Cv) of K2 and K3 in a config's train step: the model
    YAML over its dataset config (configs/scannet.yaml for ScanNet, else
    configs/mapfree.yaml, then configs/mapfree_multi.yaml for the
    multi-frame models), HW the encoder's output grid of its frames."""
    cfg = default_cfg.clone()
    rel = str(path.relative_to(REPO))
    cfg.merge_from_file(str(REPO / ("configs/scannet.yaml" if "/scannet/" in rel
                                    else "configs/mapfree.yaml")))
    if "/multiframe/" in rel:
        cfg.merge_from_file(str(REPO / "configs/mapfree_multi.yaml"))
    cfg.merge_from_file(str(path))
    H, W = encoder_out_hw(cfg.ENCODER, int(cfg.DATASET.HEIGHT), int(cfg.DATASET.WIDTH))
    C = int(cfg.ENCODER.NUM_OUT_LAYERS)
    cq = C // 2 if cfg.AGGREGATOR.CV_HALF_CHANNELS else C
    return getattr(torch, cfg.TPU.COMPUTE_DTYPE), H * W, cq, C


def test_the_regression_configs_are_all_here():
    assert len(REGRESSION) == 23


@pytest.mark.parametrize("path", REGRESSION,
                         ids=[str(p.relative_to(REPO / "configs" / "regression"))
                              for p in REGRESSION])
def test_every_regression_config_trains_on_the_measured_pair(path):
    """Every config under configs/regression/ trains in bf16 on a grid of
    more than 64 positions at 32 channels (16 / 32 with CV_HALF_CHANNELS),
    where the mma.sync K2 and K3 measured faster than the wgmma ones
    (MMA_SYNC_FASTER): the mma.sync pair; in float32 the same widths take
    the FMA design (no tensor-core pair)."""
    dtype, HW, cq, cv = _train_shape(path)
    assert dtype == torch.bfloat16 and HW > corr.FEW_ROWS_HW
    assert corr.wgmma_width_class(cq, cv) in corr.MMA_SYNC_FASTER
    assert corr.backward_kernel(dtype, HW, cq, cv) == corr.KERNEL_FWD_MMA_SYNC
    assert corr.backward_kernel(torch.float32, HW, cq, cv) is None


WG, MS = corr.KERNEL_FWD_WGMMA, corr.KERNEL_FWD_MMA_SYNC
# (path, HW, Cq, Cv) -> the pair of K2 and K3's tensor-core design that
# serves it: the 3d3d grid (360x270 frames: 92 x 68) for the train step and
# the fusion step's 90 rows, ScanNet's 80 x 60, CV_HALF_CHANNELS, the 128-
# and 256-channel ResUNets, 256 / 96, the ResNet encoder's 5 x 4 grid at 256
# and 1,024 channels, the edges of FEW_ROWS_HW and WGMMA_MAX_CQ
DRIVEN = [
    ("3d3d", 6256, 32, 32, MS),
    ("cv_half_channels", 6256, 16, 32, MS),
    ("scannet", 4800, 32, 32, MS),
    ("resunet128", 6256, 128, 128, WG),
    ("q256_v96", 6256, 256, 96, WG),
    ("resunet256", 6256, 256, 256, WG),
    ("resnet_basic_block", 20, 256, 256, MS),
    ("resnet_bottleneck", 20, 1024, 1024, MS),
    ("hw64_few_rows_c128", 64, 128, 128, MS),
    ("hw65_c128", 65, 128, 128, WG),
    ("q264_wider_than_resident", 6256, 264, 32, MS),
    ("v264_wider_than_resident", 6256, 32, 264, MS),
]


@pytest.mark.parametrize("name,HW,cq,cv,kernel", DRIVEN, ids=[c[0] for c in DRIVEN])
def test_backward_kernel_at_the_driven_shapes(name, HW, cq, cv, kernel):
    """The pair backward_kernel picks, which correlation_bwd_rows and
    correlation_bwd_cols launch: wgmma beyond FEW_ROWS_HW positions with Cq
    and Cv up to WGMMA_MAX_CQ where it measured faster (128 and 256
    channels, 256 / 96), mma.sync elsewhere (32 channels, the few-rows
    grids, wider); none in float32 or at a bf16 width the FMA design takes."""
    assert corr.backward_kernel(torch.bfloat16, HW, cq, cv) == kernel
    assert corr.backward_kernel(torch.float32, HW, cq, cv) is None
    assert corr.backward_kernel(torch.bfloat16, HW, cq + 4, cv) is None


def test_backward_kernel_follows_the_design():
    """Every bf16 width the tensor-core design takes has a pair; the wgmma
    one exactly beyond FEW_ROWS_HW positions, within the wgmma kernels'
    width classes and outside MMA_SYNC_FASTER."""
    for HW in (20, 64, 65, 6256):
        for cq in range(8, 513, 8):
            for cv in (8, 24, 96, 128, 136, 256, 264):
                width = corr.wgmma_width_class(cq, cv)
                assert (width is None) == (max(cq, cv) > corr.WGMMA_MAX_CQ or cq > 256)
                got = corr.backward_kernel(torch.bfloat16, HW, cq, cv)
                assert got in corr.BWD_KERNELS
                assert (got == WG) == (HW > corr.FEW_ROWS_HW and width is not None
                                       and width not in corr.MMA_SYNC_FASTER)


@pytest.mark.parametrize("dispatch", ["dispatch_rows_wgmma", "dispatch_cols_wgmma"])
def test_width_classes_are_the_cu_dispatchs(dispatch):
    """WGMMA_WIDTH_CLASSES is each wgmma dispatch's list of (Cq, Cv) classes,
    in its order, and MMA_SYNC_FASTER names classes of it."""
    src = WGMMA_SOURCE.read_text()
    body = src[src.index(f"cudaError_t {dispatch}(const Args& a)"):]
    body = body[:body.index("return cudaErrorInvalidValue;")]
    classes = [(int(a), int(b)) for a, b in
               re.findall(r"if \(a\.Cq <= (\d+) && a\.Cv <= (\d+)\)", body)]
    assert tuple(classes) == corr.WGMMA_WIDTH_CLASSES
    assert corr.MMA_SYNC_FASTER <= set(corr.WGMMA_WIDTH_CLASSES)


@pytest.mark.parametrize("source", [MMA_SOURCE, WGMMA_SOURCE], ids=["mma_sync", "wgmma"])
def test_each_pair_keeps_the_plain_versions_key_group_and_gap(source):
    """Both pairs' TKG (keys a step of K2's online max) and LAZY_GAP (8 /
    log2e in raw score units) are the plain one-sweep's BWD_KEY_TILE and
    BWD_LAZY_GAP_LOG2, so that one bf16_roundings yardstick serves both."""
    src = source.read_text()
    assert re.findall(r"constexpr int TKG = (\d+);", src) == [str(corr.BWD_KEY_TILE)]
    gap = re.findall(r"constexpr float LAZY_GAP = ([\d.]+)f / LOG2E;", src)
    assert [float(g) for g in gap] == [corr.BWD_LAZY_GAP_LOG2]


def test_wgmma_pair_is_a_library_of_its_own():
    """The wgmma pair builds from correlation_bwd_wgmma.cu, its own entry in
    LIBRARIES (so its nvcc runs beside the others'), and each pair's C
    functions stand in its library's source."""
    assert corr.KERNEL_BWD_WGMMA in corr.LIBRARIES
    assert len(set(corr.LIBRARIES)) == len(corr.LIBRARIES)
    for kernel, (library, suffix) in corr.BWD_KERNELS.items():
        assert library in corr.LIBRARIES
        src = (_build.CSRC_DIR / f"{library}.cu").read_text()
        for fn in (corr.KERNEL_BWD_ROWS + suffix, corr.KERNEL_BWD_COLS + suffix):
            assert f'extern "C" int {fn}(' in src, (kernel, fn)
    assert set(corr.BWD_KERNELS) == set(corr.FWD_KEY_TILES)


def test_wgmma_build_follows_its_headers(tmp_path):
    """The wgmma pair's source includes hopper_tile.cuh and mma_tile.cuh:
    editing either names a new build of it."""
    files = {p.name for p in _build.source_files(WGMMA_SOURCE)}
    assert files == {"correlation_bwd_wgmma.cu", "hopper_tile.cuh", "mma_tile.cuh"}
    for name in files:
        shutil.copy(_build.CSRC_DIR / name, tmp_path / name)
    src = tmp_path / "correlation_bwd_wgmma.cu"
    assert _build.source_digest(src) == _build.source_digest(WGMMA_SOURCE)
    for name in ("hopper_tile.cuh", "mma_tile.cuh"):
        header = tmp_path / name
        saved = header.read_text()
        header.write_text(saved + "\n// edited\n")
        assert _build.source_digest(src) != _build.source_digest(WGMMA_SOURCE)
        header.write_text(saved)
    assert _build.source_digest(src) == _build.source_digest(WGMMA_SOURCE)


def _bf16(B, HW, C, seed):
    return torch.randn((B, HW, C), generator=torch.Generator().manual_seed(seed)).bfloat16()


@pytest.mark.parametrize("kernel", ["wmma", "mma", "fma"])
def test_an_unknown_backward_kernel_is_refused(kernel):
    """K2 and K3 asked for a kernel the tensor-core design lacks raise
    before anything is launched (no fallback)."""
    q, k, v = _bf16(1, 70, 32, 0), _bf16(1, 70, 32, 1), _bf16(1, 70, 32, 2)
    grid = torch.zeros((70, 2), dtype=torch.bfloat16)
    out = torch.zeros((1, 70, 35))
    with pytest.raises(ValueError, match="no kernel"):
        corr.correlation_bwd_rows(q, k, v, grid, out, out, kernel=kernel)
    rows = corr.RowPass(torch.zeros((1, 70, 4)), torch.zeros((1, 70), dtype=torch.int32),
                        torch.zeros((1, 70, corr.dmain_width(32)), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel"):
        corr.correlation_bwd_cols(q, k, v, grid, out, rows, kernel=kernel)


def test_launches_by_function_reset_with_the_counts():
    """reset_launches clears the per-function counts beside the per-kernel
    ones."""
    corr.kernel_launches["correlation_bwd_rows_wgmma"] = 3
    corr.reset_launches()
    assert corr.kernel_launches == {} and not any(corr.launches.values())
