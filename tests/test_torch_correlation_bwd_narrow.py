"""PyTorch port: what surrounds the narrow pair of K2 and K3's tensor-core
design (``ops/csrc/correlation_bwd_narrow.cu``, bf16 with Cq and Cv up to 64
beyond 64 positions) and can be checked without a card: which pair
``backward_kernel`` gives the narrow widths, the pair's width classes and
constants against its .cu, its library and build digest, and the refusal
of a pair the design lacks. The kernels themselves run on the card only
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 3). No JAX
here.
"""

import re
import shutil

import pytest
import torch

from mapfree_tpu_torch.ops import _build
from mapfree_tpu_torch.ops import correlation as corr

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NARROW_SOURCE = _build.CSRC_DIR / "correlation_bwd_narrow.cu"
NW, MS = corr.KERNEL_BWD_PAIR_NARROW, corr.KERNEL_FWD_MMA_SYNC


@pytest.mark.parametrize("dispatch", ["dispatch_rows_narrow", "dispatch_cols_narrow"])
def test_narrow_classes_are_the_cu_dispatchs(dispatch):
    """NARROW_WIDTH_CLASSES is each narrow dispatch's list of (Cq, Cv)
    classes, in its order; the wgmma pair's classes all lie beyond them, and
    MMA_SYNC_FASTER names narrow classes."""
    src = NARROW_SOURCE.read_text()
    body = src[src.index(f"cudaError_t {dispatch}(const Args& a)"):]
    body = body[:body.index("return cudaErrorInvalidValue;")]
    classes = [(int(a), int(b)) for a, b in
               re.findall(r"if \(a\.Cq <= (\d+) && a\.Cv <= (\d+)\)", body)]
    assert tuple(classes) == corr.NARROW_WIDTH_CLASSES
    assert all(max(c) > 64 for c in corr.WGMMA_WIDTH_CLASSES)
    assert corr.MMA_SYNC_FASTER < set(corr.NARROW_WIDTH_CLASSES)


def test_narrow_pair_takes_what_its_classes_hold():
    """The C functions take bf16 multiples of 8 up to the widest class's 64
    channels, and every instantiation a class launches holds the class."""
    src = NARROW_SOURCE.read_text()
    guard = src[src.index("bool narrow_takes("):]
    guard = guard[:guard.index("}")]
    widest = max(max(c) for c in corr.NARROW_WIDTH_CLASSES)
    assert f"Cq <= {widest} && Cv <= {widest}" in guard and "dtype == 1" in guard
    for dispatch in ("dispatch_rows_narrow", "dispatch_cols_narrow"):
        body = src[src.index(f"cudaError_t {dispatch}(const Args& a)"):]
        body = body[:body.index("return cudaErrorInvalidValue;")]
        for cq, cv, w, c in re.findall(
                r"if \(a\.Cq <= (\d+) && a\.Cv <= (\d+)\) return launch_\w+<(\d+), (\d+),", body):
            assert (int(w), int(c)) == (int(cq), int(cv)), dispatch


def test_narrow_pair_is_a_library_of_its_own():
    """The narrow pair builds from correlation_bwd_narrow.cu, its own entry
    in LIBRARIES (its nvcc runs beside the others'), and names its C
    functions with its suffix."""
    assert corr.KERNEL_BWD_NARROW in corr.LIBRARIES
    assert corr.BWD_KERNELS[NW] == (corr.KERNEL_BWD_NARROW, "_narrow")
    assert NARROW_SOURCE.is_file()
    src = NARROW_SOURCE.read_text()
    for fn in (corr.KERNEL_BWD_ROWS + "_narrow", corr.KERNEL_BWD_COLS + "_narrow"):
        assert f'extern "C" int {fn}(' in src
    assert len({lib for lib, _ in corr.BWD_KERNELS.values()}) == len(corr.BWD_KERNELS)


def test_narrow_build_follows_its_headers(tmp_path):
    """The narrow pair's source includes correlation_bwd_hopper.cuh (the parts
    both Hopper pairs share), hopper_tile.cuh and mma_tile.cuh: editing any
    of them names a new build of it."""
    files = {p.name for p in _build.source_files(NARROW_SOURCE)}
    assert files == {"correlation_bwd_narrow.cu", "correlation_bwd_hopper.cuh", "hopper_tile.cuh",
                     "mma_tile.cuh"}
    for name in files:
        shutil.copy(_build.CSRC_DIR / name, tmp_path / name)
    src = tmp_path / "correlation_bwd_narrow.cu"
    assert _build.source_digest(src) == _build.source_digest(NARROW_SOURCE)
    for name in ("correlation_bwd_hopper.cuh", "hopper_tile.cuh", "mma_tile.cuh"):
        header = tmp_path / name
        saved = header.read_text()
        header.write_text(saved + "\n// edited\n")
        assert _build.source_digest(src) != _build.source_digest(NARROW_SOURCE)
        header.write_text(saved)
    assert _build.source_digest(src) == _build.source_digest(NARROW_SOURCE)


@pytest.mark.parametrize("HW", [65, 70, 1000, 4800, 6256])
def test_backward_kernel_gives_the_narrow_widths_their_measured_pair(HW):
    """Beyond FEW_ROWS_HW positions every bf16 width up to 64 channels takes
    the mma.sync pair where its class is in MMA_SYNC_FASTER and the narrow
    pair where it is not; float32 and bf16 widths off the multiples of 8
    take no tensor-core pair."""
    for cq in range(8, 65, 8):
        for cv in range(8, 65, 8):
            width = corr.hopper_width_class(cq, cv)
            assert width in corr.NARROW_WIDTH_CLASSES
            want = MS if width in corr.MMA_SYNC_FASTER else NW
            assert corr.backward_kernel(torch.bfloat16, HW, cq, cv) == want
            assert corr.backward_kernel(torch.float32, HW, cq, cv) is None
    assert corr.backward_kernel(torch.bfloat16, HW, 36, 32) is None


@pytest.mark.parametrize("HW", [1, 20, 63, 64])
def test_few_rows_keep_the_mma_sync_pair(HW):
    """Up to FEW_ROWS_HW positions (the ResNet encoder's 5x4 grid) every
    narrow width keeps the mma.sync pair: a 64-row warpgroup product would
    leave most of its rows empty."""
    for cq, cv in corr.NARROW_WIDTH_CLASSES + ((8, 8), (24, 40)):
        assert corr.backward_kernel(torch.bfloat16, HW, cq, cv) == MS


# the published train steps' K2 and K3 (every config under
# configs/regression/ at NUM_OUT_LAYERS 32: 3d3d's grid, the fusion step's,
# ScanNet's, and 16 / 32 with CV_HALF_CHANNELS), the narrow classes' other
# widths, and the ResNet encoder's 5x4 grid
DRIVEN_NARROW = [
    ("3d3d", 6256, 32, 32, MS),
    ("fusion", 6256, 32, 32, MS),
    ("cv_half_channels", 6256, 16, 32, MS),
    ("scannet", 4800, 32, 32, MS),
    ("c16", 6256, 16, 16, MS),
    ("c64", 6256, 64, 64, NW),
    ("c48_v64", 6256, 48, 64, NW),
    ("resnet_grid_c64", 20, 64, 64, MS),
]


@pytest.mark.parametrize("name,HW,cq,cv,kernel", DRIVEN_NARROW, ids=[c[0] for c in DRIVEN_NARROW])
def test_backward_kernel_at_the_driven_narrow_shapes(name, HW, cq, cv, kernel):
    """The pair correlation_bwd_rows and correlation_bwd_cols launch at the
    narrow shapes: the narrow pair at 64 channels, where it measured faster
    than the mma.sync pair in the same call; the mma.sync pair at 16 and 32
    channels (the published train steps), where it stayed faster, and on
    the 5x4 grid."""
    assert corr.backward_kernel(torch.bfloat16, HW, cq, cv) == kernel


@pytest.mark.parametrize("kernel", ["Narrow", "narrow_wgmma", "wgmma_narrow", "narrow "])
def test_an_unknown_pair_is_refused_beside_the_narrow_one(kernel):
    """Only the three pairs' names are taken: a misspelt pair raises before
    anything is launched (no fallback)."""
    q = k = v = torch.zeros((1, 70, 32), dtype=torch.bfloat16)
    grid = torch.zeros((70, 2), dtype=torch.bfloat16)
    out = torch.zeros((1, 70, 35))
    with pytest.raises(ValueError, match="no kernel"):
        corr.correlation_bwd_rows(q, k, v, grid, out, out, kernel=kernel)
    rows = corr.RowPass(torch.zeros((1, 70, 4)), torch.zeros((1, 70), dtype=torch.int32),
                        torch.zeros((1, 70, corr.dmain_width(32)), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel"):
        corr.correlation_bwd_cols(q, k, v, grid, out, rows, kernel=kernel)
