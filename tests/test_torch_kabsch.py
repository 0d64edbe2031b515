"""PyTorch port: the routes of ``geom/procrustes.py::procrustes``, the Kabsch
kernel's wrapper (``ops/kabsch.py``) and what the kernel
(``ops/csrc/kabsch.cu``) states, on the CPU.

The kernel runs only on a card: its cases against the tensor version are the
``cuda`` tests in ``tests/test_torch_cuda_kernels.py``. Here the route is
held on fake CUDA tensors (``FakeTensorMode``: shapes, devices and flags, no
data), the wrapper's refusals before any launch, and the kernel's constants
against the tensor version's. Imports no JAX.
"""

import inspect
import re
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mapfree_tpu_torch.geom import smallblas
from mapfree_tpu_torch.geom.procrustes import (ROUTE_KERNEL, ROUTE_TENSOR, procrustes,
                                               procrustes_plain, procrustes_route)
from mapfree_tpu_torch.ops import _build, kabsch

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KABSCH_SOURCE = _build.CSRC_DIR / "kabsch.cu"


def _cu_constant(name: str) -> float:
    found = re.findall(rf"constexpr (?:int|float) {name} = ([0-9.e+-]+)f?;",
                       KABSCH_SOURCE.read_text())
    assert len(found) == 1, f"{name} in {KABSCH_SOURCE.name}: {found}"
    return float(found[0])


def _inputs(device, dtype=torch.float32, grad=(), weights=False, n=4, N=3):
    """A, B [n, N, 3] and weights [n, N] (or None); those named in ``grad``
    require grad."""
    A = torch.empty((n, N, 3), device=device, dtype=dtype, requires_grad="A" in grad)
    B = torch.empty((n, N, 3), device=device, dtype=dtype)
    w = (torch.empty((n, N), device=device, dtype=dtype, requires_grad="weights" in grad)
         if weights else None)
    return A, B, w


# (case, device, dtype, inputs that require grad, weights, grad mode, route)
ROUTE_CASES = [
    ("cpu", "cpu", torch.float32, (), False, "grad", ROUTE_TENSOR),
    ("cpu_no_grad", "cpu", torch.float32, (), False, "no_grad", ROUTE_TENSOR),
    ("cpu_requires_grad", "cpu", torch.float32, ("A",), True, "grad", ROUTE_TENSOR),
    ("cuda_no_grad", "cuda", torch.float32, (), False, "no_grad", ROUTE_KERNEL),
    ("cuda_inference_mode", "cuda", torch.float32, (), True, "inference_mode",
     ROUTE_KERNEL),
    ("cuda_grad_enabled_nothing_requires_it", "cuda", torch.float32, (), True, "grad",
     ROUTE_KERNEL),
    ("cuda_requires_grad", "cuda", torch.float32, ("A",), False, "grad", ROUTE_TENSOR),
    ("cuda_requires_grad_weighted", "cuda", torch.float32, ("A",), True, "grad",
     ROUTE_TENSOR),
    ("cuda_weights_require_grad", "cuda", torch.float32, ("weights",), True, "grad",
     ROUTE_TENSOR),
    ("cuda_requires_grad_under_no_grad", "cuda", torch.float32, ("A",), False, "no_grad",
     ROUTE_KERNEL),
    ("cuda_bf16", "cuda", torch.bfloat16, (), False, "inference_mode", ROUTE_KERNEL),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_procrustes_route(case):
    """The kernel on CUDA wherever autograd records nothing; the tensor
    version on the CPU and where it records (a training step)."""
    _, device, dtype, grad, weights, mode, route = case
    with FakeTensorMode():
        A, B, w = _inputs(device, dtype, grad, weights)
        scope = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
                 "inference_mode": torch.inference_mode}[mode]
        with scope():
            assert procrustes_route(A, B, w) == route


@pytest.mark.parametrize("weighted", [False, True])
def test_kernel_route_hands_on_contiguous_float32(monkeypatch, weighted):
    """A call routed to the kernel casts to float32 first (bf16 anchors, a
    bool mask) and makes every input contiguous (the heads' expanded
    identity basis); the kernel's outputs are returned as they come."""
    seen = {}

    def fake_kernel(A, B, weights=None):
        seen.update(A=A, B=B, weights=weights)
        return "R", "t"

    # the route forced on CPU tensors (a fake CUDA tensor cannot be made
    # contiguous without a CUDA build): the module, not the function that
    # geom/__init__.py exports by its name
    monkeypatch.setattr(sys.modules[procrustes.__module__], "procrustes_route",
                        lambda *args: ROUTE_KERNEL)
    monkeypatch.setattr(kabsch, "procrustes_cuda", fake_kernel)
    A = torch.eye(3).expand(5, 3, 3)
    B = torch.randn(5, 3, 3).to(torch.bfloat16)
    w = torch.ones(5, 3, dtype=torch.bool) if weighted else None
    assert procrustes(A, B, w) == ("R", "t")
    inputs = [seen["A"], seen["B"]] + ([seen["weights"]] if weighted else [])
    assert all(x.dtype == torch.float32 and x.is_contiguous() for x in inputs)
    assert seen["weights"] is None or seen["weights"].shape == (5, 3)
    torch.testing.assert_close(seen["B"], B.float())


def test_cpu_route_is_the_tensor_version_and_launches_nothing():
    kabsch.reset_launches()
    g = torch.Generator().manual_seed(0)
    A = torch.randn(8, 6, 3, generator=g)
    B = torch.randn(8, 6, 3, generator=g)
    w = torch.rand(8, 6, generator=g)
    for weights in (None, w):
        R, t = procrustes(A, B, weights)
        R0, t0 = procrustes_plain(A, B, weights)
        assert torch.equal(R, R0) and torch.equal(t, t0)
    assert kabsch.launches == 0


# (case, what the wrapper is given, the error it raises before any launch, and
# words of its message)
REFUSALS = [
    ("cpu_tensors", lambda: _inputs("cpu"), ValueError, "one CUDA device"),
    ("bf16", lambda: _inputs("cuda", torch.bfloat16), TypeError, "float32"),
    ("float64_weights", lambda: _inputs("cuda")[:2]
     + (torch.empty((4, 3), device="cuda", dtype=torch.float64),), TypeError,
     "weights is torch.float64"),
    ("not_contiguous", lambda: (torch.empty((3, 4, 3), device="cuda").transpose(0, 1),
                                torch.empty((4, 3, 3), device="cuda"), None), ValueError,
     "contiguous"),
    ("shapes_differ", lambda: (torch.empty((4, 3, 3), device="cuda"),
                               torch.empty((4, 4, 3), device="cuda"), None), ValueError,
     "one shape"),
    ("not_3d_points", lambda: (torch.empty((4, 3, 2), device="cuda"),
                               torch.empty((4, 3, 2), device="cuda"), None), ValueError,
     "one shape"),
    ("no_points", lambda: (torch.empty((4, 0, 3), device="cuda"),
                           torch.empty((4, 0, 3), device="cuda"), None), ValueError,
     "N >= 1"),
    ("weights_shape", lambda: _inputs("cuda")[:2]
     + (torch.empty((4, 2), device="cuda"),), ValueError, "weights must be"),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[c[0] for c in REFUSALS])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case):
    _, make, error, match = case
    kabsch.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True):
        A, B, w = make()
        with pytest.raises(error, match=match):
            kabsch.procrustes_cuda(A, B, w)
    assert kabsch.launches == 0


def test_kernel_states_the_tensor_versions_constants():
    """The .cu's sweeps, rotation guard, completion tolerance and weight
    floor are those of smallblas.svd3 and procrustes_plain."""
    assert inspect.signature(smallblas.svd3).parameters["sweeps"].default == 8
    assert _cu_constant("SWEEPS") == 8
    assert re.search(r"torch\.abs\(a_pq\) < 1e-30\b", inspect.getsource(
        smallblas._jacobi_rotation))
    assert _cu_constant("TINY") == 1e-30
    assert re.search(r"tol = 1e-5 \* torch\.clamp\(S\[\.\.\., :1\], min=1e-30\)",
                     inspect.getsource(smallblas._complete_orthonormal))
    assert _cu_constant("RANK_TOL") == 1e-5
    assert "min=1e-9)" in inspect.getsource(procrustes_plain)
    assert _cu_constant("WSUM_MIN") == 1e-9


def test_kernel_source_uses_no_fast_math_and_builds_as_plain_c():
    """IEEE division and square root and no contraction: every operation of
    the sweeps goes through the _rn intrinsics, and neither the source nor
    the build flags ask for fast math. The library's C function is the one
    the wrapper loads."""
    src = KABSCH_SOURCE.read_text()
    assert "fast_math" not in " ".join(_build.NVCC_FLAGS) and "--use_fast_math" not in src
    for intrinsic in ("__fmul_rn", "__fadd_rn", "__fsub_rn", "__fdiv_rn", "__fsqrt_rn"):
        assert intrinsic in src
    body = src[src.index("kabsch_kernel("):]
    assert not re.search(r"[^_]sqrtf?\(|rsqrtf|__fdividef|__expf", body)
    assert re.search(rf'extern "C" int {kabsch.LIBRARY}\(', src)
    assert _build.source_files(KABSCH_SOURCE) == [KABSCH_SOURCE]


# (case, A, B, weights, exact_h, the R limit wanted for every problem)
_I = torch.eye(3)
TOLERANCE_CASES = [
    # H = diag(3, 2, 1): sigma_0 / sigma_1 = 1.5, within the plain 1e-5
    ("well_conditioned", torch.cat([_I, -_I])[None], torch.cat([torch.diag(torch.tensor(
        [3.0, 2.0, 1.0])), -torch.diag(torch.tensor([3.0, 2.0, 1.0]))])[None] / 2, None, False,
     1e-5),
    # H = diag(1,000, 1, 1): the gap of 1,000 widens R's limit to 1e-6 x gap
    ("ill_conditioned", torch.cat([_I, -_I])[None], torch.cat([torch.diag(torch.tensor(
        [1000.0, 1.0, 1.0])), -torch.diag(torch.tensor([1000.0, 1.0, 1.0]))])[None] / 2, None,
     False, 1e-3),
    # the same H exact in float32: both routes take the same steps
    ("ill_conditioned_exact_h", torch.cat([_I, -_I])[None], torch.cat([torch.diag(torch.tensor(
        [1000.0, 1.0, 1.0])), -torch.diag(torch.tensor([1000.0, 1.0, 1.0]))])[None] / 2, None,
     True, 1e-5),
    # rank 1 (sigma_1 = 0): an unbounded gap, held only where H is exact
    ("rank1_exact_h", torch.cat([_I, -_I])[None], torch.cat([torch.diag(torch.tensor(
        [1.0, 0.0, 0.0])), -torch.diag(torch.tensor([1.0, 0.0, 0.0]))])[None] / 2, None, True,
     1e-5),
]


@pytest.mark.parametrize("case", TOLERANCE_CASES, ids=[c[0] for c in TOLERANCE_CASES])
def test_vs_plain_tolerances(case):
    """The card's limits for the kernel against the tensor version: R's grows
    with sigma_0 / sigma_1 beyond 10 unless H is exact, t's adds |a_mean|_1
    times R's and 1e-5 times max(1, |b_mean|)."""
    _, A, B, w, exact_h, want_R = case
    tol_R, tol_t = kabsch.vs_plain_tolerances(A, B, w, exact_h)
    assert tol_R.dtype == torch.float64 and tol_R.shape == (1,)
    torch.testing.assert_close(tol_R, torch.tensor([want_R], dtype=torch.float64))
    # the clouds are centred: t's limit is the means' 1e-5 alone
    torch.testing.assert_close(tol_t, torch.tensor([1e-5], dtype=torch.float64))


def test_vs_plain_tolerances_weighted_and_moved():
    """Zero weights drop points from the means; a moved cloud widens t's limit."""
    A = torch.cat([_I, -_I, torch.full((1, 3), 100.0)])[None] + torch.tensor([2.0, 0.0, 0.0])
    B = torch.cat([_I, -_I, torch.full((1, 3), -100.0)])[None] + torch.tensor([0.0, 0.0, 30.0])
    w = torch.tensor([[1.0] * 6 + [0.0]])
    tol_R, tol_t = kabsch.vs_plain_tolerances(A, B, w)
    torch.testing.assert_close(tol_R, torch.tensor([1e-5], dtype=torch.float64))
    torch.testing.assert_close(tol_t, torch.tensor([1e-5 * 2 + 1e-5 * 30], dtype=torch.float64))
