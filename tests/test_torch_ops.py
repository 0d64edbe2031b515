"""PyTorch port, op level: the correlation warp (K1), YUV420 unpacking,
the 3x3 SVD and Kabsch solve, quaternions and packing, each held against
the JAX package on the same numpy inputs.

K1's JAX side runs as tests/test_correlation.py runs it on the CPU: the
Pallas kernel under the interpreter. The port's CPU route is the kernel's
plain version; the CUDA kernel itself is held against it on the card by
tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapfree_tpu.geom import projection as jax_proj
from mapfree_tpu.geom import quaternion as jax_quat
from mapfree_tpu.geom.procrustes import procrustes as jax_procrustes
from mapfree_tpu.geom.smallblas import det3 as jax_det3, svd3 as jax_svd3
from mapfree_tpu.models.aggregators import _uv_grid as jax_uv_grid
from mapfree_tpu.ops import image as jax_image
from mapfree_tpu.ops.correlation import fused_correlation_warp as jax_fcw

from mapfree_tpu_torch.geom import projection as pt_proj
from mapfree_tpu_torch.geom import quaternion as pt_quat
from mapfree_tpu_torch.geom.procrustes import procrustes as pt_procrustes
from mapfree_tpu_torch.geom.smallblas import det3 as pt_det3, svd3 as pt_svd3
from mapfree_tpu_torch.models.aggregators import _uv_grid as pt_uv_grid
from mapfree_tpu_torch.ops import correlation as pt_corr
from mapfree_tpu_torch.ops import image as pt_image
from mapfree_tpu_torch.utils.packing import pack_arrays, spec_of, unpack

from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _qkv(B=2, H=10, W=13, C=32, seed=0):
    rng = np.random.default_rng(seed)
    HW = H * W
    q, k, v = (rng.normal(size=(B, HW, C)).astype(np.float32) for _ in range(3))
    return q, k, v, np.array(jax_uv_grid(H, W, jnp.float32))


# (name, q channels, dtype, atol): the forward cases of tests/test_correlation.py.
# f32: both sides are f32 softmax-weighted sums, 1e-5 covers summation order.
# bf16: both sides take bf16-rounded inputs, the grid in bf16 and f32
# accumulation; 0.05 is the JAX test's bound for the bf16 interpreter path.
K1_CASES = [
    ("f32_hw130", 32, "float32", 1e-5),
    ("half_channel_q16_v32", 16, "float32", 1e-5),
    ("bf16_inputs", 32, "bfloat16", 0.05),
]


@pytest.mark.parametrize("name,cq,dtype,atol", K1_CASES, ids=[c[0] for c in K1_CASES])
def test_k1_plain_matches_jax_interpret(name, cq, dtype, atol):
    q, k, v, grid = _qkv()  # HW = 130: not a multiple of any row block
    q, k = q[..., :cq], k[..., :cq]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jax_fcw(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                  jnp.asarray(grid), interpret=True)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(td) for a in (q, k, v)]
    out = pt_corr.fused_correlation_warp(*args, torch.from_numpy(grid))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        assert o.shape == tuple(r.shape)
        np.testing.assert_allclose(o.numpy(), np.asarray(r, np.float32), atol=atol)
    # softmax rows sum to 1, so the max score lies in (0, 1]
    ms = out[2].numpy()
    assert ms.min() > 0.0 and ms.max() <= 1.0 + 1e-6


def test_k1_rounded_plain_matches_jax_interpret():
    """The plain forward with the tensor-core K1's arithmetic (online softmax
    over 64-key tiles, P rounded to bf16) stays within the bf16 case's 0.05 of
    the JAX kernel under the interpreter: the kernel's roundings keep it the
    reference's function."""
    name, cq, dtype, atol = next(c for c in K1_CASES if c[2] == "bfloat16")
    q, k, v, grid = _qkv()
    ref = jax_fcw(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(grid),
                  interpret=True)
    args = [torch.from_numpy(np.ascontiguousarray(a)).bfloat16() for a in (q, k, v)]
    assert pt_corr.forward_design(torch.bfloat16, cq, v.shape[-1]) == pt_corr.DESIGN_MMA
    out = pt_corr.fused_correlation_warp_plain(*args, torch.from_numpy(grid),
                                               bf16_roundings=True)
    for o, r in zip(out, ref):
        assert o.shape == tuple(r.shape)
        np.testing.assert_allclose(o.numpy(), np.asarray(r, np.float32), atol=atol)


def test_k1_cpu_route_is_the_plain_version_and_counts_nothing():
    q, k, v, grid = map(torch.from_numpy, _qkv(B=1, H=5, W=7, C=8, seed=1))
    before = dict(pt_corr.launches)
    fused = pt_corr.fused_correlation_warp(q, k, v, grid)
    plain = pt_corr.fused_correlation_warp_plain(q, k, v, grid)
    for a, b in zip(fused, plain):
        assert torch.equal(a, b)
    assert pt_corr.launches == before


def test_k1_rejects_bad_shapes():
    q, k, v, grid = map(torch.from_numpy, _qkv(B=1, H=5, W=7, C=8, seed=1))
    with pytest.raises(ValueError):
        pt_corr.fused_correlation_warp(q, k[:, :-1], v, grid)
    with pytest.raises(ValueError):
        pt_corr.fused_correlation_warp(q, k, v, grid[:-1])
    with pytest.raises(TypeError):
        pt_corr.fused_correlation_warp(q, k.double(), v, grid)


def test_uv_grid_matches_jax():
    # torch.linspace and jnp.linspace round some points differently: 1 ulp
    for H, W in ((10, 13), (92, 68)):
        np.testing.assert_allclose(pt_uv_grid(H, W).numpy(),
                                   np.asarray(jax_uv_grid(H, W, jnp.float32)),
                                   atol=2.5e-7, rtol=0)


@pytest.mark.parametrize("lead", [(2,), (2, 3)])
def test_yuv420_to_rgb_matches_jax(lead):
    rng = np.random.default_rng(3)
    rgb = rng.random(lead + (48, 64, 3)).astype(np.float32)
    packed = jax_image.yuv420_pack_host(rgb.reshape((-1, 48, 64, 3)))
    np.testing.assert_array_equal(pt_image.yuv420_pack_host(
        rgb.reshape((-1, 48, 64, 3))), packed)
    packed = packed.reshape(lead + packed.shape[1:])
    ref = np.asarray(jax_image.yuv420_to_rgb(jnp.asarray(packed)))
    out = pt_image.yuv420_to_rgb(torch.from_numpy(packed)).numpy()
    assert out.shape == ref.shape == lead + (48, 64, 3)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def _svd_inputs():
    rng = np.random.default_rng(4)
    degenerate = np.stack([
        np.zeros((3, 3)), np.eye(3), np.diag([1.0, 1.0, 0.0]),
        np.diag([5.0, 5.0, 5.0]), np.outer([1.0, 2.0, 3.0], [4.0, 5.0, 6.0]),
    ])
    return np.concatenate([rng.normal(size=(64, 3, 3)), degenerate]).astype(np.float32)


def test_svd3_and_det3_match_jax():
    A = _svd_inputs()
    U, S, Vt = (np.asarray(x) for x in jax_svd3(jnp.asarray(A)))
    u, s, vt = (x.numpy() for x in pt_svd3(torch.from_numpy(A)))
    np.testing.assert_allclose(s, S, atol=1e-5)
    np.testing.assert_allclose(u, U, atol=1e-5)
    np.testing.assert_allclose(vt, Vt, atol=1e-5)
    np.testing.assert_allclose(pt_det3(torch.from_numpy(A)).numpy(),
                               np.asarray(jax_det3(jnp.asarray(A))), atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_procrustes_matches_jax(weighted):
    rng = np.random.default_rng(5)
    A = rng.normal(size=(16, 6, 3)).astype(np.float32)
    B = (A @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T
         + rng.normal(size=(16, 6, 3)) * 0.05).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=(16, 6)).astype(np.float32) if weighted else None
    R, t = jax_procrustes(
        jnp.asarray(A), jnp.asarray(B), None if w is None else jnp.asarray(w))
    r, tt = pt_procrustes(torch.from_numpy(A), torch.from_numpy(B),
                          None if w is None else torch.from_numpy(w))
    assert r.shape == (16, 3, 3) and tt.shape == (16, 1, 3)
    np.testing.assert_allclose(r.numpy(), np.asarray(R), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(t), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(r.numpy()), 1.0, atol=1e-5)


def test_quaternions_match_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(32, 4))
    R = jax_quat.quat2mat(q)
    np.testing.assert_allclose(pt_quat.quat2mat(q), R, atol=1e-12)
    np.testing.assert_allclose(pt_quat.mat2quat(R), jax_quat.mat2quat(R), atol=1e-12)
    # identity and half-turns exercise every Shepperd pivot
    special = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                        np.diag([-1.0, -1, 1])])
    np.testing.assert_allclose(pt_quat.mat2quat(special), jax_quat.mat2quat(special),
                               atol=1e-12)


def test_pack_unpack_roundtrip_including_misaligned_fields():
    rng = np.random.default_rng(7)
    named = [("ref_idx", np.array([0, 1, 1], np.int32)),
             ("image0u", rng.integers(0, 255, (2, 9, 4), dtype=np.uint8)),
             ("odd", rng.integers(0, 255, (3,), dtype=np.uint8)),
             ("f", rng.normal(size=(2, 3)).astype(np.float32))]  # offset 87
    buf = torch.from_numpy(pack_arrays([a for _, a in named]))
    parts = unpack(buf, spec_of(named))
    for name, a in named:
        assert parts[name].dtype == getattr(torch, str(a.dtype))
        np.testing.assert_array_equal(parts[name].numpy(), a)
    with pytest.raises(ValueError):
        unpack(buf[:-1], spec_of(named))


def test_quaternion_algebra_matches_jax():
    """The helpers the datasets call on numpy: the same float64 arithmetic."""
    rng = np.random.default_rng(8)
    q1, q2 = rng.normal(size=(2, 16, 4))
    t1, t2, v = rng.normal(size=(3, 16, 3))
    for name in ("qinverse", "qconjugate"):
        np.testing.assert_allclose(getattr(pt_quat, name)(q1), getattr(jax_quat, name)(q1),
                                   rtol=0, atol=1e-15)
    np.testing.assert_allclose(pt_quat.qmult(q1, q2), jax_quat.qmult(q1, q2), rtol=0, atol=1e-15)
    np.testing.assert_allclose(pt_quat.rotate_vector(v, q1), jax_quat.rotate_vector(v, q1),
                               rtol=0, atol=1e-15)
    for got, ref in zip(pt_quat.relative_pose_wxyz(q1, t1, q2, t2),
                        jax_quat.relative_pose_wxyz(q1, t1, q2, t2)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)


def test_projection_matches_jax():
    rng = np.random.default_rng(9)
    K = np.array([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    for sx, sy in ((0.5, 0.5), (270 / 540, 360 / 720), (1.25, 0.75)):
        np.testing.assert_array_equal(pt_proj.correct_intrinsic_scale(K, sx, sy),
                                      jax_proj.correct_intrinsic_scale(K, sx, sy))
    pts = rng.normal(size=(2, 10, 3)) + np.array([0, 0, 4.0])
    Ks = np.stack([K, K * 1.1]).astype(np.float64)
    for size in (None, (640, 480)):
        np.testing.assert_array_equal(pt_proj.project(pts, Ks, size),
                                      jax_proj.project(pts, Ks, size))
    uv, depth = rng.uniform(0, 400, size=(2, 10, 2)), rng.uniform(1, 5, size=(2, 10))
    np.testing.assert_array_equal(pt_proj.backproject_3d(uv, depth, Ks),
                                  jax_proj.backproject_3d(uv, depth, Ks))


def test_unpack_takes_bool_as_the_jax_unpack_does():
    """Bool masks (the matching track's ICP masks) round-trip through the
    packed buffer; the JAX unpack casts each byte, so a nonzero byte is
    True in both."""
    import jax

    from mapfree_tpu.utils.packing import unpack as jax_unpack

    rng = np.random.default_rng(10)
    named = [("f", rng.normal(size=(2, 3)).astype(np.float32)),
             ("mask0", rng.random((3, 5)) < 0.5), ("mask1", rng.random((7,)) < 0.3),
             ("image", rng.integers(0, 255, (2, 3), dtype=np.uint8))]
    buf = pack_arrays([a for _, a in named])
    spec = spec_of(named)
    parts = unpack(torch.from_numpy(buf), spec)
    ref = jax.jit(lambda b: jax_unpack(b, spec))(jnp.asarray(buf))
    for name, a in named:
        assert str(parts[name].dtype) == f"torch.{a.dtype}"
        np.testing.assert_array_equal(parts[name].numpy(), a)
        np.testing.assert_array_equal(parts[name].numpy(), np.asarray(ref[name]))
    buf[24] = 7  # a stray nonzero byte in mask0 reads as True in both
    parts = unpack(torch.from_numpy(buf), spec)
    ref = jax.jit(lambda b: jax_unpack(b, spec))(jnp.asarray(buf))
    assert bool(parts["mask0"][0, 0]) and bool(np.asarray(ref["mask0"])[0, 0])


@pytest.mark.parametrize("hw,out", [((9, 7), (18, 14)), ((23, 17), (46, 34))])
def test_upsample_matches_jax_in_bf16_and_f32(hw, out):
    """UpConv's upsample in the compute dtype, as the JAX package computes it:
    two interpolation matmuls with bf16 matrices, float32 sums, and bf16
    after each axis. Each output is the sum of two exact bf16 x bf16
    products rounded once to float32 and once to bf16 on both sides, so the
    two agree to the bit; the stated tolerance is one bf16 step (2^-8 of the
    value) for a CPU whose bf16 matmul rounds its float32 sum otherwise. Both
    memory layouts (NCHW, and the channels-last the convolutions keep) give
    the same values and keep their layout. In
    float32 it is held to the previous F.interpolate at 1e-5 on inputs of
    magnitude up to ~4.5: the two compute the source coordinates by other
    float32 formulas, so their weights differ by an ulp or two."""
    import torch.nn.functional as F

    from mapfree_tpu.models.blocks import _resize_bilinear_align_corners as jax_resize
    from mapfree_tpu_torch.models.blocks import resize_bilinear_align_corners

    rng = np.random.default_rng(11)
    x = rng.normal(size=(2,) + hw + (6,)).astype(np.float32)  # NHWC
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_resize(xj, out).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).permute(0, 3, 1, 2)
    for layout in (torch.contiguous_format, torch.channels_last):
        with torch.autocast("cpu", dtype=torch.bfloat16):  # the bf16 model's setting
            got = resize_bilinear_align_corners(xt.contiguous(memory_format=layout), out)
        assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=layout)
        got = got.float().permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -8, atol=0)
    got32 = resize_bilinear_align_corners(xt, out)
    assert got32.dtype == torch.float32
    old = F.interpolate(xt, size=out, mode="bilinear", align_corners=True)
    np.testing.assert_allclose(got32.numpy(), old.numpy(), rtol=0, atol=1e-5)


def test_upsample_matrices_are_made_once_and_serve_autograd():
    """The interpolation matrices are made once per (size, device, dtype),
    not copied from the host on every call; one first made in inference
    mode (the predictor's) still serves a backward pass afterwards."""
    from mapfree_tpu_torch.models.blocks import _interp_tensor, resize_bilinear_align_corners

    _interp_tensor.cache_clear()
    x = torch.randn(2, 3, 5, 4)
    with torch.inference_mode():
        resize_bilinear_align_corners(x, (10, 8))
    resize_bilinear_align_corners(x, (10, 8))
    info = _interp_tensor.cache_info()
    assert (info.misses, info.hits) == (2, 2)
    assert _interp_tensor(5, 10, x.device, x.dtype) is _interp_tensor(5, 10, x.device, x.dtype)
    xg = x.clone().requires_grad_(True)
    resize_bilinear_align_corners(xg, (10, 8)).sum().backward()
    # each output row's weights sum to one, so each input pixel's gradient
    # is the sum of its column of the matrix in H times that in W
    mh, mw = _interp_tensor(5, 10, x.device, x.dtype), _interp_tensor(4, 8, x.device, x.dtype)
    expected = mh.sum(0)[:, None] * mw.sum(0)[None, :]
    torch.testing.assert_close(xg.grad, expected.expand_as(xg), rtol=1e-6, atol=1e-6)
