"""The frozen reference against the port's plain path (the CPU route of
``fused_correlation_warp``, float32) at a small size, with the same weights
made by the benchmark: forwards of both models."""

import numpy as np
import pytest
import torch

from perfbench.harness import cell as C
from perfbench.harness import traffic
from perfbench.harness.weights import calibrate_batchnorm, make_weights
from perfbench.reference.model import Model, rgb_uint8, yuv420_to_rgb
from perfbench.tests.conftest import SMALL

F32 = dict(SMALL, **{"TPU.COMPUTE_DTYPE": "float32"})


def both(cell_name, seed):
    from mapfree_tpu_torch.models.regression import build_regression_net

    ctx = C.Context(C.load_cell(cell_name), seed, 0, None, torch.device("cpu"),
                    F32)
    with torch.device("meta"):
        spec = Model(**ctx.ref_args)
    weights = make_weights(spec, seed, "cpu")
    net = build_regression_net(ctx.cfg)
    ref = Model(**ctx.ref_args)
    return ctx, weights, net, ref


@pytest.mark.parametrize("cell_name", ["3d3d-sweep", "fusion-sweep"])
def test_forward_matches_the_port(cell_name):
    ctx, weights, net, ref = both(cell_name, 2 ** 33 + 5)
    from perfbench.harness.sweep import reference_inputs, shape_of

    pool = traffic.make_pool(shape_of(ctx), ctx.mix, 2 ** 33 + 5, "cpu")
    args, kwargs = reference_inputs(pool[0], ctx.ref_args["frames"], "cpu", rows=2)
    weights = calibrate_batchnorm(ref, weights, *args, **kwargs)
    net.load_state_dict(weights)
    ref.load_state_dict(weights)
    net.eval()
    ref.eval()
    b = pool[1]
    with torch.no_grad():
        args, kwargs = reference_inputs(b, ctx.ref_args["frames"], "cpu")
        R_ref, t_ref = ref(*args, **kwargs)
        if ctx.ref_args["frames"]:
            R, t, _ = net(torch.from_numpy(b["image0"]), torch.from_numpy(b["image1"]),
                          q_device=kwargs["q_device"], t_device=kwargs["t_device"])
        else:
            R, t, _ = net(torch.from_numpy(b["image0_unique"]), torch.from_numpy(b["image1"]),
                          ref_idx=kwargs["ref_idx"])
    assert torch.allclose(R, R_ref, atol=2e-5) and torch.allclose(t, t_ref, atol=2e-5)


def test_yuv420_and_grid_conventions():
    from mapfree_tpu_torch.ops.image import yuv420_to_rgb as port_yuv

    rng = np.random.default_rng(3)
    packed = torch.from_numpy(rng.integers(0, 256, (2, 24, 10), dtype=np.uint8))
    assert torch.allclose(yuv420_to_rgb(packed), port_yuv(packed).permute(0, 3, 1, 2), atol=1e-6)
    img = torch.from_numpy(rng.integers(0, 256, (2, 5, 4, 3), dtype=np.uint8))
    assert torch.equal(rgb_uint8(img), img.permute(0, 3, 1, 2).float() / 255.0)
