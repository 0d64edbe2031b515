"""PyTorch port, the encoders reachable only by YAML key, on the 3d3d model
against the JAX package on the CPU at float32, held as
tests/test_torch_variants.py says: ResNet with each block type (192 x 144
frames, since its output is 1/64 of the frame) and the ResUNet with
``BLOCK_TYPE`` 2 (the grouped-convolution bottleneck)."""

import pytest
import torch

from mapfree_tpu_torch.ops.correlation import (DESIGN_FMA, DESIGN_MMA, backward_design,
                                                forward_design)

from torch_configs import check_variant
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASE = "configs/regression/mapfree/3d3d.yaml"
OVERRIDES = {
    "resnet_preact": {"ENCODER.TYPE": "ResNet", "ENCODER.BLOCK_TYPE": 0},
    "resnet_bottleneck": {"ENCODER.TYPE": "ResNet", "ENCODER.BLOCK_TYPE": 1},
    "resnet_depthwise": {"ENCODER.TYPE": "ResNet", "ENCODER.BLOCK_TYPE": 2},
    "resunet_depthwise": {"ENCODER.BLOCK_TYPE": 2},
}


@pytest.mark.parametrize("name", list(OVERRIDES))
def test_encoder_override_matches_jax(name):
    resnet = OVERRIDES[name].get("ENCODER.TYPE") == "ResNet"
    net = check_variant(BASE, seed=len(name), H=192 if resnet else 96,
                        W=144 if resnet else 72, **OVERRIDES[name])
    if resnet:
        # 256 or 1,024 channels: on the card K1, K2 and K3 take them on the
        # tensor cores in bf16; float32 stays FMA
        width = 256 * net.encoder.layer3[0].expansion
        for design in (forward_design, backward_design):
            assert design(torch.bfloat16, width, width) == DESIGN_MMA
            assert design(torch.float32, width, width) == DESIGN_FMA
