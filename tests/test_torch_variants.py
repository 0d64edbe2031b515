"""PyTorch port, the RPR family against the JAX package on the CPU at
float32: every model config under ``configs/regression/`` (the multi-frame
ones over ``configs/mapfree_multi.yaml``), and the ResNet encoder and
``BLOCK_TYPE`` 2 by override. The configs are spread over this file and
tests/test_torch_variants_{heads,scannet,scannet_cv,encoders}.py
(``torch_configs.VARIANT_GROUPS``), each compiling the JAX network of each of
its configs; this one holds the 3d3d family and the weight bridge's
refusals.

Each config is cut to one block per stage and 96 x 72 frames (ResNet:
192 x 144, since its output is 1/64 of the frame) and keeps its other
widths (``torch_configs.check_variant``). The port's module gives the
flax-layout tree (``to_jax_variables``), which is filled with seeded random
values; the tree must have the names and shapes of the JAX package's own,
and ``load_jax_variables`` followed by ``to_jax_variables`` must give it
back bit for bit. The JAX network then runs on that tree (its dense
correlation: the fused path is the TPU's) and the port's on the same numpy
inputs: R and t within 1e-4.
"""

from pathlib import Path

import numpy as np
import pytest

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.regression import build_regression_net as pt_build_net
from mapfree_tpu_torch.tools.convert_weights import load_jax_variables, to_jax_variables

from torch_configs import (REGRESSION_CONFIGS, VARIANT_GROUPS, check_variant,
                           random_variables, small_cfg)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_every_regression_config_is_held_once():
    held = [c for group in VARIANT_GROUPS.values() for c in group]
    assert sorted(held) == REGRESSION_CONFIGS and len(held) == 23
    tests = Path(__file__).parent
    assert all((tests / name).is_file() for name in VARIANT_GROUPS)


@pytest.mark.parametrize("model_yaml", VARIANT_GROUPS[Path(__file__).name])
def test_config_matches_jax(model_yaml):
    check_variant(model_yaml, seed=len(model_yaml))


# per config, one module the 3d3d model lacks: the leaf whose loss, surplus
# and misshaping are tried, and the port's tensor that must be named
NEW_PARAMETERS = {
    "configs/regression/mapfree/rotbin_transdirectionbin_scale_qkv.yaml":
        (("params", "aggregator", "Q_mlp", "kernel"), "aggregator.Q_mlp.weight"),
    "configs/regression/mapfree/multiframe/3d3d_multi_fusion.yaml":
        (("params", "frame_weight", "kernel"), "frame_weight.weight"),
    "configs/regression/mapfree/rotquat_transdirection_scale.yaml":
        (("params", "head", "mlp", "fc3", "kernel"), "head.mlp.4.weight"),
}


@pytest.mark.parametrize("model_yaml", list(NEW_PARAMETERS))
def test_bridge_rejects_missing_extra_and_misshapen_leaves(model_yaml):
    """A leaf of the new modules left out, one with no tensor in the port,
    and one of the wrong shape each raise, naming the tensor."""
    net = pt_build_net(small_cfg(pt_default_cfg, model_yaml))
    tree = random_variables(to_jax_variables(net), 0)
    load_jax_variables(net, tree)  # the complete tree loads
    (*path, leaf), key = NEW_PARAMETERS[model_yaml]

    def node_of(t):
        for p in path:
            t = t[p]
        return t

    missing = random_variables(tree, 1)
    del node_of(missing)[leaf]
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        load_jax_variables(net, missing)

    extra = random_variables(tree, 1)
    node_of(extra)["unknown"] = np.zeros((2,), np.float32)
    with pytest.raises(KeyError, match="unknown"):
        load_jax_variables(net, extra)

    misshapen = random_variables(tree, 1)
    node_of(misshapen)[leaf] = node_of(misshapen)[leaf][..., :-1]
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        load_jax_variables(net, misshapen)
