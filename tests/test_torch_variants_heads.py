"""PyTorch port, the RPR family against the JAX package on the CPU at
float32: the configs torch_configs.VARIANT_GROUPS gives this file, held
as tests/test_torch_variants.py says."""

from pathlib import Path

import pytest

from torch_configs import VARIANT_GROUPS, check_variant
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("model_yaml", VARIANT_GROUPS[Path(__file__).name])
def test_config_matches_jax(model_yaml):
    check_variant(model_yaml, seed=len(model_yaml))
