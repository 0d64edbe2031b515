"""PyTorch port: the package's public surface against the JAX package's.

- Every name the JAX ``geom``, ``ops``, ``models``, ``utils`` and
  ``parallel`` packages export from their ``__init__`` imports from the
  port's counterpart, except ``ops.fused_path_available`` (it asks whether
  the backend is a TPU; in the port the tensor's device chooses the route).
- ``axangle2quat`` and ``euler2quat`` agree with the JAX functions within
  1e-12 on seeded inputs (float64, the same numpy arithmetic).
- ``StageTimes.add`` / ``reset`` / ``repr`` and ``_NullTimes.add`` behave as
  the JAX ones do.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

from mapfree_tpu.geom import quaternion as jax_quaternion
from mapfree_tpu.utils import timing as jax_timing

from mapfree_tpu_torch.geom import quaternion as pt_quaternion
from mapfree_tpu_torch.utils import timing as pt_timing

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PACKAGES = ("geom", "ops", "models", "utils", "parallel")
BY_DESIGN = {("ops", "fused_path_available")}


def _exported(module) -> set:
    """The names a package's __init__.py imports (its exports)."""
    tree = ast.parse(Path(module.__file__).read_text())
    return {alias.asname or alias.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for alias in node.names}


@pytest.mark.parametrize("package", PACKAGES)
def test_every_exported_name_imports_from_the_port(package):
    jax_pkg = importlib.import_module(f"mapfree_tpu.{package}")
    pt_pkg = importlib.import_module(f"mapfree_tpu_torch.{package}")
    names = _exported(jax_pkg) - {n for p, n in BY_DESIGN if p == package}
    assert names, package
    missing = sorted(n for n in names if not hasattr(pt_pkg, n))
    assert not missing, f"mapfree_tpu_torch.{package} lacks {missing}"
    for name in names:
        exec(f"from mapfree_tpu_torch.{package} import {name}", {})


def test_axangle2quat_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        axis = rng.normal(size=3)
        theta = float(rng.uniform(-np.pi, np.pi))
        np.testing.assert_allclose(pt_quaternion.axangle2quat(axis, theta),
                                   jax_quaternion.axangle2quat(axis, theta), rtol=0, atol=1e-12)
        unit = axis / np.linalg.norm(axis)
        np.testing.assert_allclose(
            pt_quaternion.axangle2quat(unit, theta, is_normalized=True),
            jax_quaternion.axangle2quat(unit, theta, is_normalized=True), rtol=0, atol=1e-12)


def test_euler2quat_matches_jax():
    rng = np.random.default_rng(1)
    for ai, aj, ak in rng.uniform(-np.pi, np.pi, size=(20, 3)):
        q = pt_quaternion.euler2quat(ai, aj, ak)
        np.testing.assert_allclose(q, jax_quaternion.euler2quat(ai, aj, ak), rtol=0, atol=1e-12)
        assert abs(np.linalg.norm(q) - 1.0) < 1e-12


@pytest.mark.parametrize("module", [jax_timing, pt_timing], ids=["jax", "port"])
def test_stage_times_add_reset_repr(module):
    times = module.StageTimes()
    with times.stage("decode"):
        pass
    times.add("decode", 0.25)
    times.add("h2d", 1.5)
    assert times.calls == {"decode": 2, "h2d": 1}
    assert times.seconds["h2d"] == 1.5 and times.seconds["decode"] >= 0.25
    assert repr(times).startswith("StageTimes(decode=0.2")
    assert repr(times).endswith(", h2d=1.500s/1)")
    times.reset()
    assert times.summary() == {} and repr(times) == "StageTimes()"
    module.NULL_TIMES.add("decode", 1.0)
    assert module.NULL_TIMES.summary() == {}


def test_stage_times_repr_is_the_jax_repr():
    reprs = []
    for module in (jax_timing, pt_timing):
        times = module.StageTimes()
        times.add("decode", 0.125)
        times.add("dispatch", 2.0)
        times.add("decode", 0.5)
        reprs.append((repr(times), times.summary(), dict(times.calls)))
    assert reprs[0] == reprs[1]
