"""Test configuration: force an 8-device virtual CPU platform so multi-chip
sharding paths can be exercised without TPU hardware.

Note: the env var JAX_PLATFORMS alone is not honoured when a TPU plugin is
installed; jax.config.update must be called before any computation.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# persistent compile cache: the batched RANSAC/solver graphs take minutes of
# CPU compile per distinct shape; cached reruns cut the suite time sharply
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(os.path.dirname(__file__), "..", ".jax_cache_cpu"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the PyTorch port's kernels); "
        "skipped without one")
