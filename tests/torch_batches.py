"""Batch comparison for the PyTorch port's data-layer tests: a batch (or a
sample) of the JAX package against the port's, key by key."""

import numpy as np


def assert_same_value(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):  # a sample: the same keys in the same order
        assert isinstance(b, dict) and list(a) == list(b), where
        for key in a:
            assert_same_value(a[key], b[key], f"{where}.{key}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_value(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def assert_same_batches(jax_batches, pt_batches):
    assert len(jax_batches) == len(pt_batches) > 0
    for n, (a, b) in enumerate(zip(jax_batches, pt_batches)):
        assert list(a) == list(b), n  # the same keys in the same order
        for key in a:
            assert_same_value(a[key], b[key], f"batch {n} {key}")
