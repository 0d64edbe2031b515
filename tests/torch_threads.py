"""One intra-op thread for the PyTorch port's CPU tests.

The tier-1 run puts several test workers on the cores at once, and each
PyTorch process starts as many intra-op threads as there are cores. Their
small tensors then spend most of their time waiting for each other's
threads: a CPU train-step test that takes 4 s alone took over 90 s in that
run. Each port test file imports the fixture below, which gives every test one
thread and restores the count after it."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
