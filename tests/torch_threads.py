"""One intra-op PyTorch thread for the port's CPU tests that import it:
their tensors are small, a single thread runs them as fast as eight, and
in the parallel test run several processes of eight threads each would
oversubscribe the cores."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
