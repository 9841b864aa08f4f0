"""The benchmark's own tests: CPU tests of its files, and tests marked
`card` that need an NVIDIA card and skip without one (decided in the
`card` fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest benchmark/tests -m card)")
    return torch.device("cuda:0")
