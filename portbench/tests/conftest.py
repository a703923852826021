"""The benchmark's own tests: on the CPU at a tiny size (the skeletal
backbone, two small image shapes); the ones marked ``cuda`` need the card
and skip without one. Run: ``python -m pytest portbench/tests -q``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    import torch
    # several test workers share the CPU
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (a CUDA kernel has no CPU "
        "mode); skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
