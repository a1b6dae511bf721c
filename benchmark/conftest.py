"""Pytest settings of the benchmark's own tests (``python -m pytest benchmark/tests``).

``card`` marks a test that needs a CUDA card: it asks for the ``card`` fixture, which skips it where there is none.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA card; skipped where there is none')
    import torch

    torch.set_num_threads(2)  # several test processes share the machine's cores


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')
