"""Fixtures of the benchmark's own tests (``python -m pytest
port_bench/tests`` from the repository's root). Tests that need the card
carry the ``gpu`` marker and skip from the ``card`` fixture."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
