"""The benchmark's own tests: ``python3 -m pytest vbench/tests`` from the
root of the repository.  Tests that need a card are marked ``cuda`` and
skip in their fixture where there is none."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
