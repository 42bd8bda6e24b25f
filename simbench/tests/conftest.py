"""The benchmark's own tests (CPU, tiny sizes; ``cuda``-marked ones on a
card):

    python -m pytest -q simbench/tests
"""
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips where no CUDA device exists (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
