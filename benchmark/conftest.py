"""Test settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the repository root on the path, and the ``card``
marker for tests that need a CUDA card, decided inside a fixture and
skipped without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _card_only(request):
    if request.node.get_closest_marker("card") is None:
        return
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
