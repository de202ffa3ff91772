"""On-card tests: every kept engine compiled for the GPU and compared
with the general float64 engine on the card.

Run on a machine with an NVIDIA GPU (``python chip_smoke.py`` runs them
as its phase (e)):

    python -m pytest tests_gpu -q -m gpu

Elsewhere every test skips through the ``gpu`` fixture below; nothing is
decided at import or collection time.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    from radiative_transfer import backend

    p = backend.platform()
    if p != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {p!r})")
