"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``
from the repository's root; the repository's ``pytest tests/`` does not
collect them)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips, with its reason, where there is none")
