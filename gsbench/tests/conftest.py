"""The benchmark's CPU tests: ``python -m pytest gsbench/tests -q`` from
the repository's root. A test that needs the card carries the ``cuda``
marker and skips, deciding inside the test, where there is none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without a card")
