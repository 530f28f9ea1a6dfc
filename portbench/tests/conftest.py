"""The benchmark's CPU tests: the repository root on the import path, and
the marker of tests that need the card (each decides inside the test)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips "
                            "without one")
