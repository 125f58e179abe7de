"""Tests of the benchmark harness. They run on the CPU at tiny sizes; the
ones marked `card` need a CUDA card and skip without one (decided inside
the test): `python3 -m pytest portbench/tests -m card` on the card."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
