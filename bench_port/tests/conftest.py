"""Test set-up of the benchmark's own tests (``python -m pytest
bench_port/tests``; the repository's ``tests/`` does not collect them):
the benchmark's folder and the checkout's root on the import path, torch
kept to two threads, and the ``cuda`` marker of tests that need a card
(they decide inside the test whether there is one)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is False")
