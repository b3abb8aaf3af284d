"""Tests of the benchmark, on the CPU (the one test marked ``gpu`` skips
without a card). Run from the checkout's root:

    python -m pytest ldpc_bench/tests -q
"""
import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@pytest.fixture(scope="session")
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)
