"""The benchmark's own tests (``python -m pytest gpubench/tests``), on the
CPU at small sizes."""

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def small(config: str, reads: int, genes: int) -> dict:
    """A configuration of the benchmark cut to ``reads`` over ``genes``."""
    with open(os.path.join(ROOT, "gpubench", "configs", config + ".json")) as fh:
        cfg = json.load(fh)
    cfg["data"].update(reads=reads, genes=genes)
    return cfg
