"""Tests of the benchmark harness, on the CPU at tiny sizes:

    python -m pytest -q perfbench/tests

Tests that need a card carry the ``cuda`` marker and skip without one;
on the card: ``python -m pytest -q -m cuda perfbench/tests``."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "perfbench")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# tiny versions of each cell: the same code paths at sizes a CPU run holds
TINY = {
    "alphaprime_city.fit": dict(
        scene=dict(num_buildings=30),
        sensor=dict(tls_resolution_horizontal=120,
                    tls_resolution_vertical=24),
        fit=dict(pulses=120 * 24)),
    "als_terrain.fit": dict(scene=dict(num_tris=20000),
                            fit=dict(pulses=4096)),
    "als_terrain.survey": dict(scene=dict(num_tris=2000, half=40.0)),
}


@pytest.fixture
def tiny_spec():
    """``tiny_spec(cell)``: the cell's resolved files, cut to a tiny
    size."""
    from perfbench import core

    def make(cell):
        spec = copy.deepcopy(core.resolve(core.load_benchmark(), cell))
        for key, over in TINY[cell].items():
            spec["config"][key].update(over)
        spec["traffic"]["reference_pulse_block"] = 1000
        if "chunk_pulses" in spec["traffic"]:
            spec["traffic"]["chunk_pulses"] = 2048
        return spec
    return make
