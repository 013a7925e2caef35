"""Fixtures of the benchmark's tests: a cell of BENCHMARK.json cut to a
small grove (tests/data/grove.xml) and a small frame for the CPU, and
the card, for the tests marked cuda."""
from __future__ import annotations

import dataclasses
import os

import pytest
import torch

from gdbench import registry

GROVE = os.path.join(os.path.dirname(__file__), "data", "grove.xml")


# (width, height, spp) of a route's CPU frame.  The L1 solve's iterates
# drift under rounding; over a few hundred pixels that drift reads above
# the limits set at the cell's own size, so G-PT's frame is larger.
FRAMES = {"gpt_l1": (64, 48, 4)}


def grove_cell(name):
    """The cell `name` with the grove for its scene and a small frame."""
    c = registry.cell(name)
    width, height, spp = FRAMES.get(c.config["route"], (16, 12, 2))
    return dataclasses.replace(
        c, config=dict(c.config, scene=GROVE),
        traffic=dict(c.traffic, width=width, height=height, spp=spp))


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suites run several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda:0"
