"""Shared fixtures of the benchmark's own tests (CPU, tiny sizes)."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"width": 32, "height": 18, "spp": 2}


@pytest.fixture(autouse=True)
def one_thread():
    """A few intra-op threads: the tests run beside other work."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cell():
    """A cell resolved from its files and cut to a tiny film."""
    from benchmark import harness

    def make(name):
        cell = harness.resolve(name)
        cell.traffic["render"] = dict(TINY)
        cell.traffic["check_pixels"] = 64
        return cell
    return make
