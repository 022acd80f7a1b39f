"""The autouse fixture shared by the port's test files that run many
small eager tensors (import ``one_thread`` into the module to use it),
and a test that it pins one intra-op thread."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors: one intra-op thread a worker keeps the suite's test
    workers from oversubscribing the cores (alone a file runs as fast
    either way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_pins_one_intra_op_thread():
    assert torch.get_num_threads() == 1
