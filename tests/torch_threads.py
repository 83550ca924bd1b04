"""The port tests' one-thread fixture (not a test module).

A port test module imports ``one_thread``, which then applies to each of
its tests: on shared CPUs the small batched torch ops of these tests ran
up to 20x slower with a full intra-op thread pool, and several test
processes each with a pool of every core oversubscribe the machine.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread for the module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
