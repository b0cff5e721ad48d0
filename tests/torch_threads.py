"""A module fixture that runs the port's CPU work on one intra-op thread.

The port's tests run narrow models whose ops gain nothing from more
threads, while the tier runs several test processes at once: with every
process holding one OpenMP thread per core, each op's barrier waits for
threads the other processes keep off the cores, and the same test runs
tens of times slower than alone. Import it into a test module to use it.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
