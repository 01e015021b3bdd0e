"""One intra-op torch thread for a module of the port's CPU tests.

The suite runs in several worker processes at once; torch's thread pool,
one thread per core in each of them, oversubscribes the cores and makes
the port's tests several times slower (and slows the workers beside them).
A test module imports the fixture, which is autouse, to run its tests, its
module fixtures included, on one thread and to restore the count after.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
