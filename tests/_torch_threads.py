"""One torch thread for the PyTorch port's test modules.

The tier-1 command spreads the test files over six xdist workers on an
8-core machine.  torch's intra-op pool takes a thread per core in every
worker, and on a machine that many threads oversubscribe, those threads
wait for each other: a plain-version test that takes 0.5 s alone took
43 s in a tier-1 run.  The port's tests run small shapes, which one
thread serves as fast, and the other workers keep the cores they
compile on.  A test module takes the fixture by importing it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op threads set to one for the module, restored after
    it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
