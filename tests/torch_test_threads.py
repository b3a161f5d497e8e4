"""One torch thread in each of the port's test files.

The suite runs under pytest-xdist with six workers on an 8-core machine.  A
worker whose torch sizes its OpenMP and MKL pools to every core spins far
more than it computes, and slows every other worker with it: six of the
port's files took 535 s side by side with torch's default pools and 180 s
with one torch thread each (an 8-core CPU machine).  Each
``tests/test_torch_*.py`` imports ``one_torch_thread``, a module-scoped
autouse fixture: the cap holds while the file's tests run and is lifted
after them.  Files that spawn gloo ranks cap the ranks themselves
(``torch_dist_ranks.torch_threads``; a CPU rank runs one thread).
"""
import pytest
import torch

TEST_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)
