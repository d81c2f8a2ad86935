"""A fixture for the tests that run the port's fixed-point chains and its
runtime on the CPU.

The kiss chain issues about 1,400 small int32 ops a step.  With torch's
intra-op pool on every core of a machine that pytest-xdist already fills
with one worker per core, each op waits at its barrier for threads that
other workers have descheduled: these tests then take 20-50 times their
time alone.  One intra-op thread while they run keeps their time what it
is alone; the count is restored afterwards, so the other tests of the
worker are untouched.  Use it with `pytestmark = pytest.mark.usefixtures(
"one_intra_op_thread")` or by name.
"""
import pytest
import torch


@pytest.fixture
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
