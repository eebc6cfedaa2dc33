"""A module fixture for the port's CPU tests: one torch intra-op thread.

At the tests' sizes torch's default of one thread a core only adds
synchronization (the thesis tests take 68 s with 8 threads, 14 s with
one), and beside the suite's other workers the spinning threads contend
for the same cores. Use with ``from torch_one_thread import one_thread``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
