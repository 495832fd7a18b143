"""One torch thread for the port's CPU tests.

The suite runs under xdist, several workers sharing the machine's cores; at
torch's default of one thread per core each worker's torch ops oversubscribe
the CPU, and a test's time then grows many times over. A port test module
imports ``one_torch_thread``, a module-scoped autouse fixture, so its tests
and its module fixtures run torch at one thread.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
