"""One torch thread for the port's CPU tests.

pytest-xdist runs the suite in several worker processes. With torch's
default intra-op pool (a thread a core) in each, the workers' OpenMP
threads oversubscribe the cores and spin: on an 8-core host, six
concurrent copies of one engine test (28 s alone) took 412 s, against 27 s
with one thread each. The port's CPU tests run small tensors, so one thread
costs them nothing alone. Each `tests/test_torch_*.py` imports
`one_torch_thread`, an autouse fixture that sets torch's intra-op threads
to 1 for the module's tests and restores the count after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
