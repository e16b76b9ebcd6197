"""One torch intra-op thread per test module.

Under the suite's parallel workers (``-n 6`` on a machine of a few cores)
torch's intra-op threads only contend for the cores, and the port's tests
run small tensors whose ops gain nothing from them.  A test module imports
:func:`one_torch_thread`; as an autouse fixture it then pins torch to one
thread for that module and restores the count after it.  Importing this
module imports nothing of JAX."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
