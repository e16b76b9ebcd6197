"""One torch intra-op thread and one BLAS thread per test module.

Under the suite's parallel workers (``-n 6`` on a machine of a few cores)
torch's intra-op threads and numpy's BLAS threads (OpenBLAS starts one per
core in every worker) only contend for the cores: the port's tests run
small tensors whose ops gain nothing from them, and a dense solve or
pseudo-inverse in six workers at once ran several times slower than on one
thread each.  A test module imports :func:`one_torch_thread`; as an
autouse fixture it then pins torch to one thread and numpy's BLAS to one
(through ``threadpoolctl``, where it is installed) for that module and
restores both after it.  Importing this module imports nothing of JAX."""

import contextlib

import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # not every installation has it; torch's own limit still holds
    threadpool_limits = None


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas") if threadpool_limits else contextlib.nullcontext():
        yield
    torch.set_num_threads(n)
