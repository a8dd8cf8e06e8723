"""A module fixture for the port's CPU tests: PyTorch's intra-op thread
pool, and the OpenMP runtime of every subprocess started meanwhile (the
launcher runs), at one thread while the module's tests run.

The suite runs in several worker processes at once; with each worker's
PyTorch using every core, the many small operations of a reduced model
spin on each other's threads.  On an 8-core machine the port's tests took
871 s with 6 workers at PyTorch's default thread count and 150 s at one
thread.  The thread count changes no result a test compares: each side of
a comparison runs in the same process, at the same count, or is a copy
compared byte for byte."""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp
