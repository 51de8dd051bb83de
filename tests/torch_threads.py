"""One intra-op PyTorch thread for a port test module.

The tier-1 run shares the machine between six pytest workers. PyTorch's
intra-op threads spinning over the small operations of the port's tests
(a scan's steps, a tiny model's training steps) then slow a test by one
to two orders of magnitude: ``test_torch_training.py``'s
``run_training`` parity test took 30 s alone at PyTorch's default
threads, 6.5 s at one, and 2,012 s beside five other workers. Import
:func:`one_thread` into a test module (``from tests.torch_threads import
one_thread  # noqa: F401``): for the module's tests PyTorch runs one
intra-op thread, and so do the processes they start (spawned ranks, CLI
subprocesses), through ``OMP_NUM_THREADS``.
"""
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread in this process and in the processes it starts,
    for the module's tests; the settings before it afterwards."""
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = omp
