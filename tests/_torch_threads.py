"""One PyTorch intra-op thread for a test module.

Under ``pytest -n 6`` every worker's PyTorch thread pool takes all the
cores, and six such pools on eight cores spin against each other: a train
step that takes 0.3 s alone took 90 s among six workers, and 0.7 s with
one thread each.  A module that uses this fixture runs its tests with one
thread and restores the worker's count after them.

    from _torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
