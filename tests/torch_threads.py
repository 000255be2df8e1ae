"""A fixture the port's CPU test modules share: `from torch_threads import
one_torch_thread` in a module runs its tests with torch on one thread."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread in this module: the parallel test run
    puts several workers on the host's cores, and torch's default of one
    thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
