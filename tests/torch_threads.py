"""One intra-op thread for the port's CPU tests.

The tier-1 run starts several pytest workers on one machine. Each torch
process would start a thread per core, and their spinning threads slow
every worker several times over. The port's tests run small shapes, so one
thread each costs them little alone and saves most of their time under
load. Import ``one_torch_thread`` into a test module to apply it there.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
