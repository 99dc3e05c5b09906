"""The benchmark's CPU tests run the program on the CPU: one intra-op
thread a test process, so that parallel test processes do not crowd the
host's cores."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
