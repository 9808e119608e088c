"""The benchmark's CPU tests run torch on few threads: the suite runs in
several worker processes at once, and each would otherwise take every
core."""
import pytest


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
