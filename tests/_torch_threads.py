"""An autouse fixture for the CPU test files that train or evaluate port
models: torch runs on one thread while the file's tests run. The suite runs
its files in several worker processes at once, and torch's default of one
thread per core in each of them oversubscribes the CPU, which slows these
loops of many small operations by an order of magnitude. Import it into a
test module to apply it there."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
