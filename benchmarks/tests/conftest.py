"""The benchmark's own tests (``python -m pytest benchmarks/tests``): on the
CPU at tiny sizes; those marked ``gpu`` need the card and skip without it."""
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips "
                            "without one")


def pytest_sessionstart(session):
    torch.set_num_threads(min(4, torch.get_num_threads()))
