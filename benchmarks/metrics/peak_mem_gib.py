"""The device memory the allocator held at most in the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(run):
    return run["peak_bytes"] / 2**30 if run["peak_bytes"] else None
