"""Device: ms a frame in which kernels ran (copies and sets left out), over
the profiled steps. It reads the card's own work, which the host's speed
moves far less than the window's frames a second."""


def read(run):
    p = run.get("profile")
    return 1e3 * p["kernel_s"] / p["frames"] if p and p["kernels"] else None
