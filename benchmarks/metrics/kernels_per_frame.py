"""Device: kernel launches a frame that the profiler saw (copies and sets
left out), over the profiled steps."""


def read(run):
    p = run.get("profile")
    return p["kernels"] / p["frames"] if p and p["kernels"] else None
