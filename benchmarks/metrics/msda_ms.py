"""MSDA kernels: device ms a frame of the launches whose names hold
``msda``, over the profiled steps (profiler)."""


def read(run):
    p = run.get("profile")
    return 1e3 * p["msda_s"] / p["frames"] if p and p["msda_launches"] else None
