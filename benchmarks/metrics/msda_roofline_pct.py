"""MSDA kernels' share of their roofline: over the profiled steps' MSDA
launches, the least time the chip could take for each call (the larger of
its bytes over the memory bandwidth and its operations over the float32
rate; ``counts/msda.py`` from each call's own table, shapes and sample
locations), summed, over the launches' device time from the profiler,
both taken a launch."""


def read(run):
    p = run.get("profile")
    if not p or not p["msda_launches"] or not p["msda_calls"] \
            or p["msda_s"] <= 0:
        return None
    bound = p["msda_bound_s"] / p["msda_calls"]
    return 100.0 * bound / (p["msda_s"] / p["msda_launches"])
