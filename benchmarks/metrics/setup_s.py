"""Seconds from the process's start to the first timed step: imports,
weights, frames, calibration and warm-up (and the kernels' build where the
checkout has none yet)."""


def read(run):
    return run["setup_s"]
