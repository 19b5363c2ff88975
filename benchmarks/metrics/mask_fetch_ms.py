"""Batched tracker, the masks' fetch: host ms a step of the program's
``mask_fetch`` span (every live row's mask probabilities copied to
page-locked host memory, after the rows' copy, and waited for), mean over
the window's steps."""
from benchmarks.program_trace import span_ms_a_step


def read(run):
    return span_ms_a_step(run, "mask_fetch")
