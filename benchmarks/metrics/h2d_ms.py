"""Batched tracker, the copy to the device: host ms a step of the
program's ``h2d`` spans (the staged arrays copied to the device, a row at
a time, and concatenated there), mean over the window's steps."""
from benchmarks.program_trace import span_ms_a_step


def read(run):
    return span_ms_a_step(run, "h2d")
