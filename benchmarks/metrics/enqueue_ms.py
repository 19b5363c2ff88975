"""Model forward, the enqueue: host ms a step of the program's ``forward``
spans (the model's Python launching the step's device work, and the
postprocess; no synchronisation inside), mean over the window's steps."""
from benchmarks.program_trace import span_ms_a_step


def read(run):
    return span_ms_a_step(run, "forward")
