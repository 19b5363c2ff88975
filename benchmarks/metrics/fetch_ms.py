"""Batched tracker, the fetch: host ms a step of the program's ``fetch``
span (the wait for the card and the one copy of every live row to the
host), mean over the window's steps."""
from benchmarks.program_trace import span_ms_a_step


def read(run):
    return span_ms_a_step(run, "fetch")
