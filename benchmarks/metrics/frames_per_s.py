"""Frames tracked by all streams in the window, over the window's seconds
(host clock; the window closes after the step that crosses its end; the
seconds the benchmark spends between steps keeping a sampled step's states
and memories for the check are not the program's and are left out)."""


def read(run):
    return run["frames"] / run["window_s"] if run["window_s"] > 0 else None
