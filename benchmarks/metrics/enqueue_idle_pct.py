"""Device: the share of the profiled window in which no kernel or copy ran
while the host was inside the program's ``forward`` span or one of its
children (the idle gaps named by the innermost span at their midpoint)."""
from benchmarks.program_trace import FORWARD


def read(run):
    p = run.get("profile")
    if not p or "program_gaps" not in p or p["window_s"] <= 0:
        return None
    idle = sum(v for k, v in p["program_gaps"].items() if k in FORWARD)
    return 100.0 * idle / p["window_s"]
