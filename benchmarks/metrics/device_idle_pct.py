"""Device: the share of the profiled window that no kernel or copy covers
(one stream, so the operations do not overlap)."""


def read(run):
    p = run.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
