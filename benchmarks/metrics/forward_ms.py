"""Model forward: host ms a step from the forward's call to the
synchronisation after it (the traced run synchronises there), mean over
the traced window's steps."""
import statistics


def read(run):
    spans = (run.get("spans") or {}).get("forward")
    return statistics.fmean(spans) if spans else None
