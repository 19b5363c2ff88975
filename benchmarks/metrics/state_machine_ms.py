"""Tracker state machine: host ms of one stream's ``Tracker._consume`` a
frame (thresholds, NMS, re-identification, track bookkeeping, results),
mean over the traced window's frames."""
import statistics


def read(run):
    spans = (run.get("spans") or {}).get("state_machine")
    return statistics.fmean(spans) if spans else None
