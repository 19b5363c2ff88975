"""Batched tracker, staging: host ms a step from the step's entry to the
forward's call (each stream's track-query slots, the per-row host-to-device
copies and their concatenation), mean over the traced window's steps."""
import statistics


def read(run):
    spans = (run.get("spans") or {}).get("stage")
    return statistics.fmean(spans) if spans else None
