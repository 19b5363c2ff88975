"""Spans and counters of the served step, kept in memory until drained.

    from kinet_tpu_torch.utils import trace

    trace.enable()
    tracker.step(blob)          # spans: step > stage, h2d, forward > ...
    rec = trace.drain()         # {"spans": [...], "counters": {...}}
    print("\\n".join(trace.summary(rec)))

Off (the default), ``span`` returns one shared object that does nothing
and ``count`` returns at once: no clock is read and nothing is kept or
allocated. On, a span keeps its name, its start and end, its parent and
its identifiers, and opens a ``torch.profiler.record_function`` range
named ``kinet.<name>``, so it lands in any profile taken meanwhile.

Identifiers: a span named ``step`` starts the next step number, and every
span inside it carries that number (the counts made inside it are kept
with it too); ``stream`` is the index of the stream (the batched
tracker's slot) a span belongs to, inherited from the parent where not
given. Nothing here synchronizes the device: a span measures the
host's time, and a profile places the device's work in it.

Times are ns since the Unix epoch, the clock the profiler stamps its host
and device events with (``kineto_results.trace_start_ns()`` and each
event's ``start_ns()``): each end is read on the monotonic clock, and
``enable`` takes an anchor pair of both clocks that places them.

Spans stay in memory until ``drain``, which is called between steps.
"""
from __future__ import annotations

import time

import numpy as np
import torch

_STEP = "step"


class _Off:
    """The span of a tracer that is off: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "row", "range")

    def __init__(self, rec, row):
        self.rec, self.row = rec, row

    def __enter__(self):
        self.range = torch.profiler.record_function("kinet." + self.row[0])
        self.range.__enter__()
        self.row[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.row[2] = time.perf_counter_ns()
        rec = self.rec
        rec.stack.pop()
        if self.row[6] is not None:  # a step: counts go outside it again
            rec.counters = rec.loose
        return False


class _Recorder:
    def __init__(self):
        # the anchor: the epoch's ns at the monotonic clock's zero
        self.offset = time.time_ns() - time.perf_counter_ns()
        # [name, start, end, parent row, step, stream, a step's counters]
        self.rows = []
        self.stack = []  # indices of the open spans' rows
        self.loose = {}  # the counters counted outside every step
        self.counters = self.loose  # where ``count`` adds: the open step's
        self.steps = 0

    def open(self, name, stream):
        parent = self.stack[-1] if self.stack else None
        step = None
        if parent is not None:
            up = self.rows[parent]
            step = up[4]
            if stream is None:
                stream = up[5]
        counters = None
        if name == _STEP:
            step, self.steps = self.steps, self.steps + 1
            counters = self.counters = {}
        row = [name, None, None, parent, step, stream, counters]
        self.stack.append(len(self.rows))
        self.rows.append(row)
        return _Span(self, row)


_rec = None  # the recorder while on


def enable():
    """Turns the tracer on (a second call keeps what was recorded)."""
    global _rec
    if _rec is None:
        _rec = _Recorder()


def disable():
    """Turns the tracer off; what was not drained is dropped."""
    global _rec
    _rec = None


def enabled() -> bool:
    return _rec is not None


def span(name: str, stream=None):
    """A context manager that records the span ``name`` while on."""
    rec = _rec
    if rec is None:
        return _OFF
    return rec.open(name, stream)


def count(name: str, n=1):
    """Adds ``n`` to the counter ``name`` while on."""
    rec = _rec
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def drain() -> dict:
    """The spans and counters recorded since the last drain, which are
    cleared: {"spans": [{"name", "start_ns", "end_ns", "parent" (an index
    into the list, or None), "step", "stream"}], "counters": {name: sum}}.
    A ``step`` span also holds "counters", those counted inside it, so
    that a reader can sum them over the steps it keeps. Empty while off."""
    rec = _rec
    if rec is None:
        return {"spans": [], "counters": {}}
    if rec.stack:
        raise RuntimeError("trace.drain() inside a span: drain between steps")
    off = rec.offset
    spans, counters = [], dict(rec.loose)
    for name, start, end, parent, step, stream, own in rec.rows:
        span = {"name": name, "start_ns": start + off, "end_ns": end + off,
                "parent": parent, "step": step, "stream": stream}
        if own is not None:
            span["counters"] = own
            for k, n in own.items():
                counters[k] = counters.get(k, 0) + n
        spans.append(span)
    rec.rows, rec.loose = [], {}
    rec.counters = rec.loose
    return {"spans": spans, "counters": counters}


def summary(rec: dict) -> list:
    """Lines for an operator: each span name's count, median and 95th
    percentile in ms, then the counters (frames, MB to the device, of
    which copied from page-locked buffers, staging buffers allocated,
    tracks born, re-identified, ended, and live a frame; with a mask head,
    its rows, the MB of mask probabilities fetched and the track masks
    resolved)."""
    by_name = {}
    for s in rec["spans"]:
        by_name.setdefault(s["name"], []).append(
            (s["end_ns"] - s["start_ns"]) * 1e-6)
    lines = [f"SPAN {name}: {len(ms)} x, median {np.median(ms):.3f} ms, "
             f"p95 {np.percentile(ms, 95):.3f} ms"
             for name, ms in by_name.items()]
    c = rec["counters"]
    frames = c.get("frames", 0)
    lines.append(
        f"COUNTERS: {frames} frames, "
        f"{c.get('h2d_bytes', 0) / 1e6:.2f} MB to the device "
        f"({c.get('h2d_pinned_bytes', 0) / 1e6:.2f} MB copied page-locked, "
        f"{c.get('h2d_stage_allocs', 0)} staging buffers allocated), "
        f"tracks born "
        f"{c.get('tracks_born', 0)}, re-identified "
        f"{c.get('tracks_reidentified', 0)}, ended {c.get('tracks_ended', 0)},"
        f" live a frame {c.get('tracks_live', 0) / max(frames, 1):.2f}")
    if "mask_rows" in c:
        lines.append(
            f"MASKS: {c['mask_rows']} rows through the mask head, "
            f"{c.get('mask_d2h_bytes', 0) / 1e6:.2f} MB of probabilities to "
            f"the host, {c.get('masks_resolved', 0)} track masks resolved")
    return lines
