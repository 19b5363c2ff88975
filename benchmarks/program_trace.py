"""The program's own spans and counters (``kinet_tpu_torch/utils/trace.py``)
read against a run of the benchmark: pure functions of a drained record
and a profile, called by ``run_traced.py`` and by the metric readers
under ``metrics/``.

- ``window``: the steps of a drained record that fall in the timed window,
  with their spans and the sum of their counters;
- ``span_ms_a_step``: the host ms a step of one span name;
- ``program_profile``: ``program_gaps`` (each idle gap of the card named by
  the innermost program span at its midpoint, or ``outside``) and
  ``program_device_s`` (each kernel's device seconds given to the
  innermost program span around its launch: the profiler links a kernel
  to its launch call by correlation id; ``unlinked`` where none has its
  id).

The program stamps its spans in ns since the Unix epoch, the clock of the
profiler's events, so a span and the card's work compare directly.
"""
from __future__ import annotations

import bisect

# the spans in which the host enqueues the forward's device work
FORWARD = ("forward", "backbone", "encoder", "decoder", "postprocess")
OUTSIDE = "outside"


class Innermost:
    """The innermost of nested spans at a time: ``spans`` [(start, end,
    name)] in one unit, each span inside its parent or apart from it."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [a for a, _, _ in self.spans]

    def __call__(self, t) -> str:
        # the span that starts last at or before t and holds it is the
        # innermost: the spans that hold t nest, and start in that order
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            a, z, name = self.spans[i]
            if t <= z:
                return name
            i -= 1
        return OUTSIDE


def name_gaps(dev, start, end, owner) -> dict:
    """{name: idle seconds} of the window [start, end] (us) between the
    card's operations ``dev`` [(start us, end us, name)], sorted by
    start, each gap named by ``owner`` at its midpoint (the loop's
    ``read_profile`` walks the same gaps)."""
    gaps, prev = {}, start
    for a, z, _ in dev:
        if a > prev:
            k = owner((a + prev) / 2)
            gaps[k] = gaps.get(k, 0.0) + (a - prev) * 1e-6
        prev = max(prev, z)
    if end > prev:
        k = owner((end + prev) / 2)
        gaps[k] = gaps.get(k, 0.0) + (end - prev) * 1e-6
    return gaps


def device_by_span(kernels, launches, owner) -> dict:
    """{name: device seconds} of ``kernels`` [(correlation id, seconds)],
    each given to the span ``owner`` names at its launch's host time
    (``launches`` {correlation id: ns}); ``unlinked`` where no launch has
    its id."""
    out = {}
    for corr, secs in kernels:
        t = launches.get(corr)
        k = "unlinked" if t is None else owner(t)
        out[k] = out.get(k, 0.0) + secs
    return out


def window(program, start_ns, end_ns) -> dict:
    """The steps of a drained record (``trace.drain()``) whose ``step``
    span has its midpoint in [start_ns, end_ns] (epoch ns): their spans,
    parents indexed anew, and the sum of the counters kept with them."""
    spans = program["spans"]
    steps = {s["step"] for s in spans if s["name"] == "step"
             and start_ns <= (s["start_ns"] + s["end_ns"]) / 2 <= end_ns}
    keep = [i for i, s in enumerate(spans) if s["step"] in steps]
    index = {old: new for new, old in enumerate(keep)}
    out, counters = [], {}
    for i in keep:
        s = dict(spans[i], parent=index.get(spans[i]["parent"]))
        for k, n in s.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + n
        out.append(s)
    return {"spans": out, "counters": counters}


def span_ms_a_step(run, name):
    """Host ms a step of the program's spans ``name`` in a record, mean
    over the window's steps; None without them."""
    steps = {}
    for s in (run.get("program") or {}).get("spans") or ():
        if s["name"] == name:
            steps[s["step"]] = steps.get(s["step"], 0.0) \
                + (s["end_ns"] - s["start_ns"]) * 1e-6
    return sum(steps.values()) / len(steps) if steps else None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "cudaMemcpy"))


def program_profile(prof, spans, dev, start, end) -> dict:
    """``program_gaps`` and ``program_device_s`` of a profile: ``spans``
    the program's drained spans (epoch ns), ``dev`` the card's operations
    and [start, end] the window, as the loop's ``read_profile`` takes them
    (us from the profile's start)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    # the spans of the profiled steps, in us from the profile's start
    kept = [((s["start_ns"] - t0) * 1e-3, (s["end_ns"] - t0) * 1e-3, s)
            for s in spans]
    kept = [(a, z, s) for a, z, s in kept if z >= start and a <= end]
    epoch = Innermost([(s["start_ns"], s["end_ns"], s["name"])
                       for _, _, s in kept])
    rel = Innermost([(a, z, s["name"]) for a, z, s in kept])
    launches, kernels = {}, []
    for e in results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # annotations (the ranges of the benchmark and the program on
            # the device's timeline) and copies are not kernels
            if name.startswith(("bench.", "kinet.")) or is_copy(name):
                continue
            kernels.append((e.correlation_id(), e.duration_ns() * 1e-9))
        elif name.startswith("cu"):  # CUDA API calls: cudaLaunchKernel, cuLaunchKernel, ...
            launches[e.correlation_id()] = e.start_ns()
    return {"program_gaps": name_gaps(dev, start, end, rel),
            "program_device_s": device_by_span(kernels, launches, epoch)}
