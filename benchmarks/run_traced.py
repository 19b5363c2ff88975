"""Runs one cell of the benchmark as ``run.py`` does, with the program's own
tracer on (``kinet_tpu_torch/utils/trace.py``), and reads the metrics of
its spans and counters.

    python3 benchmarks/run_traced.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It is ``harness.main`` with ``run_cell``
below in the place of ``harness.run_cell``: the same checks of the cell,
the card and the modules loaded, the same log and the same result line,
and besides:

- the record gets ``program``: the spans and counters of the window's
  steps (``program_trace.window``), and the log their summary;
- with ``--trace 1``, the profile's record gets ``program_gaps`` and
  ``program_device_s`` (``program_trace.program_profile``), and the
  result's breakdown both;
- the result's metrics add ``PROGRAM_METRICS``, read by their files under
  ``metrics/`` (those of the device need ``--trace 1`` and a card).

``BENCHMARK.json`` does not list these metrics, and ``run.py`` does not
turn the tracer on: that needs a change to the loop
(``loops/batched_tracking.py``), a file the benchmark already has. Until
then the one hook into the loop is its ``read_profile``, wrapped while a
cell runs to keep a handle on the profile it reads.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])  # the checkout

from benchmarks import harness, program_trace  # noqa: E402

# as BENCHMARK.json would list them
PROGRAM_METRICS = [
    {"name": "h2d_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "batched tracker",
     "moves": "frames_per_s"},
    {"name": "h2d_mb_per_frame", "unit": "MB", "better": "lower",
     "source": "program_counter", "layer": "batched tracker",
     "moves": "frames_per_s"},
    {"name": "enqueue_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "model forward",
     "moves": "frames_per_s"},
    {"name": "fetch_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "batched tracker",
     "moves": "frame_ms_p95"},
    {"name": "enqueue_idle_pct", "unit": "%", "better": "lower",
     "source": "device_trace", "layer": "device", "moves": "frames_per_s"},
    {"name": "backbone_ms", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "model forward",
     "moves": "frames_per_s"},
    {"name": "encoder_ms", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "model forward",
     "moves": "frames_per_s"},
    {"name": "decoder_ms", "unit": "ms", "better": "lower",
     "source": "device_trace", "layer": "model forward",
     "moves": "frames_per_s"},
]
_plain_run_cell = harness.run_cell


def run_cell(name, seed, seconds, trace, device, bench, root=harness.ROOT,
             t_start=None):
    """``harness.run_cell`` with the program's tracer on: the same four
    results, the record with ``program`` and the result with the program's
    metrics."""
    from kinet_tpu_torch.utils import trace as program

    _, work, _, _ = harness.load_cell(name, bench, root)
    serve = harness.loop(work["loop"])
    read_profile, profiles = serve.read_profile, []

    def read(prof, *args):
        profiles.append(prof)
        return read_profile(prof, *args)

    serve.read_profile = read
    program.enable()
    # the epoch's ns at the monotonic clock's zero, as the tracer's anchor
    anchor = time.time_ns() - time.perf_counter_ns()
    try:
        result, rows, record, ctx = _plain_run_cell(
            name, seed, seconds, trace, device, bench, root, t_start)
        drained = program.drain()
    finally:
        program.disable()
        serve.read_profile = read_profile
    # the window: from its first step's start to its last step's end
    t0 = ctx.t_start + record["setup_s"]
    t1 = t0 + record["window_s"] + record["kept_s"]
    record["program"] = program_trace.window(drained, anchor + t0 * 1e9,
                                             anchor + t1 * 1e9)
    prof = record.get("profile")
    if profiles and prof:
        dev, host = serve.device_events(profiles[0])
        steps = host.get("step", [])
        start = min([a for a, _ in steps] + [dev[0][0]])
        end = max([z for _, z in steps] + [dev[-1][1]])
        prof.update(program_trace.program_profile(
            profiles[0], record["program"]["spans"], dev, start, end))
        for key in ("program_gaps", "program_device_s"):
            result["breakdown"][key] = sorted(
                ([k, v] for k, v in prof[key].items()), key=lambda kv: -kv[1])
    for m in PROGRAM_METRICS:
        value = harness.reader(m["name"], root)(record)
        if value is None:
            ctx.log(f"{m['name']}: nothing to read in this run")
            continue
        result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    for line in program.summary(record["program"]):
        ctx.log(line)
    return result, rows, record, ctx


def main(argv, t_start) -> int:
    """``harness.main``, which calls ``run_cell`` by its name in the
    harness, with this file's ``run_cell`` there for the call."""
    plain, harness.run_cell = harness.run_cell, run_cell
    try:
        return harness.main(argv, t_start)
    finally:
        harness.run_cell = plain


if __name__ == "__main__":
    t_start = time.perf_counter() - harness.process_age()
    harness.setup_env()
    sys.exit(main(sys.argv[1:], t_start))
