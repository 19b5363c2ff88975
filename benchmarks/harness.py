"""The benchmark's general part: finds a cell's files by name, checks the
machine, runs the cell's loop, reads the metrics and prints the result.

Everything that belongs to one piece sits in a file of its own under
this folder, found by the name that ``BENCHMARK.json`` gives:

- ``workloads/<cell>.json``: the cell (its configuration and traffic by
  name, its loop, its tracker settings, the steps it warms up, keeps for
  the check and profiles, and the limit of each compared number);
- ``configs/<config>.json``: a configuration (the program's named cfgs and
  overrides, the precision, the model's sizes that the reference reads);
- ``traffic/<traffic>.json``: a traffic mix, read by ``traffic/generator.py``;
- ``loops/<loop>.py``: a loop that serves a cell, ``run(ctx) -> record``;
- ``metrics/<metric>.py``: the reader of a metric, ``read(record)``, which
  returns the value, or None where the record holds nothing to read.

A new cell, configuration, traffic mix or metric is a new file there and
an entry in ``BENCHMARK.json``; no file that is there changes.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent  # this folder
FORBIDDEN = ("jax", "jaxlib", "flax", "kinet_tpu")  # whole top-level names


def setup_env():
    """Before torch is imported: the build and kernel caches at fixed paths
    inside the checkout (``build/``, where the program builds its kernels),
    one thread for the host's numeric libraries (the host is shared, and
    thread pools that spin widen the spread between runs), and the
    checkout's root first on the path (this package and the program)."""
    repo = ROOT.parent
    os.environ["TRITON_CACHE_DIR"] = str(repo / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(repo / "build" / "torch_extensions")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if str(repo) not in sys.path:
        sys.path.insert(0, str(repo))


def forbidden_modules(modules=None) -> list:
    """The top-level names among ``modules`` (default: ``sys.modules``) that
    the benchmark may not load: JAX, its libraries and the JAX package
    (``kinet_tpu_torch`` is another name)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict, root: Path = ROOT):
    """(BENCHMARK.json's entry, workload, configuration, traffic) of a cell."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = load_json(root / "workloads" / f"{name}.json")
    if (work["config"], work["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"{name}: workloads/{name}.json names "
                         f"{work['config']}, {work['traffic']}; BENCHMARK.json "
                         f"{entry['config']}, {entry['traffic']}")
    conf = load_json(root / "configs" / f"{entry['config']}.json")
    traffic = load_json(root / "traffic" / f"{entry['traffic']}.json")
    return entry, work, conf, traffic


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(name: str):
    """A loop module: ``loops/<name>.py`` of the benchmarks package."""
    return importlib.import_module(f"{__package__}.loops.{name}")


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    safe = metric.replace(".", "_").replace("-", "_")
    return load_module(root / "metrics" / f"{metric}.py",
                       f"_bench_metric_{safe}").read


def cell_metrics(name: str, bench: dict, trace: bool) -> list:
    """The metric entries a cell reports: the end-to-end ones in a run
    without the trace, the per-layer ones with it."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if name in m.get("workloads", [name])]


def smi() -> str:
    """The card's name, clocks, power draw and power limit, temperature."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return res.stdout.strip().replace("\n", " | ") or res.stderr.strip()


class Context:
    """What a loop gets: the cell's files, the run's arguments, the
    device, the table of peaks, a log on standard error."""

    def __init__(self, name, entry, work, conf, traffic, seed, seconds,
                 trace, device, t_start, root=ROOT):
        import torch

        self.name, self.entry, self.workload = name, entry, work
        self.config, self.traffic = conf, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.peaks = load_json(root / "peaks.json")
        self.smi = smi if self.device.type == "cuda" else (lambda: "no card")
        self.smi_before = self.smi_after = ""
        self.kept = None

    @staticmethod
    def log(msg: str):
        print(msg, file=sys.stderr, flush=True)


def run_cell(name, seed, seconds, trace, device, bench, root=ROOT,
             t_start=None):
    """Runs one cell once: (the result's dict, the compared rows, the
    record, the context)."""
    entry, work, conf, traffic = load_cell(name, bench, root)
    serve = loop(work["loop"])
    ctx = Context(name, entry, work, conf, traffic, seed, seconds, trace,
                  device, time.perf_counter() if t_start is None else t_start,
                  root)
    record = serve.run(ctx)
    nums = dict(record["check"], frames_untracked=record["failed"])
    limits = work["limits"]
    rows = [(k, nums[k], limits[k]) for k in limits]
    correct = all(v <= lim for _, v, lim in rows)
    metrics = {}
    for m in cell_metrics(name, bench, trace):
        value = reader(m["name"], root)(record)
        if value is None:
            ctx.log(f"{m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": record["frames"],
              "failed": record["failed"], "metrics": metrics,
              "device": device_info(ctx, entry, record)}
    prof = record.get("profile")
    if trace and prof:
        result["device"].update(busy_s=prof["busy_s"],
                                window_s=prof["window_s"])
        top = lambda d: [[k, v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        result["breakdown"] = {"device_ops": top(prof["ops"]),
                               "idle_gaps": top(prof["gaps"])}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows, record, ctx


def device_info(ctx, entry, record) -> dict:
    import torch

    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": entry["chips"], "memory_peak_bytes": record["peak_bytes"]}


def parse(argv):
    ap = argparse.ArgumentParser(description="Runs one cell of the benchmark "
                                 "once and prints its result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start) -> int:
    args = parse(argv)
    bench = load_json(ROOT.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload),
                 None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 3
    work = load_json(ROOT / "workloads" / f"{args.workload}.json")
    loop(work["loop"])  # the loop and the program it imports
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded at the start: {bad}", file=sys.stderr)
        return 4
    log = Context.log
    log(f"card before set-up: {smi()}")
    result, rows, record, ctx = run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
        bench, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded by the end of the window: {bad}",
              file=sys.stderr)
        return 4
    log(f"card at the window's start: {ctx.smi_before}")
    log(f"card at the window's end: {ctx.smi_after}")
    log("warm set-up (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in record["setup_parts"].items())
        + f"; setup_s {record['setup_s']:.3f}; check {record['check_s']:.3f}")
    log(f"check steps {record['check_samples']} ({record['late_samples']} "
        f"stepped after the window)")
    for k, v, lim in rows:
        log(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0
