"""A tiny cell for the CPU tests, added the way a later change adds one:
new files in a copy of this folder (a configuration, a traffic mix, a
workload, optionally a metric reader) and new entries in a copy of
``BENCHMARK.json``; no file that is there changes."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY = dict(backbone="resnet_test", hidden_dim=48, nheads=4, enc_layers=2,
            dec_layers=2, dim_feedforward=64, num_queries=20,
            max_track_queries=8)


def tiny_config(name, base_config, precision="float32", **over):
    conf = json.loads((BENCH / "configs" / f"{base_config}.json").read_text())
    conf["name"] = name
    conf["precision"] = precision
    conf["overrides"] = dict(conf["overrides"], **TINY, **over)
    conf["model"] = dict(conf["model"], **TINY, **over)
    return conf


TRAFFIC = {"streams": 4, "height": 96, "width": 160, "pad_bottom": 8,
           "pad_right": 16, "cycle_frames": 5, "boxes": 4,
           "box_height": [0.1, 0.4], "box_width": [0.05, 0.2],
           "max_speed": 0.03, "background_std": 0.5, "box_gain": 2.0,
           "live_tracks": 4, "births_per_frame": 0.5, "settle_steps": 6}


def make_root(tmp: Path, cells: dict, metric_files: dict | None = None,
              per_layer: list | None = None):
    """A copy of the benchmark under ``tmp`` with the cells ``cells``
    ({cell: (configuration dict, limits or None)}) added as new files, and
    ``metric_files`` ({name: source}) as new readers listed under
    ``per_layer``. Returns (root, the BENCHMARK.json dict)."""
    root = tmp / "benchmarks"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (root / "traffic" / "tiny.json").write_text(json.dumps(TRAFFIC))
    for cell, (conf, limits) in cells.items():
        (root / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
        work = json.loads((root / "workloads" / "mot17.s4.json").read_text())
        work.update(config=conf["name"], traffic="tiny", warmup_steps=4,
                    check_steps=2, profile_steps=1)
        if limits is not None:
            work["limits"] = dict(work["limits"], **limits)
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(work))
        bench["configs"].append({"name": conf["name"], "source": conf["source"],
                                 "file": f"benchmarks/configs/{conf['name']}.json",
                                 "reduced": [], "why": "CPU tests"})
        bench["workloads"].append({"name": cell, "config": conf["name"],
                                   "traffic": "tiny", "chips": 1,
                                   "why": "CPU tests"})
    for name, src in (metric_files or {}).items():
        (root / "metrics" / f"{name}.py").write_text(src)
    bench = copy.deepcopy(bench)
    bench["per_layer"] += per_layer or []
    return root, bench
