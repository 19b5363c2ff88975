"""A tiny MOTS cell for the CPU tests, added the way ``tiny.py`` adds its
cell: new files in a copy of this folder (a configuration from
``trackformer_mots20.json`` at tiny widths, a traffic mix, a workload from
``mots20.s4.json``) and new entries in a copy of ``BENCHMARK.json``."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from .tiny import BENCH, TRAFFIC

TINY = dict(backbone="resnet_test", hidden_dim=64, nheads=4, enc_layers=2,
            dec_layers=2, dim_feedforward=64, num_queries=12,
            max_track_queries=8)
# 100 x 164: levels C2..C5 25x41, 13x21, 7x11, 4x6; no size doubles the
# next, so every resize of the mask head takes the half-pixel rule; 20
# settle steps bring the tiny model to its 4 live tracks a stream, which
# the cell's ``live_tracks_gap`` holds it to
MOTS_TRAFFIC = dict(TRAFFIC, height=100, width=164, pad_bottom=8,
                    pad_right=16, settle_steps=20)
# float32 on the CPU: the order of sums alone
LIMITS = {"feature_gap": 1e-4, "memory_gap": 1e-4, "decoder_gap": 1e-4,
          "box_gap_px": 1e-2, "score_gap": 1e-4, "mask_gap": 1e-3,
          "prob_gap": 1e-5}


def tiny_config(name="tiny_mots", precision="float32", **over):
    conf = json.loads((BENCH / "configs" / "trackformer_mots20.json")
                      .read_text())
    conf["name"] = name
    conf["precision"] = precision
    conf["overrides"] = dict(conf["overrides"], **TINY, **over)
    conf["model"] = dict(conf["model"], **TINY, **over)
    return conf


def make_root(tmp: Path, conf: dict, limits=None, cell="tiny.mots"):
    """A copy of the benchmark under ``tmp`` with the cell ``cell`` of the
    configuration ``conf`` and ``limits`` (default ``LIMITS``) added as new
    files. Returns (root, the BENCHMARK.json dict)."""
    root = tmp / "benchmarks"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (root / "traffic" / "tiny_mots.json").write_text(json.dumps(MOTS_TRAFFIC))
    (root / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
    work = json.loads((root / "workloads" / "mots20.s4.json").read_text())
    work.update(config=conf["name"], traffic="tiny_mots", warmup_steps=4,
                check_steps=2, profile_steps=1)
    work["limits"] = dict(work["limits"], **(LIMITS if limits is None
                                             else limits))
    (root / "workloads" / f"{cell}.json").write_text(json.dumps(work))
    bench["configs"].append({"name": conf["name"], "source": conf["source"],
                             "file": f"benchmarks/configs/{conf['name']}.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": cell, "config": conf["name"],
                               "traffic": "tiny_mots", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["per_layer"]:
        if m.get("workloads") == ["mots20.s4"]:
            m["workloads"] = ["mots20.s4", cell]
    return root, bench
