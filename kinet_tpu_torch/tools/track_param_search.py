"""Tracker hyper-parameter grid search (port of
``kinet_tpu/tools/track_param_search.py``; reference:
src/track_param_search.py:55-122).

Runs the port's tracking pipeline (``engine/track.py::main_track``) once
per combination of ``tracker_cfg`` overrides and reports each one's MOTA
and IDF1, and the best by MOTA. Every run restores the model from
``obj_detect_checkpoint_dir`` and reseeds numpy, so each combination starts
from the same state.

    python -m kinet_tpu_torch.tools.track_param_search --config track.yaml \
        obj_detect_checkpoint_dir=models/exp1

runs on the GPU; ``device=cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import itertools

from ..config import load_config, parse_cli_overrides
from ..engine.track import main_track

DEFAULT_GRID = {
    "detection_obj_score_thresh": [0.3, 0.4, 0.5],
    "track_obj_score_thresh": [0.3, 0.4, 0.5],
    "detection_nms_thresh": [0.9],
    "track_nms_thresh": [0.9],
    "steps_termination": [1],
}


def search(cfg, grid: dict | None = None):
    """[{grid key: value, ..., "mota", "idf1"}] in the grid's order (the
    first key varies slowest), or None when the sequences have no ground
    truth."""
    grid = grid or DEFAULT_GRID
    keys = list(grid)
    best = None
    results = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        over = {f"tracker_cfg.{k}": v for k, v in zip(keys, combo)}
        summary = main_track(cfg.replace(**over))
        if summary is None:
            print("no GT available — cannot search")
            return None
        overall = summary.get("OVERALL") or next(iter(summary.values()))
        entry = {
            **dict(zip(keys, combo)),
            "mota": overall["mota"],
            "idf1": overall["idf1"],
        }
        results.append(entry)
        print(f"combo {dict(zip(keys, combo))} -> "
              f"MOTA {overall['mota']:.4f} IDF1 {overall['idf1']:.4f}")
        if best is None or entry["mota"] > best["mota"]:
            best = entry
    print(f"BEST: {best}")
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="track.yaml")
    p.add_argument("overrides", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = load_config(
        args.config, overrides=parse_cli_overrides(args.overrides)
    )
    search(cfg)


if __name__ == "__main__":
    main()
