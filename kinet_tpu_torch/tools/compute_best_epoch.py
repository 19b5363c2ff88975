"""Best-epoch extraction across cross-validation splits (port of
``kinet_tpu/tools/compute_best_epoch.py``; reference:
src/compute_best_mean_epoch_from_splits.py reads visdom logs). The
per-epoch evaluation metrics come from the ``metrics.jsonl`` that
``engine/train.py`` writes into each run's output_dir.

    python -m kinet_tpu_torch.tools.compute_best_epoch runs/split1 runs/split2
"""
from __future__ import annotations

import argparse
import json
import os.path as osp

import numpy as np


def load_metrics(output_dir: str) -> dict[int, dict]:
    """{epoch: its metrics record} of a run ({} without metrics.jsonl)."""
    path = osp.join(output_dir, "metrics.jsonl")
    out = {}
    if not osp.exists(path):
        return out
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out[int(rec["epoch"])] = rec
    return out


def best_mean_epoch(dirs: list[str], metric: str = "mota"):
    """(the epoch whose ``metric``, averaged over the runs, is highest;
    {epoch: mean}) over the epochs every run has, or (None, {})."""
    per_split = [load_metrics(d) for d in dirs]
    epochs = sorted(set.intersection(*(set(m) for m in per_split)) or set())
    if not epochs:
        return None, {}
    means = {
        e: float(np.mean([m[e].get(metric, np.nan) for m in per_split]))
        for e in epochs
    }
    best = max(means, key=lambda e: means[e])
    return best, means


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dirs", nargs="+")
    p.add_argument("--metric", default="mota")
    args = p.parse_args(argv)
    best, means = best_mean_epoch(args.dirs, args.metric)
    for e in sorted(means):
        print(f"epoch {e}: mean {args.metric} = {means[e]:.4f}")
    print(f"BEST epoch: {best}")


if __name__ == "__main__":
    main()
