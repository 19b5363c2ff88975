"""Training-log plotting (port of ``kinet_tpu/utils/plot_utils.py``;
reference: src/trackformer/util/plot_utils.py).

The reference plots torch training logs and pickled precision-recall
results. Here the same plots read this framework's artifacts: the
``metrics.jsonl`` that ``engine/train.py`` writes into a run's output_dir,
and the accumulated precisions of ``utils/coco_eval.py::CocoEvaluator``.
These functions draw with matplotlib, and raise an ImportError naming it
where it is not installed.
"""
from __future__ import annotations

import json
import os.path as osp
from pathlib import Path

import numpy as np

from . import vis


def _pyplot():
    """matplotlib.pyplot on the Agg backend; raises without matplotlib."""
    plt = vis._pyplot()
    if plt is None:
        raise ImportError("kinet_tpu_torch.utils.plot_utils draws with "
                          "matplotlib, which is not installed")
    return plt


def load_log(output_dir: str) -> list[dict]:
    """The records of ``output_dir/metrics.jsonl`` ([] without it)."""
    path = Path(output_dir) / "metrics.jsonl"
    if not path.exists():
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def plot_logs(
    log_dirs: list[str],
    fields=("AP", "mota", "idf1"),
    output_path: str | None = None,
):
    """Compares runs field by field over their epochs (reference
    plot_utils.plot_logs); returns the figure, or writes it to
    ``output_path`` and closes it."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, len(fields), figsize=(5 * len(fields), 4))
    if len(fields) == 1:
        axes = [axes]
    for d in log_dirs:
        recs = load_log(d)
        if not recs:
            continue
        epochs = [r["epoch"] for r in recs]
        for ax, f in zip(axes, fields):
            vals = [r.get(f) for r in recs]
            if any(v is not None for v in vals):
                ax.plot(epochs, [v if v is not None else np.nan for v in vals],
                        label=osp.basename(d))
    for ax, f in zip(axes, fields):
        ax.set_title(f)
        ax.set_xlabel("epoch")
        ax.legend(fontsize=6)
    if output_path:
        fig.savefig(output_path, dpi=110)
        plt.close(fig)
    return fig


def plot_precision_recall(evaluator, output_path: str | None = None):
    """Precision-recall curves at IoU 0.5 and 0.75 from a CocoEvaluator's
    accumulated precisions (reference plot_utils.plot_precision_recall
    reads pickled COCO evaluations); None before ``accumulate()``."""
    plt = _pyplot()
    if evaluator.eval_imgs is None:
        return None
    from .coco_eval import IOU_THRS, REC_THRS

    p = evaluator.eval_imgs["precision"]  # [T, R, K, A]
    fig, ax = plt.subplots(figsize=(6, 5))
    for ti in (0, 5):
        prec = p[ti, :, :, 0]
        prec = prec[:, (prec > -1).any(axis=0)]
        if prec.size:
            ax.plot(REC_THRS, prec.mean(axis=1),
                    label=f"IoU={IOU_THRS[ti]:.2f}")
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.legend()
    if output_path:
        fig.savefig(output_path, dpi=110)
        plt.close(fig)
    return fig
