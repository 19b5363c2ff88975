"""Training visualization (the port's own copy of the metric and image
windows of ``kinet_tpu/utils/vis.py``; reference:
src/trackformer/vis.py).

The reference streams line plots and example images to a Visdom server
(vis.py:18-98). Here the same API writes matplotlib figures under
``output_dir/vis/``, and nothing when there is no output_dir or no
matplotlib: pyplot is imported on first use, so a machine without it
trains all the same. ``plot_sequence`` (the tracker's frame images) is
not ported yet (ROADMAP.md, 'Modules to port': Host tools).
"""
from __future__ import annotations

import json
import os
import os.path as osp
from collections import defaultdict

import numpy as np

def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


class MetricsSink:
    """Live metric stream — the answer to the reference's live Visdom
    windows (vis.py:247-374). Each point is emitted AS IT ARRIVES:

    - kind='jsonl': one JSON line per point appended to
      `output_dir/vis/metrics.jsonl` (`tail -f` is the live dashboard);
    - kind='tensorboard': SummaryWriter scalars under `output_dir/vis/tb`
      (degrades to jsonl if tensorboard isn't importable).
    """

    def __init__(self, kind: str, output_dir: str):
        self.kind = kind
        self.output_dir = output_dir
        self._file = None
        self._tb = None
        if kind == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter

                os.makedirs(osp.join(output_dir, "vis", "tb"), exist_ok=True)
                self._tb = SummaryWriter(osp.join(output_dir, "vis", "tb"))
            except ImportError:
                self.kind = "jsonl"
        if self._tb is None:
            os.makedirs(osp.join(output_dir, "vis"), exist_ok=True)
            self._file = open(
                osp.join(output_dir, "vis", "metrics.jsonl"), "a", buffering=1
            )

    def emit(self, series: str, name: str, x: float, value: float):
        if self._tb is not None:
            self._tb.add_scalar(f"{series}/{name}", value, int(x))
            return
        self._file.write(
            json.dumps({"series": series, "name": name, "x": x, "value": value})
            + "\n"
        )

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._file is not None:
            self._file.close()


class LineVis:
    """≙ reference LineVis (vis.py:18-72): appended line plots per metric."""

    def __init__(self, opts: dict, output_dir: str | None = None, enabled=True,
                 sink: MetricsSink | None = None):
        self.opts = opts
        self.output_dir = output_dir
        self.enabled = bool(enabled and output_dir and _pyplot() is not None)
        self.sink = sink
        self.data = defaultdict(list)
        self.steps = defaultdict(list)

    def plot(self, y, x):
        if not self.enabled and self.sink is None:
            return
        ys = np.atleast_1d(np.asarray(y, np.float64))
        legend = self.opts.get("legend", [f"y{i}" for i in range(len(ys))])
        title = self.opts.get("title", "metrics")
        for name, v in zip(legend, ys):
            if self.enabled:
                self.data[name].append(float(v))
                self.steps[name].append(float(x))
            if self.sink is not None:
                self.sink.emit(title, name, float(x), float(v))

    def save(self):
        if not self.enabled or not self.data:
            return
        plt = _pyplot()
        os.makedirs(osp.join(self.output_dir, "vis"), exist_ok=True)
        fig, ax = plt.subplots(figsize=(8, 5))
        for name, vals in self.data.items():
            ax.plot(self.steps[name], vals, label=name)
        ax.set_title(self.opts.get("title", "metrics"))
        ax.set_xlabel(self.opts.get("xlabel", "step"))
        ax.legend(fontsize=6)
        fname = self.opts.get("title", "metrics").replace(" ", "_")
        fig.savefig(osp.join(self.output_dir, "vis", f"{fname}.png"), dpi=100)
        plt.close(fig)


class ImgVis:
    """≙ reference ImgVis (vis.py:75-98): image panels."""

    def __init__(self, opts: dict, output_dir: str | None = None, enabled=True):
        self.opts = opts
        self.output_dir = output_dir
        self.enabled = bool(enabled and output_dir and _pyplot() is not None)
        self.count = 0

    def plot(self, images):
        if not self.enabled:
            return
        plt = _pyplot()
        os.makedirs(osp.join(self.output_dir, "vis"), exist_ok=True)
        n = len(images)
        fig, axes = plt.subplots(1, n, figsize=(6 * n, 5))
        if n == 1:
            axes = [axes]
        for ax, img in zip(axes, images):
            ax.imshow(np.asarray(img).astype(np.uint8))
            ax.axis("off")
        fname = self.opts.get("title", "imgs").replace(" ", "_")
        fig.savefig(
            osp.join(self.output_dir, "vis", f"{fname}_{self.count:04d}.jpg"),
            dpi=80,
        )
        plt.close(fig)
        self.count += 1


def build_visualizers(cfg):
    """≙ reference build_visualizers (vis.py:247-374): iter/epoch metric
    windows + example-result windows, keyed like the reference, and the
    metrics sink under "sink" when ``metrics_sink`` names one."""
    out = {"train": {}, "val": {}}
    if cfg.get("no_vis", True) and not cfg.get("output_dir"):
        return out
    output_dir = cfg.get("output_dir") or None
    sink = None
    sink_kind = cfg.get("metrics_sink", None)
    if sink_kind and output_dir:
        sink = MetricsSink(str(sink_kind), output_dir)
        out["sink"] = sink
    for split in ("train", "val"):
        out[split]["iter_metrics"] = LineVis(
            {"title": f"{split} iter metrics", "xlabel": "iter",
             "legend": ["loss", "loss_ce", "loss_bbox", "loss_giou"]},
            output_dir, sink=sink,
        )
        out[split]["epoch_metrics"] = LineVis(
            {"title": f"{split} epoch metrics", "xlabel": "epoch",
             "legend": ["AP", "AP50", "MOTA", "IDF1"]},
            output_dir, sink=sink,
        )
        out[split]["example_results"] = ImgVis(
            {"title": f"{split} example results"}, output_dir
        )
    return out
