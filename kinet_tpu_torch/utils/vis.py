"""Training and tracking visualization (the port's own copy of
``kinet_tpu/utils/vis.py``; reference: src/trackformer/vis.py and
util/track_utils.py:127-237 plot_sequence).

The reference streams line plots and example images to a Visdom server
(vis.py:18-98). Here the same API writes matplotlib figures under
``output_dir/vis/``, and nothing when there is no output_dir or no
matplotlib: pyplot is imported on first use, so a machine without it
trains all the same. ``draw_boxes`` and ``plot_sequence`` (the tracker's
frame images, ``write_images`` in the track config) draw with numpy and
write with PIL, so they need no matplotlib: ``plot_sequence`` writes every
frame or raises.
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


# the track colours of plot_sequence: track id modulo 8
PALETTE = np.array(
    [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0],
     [255, 0, 255], [0, 255, 255], [255, 128, 0], [128, 0, 255]]
)


def draw_boxes(img: np.ndarray, boxes, color=(255, 0, 0), width=2):
    """Box overlay on an HWC uint8 image (no PIL.Draw dependency): each
    x0, y0, x1, y1 box rounded to whole pixels and clipped to the image,
    its edges ``width`` pixels wide, growing outwards."""
    out = np.asarray(img).astype(np.uint8).copy()
    h, w = out.shape[:2]
    for b in boxes:
        x0, y0, x1, y1 = [int(round(float(v))) for v in b[:4]]
        x0, x1 = np.clip([x0, x1], 0, w - 1)
        y0, y1 = np.clip([y0, y1], 0, h - 1)
        for t in range(width):
            xa, ya = max(x0 - t, 0), max(y0 - t, 0)
            xb, yb = min(x1 + t, w - 1), min(y1 + t, h - 1)
            out[ya, xa:xb + 1] = color
            out[yb, xa:xb + 1] = color
            out[ya:yb + 1, xa] = color
            out[ya:yb + 1, xb] = color
    return out


def vis_results(visualizer, img, result, target, tracking: bool):
    """≙ reference vis_results (vis.py:101-244): current-frame detections
    (green), track queries (blue), false track queries (red), as one image
    of ``visualizer``; a float image is taken as ImageNet-normalized."""
    if visualizer is None or not getattr(visualizer, "enabled", False):
        return
    frame = np.asarray(img)
    if frame.dtype != np.uint8:
        mean = np.array([0.485, 0.456, 0.406])
        std = np.array([0.229, 0.224, 0.225])
        frame = np.clip((frame * std + mean) * 255, 0, 255).astype(np.uint8)
    frame = draw_boxes(frame, np.asarray(result.get("boxes", [])), (0, 255, 0))
    if tracking and "track_query_boxes" in result:
        frame = draw_boxes(frame, result["track_query_boxes"], (0, 0, 255))
    if tracking and "track_query_fp_boxes" in result:
        frame = draw_boxes(frame, result["track_query_fp_boxes"], (255, 0, 0))
    visualizer.plot([frame])


def plot_sequence(results: dict, seq, output_dir: str, write_images="pretty"):
    """Writes ``output_dir/%06d.jpg`` for every frame of ``seq`` (its
    ``data[i]["im_path"]``): the frame with each track's box of that frame
    in ``PALETTE[track id % 8]`` (reference track_utils.py:127-237).
    ``results``: {track id: {frame index: {"bbox": x0, y0, x1, y1, ...}}}.
    Every value of ``write_images`` draws the same boxes, as in the JAX
    package."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    for frame_idx in range(len(seq)):
        img = np.asarray(
            Image.open(seq.data[frame_idx]["im_path"]).convert("RGB")
        )
        for tid, track in results.items():
            if frame_idx in track:
                color = tuple(int(c) for c in PALETTE[tid % len(PALETTE)])
                img = draw_boxes(img, [track[frame_idx]["bbox"]], color)
        Image.fromarray(img).save(
            osp.join(output_dir, f"{frame_idx:06d}.jpg")
        )
