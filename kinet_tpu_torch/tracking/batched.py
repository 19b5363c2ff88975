"""Batched multi-sequence tracking (port of
``kinet_tpu/tracking/batched.py``): N sequences stepped in lock-step,
one forward a step for all of them.

The reference tracker (tracker.py:269-557) runs sequences one at a time.
Stepping N together shares what a forward costs whatever its batch (the
model's Python, the launches, the fetch), which on the card is most of a
served frame (PERF.md §5).

N untouched per-sequence ``Tracker``s keep their host state machines;
this class only moves where the forward runs. Each step every live
tracker stages its padded track-query state (``Tracker._build_inputs``),
the arrays are copied to the device as one batch (``staging.py``: the
frames filled in parallel into reusable host buffers), the forward runs, ONE
device-to-host copy fetches every live row (``fetch_rows``), and each
tracker consumes its own row (``Tracker._consume``). The previous frame's
features and the ``cache_prev_encoder`` caches (encoded memory, position
embeddings) live here as [N, ...] tensors, not in the trackers.

Two device execution forms, ``batch_exec``:
- ``stacked``: one [N, ...] forward;
- ``interleaved``: N forwards at batch 1 on row slices of the inputs and
  caches, their outputs concatenated, then the same one fetch. Each
  sequence's forward is then the single tracker's own, at its shapes;
- ``auto``: stacked, the faster form at every frame size timed on the
  card (``exec_form``).

All sequences of a batch share the padded frame shape (``engine/track.py``
groups them). A finished sequence's slot rides on its own last inputs and
a slot that never started on another slot's, their outputs discarded, so
the batch keeps its shape.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..utils import trace
from .kine_tracker import TrackerKinematic, fetch_kine_rows
from .tracker import Tracker, fetch_rows


def _row(x, e: int):
    """Batch row e of a tensor, or of every tensor in a (nested) tuple or
    list; None stays None."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x[e:e + 1]
    return type(x)(_row(y, e) for y in x)


def _concat(xs: list):
    """The batch-axis concatenation of like structures (dicts, tuples,
    lists of tensors, None)."""
    x0 = xs[0]
    if x0 is None:
        return None
    if torch.is_tensor(x0):
        return torch.cat(xs, dim=0)
    if isinstance(x0, dict):
        return {k: _concat([x[k] for x in xs]) for k in x0}
    return type(x0)(_concat(list(parts)) for parts in zip(*xs))


def _stage_inputs(trackers, blobs, last_inputs):
    """Each slot's forward inputs: a live slot's tracker stages its next
    frame; a finished slot (blob None) rides on its own last inputs, one
    that never started on a live slot's, so the batch keeps its shape.
    None when no slot has anything to ride on (every sequence empty)."""
    inputs: list = [None] * len(trackers)
    for i, (tr, blob) in enumerate(zip(trackers, blobs)):
        if blob is None:
            inputs[i] = last_inputs[i]
            continue
        inputs[i] = last_inputs[i] = tr._build_inputs(blob)
    donor = next((inp for inp in inputs if inp is not None), None)
    if donor is None:
        return None
    return [inp if inp is not None else donor for inp in inputs]


def _stack(inputs: list) -> dict:
    return {k: np.concatenate([inp[k] for inp in inputs], axis=0)
            for k in inputs[0]}


class BatchedTracker:
    def __init__(
        self,
        model,
        postprocess,
        tracker_cfg: dict,
        *,
        num_object_queries: int,
        num_track_slots: int,
        hidden_dim: int,
        n_sequences: int,
        overflow_boxes: bool = False,
        generate_attention_maps: bool = False,
    ):
        self.trackers = [
            Tracker(model, postprocess, tracker_cfg,
                    num_object_queries=num_object_queries,
                    num_track_slots=num_track_slots, hidden_dim=hidden_dim,
                    overflow_boxes=overflow_boxes,
                    generate_attention_maps=generate_attention_maps)
            for _ in range(n_sequences)
        ]
        for i, tr in enumerate(self.trackers):
            tr.stream = i
        self._fwd = self.trackers[0]._fwd
        self._batch_exec = str(tracker_cfg.get("batch_exec", "auto"))
        if self._batch_exec not in ("auto", "stacked", "interleaved"):
            raise ValueError(f"unknown batch_exec {self._batch_exec!r}")
        self._prev_frame_dist = self.trackers[0].prev_frame_dist
        self.reset()

    @property
    def n_sequences(self) -> int:
        return len(self.trackers)

    def reset(self, hard: bool = True):
        for t in self.trackers:
            t.reset(hard)
        self._prev_features = deque([None], maxlen=self._prev_frame_dist)
        self._prev_memory = deque([None], maxlen=self._prev_frame_dist)
        self._pos_cache = None
        self._last_inputs: list = [None] * len(self.trackers)

    def exec_form(self) -> str:
        """The form a step takes.

        ``auto`` takes the stacked form at every size: no crossover was
        found. With 4 sequences of the served flagship (dec_msda_int8,
        bf16) at B = 4, aggregate frames/s stacked vs interleaved were
        109.8 vs 28.3 at 544x960, 85.8 vs 30.1 at 800x1440 and 71.2 vs
        32.2 at 1088x1920 (chip_smoke.py's phase B on an "NVIDIA H100 80GB
        HBM3, 700.00 W"; earlier runs 2.1-4.6x at the two smaller sizes;
        PERF.md §6): interleaving pays the host's Python of a forward once
        a sequence, and runs the same device work as the stacked form."""
        if self._batch_exec != "auto":
            return self._batch_exec
        return "stacked"

    def _forward(self, inputs: list):
        """The forward over every slot's staged inputs ([1, ...] host
        arrays each), in the form ``exec_form`` names."""
        caches = (self._prev_features[0], self._prev_memory[0],
                  self._pos_cache)
        tracker = self.trackers[0]
        if len(inputs) == 1 or self.exec_form() == "stacked":
            # the rows filled in parallel into the first tracker's staging
            # buffers and copied to the device (staging.py)
            with trace.span("h2d"):
                dev_inputs = tracker.make_device_inputs(inputs)
            return self._fwd(*dev_inputs, *caches)
        outs = []
        for e, inp in enumerate(inputs):
            with trace.span("h2d", e):
                dev_inputs = tracker.make_device_inputs(inp)
            outs.append(self._fwd(*dev_inputs, *(_row(c, e) for c in caches)))
        return _concat(outs)

    def step(self, blobs: list):
        """blobs[i]: the next frame blob of sequence i, or None once that
        sequence is finished."""
        if len(blobs) != len(self.trackers):
            raise ValueError(f"{len(blobs)} blobs for {len(self.trackers)} "
                             f"sequences")
        with trace.span("step"):
            inputs = _stage_inputs(self.trackers, blobs, self._last_inputs)
            if inputs is None:
                return
            res = self._forward(inputs)
            live = [i for i, blob in enumerate(blobs) if blob is not None]
            outs = fetch_rows(res, live)
            for i in live:
                self.trackers[i]._consume(outs[i], blobs[i])
            if res["frame_features"] is not None:
                self._prev_features.append(res["frame_features"])
            if res["frame_memory"] is not None:
                self._prev_memory.append(res["frame_memory"])
            if res["pos_cache"] is not None:
                self._pos_cache = res["pos_cache"]

    def get_results(self, i: int):
        return self.trackers[i].get_results()


class BatchedTrackerKinematic:
    """N detection sequences through one KineT forward a step. The forward
    holds no state across frames (no image, no cached memory), so one
    stacked form serves; the same design as ``BatchedTracker``."""

    def __init__(
        self,
        model,
        postprocess,
        tracker_cfg: dict,
        *,
        num_object_queries: int,
        num_track_slots: int,
        trail_len: int,
        trail_enc_dim: int,
        n_sequences: int,
        meta_dim: int = 1,
        n_classes: int = 1,
        overflow_boxes: bool = False,
    ):
        self.trackers = [
            TrackerKinematic(model, postprocess, tracker_cfg,
                             num_object_queries=num_object_queries,
                             num_track_slots=num_track_slots,
                             trail_len=trail_len, trail_enc_dim=trail_enc_dim,
                             meta_dim=meta_dim, n_classes=n_classes,
                             overflow_boxes=overflow_boxes)
            for _ in range(n_sequences)
        ]
        self._fwd = self.trackers[0]._fwd_kine
        self.reset()

    @property
    def n_sequences(self) -> int:
        return len(self.trackers)

    def reset(self, hard: bool = True):
        for t in self.trackers:
            t.reset(hard)
        self._last_inputs: list = [None] * len(self.trackers)

    def step(self, blobs: list):
        if len(blobs) != len(self.trackers):
            raise ValueError(f"{len(blobs)} blobs for {len(self.trackers)} "
                             f"sequences")
        inputs = _stage_inputs(self.trackers, blobs, self._last_inputs)
        if inputs is None:
            return
        res = self._fwd(*self.trackers[0].make_device_inputs(_stack(inputs)))
        live = [i for i, blob in enumerate(blobs) if blob is not None]
        outs = fetch_kine_rows(res, live)
        for i in live:
            self.trackers[i]._consume(outs[i], blobs[i])

    def get_results(self, i: int):
        return self.trackers[i].get_results()


def run_batched(batched, frame_iters: list) -> None:
    """Drives a batched tracker over N frame iterators of differing
    lengths: steps while at least one has frames left; finished slots ride
    along on their last inputs."""
    alive = [True] * len(frame_iters)
    while any(alive):
        blobs = []
        for i, it in enumerate(frame_iters):
            if not alive[i]:
                blobs.append(None)
                continue
            try:
                blobs.append(next(it))
            except StopIteration:
                alive[i] = False
                blobs.append(None)
        if all(b is None for b in blobs):
            break
        batched.step(blobs)
