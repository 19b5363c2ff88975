"""The seeded camera streams: one general generator that every traffic
file (``traffic/<name>.json``) parameterises.

Each stream is a fixed noisy background with bright boxes moving at
constant speeds, clipped to the frame, normalized as the program's loaders
normalize a frame (zero mean, unit scale) and laid out as the tracker
takes a decoded frame: ``{"images": [1, H, W, 3] float32, "pad_mask":
[1, H, W] bool, "orig_size": (H, W), "dets": [0, 4]}``. The frames of a
stream are made once, before the window, as a cycle of ``cycle_frames``
frames that the loop plays forward and then back, so the boxes move
continuously for as long as a run lasts.

Parameters (with the traffic file's keys): ``streams``; ``height``,
``width`` (a frame as the program serves it, padded as it pads: the pad
mask marks ``pad_bottom`` rows and ``pad_right`` columns); ``cycle_frames``;
``boxes`` a stream; ``box_height`` and ``box_width`` ranges as shares of
the frame; ``max_speed`` in shares of the frame a frame;
``background_std``; ``box_gain``. ``live_tracks`` (the tracks a stream
starts with on its first frame and holds), ``births_per_frame`` (new
tracks a frame and stream after it) and ``settle_steps`` are read by the
loop, which sets the score thresholds to them in set-up.

The same seed gives the same frames (numpy's ``SeedSequence`` of the seed
and the stream); every seed gives the same sizes and counts.
"""
from __future__ import annotations

import numpy as np


def stream_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream]))


def box_paths(rng, t: dict, n_frames: int):
    """Per frame, each box's (y0, x0, height, width) in pixels."""
    h, w = t["height"], t["width"]
    n = t["boxes"]
    bh = rng.uniform(*t["box_height"], size=n) * h
    bw = rng.uniform(*t["box_width"], size=n) * w
    y = rng.uniform(0, h - bh)
    x = rng.uniform(0, w - bw)
    vy, vx = rng.uniform(-1, 1, size=(2, n)) * t["max_speed"] * \
        np.array([[h], [w]])
    out = []
    for f in range(n_frames):
        out.append([(int(np.clip(y[i] + vy[i] * f, 0, h - bh[i])),
                     int(np.clip(x[i] + vx[i] * f, 0, w - bw[i])),
                     int(bh[i]), int(bw[i])) for i in range(n)])
    return out


def stream_frames(t: dict, seed: int, stream: int) -> list:
    """The cycle of frame blobs of one stream."""
    rng = stream_rng(seed, stream)
    h, w = t["height"], t["width"]
    background = rng.standard_normal((h, w, 3), dtype=np.float32)
    background *= np.float32(t["background_std"])
    pad = np.zeros((1, h, w), bool)
    if t.get("pad_bottom", 0):
        pad[:, h - t["pad_bottom"]:] = True
    if t.get("pad_right", 0):
        pad[:, :, w - t["pad_right"]:] = True
    frames = []
    for boxes in box_paths(rng, t, t["cycle_frames"]):
        img = background.copy()
        for y0, x0, bh, bw in boxes:
            img[y0:y0 + bh, x0:x0 + bw] += np.float32(t["box_gain"])
        img[pad[0]] = 0.0
        frames.append({"images": img[None], "pad_mask": pad,
                       "orig_size": (h, w),
                       "dets": np.zeros((0, 4), np.float32)})
    return frames


def make_streams(t: dict, seed: int) -> list:
    """Each stream's cycle of frames."""
    return [stream_frames(t, seed, s) for s in range(t["streams"])]


def frame_index(step: int, cycle: int) -> int:
    """The frame a stream takes at global step ``step``: 0, 1, .., n-1,
    n-2, .., 1, 0, 1, ...: forward, then back."""
    if cycle == 1:
        return 0
    period = 2 * (cycle - 1)
    k = step % period
    return k if k < cycle else period - k
