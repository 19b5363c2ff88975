"""Plain reference of TrackFormer's online tracker state machine, in numpy.

One frame of a stream is two stages around the forward (TrackFormer's
``Tracker.step``, arXiv:2101.02702 section 3.3): ``stage`` ages the
inactive tracks and pads the live and inactive tracks into the fixed
track-query slots; ``consume`` takes the forward's rows and keeps, ends,
re-identifies and births tracks (score thresholds, NMS, re-identification
by the Hungarian assignment over embedding distances) and writes the
frame's results. The options are those of the served tracker
configuration: no public detections, no masks, no attention maps.

State is plain data (``State``, ``Track``) so that a tracker's state can be
taken, compared and stepped here without the program.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.optimize import linear_sum_assignment


@dataclass
class Track:
    id: int
    pos: np.ndarray  # xyxy px
    score: float
    hs_embed: np.ndarray
    obj_ind: int
    count_inactive: int = 0
    count_termination: int = 0
    last_pos: list = field(default_factory=list)

    def has_positive_area(self):
        return bool(self.pos[2] > self.pos[0] and self.pos[3] > self.pos[1])


@dataclass
class State:
    tracks: list
    inactive: list
    track_num: int
    frame_index: int
    num_reids: int
    num_prev: int = 0
    frame_results: dict = field(default_factory=dict)  # {id: (bbox, score, obj_ind)}


def cxcywh(b):
    return np.stack([(b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2,
                     b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]], -1)


def nms(boxes, scores, thresh):
    """Greedy NMS over xyxy boxes: kept indices by descending score; an IoU
    strictly above ``thresh`` suppresses."""
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    b = boxes.astype(np.float64)
    x0 = np.maximum(b[:, None, 0], b[None, :, 0])
    y0 = np.maximum(b[:, None, 1], b[None, :, 1])
    x1 = np.minimum(b[:, None, 2], b[None, :, 2])
    y1 = np.minimum(b[:, None, 3], b[None, :, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iou = inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-9)
    suppressed = np.zeros(len(b), bool)
    keep = []
    for i in np.argsort(-scores, kind="stable"):
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > thresh
        suppressed[i] = False
    return np.asarray(keep, np.int64)


def stage(st: State, orig_size, n_slots, hidden, patience):
    """Ages the inactive tracks and pads the track-query slots: returns the
    slots {tq_embeds [1, T, D], tq_boxes [1, T, 4] (cxcywh / size),
    tq_mask [1, T]} and updates ``st``."""
    st.inactive = [t for t in st.inactive
                   if t.has_positive_area() and t.count_inactive <= patience]
    for t in st.tracks:
        t.last_pos.append(t.pos.copy())
    h0, w0 = orig_size
    slots = (st.tracks + st.inactive)[:n_slots]
    st.num_prev = len(slots)
    embeds = np.zeros((1, n_slots, hidden), np.float32)
    boxes = np.full((1, n_slots, 4), 0.5, np.float32)
    mask = np.zeros((1, n_slots), bool)
    if slots:
        boxes[0, :len(slots)] = cxcywh(np.stack([t.pos for t in slots])) / \
            np.array([w0, h0, w0, h0], np.float32)
        embeds[0, :len(slots)] = np.stack([t.hs_embed for t in slots])
        mask[0, :len(slots)] = True
    return dict(tq_embeds=embeds, tq_boxes=boxes, tq_mask=mask)


def _to_inactive(st, tracks):
    st.tracks = [t for t in st.tracks if t not in tracks]
    for t in tracks:
        t.last_pos.append(t.last_pos[-1] if t.last_pos else t.pos.copy())
    st.inactive += tracks


def _reid(st, boxes, scores, hs, c):
    st.inactive = [t for t in st.inactive if t.has_positive_area()
                   and t.count_inactive <= c["inactive_patience"]]
    keep = np.ones(len(boxes), bool)
    if not st.inactive or len(boxes) == 0:
        return keep
    dist = np.linalg.norm(np.stack([t.hs_embed for t in st.inactive])[:, None]
                          - hs[None], axis=-1)
    rows, cols = linear_sum_assignment(dist)
    found = []
    for r, j in zip(rows, cols):
        if dist[r, j] <= c["reid_sim_threshold"]:
            t = st.inactive[r]
            t.count_inactive = 0
            t.pos = np.asarray(boxes[j])
            t.score = float(scores[j])
            t.hs_embed = np.asarray(hs[j])
            t.last_pos = [t.pos.copy()]
            keep[j] = False
            found.append(t)
            st.tracks.append(t)
            st.num_reids += 1
    for t in found:
        st.inactive.remove(t)
    return keep


def consume(st: State, out: dict, c: dict, n_slots: int):
    """The state machine over one frame's rows ``out`` {scores, labels,
    boxes (xyxy px), hs_embed} [T + Q, ...]; ``c``: the tracker
    configuration (thresholds, patience, steps to end a track)."""
    scores, labels, boxes, hs = (out["scores"], out["labels"], out["boxes"],
                                 out["hs_embed"])
    n_prev = st.num_prev
    if n_prev:
        keep = (scores[:n_slots] > c["track_obj_score_thresh"]) & \
            (labels[:n_slots] == 0)
        ending, returning = [], []
        for i, t in enumerate(st.tracks[:n_prev]):
            if keep[i]:
                t.score = float(scores[i])
                t.hs_embed = hs[i]
                t.pos = boxes[i]
                t.count_termination = 0
            else:
                t.count_termination += 1
                if t.count_termination >= c["steps_termination"]:
                    ending.append(t)
        keep_reid = (scores[:n_slots] > c["reid_score_thresh"]) & \
            (labels[:n_slots] == 0)
        for i, t in enumerate(st.inactive):
            row = len(st.tracks) + i
            if row >= n_prev:
                break
            if keep_reid[row]:
                t.score = float(scores[row])
                t.hs_embed = hs[row]
                t.pos = boxes[row]
                returning.append(t)
        st.num_reids += len(returning)
        for t in returning:
            st.inactive.remove(t)
            st.tracks.append(t)
        _to_inactive(st, ending)
        if c["track_nms_thresh"] and st.tracks:
            kept = set(nms(np.stack([t.pos for t in st.tracks]),
                           np.array([t.score for t in st.tracks]),
                           c["track_nms_thresh"]).tolist())
            st.tracks = [t for i, t in enumerate(st.tracks) if i in kept]

    new = (scores[n_slots:] > c["detection_obj_score_thresh"]) & \
        (labels[n_slots:] == 0)
    inds = np.nonzero(new)[0]
    nb, ns, nh = boxes[n_slots:][new], scores[n_slots:][new], hs[n_slots:][new]
    keep = _reid(st, nb, ns, nh, c)
    nb, ns, nh, inds = nb[keep], ns[keep], nh[keep], inds[keep]
    new_ids = []
    for i in range(len(nb)):
        st.tracks.append(Track(st.track_num + i, np.asarray(nb[i]),
                               float(ns[i]), np.asarray(nh[i]), int(inds[i])))
        new_ids.append(st.track_num + i)
    st.track_num += len(new_ids)
    if c["detection_nms_thresh"] and st.tracks:
        sc = np.array([t.score for t in st.tracks])
        born = np.array([t.id in new_ids for t in st.tracks])
        kept = set(nms(np.stack([t.pos for t in st.tracks]),
                       np.where(~born, np.inf, sc),
                       c["detection_nms_thresh"]).tolist())
        st.tracks = [t for i, t in enumerate(st.tracks) if i in kept]
    st.frame_results = {t.id: (np.asarray(t.pos, np.float32), float(t.score),
                               int(t.obj_ind)) for t in st.tracks}
    for t in st.inactive:
        t.count_inactive += 1
    st.frame_index += 1
