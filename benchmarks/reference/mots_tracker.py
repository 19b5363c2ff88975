"""Plain reference of TrackFormer's tracker state machine with masks, in
numpy: ``reference/tracker.py`` with the mask of each track.

TrackFormer's MOTS tracking (arXiv:2101.02702, upstream ``tracker.py``):
a track whose slot keeps it, a track re-identified by its slot and a new
detection take the mask probabilities [H, W] of their row; a track
re-identified by the embedding assignment keeps the mask it had; before
the frame's results are written, each pixel goes to the live track of
highest probability if that is above 0.5, else to none (upstream
``tracker.py:515-527``), so every live track's mask is boolean and the
masks are disjoint. A live track without a mask takes zeros there, and a
boolean mask enters as 0 and 1. Staging is ``reference/tracker.py``'s.

``Track`` adds the mask to ``reference/tracker.py``'s track; the frame's
results add it to each entry: {id: (bbox, score, obj_ind, mask)}.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import tracker as rt

stage = rt.stage
State = rt.State


@dataclass
class Track(rt.Track):
    mask: Optional[np.ndarray] = None


def resolve(tracks, hw):
    """Each pixel to the track of highest probability above 0.5 (the first
    such track on a tie), else to none: every track's mask boolean."""
    probs = np.stack([np.zeros(hw, np.float32) if t.mask is None
                      else t.mask.astype(np.float32) for t in tracks])
    winner = probs.argmax(axis=0)
    for i, t in enumerate(tracks):
        t.mask = (probs[i] > 0.5) & (winner == i)


def clip(boxes, hw):
    """xyxy boxes clipped to a frame of size ``hw`` (h, w)."""
    out = boxes.copy()
    out[..., 0::2] = np.clip(out[..., 0::2], 0, hw[1])
    out[..., 1::2] = np.clip(out[..., 1::2], 0, hw[0])
    return out


def consume(st: rt.State, out: dict, c: dict, n_slots: int, clip_hw=None):
    """``reference/tracker.py::consume`` with masks: ``out`` also holds
    ``mask_probs``, indexable by row ([T + Q, H, W], or {row: [H, W]} for
    the rows the state machine acts on). ``clip_hw``: the frame's size
    (h, w) to clip the rows' boxes to (the configuration's
    ``overflow_boxes`` false), or None to keep them as they are."""
    scores, labels, boxes, hs = (out["scores"], out["labels"], out["boxes"],
                                 out["hs_embed"])
    if clip_hw is not None:
        boxes = clip(boxes, clip_hw)
    probs = out["mask_probs"]
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
                t.mask = probs[i]
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
                t.mask = probs[row]
                returning.append(t)
        st.num_reids += len(returning)
        for t in returning:
            st.inactive.remove(t)
            st.tracks.append(t)
        rt._to_inactive(st, ending)
        if c["track_nms_thresh"] and st.tracks:
            kept = set(rt.nms(np.stack([t.pos for t in st.tracks]),
                              np.array([t.score for t in st.tracks]),
                              c["track_nms_thresh"]).tolist())
            st.tracks = [t for i, t in enumerate(st.tracks) if i in kept]

    new = (scores[n_slots:] > c["detection_obj_score_thresh"]) & \
        (labels[n_slots:] == 0)
    inds = np.nonzero(new)[0]
    nb, ns, nh = boxes[n_slots:][new], scores[n_slots:][new], hs[n_slots:][new]
    keep = rt._reid(st, nb, ns, nh, c)
    nb, ns, nh, inds = nb[keep], ns[keep], nh[keep], inds[keep]
    new_ids = []
    for i in range(len(nb)):
        st.tracks.append(Track(st.track_num + i, np.asarray(nb[i]),
                               float(ns[i]), np.asarray(nh[i]), int(inds[i]),
                               mask=probs[n_slots + int(inds[i])]))
        new_ids.append(st.track_num + i)
    st.track_num += len(new_ids)
    if c["detection_nms_thresh"] and st.tracks:
        sc = np.array([t.score for t in st.tracks])
        born = np.array([t.id in new_ids for t in st.tracks])
        kept = set(rt.nms(np.stack([t.pos for t in st.tracks]),
                          np.where(~born, np.inf, sc),
                          c["detection_nms_thresh"]).tolist())
        st.tracks = [t for i, t in enumerate(st.tracks) if i in kept]
    hw = next((t.mask.shape for t in st.tracks if t.mask is not None), None)
    if hw is not None:
        resolve(st.tracks, hw)
    st.frame_results = {t.id: (np.asarray(t.pos, np.float32), float(t.score),
                               int(t.obj_ind), t.mask) for t in st.tracks}
    for t in st.inactive:
        t.count_inactive += 1
    st.frame_index += 1
