"""Kinematic online tracker (port of ``kinet_tpu/tracking/kine_tracker.py``;
reference: src/trackformer/models/tracker.py:580-1053, TrackerKinematic and
TrackKinematic).

Image-free tracking: per frame the model reads the external detections
(``KineBatch``) and, as track queries, the trails of the live and inactive
tracks. A track's state is a trail of normalized cxcywh positions and a
trail of metadata (confidence) rows; a new track starts from a
pseudo-trail, its detection repeated. No embedding reid, masks or
attention maps.

Kept from the JAX package:
- one ``repeat_last_state`` for tracks moved to inactive (the reference's
  ``repeat_last_pos`` / ``repeat_last_state`` naming drift fixed);
- a track revived by its own row keeps its ``count_inactive``;
- spawn rows: the encoder-only model has one row per input detection (only
  the blob's real detections are spawn candidates), the query models one
  row per object query;
- ``snap_to_detections`` reports the best-IoU public detection's box.

One forward a frame; its four row outputs come back in one
device-to-host copy.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.detr import KinematicDetectorEncoder
from ..ops.nms import iou_matrix_np, nms_numpy
from ..structs import KineBatch, Targets
from .kine_augment import kine_track_embed_dims, sine_encode_trail
from .tracker import Tracker, clip_boxes_np


def pseudo_trail(rel_box: np.ndarray, n_frames: int) -> np.ndarray:
    """A relative box repeated over the trail."""
    return np.tile(rel_box[None], (n_frames, 1)).astype(np.float32)


@dataclass
class TrackKinematic:
    id: int
    pos: np.ndarray  # xyxy absolute
    pos_rel: np.ndarray  # cxcywh normalized
    score: float
    obj_ind: int
    trail: deque = field(default_factory=deque)  # of pos_rel
    meta_trail: deque = field(default_factory=deque)  # of metadata rows
    count_inactive: int = 0
    count_termination: int = 0

    def has_positive_area(self):
        return bool(self.pos[2] > self.pos[0] and self.pos[3] > self.pos[1])

    def update_state(self, pos, pos_rel, score, metadata):
        self.pos = pos
        self.pos_rel = pos_rel
        self.score = float(score)
        self.trail.append(np.asarray(pos_rel))
        self.meta_trail.append(np.asarray(metadata))

    def repeat_last_state(self):
        if self.trail:
            self.trail.append(self.trail[-1])
            self.meta_trail.append(self.meta_trail[-1])

    def get_trail(self, n_frames: int):
        """The last n positions and metadata rows, padded at the front with
        the oldest."""
        trail = list(self.trail)[-n_frames:]
        meta = list(self.meta_trail)[-n_frames:]
        while len(trail) < n_frames:
            trail.insert(0, trail[0] if trail else self.pos_rel)
            meta.insert(0, meta[0] if meta else np.zeros_like(meta[0]))
        return np.stack(trail), np.stack(meta)


def make_kine_forward_fn(model, postprocess):
    """Per-frame forward fn(kb, targets, orig_size) -> [B, rows, 10]:
    score, label, absolute xyxy box and relative cxcywh box of every
    output row, concatenated for one device-to-host copy."""

    @torch.inference_mode()
    def fwd(kb, targets, orig_size):
        out = model(kb, targets)
        res = postprocess(out, orig_size)
        return torch.cat([
            res["scores"][..., None].float(), res["labels"][..., None].float(),
            res["boxes"].float(), out["pred_boxes"].float(),
        ], dim=-1)

    return fwd


def fetch_kine_rows(res: torch.Tensor, rows) -> dict:
    """{i: the kinematic state machine's inputs from batch row i} for each
    i of ``rows``, from the forward's [B, rows, 10] output, in one
    device-to-host copy."""
    table = res.cpu().numpy()
    return {i: {"scores": table[i, :, 0],
                "labels": table[i, :, 1].astype(np.int64),
                "boxes": table[i, :, 2:6], "rel_boxes": table[i, :, 6:10]}
            for i in rows}


class TrackerKinematic(Tracker):
    def __init__(
        self,
        model,
        postprocess,
        tracker_cfg: dict,
        num_object_queries: int,
        num_track_slots: int,
        trail_len: int,
        trail_enc_dim: int,
        meta_dim: int = 1,
        n_classes: int = 1,
        overflow_boxes: bool = False,
    ):
        super().__init__(
            model, postprocess, tracker_cfg, num_object_queries,
            num_track_slots,
            hidden_dim=sum(kine_track_embed_dims(trail_len, trail_enc_dim,
                                                 meta_dim)),
            overflow_boxes=overflow_boxes,
        )
        self.trail_len = trail_len
        self.trail_enc_dim = trail_enc_dim
        self.meta_dim = meta_dim
        self.n_classes = n_classes
        self.snap_to_detections = bool(
            tracker_cfg.get("snap_to_detections", False))
        # the encoder-only model outputs one row per input detection after
        # the track slots; the query models num_object_queries query rows,
        # every one a spawn candidate
        self.rows_per_detection = isinstance(model, KinematicDetectorEncoder)
        self._fwd_kine = make_kine_forward_fn(model, postprocess)

    def _encode_trails(self, tracks):
        embeds = np.zeros((1, self.num_track_slots, self.hidden_dim),
                          np.float32)
        mask = np.zeros((1, self.num_track_slots), bool)
        n = min(len(tracks), self.num_track_slots)
        if n:
            got = [t.get_trail(self.trail_len) for t in tracks[:n]]
            flat = np.stack([g[0] for g in got]).reshape(n, self.trail_len * 4)
            metas = np.stack([g[1] for g in got])
            if self.trail_enc_dim:
                enc = sine_encode_trail(torch.from_numpy(flat),
                                        self.trail_enc_dim).numpy()
            else:  # raw trails (use_encoding_tracklets: false)
                enc = flat.astype(np.float32)
            embeds[0, :n] = np.concatenate(
                [enc, metas[:, :, : self.meta_dim].reshape(n, -1)], axis=-1)
            mask[0, :n] = True
        return embeds, mask, n

    def _build_inputs(self, blob: dict) -> dict:
        """Phase 1 of step(): age inactive tracks, stage the padded
        detections and the trail-encoded track queries as host [1, ...]
        arrays."""
        self.inactive_tracks = [
            t for t in self.inactive_tracks
            if t.has_positive_area() and t.count_inactive <= self.inactive_patience
        ]
        h0, w0 = blob["orig_size"]
        all_tracks = (self.tracks + self.inactive_tracks)[: self.num_track_slots]
        embeds, mask, self._num_prev = self._encode_trails(all_tracks)

        max_det = blob.get("max_detections", 60)
        k = min(len(blob["detections"]), max_det)
        dets = np.zeros((1, max_det, 4), np.float32)
        meta = np.zeros((1, max_det, self.meta_dim), np.float32)
        det_pad = np.ones((1, max_det), bool)
        self._num_dets = k
        if k:
            dets[0, :k] = blob["detections"][:k, :4]
            meta[0, :k] = np.asarray(blob["metadata"])[:k, : self.meta_dim]
            det_pad[0, :k] = False
        return {
            "detections": dets, "metadata": meta, "det_pad": det_pad,
            "tq_embeds": embeds, "tq_mask": mask,
            "orig_size": np.asarray([[float(h0), float(w0)]], np.float32),
        }

    def make_device_inputs(self, inputs: dict):
        """Host [B, ...] arrays -> (KineBatch, Targets, orig_size)."""
        dev = self.device
        b, t_slots, hidden = inputs["tq_embeds"].shape

        def put(a):
            return torch.from_numpy(a).to(dev)

        kb = KineBatch(put(inputs["detections"]), put(inputs["metadata"]),
                       put(inputs["det_pad"]))
        targets = Targets.create(
            torch.zeros(b, 1, 4, device=dev),
            torch.zeros(b, 1, dtype=torch.int64, device=dev),
            torch.zeros(b, 1, dtype=torch.bool, device=dev),
            num_track_queries=t_slots, hidden_dim=hidden,
        ).replace(track_query_embeds=put(inputs["tq_embeds"]),
                  track_query_mask=put(inputs["tq_mask"]))
        return kb, targets, put(inputs["orig_size"])

    def step(self, blob: dict):
        """blob: detections [K, 4] cxcywh normalized, metadata [K, M],
        orig_size (h, w), max_detections, dets [K, 4] xyxy absolute."""
        inputs = self._build_inputs(blob)
        res = self._fwd_kine(*self.make_device_inputs(inputs))
        self._consume(fetch_kine_rows(res, [0])[0], blob)

    def _num_spawn_rows(self) -> int:
        return self._num_dets if self.rows_per_detection else self.num_object_queries

    def _snap(self, boxes_abs, rel, blob, h0, w0):
        """Each kept row's box -> its best-IoU public detection's (>= 0.3):
        track rows greedily one to one in descending IoU, spawn rows each
        on its own."""
        dets_rel = np.asarray(blob["detections"], np.float32)
        if not len(dets_rel):
            return boxes_abs, rel
        scale = np.array([w0, h0, w0, h0], np.float32)
        half = dets_rel[:, 2:] / 2
        dets_xyxy = np.concatenate(
            [dets_rel[:, :2] - half, dets_rel[:, :2] + half], 1) * scale
        boxes_abs, rel = np.array(boxes_abs), np.array(rel)
        num_prev, t_slots = self._num_prev, self.num_track_slots
        iou = iou_matrix_np(boxes_abs[:num_prev], dets_xyxy)
        order = np.argsort(iou.max(axis=1))[::-1]
        claimed = np.zeros(len(dets_xyxy), bool)
        for r in order:
            k_best = int(np.argmax(np.where(claimed, -1.0, iou[r])))
            if claimed[k_best] or iou[r, k_best] < 0.3:
                continue
            claimed[k_best] = True
            boxes_abs[r] = dets_xyxy[k_best]
            rel[r] = dets_rel[k_best]
        lo, hi = t_slots, t_slots + self._num_spawn_rows()
        if hi > lo:
            iou_d = iou_matrix_np(boxes_abs[lo:hi], dets_xyxy)
            best = iou_d.argmax(axis=1)
            ok = iou_d[np.arange(hi - lo), best] >= 0.3
            boxes_abs[lo:hi] = np.where(ok[:, None], dets_xyxy[best],
                                        boxes_abs[lo:hi])
            rel[lo:hi] = np.where(ok[:, None], dets_rel[best], rel[lo:hi])
        return boxes_abs, rel

    def _consume(self, out: dict, blob: dict):
        """Phase 2 of step(): the kinematic host state machine."""
        h0, w0 = blob["orig_size"]
        t_slots = self.num_track_slots
        num_prev = self._num_prev
        scores, labels = out["scores"], out["labels"]
        boxes_abs, rel = out["boxes"], out["rel_boxes"]
        if not self.overflow_boxes:
            boxes_abs = clip_boxes_np(boxes_abs, (h0, w0))
            rel = rel.clip(0.0, 1.0)
        if self.snap_to_detections:
            boxes_abs, rel = self._snap(boxes_abs, rel, blob, h0, w0)

        # ----- track rows -----
        if num_prev:
            tr_scores, tr_labels = scores[:t_slots], labels[:t_slots]
            tr_boxes, tr_rel = boxes_abs[:t_slots], rel[:t_slots]

            def meta_row(i):
                return np.array([tr_scores[i], tr_labels[i]])[: self.meta_dim]

            keep = (tr_scores > self.track_obj_score_thresh) & (
                tr_labels < self.n_classes)
            to_inactive, from_inactive = [], []
            for i, tr in enumerate(self.tracks):
                if i >= num_prev:
                    break
                if keep[i]:
                    tr.update_state(tr_boxes[i], tr_rel[i], tr_scores[i],
                                    meta_row(i))
                    tr.count_termination = 0
                else:
                    tr.count_termination += 1
                    if tr.count_termination >= self.steps_termination:
                        to_inactive.append(tr)
            keep_reid = (tr_scores > self.reid_score_thresh) & (
                tr_labels < self.n_classes)
            for i, tr in enumerate(self.inactive_tracks):
                row = len(self.tracks) + i
                if row >= num_prev:
                    break
                if keep_reid[row]:
                    # count_inactive is kept, as the reference's track-row
                    # revival keeps it
                    tr.update_state(tr_boxes[row], tr_rel[row],
                                    tr_scores[row], meta_row(row))
                    from_inactive.append(tr)
            self.num_reids += len(from_inactive)
            for tr in from_inactive:
                self.inactive_tracks.remove(tr)
                self.tracks.append(tr)
            self.tracks = [t for t in self.tracks if t not in to_inactive]
            for t in to_inactive:
                t.repeat_last_state()
            self.inactive_tracks += to_inactive

            if self.track_nms_thresh and self.tracks:
                tb = np.stack([t.pos for t in self.tracks])
                ts = np.array([t.score for t in self.tracks])
                keep_idx = set(nms_numpy(tb, ts, self.track_nms_thresh).tolist())
                self.tracks = [t for i, t in enumerate(self.tracks)
                               if i in keep_idx]

        # ----- new detections (the spawn rows after the track slots) -----
        hi = t_slots + self._num_spawn_rows()
        nd_scores, nd_labels = scores[t_slots:hi], labels[t_slots:hi]
        nd_boxes, nd_rel = boxes_abs[t_slots:hi], rel[t_slots:hi]
        keep = (nd_scores > self.detection_obj_score_thresh) & (
            nd_labels < self.n_classes)
        nd_inds = np.nonzero(keep)[0]
        nd_boxes, nd_scores, nd_rel, nd_labels = (
            nd_boxes[keep], nd_scores[keep], nd_rel[keep], nd_labels[keep])
        pmask = self.public_detections_mask(
            nd_boxes, np.asarray(blob.get("dets", np.zeros((0, 4)))))
        nd_boxes, nd_scores, nd_rel, nd_labels, nd_inds = (
            nd_boxes[pmask], nd_scores[pmask], nd_rel[pmask],
            nd_labels[pmask], nd_inds[pmask])

        new_ids = []
        for i in range(len(nd_boxes)):
            tr = TrackKinematic(
                id=self.track_num + i, pos=nd_boxes[i], pos_rel=nd_rel[i],
                score=float(nd_scores[i]), obj_ind=int(nd_inds[i]),
            )
            meta = np.array([nd_scores[i],
                             nd_labels[i] / max(self.n_classes, 1)])[: self.meta_dim]
            for p in pseudo_trail(nd_rel[i], self.trail_len):
                tr.trail.append(p)
                tr.meta_trail.append(meta)
            self.tracks.append(tr)
            new_ids.append(tr.id)
        self.track_num += len(new_ids)

        if self.detection_nms_thresh and self.tracks:
            tb = np.stack([t.pos for t in self.tracks])
            ts = np.array([t.score for t in self.tracks])
            new_mask = np.array([t.id in new_ids for t in self.tracks])
            ts = np.where(~new_mask, np.inf, ts)
            keep_idx = set(nms_numpy(tb, ts, self.detection_nms_thresh).tolist())
            self.tracks = [t for i, t in enumerate(self.tracks) if i in keep_idx]

        for t in self.tracks:
            self.results.setdefault(t.id, {})
            bbox = t.pos if self.overflow_boxes else clip_boxes_np(t.pos, (h0, w0))
            self.results[t.id][self.frame_index] = {
                "bbox": np.asarray(bbox, np.float32),
                "score": float(t.score),
                "obj_ind": int(t.obj_ind),
            }
        for t in self.inactive_tracks:
            t.count_inactive += 1
        self.frame_index += 1
