"""Online tracker, the frame-by-frame state machine (port of
``kinet_tpu/tracking/tracker.py``).

Split of responsibilities, as in the JAX package:
- the device work per frame is one forward with the track-query slots
  padded to a fixed count, its inputs copied through reusable host buffers
  (``staging.py``); its four row outputs come back to the host in
  one device-to-host copy (with masks, the mask probabilities after it, in
  copies into page-locked memory with a synchronization of their own),
- everything over O(#tracks) state (keep/terminate hysteresis, reid, NMS,
  public-detection filtering, result writing) is host-side numpy/scipy.

The forward drives ``DeformableDETR`` (its encoder cache included) and
vanilla ``DETR``. With ``generate_attention_maps`` (vanilla DETR) each
query's map [Hf, Wf] is the head mean of the last decoder layer's
cross-attention weights; a track keeps its row's map and the results carry
it (``attention_map``).

With a ``SegmWrapper`` model (MOTS) each query's mask logits are resized
bilinearly to the padded input size, THEN sigmoided (``mask_probs``
[Q, H, W], every row fetched); a track keeps its row's probabilities, and
before the results are written each pixel goes to the track of highest
probability if that is above 0.5 (the per-pixel overlap resolution), so
the results' boolean ``mask``s [H, W] are disjoint.

With ``spatial_group`` (a process group of N > 1 processes, each running
this tracker on the same frames) each frame's forward is spatially
parallel (``parallel/sp.py``): its rows are split over the group, and the
outputs come back replicated on every process, so every process runs the
same host state machine on the same rows.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from ..ops.nms import nms_numpy
from ..parallel.sp import spatial_parallel
from ..structs import ImageBatch, Targets
from ..utils import trace
from .staging import FrameStager


def dense(a, dtype) -> np.ndarray:
    """``a`` as a C-ordered array with the strides of a fresh one, a view
    where ``a`` is C-contiguous already. A frame's leading axis added by
    indexing has stride 0, and the CPU convolutions take another path over
    such an array than over a batch row of the same values, which changes
    the last bits: with the strides made alike, a frame stepped alone and
    the same frame in a batch reach the model alike."""
    a = np.ascontiguousarray(a, dtype)
    return a.reshape(-1).reshape(a.shape)


def box_xyxy_to_cxcywh_np(b):
    x0, y0, x1, y1 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], axis=-1
    )


def clip_boxes_np(b, size_hw):
    h, w = size_hw
    out = b.copy()
    out[..., 0::2] = np.clip(out[..., 0::2], 0, w)
    out[..., 1::2] = np.clip(out[..., 1::2], 0, h)
    return out


RESOLVE_BAND_BYTES = 1 << 17  # a track's float32 probabilities a band


def _resolve_band(masks, out, lo, hi):
    """Rows ``lo:hi`` of ``Tracker._resolve_masks``: the pixels' highest
    probability, then each pixel to the first track that has it (argmax's
    tie rule) where it is above 0.5, written into ``out``'s boolean masks
    (numpy's argmax over the tracks' axis is several times slower)."""
    best = np.array(masks[0][lo:hi], np.float32)
    for m in masks[1:]:
        np.maximum(best, m[lo:hi], out=best)
    free = best > 0.5
    for m, o in zip(masks, out):
        mine = np.equal(m[lo:hi], best, out=o[lo:hi])
        mine &= free
        np.greater(free, mine, out=free)  # free and not mine


@dataclass
class Track:
    """Per-track state."""

    id: int
    pos: np.ndarray  # xyxy absolute
    score: float
    hs_embed: np.ndarray  # last embedding [D]
    obj_ind: int
    count_inactive: int = 0
    count_termination: int = 0
    mask: Optional[np.ndarray] = None
    attention_map: Optional[np.ndarray] = None
    last_pos: list = field(default_factory=list)

    def has_positive_area(self) -> bool:
        return bool(self.pos[2] > self.pos[0] and self.pos[3] > self.pos[1])

    def repeat_last_pos(self):
        if self.last_pos:
            self.last_pos.append(self.last_pos[-1])
        else:
            self.last_pos.append(self.pos.copy())

    def reset_last_pos(self):
        self.last_pos = [self.pos.copy()]


def make_forward_fn(model, postprocess, attention_maps=False,
                    spatial_group=None):
    """Per-frame forward with padded track-query slots:
    fn(batch, targets, orig_size, prev_features, prev_memory, pos_cache);
    with ``spatial_group`` the spatially parallel forward over that group
    (``parallel/sp.py``), its outputs replicated.
    With ``attention_maps`` (vanilla DETR) it also returns the per-query
    maps [B, Q, Hf, Wf]: the head mean of the last decoder layer's
    cross-attention weights. A model with a mask head also gives
    ``mask_probs`` [B, Q, H, W] (float32) at the padded input size: the
    logits resized bilinearly, then sigmoided (reference
    detr_segmentation.py:219-253; the other order is not the same)."""
    caches_memory = bool(getattr(model, "cache_prev_encoder", False))

    @torch.inference_mode()
    def fwd(batch, targets, orig_size, prev_features, prev_memory, pos_cache):
        with trace.span("forward"):
            kwargs = {"prev_features": prev_features}
            if spatial_group is not None:
                kwargs["spatial"] = spatial_parallel(
                    model, spatial_group, batch.images.shape[1])
            if attention_maps:
                kwargs["attention_maps"] = True
            if caches_memory:
                kwargs.update(prev_memory=prev_memory, pos_cache=pos_cache)
            out = model(batch, targets, **kwargs)
            with trace.span("postprocess"):
                res = postprocess(out, orig_size)
            maps = None
            if attention_maps:
                attn = out["attention_weights"]  # [B, H, Q, Hf * Wf]
                hf, wf = out["memory"].shape[1:3]
                maps = attn.mean(1).reshape(attn.shape[0], attn.shape[2], hf, wf)
            mask_probs = None
            if "pred_masks" in out:
                with trace.span("mask_upsample"):
                    mask_probs = F.interpolate(
                        out["pred_masks"].float(),
                        size=batch.images.shape[1:3], mode="bilinear",
                        align_corners=False).sigmoid_()
            return {
                "attention_maps": maps,
                "mask_probs": mask_probs,
                "scores": res["scores"],
                "labels": res["labels"],
                "boxes": res["boxes"],
                "hs_embed": out["hs_embed"],
                # with memory caching the raw backbone features are not needed
                # across frames, only the encoded memory
                "frame_features": (
                    None if caches_memory else out.get("frame_features")
                ),
                "frame_memory": out.get("frame_memory"),
                "pos_cache": out.get("pos_cache"),
            }

    return fwd


def fetch_mask_probs(probs, rows) -> dict:
    """{i: batch row i's mask probabilities [Q, H, W]} for each i of
    ``rows``, copied into page-locked host memory (pageable for a CPU
    tensor) and then waited for: the tracer's span ``mask_fetch`` holds
    the copies alone, and ``mask_d2h_bytes`` counts their bytes."""
    with trace.span("mask_fetch"):
        out = {}
        for i in rows:
            out[i] = torch.empty(probs.shape[1:], dtype=probs.dtype,
                                 pin_memory=probs.is_cuda)
            out[i].copy_(probs[i], non_blocking=probs.is_cuda)
        if probs.is_cuda:
            torch.cuda.current_stream(probs.device).synchronize()
    trace.count("mask_d2h_bytes",
                len(rows) * probs.shape[1:].numel() * probs.element_size())
    return out


def fetch_rows(res: dict, rows) -> dict:
    """{i: the state machine's inputs from batch row i} for each i of
    ``rows``, as numpy, from one forward's outputs ``res``. ONE blocking
    device-to-host copy brings every row's scores, labels, boxes and
    embeddings (and attention maps), and with it the wait for the forward;
    with masks, the probabilities of each of ``rows`` (hundreds of MB a
    frame) follow (``fetch_mask_probs``). ``Tracker.step`` fetches its one
    row, ``BatchedTracker.step`` the rows of its live sequences."""
    with trace.span("fetch"):
        probs = res["mask_probs"]
        parts = [
            res["scores"][..., None].float(),
            res["labels"][..., None].float(),
            res["boxes"].float(),
            res["hs_embed"].float(),
        ]
        maps = res["attention_maps"]
        if maps is not None:
            parts.append(maps.flatten(2).float())
        table = torch.cat(parts, dim=-1).cpu().numpy()  # [B, Q, columns]
        host_probs = {} if probs is None else fetch_mask_probs(probs, rows)
        d = res["hs_embed"].shape[-1]
        outs = {}
        for i in rows:
            r = table[i]
            out = {
                "scores": r[:, 0],
                "labels": r[:, 1].astype(np.int64),
                "boxes": r[:, 2:6],
                "hs_embed": r[:, 6:6 + d],
            }
            if maps is not None:
                out["attention_maps"] = r[:, 6 + d:].reshape(r.shape[0],
                                                             *maps.shape[2:])
            if i in host_probs:
                out["mask_probs"] = host_probs[i].numpy()
            outs[i] = out
        return outs


class Tracker:
    def __init__(
        self,
        model,
        postprocess,
        tracker_cfg: dict,
        num_object_queries: int,
        num_track_slots: int,
        hidden_dim: int,
        overflow_boxes: bool = False,
        generate_attention_maps: bool = False,
        spatial_group=None,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self._stager = FrameStager(self.device)
        self._fwd = make_forward_fn(model, postprocess,
                                    attention_maps=generate_attention_maps,
                                    spatial_group=spatial_group)
        self.num_object_queries = num_object_queries
        self.num_track_slots = num_track_slots
        self.hidden_dim = hidden_dim
        self.overflow_boxes = overflow_boxes

        c = tracker_cfg
        self.detection_obj_score_thresh = c["detection_obj_score_thresh"]
        self.track_obj_score_thresh = c["track_obj_score_thresh"]
        self.detection_nms_thresh = c["detection_nms_thresh"]
        self.track_nms_thresh = c["track_nms_thresh"]
        self.public_detections = c.get("public_detections", False)
        self.inactive_patience = float(c.get("inactive_patience", -1))
        self.reid_sim_threshold = c.get("reid_sim_threshold", 0.0)
        self.reid_sim_only = c.get("reid_sim_only", False)
        self.reid_score_thresh = c.get("reid_score_thresh", 0.4)
        self.reid_greedy_matching = c.get("reid_greedy_matching", False)
        self.prev_frame_dist = int(c.get("prev_frame_dist", 1))
        self.steps_termination = int(c.get("steps_termination", 1))
        # the index of this tracker's stream in a batched tracker, which
        # sets it: the identifier of its spans (utils/trace.py)
        self.stream = None
        self.reset()

    def reset(self, hard: bool = True):
        self.tracks: list[Track] = []
        self.inactive_tracks: list[Track] = []
        self._prev_features = deque([None], maxlen=self.prev_frame_dist)
        self._prev_memory = deque([None], maxlen=self.prev_frame_dist)
        # sine pos embeddings are a pure function of the (per-sequence
        # fixed) pad mask: computed by the first frame, reused after
        self._pos_cache = None
        if hard:
            self.track_num = 0
            self.results = {}
            self.frame_index = 0
            self.num_reids = 0

    # ------------------------------------------------------------------
    def move_tracks_to_inactive(self, to_inactive):
        self.tracks = [t for t in self.tracks if t not in to_inactive]
        for t in to_inactive:
            t.repeat_last_pos()
        self.inactive_tracks += to_inactive

    def add_tracks(self, boxes, scores, hs_embeds, obj_inds, masks=None):
        new_ids = []
        for i in range(len(boxes)):
            self.tracks.append(
                Track(
                    id=self.track_num + i,
                    pos=np.asarray(boxes[i]),
                    score=float(scores[i]),
                    hs_embed=np.asarray(hs_embeds[i]),
                    obj_ind=int(obj_inds[i]),
                    mask=None if masks is None else masks[i],
                )
            )
            new_ids.append(self.track_num + i)
        self.track_num += len(new_ids)
        return new_ids

    def public_detections_mask(self, new_boxes, public_boxes):
        if not self.public_detections:
            return np.ones(len(new_boxes), bool)
        if len(public_boxes) == 0 or len(new_boxes) == 0:
            return np.zeros(len(new_boxes), bool)
        mask = np.zeros(len(new_boxes), bool)
        if self.public_detections == "center_distance":
            item_size = (new_boxes[:, 2] - new_boxes[:, 0]) * (
                new_boxes[:, 3] - new_boxes[:, 1]
            )
            nc = box_xyxy_to_cxcywh_np(new_boxes)[:, :2]
            pc = box_xyxy_to_cxcywh_np(public_boxes)[:, :2]
            dist = ((nc[:, None] - pc[None]) ** 2).sum(-1)
            for j in range(len(public_boxes)):
                i = int(dist[:, j].argmin())
                if dist[i, j] < item_size[i]:
                    dist[i, :] = 1e18
                    mask[i] = True
        elif self.public_detections == "min_iou_0_5":
            x0 = np.maximum(new_boxes[:, None, 0], public_boxes[None, :, 0])
            y0 = np.maximum(new_boxes[:, None, 1], public_boxes[None, :, 1])
            x1 = np.minimum(new_boxes[:, None, 2], public_boxes[None, :, 2])
            y1 = np.minimum(new_boxes[:, None, 3], public_boxes[None, :, 3])
            inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
            a1 = (new_boxes[:, 2] - new_boxes[:, 0]) * (
                new_boxes[:, 3] - new_boxes[:, 1]
            )
            a2 = (public_boxes[:, 2] - public_boxes[:, 0]) * (
                public_boxes[:, 3] - public_boxes[:, 1]
            )
            iou = inter / np.maximum(a1[:, None] + a2[None] - inter, 1e-9)
            for j in range(len(public_boxes)):
                i = int(iou[:, j].argmax())
                if iou[i, j] >= 0.5:
                    iou[i, :] = 0
                    mask[i] = True
        else:
            raise NotImplementedError(self.public_detections)
        return mask

    def reid(self, new_boxes, new_scores, new_hs, new_masks=None):
        """ReID new detections against inactive tracks."""
        self.inactive_tracks = [
            t
            for t in self.inactive_tracks
            if t.has_positive_area() and t.count_inactive <= self.inactive_patience
        ]
        if not self.inactive_tracks or len(new_boxes) == 0:
            return np.ones(len(new_boxes), bool)

        if self.reid_greedy_matching:
            nb = box_xyxy_to_cxcywh_np(new_boxes)
            ib = box_xyxy_to_cxcywh_np(
                np.stack([t.pos for t in self.inactive_tracks])
            )
            dist = ((ib[:, None, :2] - nb[None, :, :2]) ** 2).sum(-1)
            track_size = ib[:, 2] * ib[:, 3]
            item_size = nb[:, 2] * nb[:, 3]
            invalid = (dist > track_size[:, None]) | (dist > item_size[None])
            dist = dist + invalid * 1e18
            rows, cols = [], []
            for i in range(dist.shape[0]):
                j = int(dist[i].argmin())
                if dist[i, j] < 1e16:
                    dist[:, j] = 1e18
                    dist[i, j] = 0.0
                    rows.append(i)
                    cols.append(j)
            rows, cols = np.asarray(rows, int), np.asarray(cols, int)
            dist_mat = dist
        else:
            ie = np.stack([t.hs_embed for t in self.inactive_tracks])
            dist_mat = np.linalg.norm(
                ie[:, None, :] - new_hs[None, :, :], axis=-1
            )
            rows, cols = linear_sum_assignment(dist_mat)

        keep_mask = np.ones(len(new_boxes), bool)
        removed = []
        for r, cidx in zip(rows, cols):
            if dist_mat[r, cidx] <= self.reid_sim_threshold:
                t = self.inactive_tracks[r]
                t.count_inactive = 0
                t.pos = np.asarray(new_boxes[cidx])
                t.score = float(new_scores[cidx])
                t.hs_embed = np.asarray(new_hs[cidx])
                t.reset_last_pos()
                if new_masks is not None:
                    t.mask = new_masks[cidx]
                keep_mask[cidx] = False
                removed.append(t)
                self.tracks.append(t)
                self.num_reids += 1
        for t in removed:
            self.inactive_tracks.remove(t)
        return keep_mask

    # ------------------------------------------------------------------
    def _build_inputs(self, blob: dict) -> dict:
        """Phase 1 of step(): age inactive tracks and stage the padded
        track-query state as host [1, ...] numpy arrays."""
        with trace.span("stage", self.stream):
            waiting = len(self.inactive_tracks)
            self.inactive_tracks = [
                t
                for t in self.inactive_tracks
                if t.has_positive_area() and t.count_inactive <= self.inactive_patience
            ]
            trace.count("tracks_ended", waiting - len(self.inactive_tracks))
            for t in self.tracks:
                t.last_pos.append(t.pos.copy())

            h0, w0 = blob["orig_size"]
            t_slots = self.num_track_slots
            all_tracks = self.tracks + self.inactive_tracks
            num_prev = min(len(all_tracks), t_slots)
            all_tracks = all_tracks[:num_prev]
            self._num_prev = num_prev

            tq_embeds = np.zeros((1, t_slots, self.hidden_dim), np.float32)
            tq_boxes = np.full((1, t_slots, 4), 0.5, np.float32)
            tq_mask = np.zeros((1, t_slots), bool)
            if num_prev:
                boxes_c = box_xyxy_to_cxcywh_np(
                    np.stack([t.pos for t in all_tracks])
                ) / np.array([w0, h0, w0, h0], np.float32)
                tq_boxes[0, :num_prev] = boxes_c
                tq_embeds[0, :num_prev] = np.stack([t.hs_embed for t in all_tracks])
                tq_mask[0, :num_prev] = True

            return {
                "images": dense(blob["images"], np.float32),
                "pad_mask": dense(blob["pad_mask"], bool),
                "tq_embeds": tq_embeds,
                "tq_boxes": tq_boxes,
                "tq_mask": tq_mask,
                "orig_size": np.asarray([[float(h0), float(w0)]], np.float32),
            }

    def make_device_inputs(self, inputs):
        """[B, ...] inputs -> (ImageBatch, Targets, orig_size). ``inputs``:
        a dict of host numpy arrays as ``_build_inputs`` returns them, or a
        list of such dicts, the rows of one batch in order (staged through
        ``FrameStager``, the images in the model's ``image_dtype``); or a
        dict of tensors, moved to the device as they are."""
        dev = self.device
        if isinstance(inputs, dict) and torch.is_tensor(inputs["images"]):
            inputs = {k: v.to(dev) for k, v in inputs.items()}
        else:
            inputs = self._stager.stage(
                inputs if isinstance(inputs, list) else [inputs],
                self.model.image_dtype)
        b, t_slots, hidden = inputs["tq_embeds"].shape
        batch = ImageBatch(images=inputs["images"], pad_mask=inputs["pad_mask"])
        targets = Targets.create(
            torch.zeros(b, 1, 4, device=dev),
            torch.zeros(b, 1, dtype=torch.int64, device=dev),
            torch.zeros(b, 1, dtype=torch.bool, device=dev),
            num_track_queries=t_slots, hidden_dim=hidden,
        ).replace(
            track_query_embeds=inputs["tq_embeds"],
            track_query_boxes=inputs["tq_boxes"],
            track_query_mask=inputs["tq_mask"],
        )
        return batch, targets, inputs["orig_size"]

    def step(self, blob: dict):
        """blob: images [1,H,W,3] (normalized), pad_mask [1,H,W],
        orig_size (h, w), dets [K, 4] public detections (xyxy abs)."""
        with trace.span("step"):
            inputs = self._build_inputs(blob)
            with trace.span("h2d"):
                batch, targets, orig_size = self.make_device_inputs(inputs)
            res = self._fwd(
                batch, targets, orig_size,
                self._prev_features[0], self._prev_memory[0], self._pos_cache,
            )
            self._consume(fetch_rows(res, [0])[0], blob)

            if res["frame_features"] is not None:
                self._prev_features.append(res["frame_features"])
            if res["frame_memory"] is not None:
                self._prev_memory.append(res["frame_memory"])
            if res["pos_cache"] is not None:
                self._pos_cache = res["pos_cache"]

    def _consume(self, out: dict, blob: dict):
        """Phase 2 of step(): the host state machine over one frame's
        forward outputs (numpy, batch row selected). While tracing, counts
        the frame and its tracks born, re-identified, ended and live."""
        with trace.span("state_machine", self.stream):
            on = trace.enabled()
            if on:
                before = (self.track_num, self.num_reids,
                          len(self.tracks) + len(self.inactive_tracks))
            self._state_machine(out, blob)
            if on:
                born = self.track_num - before[0]
                trace.count("frames")
                trace.count("tracks_born", born)
                trace.count("tracks_reidentified", self.num_reids - before[1])
                trace.count("tracks_ended", before[2] + born - len(self.tracks)
                            - len(self.inactive_tracks))
                trace.count("tracks_live", len(self.tracks))

    def _state_machine(self, out: dict, blob: dict):
        """``_consume``'s work: keep, end and re-identify tracks, start new
        ones, write the frame's results."""
        h0, w0 = blob["orig_size"]
        t_slots = self.num_track_slots
        num_prev = self._num_prev
        scores = out["scores"]
        labels = out["labels"]
        boxes_all = out["boxes"]
        hs = out["hs_embed"]
        attn_maps = out.get("attention_maps")
        mask_probs = out.get("mask_probs")
        if not self.overflow_boxes:
            boxes_all = clip_boxes_np(boxes_all, (h0, w0))

        # ----- track rows (slots [0:num_prev]) -----
        if num_prev:
            tr_scores = scores[:t_slots]
            tr_boxes = boxes_all[:t_slots]
            tr_labels = labels[:t_slots]
            keep = (tr_scores > self.track_obj_score_thresh) & (tr_labels == 0)

            to_inactive, from_inactive = [], []
            for i, tr in enumerate(self.tracks):
                if i >= num_prev:
                    break
                if keep[i]:
                    tr.score = float(tr_scores[i])
                    tr.hs_embed = hs[i]
                    tr.pos = tr_boxes[i]
                    tr.count_termination = 0
                    if attn_maps is not None:
                        tr.attention_map = attn_maps[i]
                    if mask_probs is not None:
                        tr.mask = mask_probs[i]
                else:
                    tr.count_termination += 1
                    if tr.count_termination >= self.steps_termination:
                        to_inactive.append(tr)

            keep_reid = (tr_scores > self.reid_score_thresh) & (tr_labels == 0)
            for i, tr in enumerate(self.inactive_tracks):
                row = len(self.tracks) + i
                if row >= num_prev:
                    break
                if keep_reid[row]:
                    tr.score = float(tr_scores[row])
                    tr.hs_embed = hs[row]
                    tr.pos = tr_boxes[row]
                    if attn_maps is not None:
                        tr.attention_map = attn_maps[row]
                    if mask_probs is not None:
                        tr.mask = mask_probs[row]
                    from_inactive.append(tr)

            self.num_reids += len(from_inactive)
            for tr in from_inactive:
                self.inactive_tracks.remove(tr)
                self.tracks.append(tr)
            self.move_tracks_to_inactive(to_inactive)

            if self.track_nms_thresh and self.tracks:
                tb = np.stack([t.pos for t in self.tracks])
                ts = np.array([t.score for t in self.tracks])
                keep_idx = set(
                    nms_numpy(tb, ts, self.track_nms_thresh).tolist()
                )
                self.tracks = [
                    t for i, t in enumerate(self.tracks) if i in keep_idx
                ]

        # ----- new detections (object-query rows) -----
        nd_scores = scores[t_slots:]
        nd_boxes = boxes_all[t_slots:]
        nd_labels = labels[t_slots:]
        nd_hs = hs[t_slots:]
        keep = (nd_scores > self.detection_obj_score_thresh) & (nd_labels == 0)
        nd_inds = np.nonzero(keep)[0]
        nd_boxes, nd_scores, nd_hs = nd_boxes[keep], nd_scores[keep], nd_hs[keep]

        pmask = self.public_detections_mask(
            nd_boxes, np.asarray(blob.get("dets", np.zeros((0, 4))))
        )
        nd_boxes, nd_scores, nd_hs, nd_inds = (
            nd_boxes[pmask], nd_scores[pmask], nd_hs[pmask], nd_inds[pmask]
        )

        rmask = self.reid(nd_boxes, nd_scores, nd_hs)
        nd_boxes, nd_scores, nd_hs, nd_inds = (
            nd_boxes[rmask], nd_scores[rmask], nd_hs[rmask], nd_inds[rmask]
        )

        new_ids = self.add_tracks(nd_boxes, nd_scores, nd_hs, nd_inds)
        if mask_probs is not None:
            det_masks = mask_probs[t_slots:]
            for tid, oi in zip(new_ids, nd_inds):
                for tr in self.tracks:
                    if tr.id == tid:
                        tr.mask = det_masks[int(oi)]
        if attn_maps is not None:
            det_maps = attn_maps[t_slots:]
            for tid, oi in zip(new_ids, nd_inds):
                for tr in self.tracks:
                    if tr.id == tid:
                        tr.attention_map = det_maps[int(oi)]

        if self.detection_nms_thresh and self.tracks:
            tb = np.stack([t.pos for t in self.tracks])
            ts = np.array([t.score for t in self.tracks])
            new_mask = np.array([t.id in new_ids for t in self.tracks])
            ts = np.where(~new_mask, np.inf, ts)
            keep_idx = set(nms_numpy(tb, ts, self.detection_nms_thresh).tolist())
            self.tracks = [t for i, t in enumerate(self.tracks) if i in keep_idx]

        # ----- results -----
        if mask_probs is not None and any(
                t.mask is not None for t in self.tracks):
            self._resolve_masks(mask_probs.shape[-2:])
        for t in self.tracks:
            self.results.setdefault(t.id, {})
            bbox = t.pos if self.overflow_boxes else clip_boxes_np(t.pos, (h0, w0))
            self.results[t.id][self.frame_index] = {
                "bbox": np.asarray(bbox, np.float32),
                "score": float(t.score),
                "obj_ind": int(t.obj_ind),
            }
            if t.mask is not None:
                self.results[t.id][self.frame_index]["mask"] = t.mask
            if t.attention_map is not None:
                self.results[t.id][self.frame_index]["attention_map"] = (
                    t.attention_map
                )

        for t in self.inactive_tracks:
            t.count_inactive += 1
        self.frame_index += 1

        if self.reid_sim_only:
            self.move_tracks_to_inactive(list(self.tracks))

    def _resolve_masks(self, hw):
        """Per-pixel mask overlap resolution (reference tracker.py:515-527):
        each pixel goes to the track of highest probability if that is above
        0.5, else to none; every track's mask becomes boolean. The tracer's
        span ``mask_resolve``; ``masks_resolved`` counts the tracks."""
        with trace.span("mask_resolve", self.stream):
            masks = [t.mask if t.mask is not None else np.zeros(hw, np.float32)
                     for t in self.tracks]
            # in bands of rows that stay in the cache: passes over the whole
            # frame read ~30 MB from memory a track, bands read each track's
            # probabilities from memory once
            out = [np.empty(hw, bool) for _ in masks]
            band = max(1, RESOLVE_BAND_BYTES // (4 * hw[1]))
            for lo in range(0, hw[0], band):
                _resolve_band(masks, out, lo, min(lo + band, hw[0]))
            for t, mine in zip(self.tracks, out):
                t.mask = mine
        trace.count("masks_resolved", len(self.tracks))

    def get_results(self):
        return self.results
