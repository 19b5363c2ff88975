"""Panoptic post-processing + evaluator (port of
``kinet_tpu/models/panoptic.py``; reference: detr_segmentation.py:256-388
PostProcessPanoptic, datasets/panoptic_eval.py:13-46 PanopticEvaluator).

`postprocess_panoptic` computes the final per-pixel segment assignment:
queries above threshold compete per pixel via mask-logit softmax, stuff
classes merge, tiny segments (< 4 px) drop — the reference's algorithm in
numpy. The PQ evaluation step depends on panopticapi in the reference
(gated by try/import there too); here `panoptic_quality` implements the
standard PQ = TP_IoU_sum / (TP + FP/2 + FN/2) directly so no external
package is needed.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..utils.dist import all_gather_objects, get_world_size


def postprocess_panoptic(
    logits: np.ndarray,  # [Q, C+1]
    masks: np.ndarray,  # [Q, H, W] logits
    is_thing_map: dict,
    threshold: float = 0.85,
):
    """Returns (seg_map [H, W] int32 segment ids, segments_info list)."""
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    scores = probs.max(-1)
    labels = probs.argmax(-1)
    keep = (labels != logits.shape[-1] - 1) & (scores > threshold)
    scores, labels, masks = scores[keep], labels[keep], masks[keep]
    q, h, w = masks.shape if masks.size else (0, *masks.shape[1:])
    if q == 0:
        return np.zeros(masks.shape[1:], np.int32), []

    # stuff classes merge: same label -> same segment
    stuff_groups = defaultdict(list)
    for k, lab in enumerate(labels):
        if not is_thing_map.get(int(lab), True):
            stuff_groups[int(lab)].append(k)
    remap = np.arange(q)
    for group in stuff_groups.values():
        for k in group:
            remap[k] = group[0]

    # per-pixel winner by mask logit softmax over queries
    flat = masks.reshape(q, -1)
    m_id = flat.argmax(0)
    m_id = remap[m_id]
    # drop tiny segments
    seg_map = np.full(h * w, -1, np.int32)
    segments = []
    sid = 0
    for k in np.unique(m_id):
        area = int((m_id == k).sum())
        if area < 4:
            continue
        seg_map[m_id == k] = sid
        segments.append(
            {
                "id": sid,
                "category_id": int(labels[k]),
                "isthing": bool(is_thing_map.get(int(labels[k]), True)),
                "area": area,
                "score": float(scores[k]),
            }
        )
        sid += 1
    return seg_map.reshape(h, w), segments


def panoptic_quality(gt_pairs, pred_pairs):
    """PQ over a list of (seg_map, segments_info) pairs.

    gt/pred seg maps use -1 for void. Matching: IoU > 0.5 (unique by
    construction). Returns {'pq', 'sq', 'rq'}.
    """
    tp_iou = 0.0
    tp = fp = fn = 0
    for (gt_map, gt_info), (pr_map, pr_info) in zip(gt_pairs, pred_pairs):
        gt_cat = {s["id"]: s["category_id"] for s in gt_info}
        pr_cat = {s["id"]: s["category_id"] for s in pr_info}
        matched_gt, matched_pr = set(), set()
        for gid, gcat in gt_cat.items():
            gmask = gt_map == gid
            garea = gmask.sum()
            for pid, pcat in pr_cat.items():
                if pcat != gcat or pid in matched_pr:
                    continue
                inter = np.logical_and(gmask, pr_map == pid).sum()
                union = garea + (pr_map == pid).sum() - inter
                iou = inter / max(union, 1)
                if iou > 0.5:
                    tp += 1
                    tp_iou += iou
                    matched_gt.add(gid)
                    matched_pr.add(pid)
                    break
        fn += len(gt_cat) - len(matched_gt)
        fp += len(pr_cat) - len(matched_pr)
    sq = tp_iou / max(tp, 1)
    rq = tp / max(tp + 0.5 * fp + 0.5 * fn, 1)
    return {"pq": sq * rq, "sq": sq, "rq": rq, "tp": tp, "fp": fp, "fn": fn}


class PanopticEvaluator:
    """API-compatible shell (reference panoptic_eval.py:13-46): collects
    (seg_map, segments_info) predictions and computes PQ against provided
    GT pairs."""

    def __init__(self, gt_pairs=None, output_dir: str | None = None):
        self.gt_pairs = gt_pairs or []
        self.predictions = []

    def update(self, predictions):
        self.predictions += predictions

    def synchronize_between_processes(self):
        """Merges every process's predictions, in rank order."""
        if get_world_size() > 1:
            merged = []
            for p in all_gather_objects(self.predictions):
                merged += p
            self.predictions = merged

    def summarize(self):
        if not self.gt_pairs:
            return None
        return panoptic_quality(self.gt_pairs, self.predictions)
