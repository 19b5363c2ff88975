"""COCO-style detection mAP evaluation, self-contained numpy: the port's
own copy of ``kinet_tpu/utils/coco_eval.py``, with the same protocol and
numbers.

The reference wraps pycocotools' COCOeval behind a distributed-merge
CocoEvaluator (reference datasets/coco_eval.py:22-73,176-211); pycocotools
is unavailable here, so the standard COCO protocol is implemented directly:
- greedy per-category matching of score-sorted detections to GT at each
  IoU threshold 0.50:0.05:0.95 (crowd/ignore GT never count as FP),
- 101-point interpolated precision, area ranges all/small/medium/large,
- the standard 12-number summary; stats[0] is mAP, stats[1] AP50 —
  the numbers train.py logs as `coco_eval_bbox` (reference engine.py:346).

API mirrors the reference evaluator: update(predictions) with
{image_id: {boxes xyxy, scores, labels}}, then accumulate()/summarize().
"""
from __future__ import annotations

import numpy as np

from .dist import all_gather_objects, get_world_size

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xyxy(d, g):
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    x0 = np.maximum(d[:, None, 0], g[None, :, 0])
    y0 = np.maximum(d[:, None, 1], g[None, :, 1])
    x1 = np.minimum(d[:, None, 2], g[None, :, 2])
    y1 = np.minimum(d[:, None, 3], g[None, :, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    area_d = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    return inter / np.maximum(area_d[:, None] + area_g[None] - inter, 1e-12)


class CocoEvaluator:
    def __init__(self, gt_index):
        """gt_index: CocoIndex (kinet_tpu_torch.data.coco) over the val json."""
        self.gt = gt_index
        self.preds = {}  # image_id -> dict
        self.eval_imgs = None

    def update(self, predictions: dict):
        for img_id, p in predictions.items():
            self.preds[img_id] = {
                "boxes": np.asarray(p["boxes"], np.float64).reshape(-1, 4),
                "scores": np.asarray(p["scores"], np.float64).reshape(-1),
                "labels": np.asarray(p["labels"], np.int64).reshape(-1),
            }

    def synchronize_between_processes(self):
        """Merges every process's prediction shard, so each process scores
        the whole val set (reference coco_eval.py:58-64)."""
        if get_world_size() == 1:
            return
        merged = {}
        for shard in all_gather_objects(self.preds):
            merged.update(shard)
        self.preds = merged

    def _gt_for(self, img_id, cat):
        anns = self.gt.anns_by_img.get(img_id, [])
        boxes, iscrowd = [], []
        for a in anns:
            if a["category_id"] - 1 != cat:
                continue
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            iscrowd.append(a.get("iscrowd", 0) or a.get("ignore", 0))
        return (
            np.asarray(boxes, np.float64).reshape(-1, 4),
            np.asarray(iscrowd, bool).reshape(-1),
        )

    def accumulate(self):
        cats = sorted({c - 1 for c in self.gt.cats}) or [0]
        n_t = len(IOU_THRS)
        precisions = -np.ones((n_t, len(REC_THRS), len(cats), len(AREA_RNG)))
        recalls = -np.ones((n_t, len(cats), len(AREA_RNG), len(MAX_DETS)))

        for ci, cat in enumerate(cats):
            # gather all dets/gt of this category over all predicted images
            records = []
            total_gt = {k: 0 for k in AREA_RNG}
            for img_id, p in self.preds.items():
                sel = p["labels"] == cat
                d_boxes = p["boxes"][sel]
                d_scores = p["scores"][sel]
                order = np.argsort(-d_scores, kind="stable")[: MAX_DETS[-1]]
                d_boxes, d_scores = d_boxes[order], d_scores[order]
                g_boxes, g_crowd = self._gt_for(img_id, cat)
                g_area = (
                    (g_boxes[:, 2] - g_boxes[:, 0])
                    * (g_boxes[:, 3] - g_boxes[:, 1])
                    if len(g_boxes)
                    else np.zeros(0)
                )
                iou = _iou_xyxy(d_boxes, g_boxes)
                records.append(
                    (d_scores, d_boxes, g_boxes, g_crowd, g_area, iou)
                )
            for ai, (aname, (lo, hi)) in enumerate(AREA_RNG.items()):
                # per-image matching at each IoU threshold; per-image
                # results are kept so each maxDets tier (1/10/100) can
                # truncate the score-sorted detections per IMAGE before the
                # global sweep — exactly pycocotools' dtMatches[:, :k]
                per_img = []  # (scores, matched, ignored) in score order
                n_gt = 0
                for d_scores, d_boxes, g_boxes, g_crowd, g_area, iou in records:
                    g_ignore = g_crowd | (g_area < lo) | (g_area > hi)
                    n_gt += int((~g_ignore).sum())
                    # pycocotools sorts GT ignored-last before matching (so
                    # a det prefers any non-ignored gt over ignored ones)
                    g_order = np.argsort(g_ignore, kind="stable")
                    g_ignore_s = g_ignore[g_order]
                    iou_s = iou[:, g_order] if len(g_boxes) else iou
                    d_area = (
                        (d_boxes[:, 2] - d_boxes[:, 0])
                        * (d_boxes[:, 3] - d_boxes[:, 1])
                    )
                    d_out_of_range = (d_area < lo) | (d_area > hi)
                    matched = np.zeros((len(IOU_THRS), len(d_boxes)), bool)
                    ignored = np.zeros((len(IOU_THRS), len(d_boxes)), bool)
                    for ti, thr in enumerate(IOU_THRS):
                        taken = np.zeros(len(g_boxes), bool)
                        for di in range(len(d_boxes)):
                            best, best_g = thr, -1
                            for gi in range(len(g_boxes)):
                                if taken[gi] and not g_ignore_s[gi]:
                                    continue
                                if (
                                    best_g >= 0
                                    and g_ignore_s[gi]
                                    and not g_ignore_s[best_g]
                                ):
                                    break  # gt sorted: ignored last
                                if iou_s[di, gi] >= best:
                                    best = iou_s[di, gi]
                                    best_g = gi
                            if best_g >= 0:
                                taken[best_g] = True
                                if g_ignore_s[best_g]:
                                    ignored[ti, di] = True
                                else:
                                    matched[ti, di] = True
                            elif d_out_of_range[di]:
                                ignored[ti, di] = True
                    per_img.append((d_scores, matched, ignored))
                total_gt[aname] = n_gt
                if n_gt == 0:
                    continue
                for mi, maxdet in enumerate(MAX_DETS):
                    scores = (
                        np.concatenate([s[:maxdet] for s, _, _ in per_img])
                        if per_img
                        else np.zeros(0)
                    )
                    matched = (
                        np.concatenate(
                            [m[:, :maxdet] for _, m, _ in per_img], axis=1
                        )
                        if per_img
                        else np.zeros((n_t, 0), bool)
                    )
                    ignored = (
                        np.concatenate(
                            [g[:, :maxdet] for _, _, g in per_img], axis=1
                        )
                        if per_img
                        else np.zeros((n_t, 0), bool)
                    )
                    order = np.argsort(-scores, kind="stable")
                    matched = matched[:, order]
                    ignored = ignored[:, order]
                    for ti in range(n_t):
                        keep = ~ignored[ti]
                        tp = np.cumsum(matched[ti][keep])
                        fp = np.cumsum(~matched[ti][keep])
                        rec = tp / n_gt
                        recalls[ti, ci, ai, mi] = rec[-1] if len(rec) else 0.0
                        if mi != len(MAX_DETS) - 1:
                            continue  # AP uses the top tier only
                        prec = tp / np.maximum(tp + fp, 1e-12)
                        # monotone precision envelope
                        for i in range(len(prec) - 1, 0, -1):
                            prec[i - 1] = max(prec[i - 1], prec[i])
                        idx = np.searchsorted(rec, REC_THRS, side="left")
                        q = np.zeros(len(REC_THRS))
                        valid = idx < len(prec)
                        q[valid] = prec[idx[valid]]
                        precisions[ti, :, ci, ai] = q

        self.eval_imgs = {"precision": precisions, "recall": recalls}

    def summarize(self):
        p = self.eval_imgs["precision"]
        r = self.eval_imgs["recall"]

        def ap(t_slice=slice(None), area=0):
            vals = p[t_slice, :, :, area]
            vals = vals[vals > -1]
            return float(vals.mean()) if vals.size else -1.0

        def ar(area=0, maxdet=len(MAX_DETS) - 1):
            vals = r[:, :, area, maxdet]
            vals = vals[vals > -1]
            return float(vals.mean()) if vals.size else -1.0

        stats = [
            ap(),  # AP @[.5:.95]
            ap(t_slice=slice(0, 1)),  # AP50
            ap(t_slice=slice(5, 6)),  # AP75
            ap(area=1), ap(area=2), ap(area=3),
            ar(maxdet=0), ar(maxdet=1), ar(maxdet=2),  # AR@1 / @10 / @100
            ar(area=1), ar(area=2), ar(area=3),
        ]
        names = [
            "AP", "AP50", "AP75", "APs", "APm", "APl",
            "AR1", "AR10", "AR100", "ARs", "ARm", "ARl",
        ]
        for n, s in zip(names, stats):
            print(f"{n:>6}: {s:.3f}")
        return stats
