"""kinet_tpu_torch's CocoEvaluator (``utils/coco_eval.py``) against the JAX
package's on the same ground truth and predictions: the 12 COCO stats are
equal exactly (both are the same numpy algorithm, so every bit agrees).

The cases cover crowd ground truth (also listed before the real one),
the maxDets tiers, duplicate detections, the area ranges, several
categories (COCO ids with gaps, ``category_id - 1`` labels), images
without predictions or without ground truth, and a random sweep."""
import json

import numpy as np
import pytest

from kinet_tpu.data.coco import CocoIndex as JaxCocoIndex
from kinet_tpu.utils.coco_eval import CocoEvaluator as JaxCocoEvaluator
from kinet_tpu_torch.data.coco import CocoIndex
from kinet_tpu_torch.utils.coco_eval import CocoEvaluator


def _img(i, hw=600):
    return {"id": i, "height": hw, "width": hw, "file_name": f"{i}.jpg"}


def _ann(aid, img, bbox, crowd=0, cat=1):
    return {"id": aid, "image_id": img, "category_id": cat, "bbox": bbox,
            "area": bbox[2] * bbox[3], "iscrowd": crowd}


def _pred(boxes, scores, labels=None):
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    return {"boxes": boxes, "scores": np.asarray(scores, np.float64),
            "labels": np.zeros(len(boxes), np.int64) if labels is None
            else np.asarray(labels, np.int64)}


def _perfect():
    anns = [_ann(1, 1, [10, 10, 50, 50]), _ann(2, 1, [100, 100, 40, 40]),
            _ann(3, 2, [20, 20, 60, 60])]
    preds = {1: _pred([[10, 10, 60, 60], [100, 100, 140, 140]], [0.9, 0.8]),
             2: _pred([[20, 20, 80, 80]], [0.95])}
    return [_img(1), _img(2)], anns, preds, [{"id": 1}]


def _crowd():
    # a detection on crowd is neither TP nor FP; one on a real object is
    anns = [_ann(1, 1, [0, 0, 300, 300], crowd=1), _ann(2, 1, [400, 400, 80, 80])]
    preds = {1: _pred([[10, 10, 110, 110], [400, 400, 480, 480],
                       [500, 20, 560, 80]], [0.9, 0.8, 0.7])}
    return [_img(1)], anns, preds, [{"id": 1}]


def _crowd_first():
    # the crowd box listed first overlaps the real one more
    anns = [_ann(1, 1, [90, 90, 140, 140], crowd=1), _ann(2, 1, [100, 100, 100, 100])]
    preds = {1: _pred([[95, 95, 200, 200]], [0.9])}
    return [_img(1)], anns, preds, [{"id": 1}]


def _maxdets():
    # 12 objects in one image, detected with falling scores: AR@1 / @10 /
    # @100 and AP's 100-detection cut differ
    anns = [_ann(i + 1, 1, [40 * i + 5, 40, 30, 30]) for i in range(12)]
    boxes = [[40 * i + 5, 40, 40 * i + 35, 70] for i in range(12)]
    preds = {1: _pred(boxes, np.linspace(0.99, 0.5, 12))}
    return [_img(1)], anns, preds, [{"id": 1}]


def _duplicate():
    anns = [_ann(1, 1, [100, 100, 80, 80]), _ann(2, 2, [50, 50, 100, 100])]
    preds = {1: _pred([[100, 100, 180, 180], [101, 101, 181, 181],
                       [99, 102, 179, 180]], [0.9, 0.85, 0.6]),
             2: _pred([[52, 50, 150, 148]], [0.7])}
    return [_img(1), _img(2)], anns, preds, [{"id": 1}]


def _areas():
    # small (< 32^2), medium and large objects, and an out-of-range
    # unmatched detection of each size
    anns = [_ann(1, 1, [10, 10, 20, 20]), _ann(2, 1, [100, 100, 60, 60]),
            _ann(3, 1, [300, 300, 150, 150])]
    preds = {1: _pred([[10, 10, 30, 30], [100, 100, 160, 158],
                       [305, 300, 450, 450], [500, 500, 520, 520],
                       [200, 10, 260, 70], [0, 400, 200, 590]],
                      [0.9, 0.8, 0.7, 0.95, 0.6, 0.5])}
    return [_img(1)], anns, preds, [{"id": 1}]


def _categories():
    # COCO ids 1 and 3 (label 0 and 2), an image without predictions and
    # an image with predictions but no ground truth
    anns = [_ann(1, 1, [10, 10, 50, 50], cat=1), _ann(2, 1, [100, 100, 60, 60], cat=3),
            _ann(3, 2, [200, 200, 90, 90], cat=3), _ann(4, 3, [5, 5, 40, 40], cat=1)]
    preds = {1: _pred([[10, 10, 60, 60], [100, 100, 160, 160], [100, 100, 160, 160]],
                      [0.9, 0.6, 0.8], [0, 0, 2]),
             2: _pred([[205, 200, 290, 292]], [0.5], [2]),
             4: _pred([[0, 0, 30, 30]], [0.4], [0])}
    return ([_img(1), _img(2), _img(3), _img(4)], anns, preds,
            [{"id": 1}, {"id": 3}])


def _random(seed):
    def case():
        rng = np.random.default_rng(seed)
        images = [_img(i, 400) for i in range(1, 6)]
        anns, preds = [], {}
        for im in images:
            n = int(rng.integers(0, 8))
            gt = []
            for _ in range(n):
                w, h = rng.uniform(8, 160, 2)
                x, y = rng.uniform(0, 400 - w), rng.uniform(0, 400 - h)
                crowd = int(rng.uniform() < 0.1)
                anns.append(_ann(len(anns) + 1, im["id"],
                                 [float(x), float(y), float(w), float(h)],
                                 crowd=crowd, cat=int(rng.integers(1, 3))))
                gt.append([x, y, x + w, y + h])
            boxes, labels = [], []
            for b in gt:  # jittered hits
                if rng.uniform() < 0.8:
                    boxes.append(np.asarray(b) + rng.normal(0, 4, 4))
                    labels.append(int(rng.integers(0, 2)))
            for _ in range(int(rng.integers(0, 5))):  # false positives
                x, y = rng.uniform(0, 300, 2)
                boxes.append([x, y, x + rng.uniform(5, 100), y + rng.uniform(5, 100)])
                labels.append(int(rng.integers(0, 2)))
            if boxes:
                preds[im["id"]] = _pred(boxes, rng.uniform(0.05, 1.0, len(boxes)),
                                        labels)
        return images, anns, preds, [{"id": 1}, {"id": 2}]
    return case


CASES = {"perfect": _perfect, "crowd": _crowd, "crowd_first": _crowd_first,
         "maxdets": _maxdets, "duplicate": _duplicate, "areas": _areas,
         "categories": _categories,
         **{f"random{s}": _random(s) for s in range(6)}}


@pytest.mark.parametrize("case", list(CASES))
def test_stats_equal_jax_exactly(case, tmp_path):
    images, anns, preds, cats = CASES[case]()
    path = tmp_path / "gt.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": cats}))
    stats = []
    for index, evaluator in ((JaxCocoIndex, JaxCocoEvaluator),
                             (CocoIndex, CocoEvaluator)):
        ev = evaluator(index(str(path)))
        ev.update({k: {f: a.copy() for f, a in p.items()} for k, p in preds.items()})
        ev.synchronize_between_processes()
        ev.accumulate()
        stats.append(ev.summarize())
    ref, got = stats
    assert len(got) == 12
    assert got == ref
    assert any(0.0 < s < 1.0 for s in got) or case in ("perfect", "crowd_first")
