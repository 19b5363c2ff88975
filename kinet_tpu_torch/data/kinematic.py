"""KineT data pipeline (port of ``kinet_tpu/data/kinematic.py``; reference:
src/trackformer/datasets/kinematic_utils.py and mot.py:318-461 MOT_Kine2).

The KineT family consumes no images: per frame it gets external detections
(boxes + confidence[+class]) and, for training, GT targets with `tracklets`
— the last `trail_len` positions of every GT object. All of it numpy here;
padding to static shapes happens in `collate_kine`.

Behaviors preserved:
- tracklet trails built from prev-frame annotations, current box as the
  default when an object is absent in a past frame (kinematic_utils.py:217-250),
- detection-space horizontal flip of dets + boxes + trails (:16-58),
- random trail noise (:61-86),
- xyxy -> normalized cxcywh for boxes, dets and trails (:89-127; the
  reference's misnamed `n_dets, w = orig_size[:2]` unpack is just h),
- sine encoding of detection vectors (:130-157) and trails
  (detr_tracking.py:286-307): freq = x·2π / dim_t, concat(cos(even),
  sin(odd)).

Samples are bit-identical to the JAX package's: the same numpy code draws
the same streams from the same per-item seeds (``coco.item_seed``).
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from .coco import CocoIndex, item_seed


def box_xyxy_to_cxcywh_np(b):
    return np.stack(
        [
            (b[..., 0] + b[..., 2]) / 2,
            (b[..., 1] + b[..., 3]) / 2,
            b[..., 2] - b[..., 0],
            b[..., 3] - b[..., 1],
        ],
        axis=-1,
    )


def sine_encode(x: np.ndarray, num_pos_feats: int, temperature=10000.0):
    """[..., K] in [0,1] -> [..., K*num_pos_feats] (reference
    DetectionsEncoderSine / SineEncodingTracklet math)."""
    t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * np.floor(t / 2) / num_pos_feats)
    freq = (x[..., None] * 2 * np.pi) / dim_t
    emb = np.concatenate([np.cos(freq[..., 0::2]), np.sin(freq[..., 1::2])], -1)
    return emb.reshape(*x.shape[:-1], -1)


def get_tracklet_data(boxes_xyxy, track_ids, prev_frames_anns, trail_len):
    """[n_obj, 4] current boxes + per-past-frame annotation lists ->
    trails [trail_len, n_obj, 4] xyxy (reference kinematic_utils.py:217-250:
    absent past frames default to the current box)."""
    n = len(boxes_xyxy)
    if n == 0:
        return np.zeros((trail_len, 0, 4), np.float32)
    id_to_row = {int(t): i for i, t in enumerate(track_ids)}
    past = np.broadcast_to(boxes_xyxy[None], (trail_len, n, 4)).copy()
    for i, frame_anns in enumerate(prev_frames_anns[:trail_len]):
        for ann in frame_anns:
            tid = ann.get("track_id")
            if tid in id_to_row:
                x, y, w, h = ann["bbox"]
                past[i, id_to_row[tid]] = [x, y, x + w, y + h]
    return past


def hflip_det(dets, meta, target):
    w = target["orig_size"][1]
    flip = lambda b: b[..., [2, 1, 0, 3]] * np.array([-1, 1, -1, 1]) + np.array(
        [w, 0, w, 0]
    )
    dets = flip(dets)
    target = dict(target)
    if len(target.get("boxes", [])):
        target["boxes"] = flip(target["boxes"]).astype(np.float32)
    if "tracklets" in target and target["tracklets"].size:
        target["tracklets"] = flip(target["tracklets"]).astype(np.float32)
    return dets.astype(np.float32), meta, target


def add_noise_tracklets(trails, width, height, rng, noise_range=(20, 30)):
    t, n, d = trails.shape
    out = trails.copy()
    out[..., 0::2] += rng.integers(-noise_range[0], noise_range[0], (t, n, d // 2))
    out[..., 1::2] += rng.integers(-noise_range[0], noise_range[1], (t, n, d // 2))
    out[..., 0::2] = out[..., 0::2].clip(0, width)
    out[..., 1::2] = out[..., 1::2].clip(0, height)
    out[..., 2] = np.maximum(out[..., 2], out[..., 0] + 5).clip(0, width)
    out[..., 3] = np.maximum(out[..., 3], out[..., 1] + 5).clip(0, height)
    return out


def normalize_kine(dets, target, overflow_boxes=False):
    """xyxy absolute -> cxcywh normalized for dets/boxes/trails."""
    h, w = target["orig_size"][:2]
    scale = np.array([w, h, w, h], np.float32)
    dets = dets.copy()
    dets[:, :4] = box_xyxy_to_cxcywh_np(dets[:, :4]) / scale
    target = dict(target)
    if len(target.get("boxes", [])):
        target["boxes"] = (
            box_xyxy_to_cxcywh_np(target["boxes"]) / scale
        ).astype(np.float32)
    if "tracklets" in target and target["tracklets"].size:
        tr = box_xyxy_to_cxcywh_np(target["tracklets"]) / scale
        if not overflow_boxes:
            tr = tr.clip(0, 1)
        target["tracklets"] = tr.astype(np.float32)
    if not overflow_boxes:
        dets[:, :4] = dets[:, :4].clip(0, 1)
    return dets.astype(np.float32), target


class MOTKine:
    """GT json + detections json per split (reference MOT_Kine2,
    mot.py:318-461). __getitem__ -> (detections, metadata, target)."""

    def __init__(
        self,
        ann_file: str,
        det_file: str,
        split: str,
        trail_len: int = 5,
        use_classes: bool = False,
        overflow_boxes: bool = False,
        noise_prob: float = 0.1,
    ):
        self.coco = CocoIndex(ann_file)
        self.dets = CocoIndex(det_file)
        self.ids = list(self.coco.img_ids)
        self.split = split
        self.trail_len = trail_len
        self.use_classes = use_classes
        self.overflow_boxes = overflow_boxes
        self.noise_prob = noise_prob
        # deterministic per-(epoch, item) augmentation seeds (see coco.py)
        self.base_seed = int(np.random.randint(2**31))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.ids)

    def seq_length(self, image_id):
        return self.coco.imgs[image_id]["seq_length"]

    def sample_weight(self, idx):
        return 1.0 / self.seq_length(self.ids[idx])

    def _prev_image_ids(self, image_id):
        info = self.coco.imgs[image_id]
        frame_id = info.get("frame_id", 0)
        first = info.get("first_frame_image_id", image_id - frame_id)
        prev = np.arange(-self.trail_len, 0) + image_id
        return np.maximum(prev, first).tolist()

    def _load_dets(self, image_id):
        anns = self.dets.anns_by_img.get(image_id, [])
        boxes, meta = [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            boxes.append([x, y, x + w, y + h])
            if self.use_classes:
                meta.append([a.get("confidence", a.get("score", 1.0)),
                             a["category_id"]])
            else:
                meta.append([a.get("confidence", a.get("score", 1.0))])
        m = 2 if self.use_classes else 1
        return (
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(meta, np.float32).reshape(-1, m),
        )

    def __getitem__(self, idx):
        image_id = self.ids[idx]
        info = self.coco.imgs[image_id]
        h, w = info["height"], info["width"]
        anns = [
            a
            for a in self.coco.anns_by_img[image_id]
            if a.get("iscrowd", 0) == 0
        ]
        boxes = np.asarray(
            [
                [a["bbox"][0], a["bbox"][1],
                 a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
                for a in anns
            ],
            np.float32,
        ).reshape(-1, 4)
        if not self.overflow_boxes:
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        track_ids = np.asarray(
            [a.get("track_id", a["id"]) for a in anns], np.int64
        )
        target = {
            "image_id": image_id,
            "boxes": boxes,
            "labels": np.asarray(
                [a["category_id"] - 1 for a in anns], np.int64
            ),
            "track_ids": track_ids,
            "orig_size": np.asarray([h, w]),
            "size": np.asarray([h, w]),
        }
        prev_ids = self._prev_image_ids(image_id)
        prev_anns = [self.coco.anns_by_img.get(i, []) for i in prev_ids]
        target["tracklets"] = get_tracklet_data(
            boxes, track_ids, prev_anns, self.trail_len
        )

        dets, meta = self._load_dets(image_id)
        if not self.overflow_boxes:
            dets[:, 0::2] = dets[:, 0::2].clip(0, w)
            dets[:, 1::2] = dets[:, 1::2].clip(0, h)

        rng = np.random.default_rng(
            item_seed(self.base_seed, self.epoch, idx)
        )
        if self.split == "train":
            if rng.uniform() < 0.5:
                dets, meta, target = hflip_det(dets, meta, target)
            if len(target["boxes"]) and rng.uniform() < self.noise_prob:
                target["tracklets"] = add_noise_tracklets(
                    target["tracklets"], w, h, rng
                )
        dets, target = normalize_kine(dets, target, self.overflow_boxes)
        return dets, meta, target


def build_mot_kine(split: str, cfg):
    """(reference mot.py:552-592: `{split}.json` GT + `det/{split}.json`)."""
    root = cfg.mot_path_train if split == "train" else cfg.mot_path_val
    split_name = cfg.train_split if split == "train" else cfg.val_split
    return MOTKine(
        ann_file=osp.join(root, "annotations", f"{split_name}.json"),
        det_file=osp.join(root, "annotations", f"det_{split_name}.json"),
        split=split,
        trail_len=max(int(cfg.track_prev_frame_range), 1),
        use_classes=bool(cfg.use_class),
        overflow_boxes=bool(cfg.overflow_boxes),
    )


def collate_kine(samples, max_detections: int, max_objects: int, trail_len: int,
                 meta_dim: int = 1, empty_start: bool = False):
    """Pad (dets, meta, target) triples to static shapes -> KineBatch arrays
    + padded target dict incl. trails [B, max_objects, trail_len, 4].

    empty_start: reserve slot 0 as a valid all-zero "no detection" slot
    (≙ reference collate_data2 prepending an empty item, misc.py:302-346).
    """
    b = len(samples)
    off = 1 if empty_start else 0
    dets = np.zeros((b, max_detections, 4), np.float32)
    meta = np.zeros((b, max_detections, meta_dim), np.float32)
    pad = np.ones((b, max_detections), bool)
    if empty_start:
        pad[:, 0] = False
    boxes = np.zeros((b, max_objects, 4), np.float32)
    labels = np.zeros((b, max_objects), np.int32)
    valid = np.zeros((b, max_objects), bool)
    track_ids = np.full((b, max_objects), -1, np.int32)
    trails = np.zeros((b, max_objects, trail_len, 4), np.float32)
    image_ids = np.zeros((b,), np.int64)
    orig_sizes = np.zeros((b, 2), np.float32)
    for i, (d, m, t) in enumerate(samples):
        image_ids[i] = int(t.get("image_id", -1))
        orig_sizes[i] = np.asarray(t["orig_size"][:2], np.float32)
        nd = min(len(d), max_detections - off)
        dets[i, off : off + nd] = d[:nd, :4]
        meta[i, off : off + nd] = m[:nd]
        pad[i, off : off + nd] = False
        n = min(len(t["boxes"]), max_objects)
        if n:
            boxes[i, :n] = t["boxes"][:n]
            labels[i, :n] = t["labels"][:n]
            valid[i, :n] = True
            track_ids[i, :n] = t["track_ids"][:n]
            trails[i, :n] = t["tracklets"].transpose(1, 0, 2)[:n]
    return {
        "detections": dets,
        "metadata": meta,
        "det_pad_mask": pad,
        "boxes": boxes,
        "labels": labels,
        "valid": valid,
        "track_ids": track_ids,
        "trails": trails,
        # eval bookkeeping (COCO AP needs ids + absolute sizes)
        "image_ids": image_ids,
        "orig_sizes": orig_sizes,
    }
