"""COCO-style detection dataset with the tracking previous-frame
simulation (the port's own copy of ``kinet_tpu/data/coco.py``; reference:
src/trackformer/datasets/coco.py).

Self-contained COCO json handling (pycocotools is not available in this
environment); annotations are converted to numpy target dicts
(≙ ConvertCocoPolysToMask, reference coco.py:191-267) with:
- crowd/ignore annotations split into `*_ignore` fields (reference :71-76),
- track_ids (or per-annotation synthetic ids for static images),
- instance masks (``masks`` [N, H, W] uint8) decoded from the
  annotations' ``segmentation`` RLEs (MOTS), padded or cropped to the
  image size,
- dual-frame sampling: the (simulated) previous frame re-applies the same
  augmentation via a shared RNG seed plus an independent jitter crop
  (reference :48-103 `_getitem_from_id` / `_add_random_jitter`).
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np
from PIL import Image

from ..utils.rle import rle_to_mask
from . import transforms as T


def item_seed(base_seed: int, epoch: int, idx: int) -> int:
    """Deterministic, well-mixed per-(epoch, item) augmentation seed."""
    return int(
        np.random.SeedSequence([base_seed, epoch, idx]).generate_state(1)[0]
        % (2**31)
    )


class CocoIndex:
    """Minimal COCO-json index: images, anns by image."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs = {im["id"]: im for im in d["images"]}
        self.img_ids = [im["id"] for im in d["images"]]
        self.anns_by_img = {i: [] for i in self.img_ids}
        for a in d.get("annotations", []):
            if a["image_id"] in self.anns_by_img:
                self.anns_by_img[a["image_id"]].append(a)
        self.cats = {c["id"]: c for c in d.get("categories", [])}

    def __len__(self):
        return len(self.img_ids)


def convert_anns_to_target(anns, img_hw, image_id):
    """≙ ConvertCocoPolysToMask (reference coco.py:191-267), numpy."""
    h, w = img_hw
    anns = [a for a in anns if a.get("iscrowd", 0) == 0]  # ref coco.py:204
    boxes, labels, areas, iscrowd, track_ids, ignores = [], [], [], [], [], []
    for a in anns:
        x, y, bw, bh = a["bbox"]
        boxes.append([x, y, x + bw, y + bh])
        labels.append(a["category_id"] - 1 if a["category_id"] > 0 else 0)
        areas.append(a.get("area", bw * bh))
        iscrowd.append(a.get("iscrowd", 0))
        track_ids.append(a.get("track_id", a["id"]))
        ignores.append(a.get("ignore", 0))
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
    masks = None
    if any("segmentation" in a for a in anns):
        decoded = []
        for a in anns:
            seg = a.get("segmentation")
            if seg is None:
                decoded.append(np.zeros((h, w), np.uint8))
                continue
            sh, sw = seg["size"]
            m = rle_to_mask(seg["counts"], (sh, sw)).astype(np.uint8)
            if (sh, sw) != (h, w):
                mm = np.zeros((h, w), np.uint8)
                mm[: min(h, sh), : min(w, sw)] = m[:h, :w]
                m = mm
            decoded.append(m)
        masks = np.stack(decoded)
    target = {
        "image_id": image_id,
        "boxes": boxes[keep],
        "labels": np.asarray(labels, np.int64).reshape(-1)[keep],
        "area": np.asarray(areas, np.float32).reshape(-1)[keep],
        "iscrowd": np.asarray(iscrowd, np.int64).reshape(-1)[keep],
        "track_ids": np.asarray(track_ids, np.int64).reshape(-1)[keep],
        "ignore": np.asarray(ignores, np.int64).reshape(-1)[keep],
        "orig_size": np.asarray([h, w]),
        "size": np.asarray([h, w]),
    }
    if masks is not None:
        target["masks"] = masks[keep]
    # split ignore-region annotations (reference coco.py:71-76)
    ig = target["ignore"].astype(bool)
    for k in ("boxes", "labels", "area", "iscrowd", "track_ids"):
        target[f"{k}_ignore"] = target[k][ig]
        target[k] = target[k][~ig]
    if masks is not None:
        target["masks"] = target["masks"][~ig]
    del target["ignore"]
    return target


class CocoDetection:
    """Images of a COCO json: loading, target conversion and seeded
    augmentation; with ``prev_frame`` the previous frame is the same image,
    re-augmented with the same draw and cropped by a jitter (``MOT``
    samples real previous frames instead)."""

    def __init__(
        self,
        img_folder: str,
        ann_file: str,
        split: str,
        img_transform=None,
        overflow_boxes: bool = False,
        prev_frame: bool = False,
        prev_frame_rnd_augs: float = 0.0,
        prev_prev_frame: bool = False,
        min_num_objects: int = 0,
    ):
        self.root = img_folder
        self.coco = CocoIndex(ann_file)
        self.ids = list(self.coco.img_ids)
        if min_num_objects:
            self.ids = [
                i
                for i in self.ids
                if len(self.coco.anns_by_img[i]) >= min_num_objects
            ]
        self.split = split
        self.transforms = T.make_coco_transforms(
            "train" if split == "train" else "val", img_transform, overflow_boxes
        )
        self._prev_frame = prev_frame
        self._prev_frame_rnd_augs = prev_frame_rnd_augs
        self._prev_prev_frame = prev_prev_frame
        # deterministic per-item augmentation seeds: drawn from the
        # process-seeded global RNG at construction, mixed with
        # (epoch, idx) per item — two seeded runs replay identical augs
        self.base_seed = int(np.random.randint(2**31))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Fresh augmentation draws per epoch, still run-deterministic."""
        self.epoch = int(epoch)

    def _item_seed(self, idx: int) -> int:
        return item_seed(self.base_seed, self.epoch, idx)

    def __len__(self):
        return len(self.ids)

    def _load(self, image_id):
        info = self.coco.imgs[image_id]
        img = np.asarray(
            Image.open(osp.join(self.root, info["file_name"])).convert("RGB")
        ).astype(np.float32)
        target = convert_anns_to_target(
            self.coco.anns_by_img[image_id],
            (info["height"], info["width"]),
            image_id,
        )
        return img, target

    def _add_random_jitter(self, img, target, rng):
        """Random crop shrinking each side by <= prev_frame_rnd_augs
        (reference coco.py:89-103) to simulate inter-frame motion."""
        if not self._prev_frame_rnd_augs:
            return img, target
        h, w = img.shape[:2]
        f = self._prev_frame_rnd_augs
        ch = int(h - rng.uniform(0, f) * h)
        cw = int(w - rng.uniform(0, f) * w)
        i = int(rng.integers(0, h - ch + 1))
        j = int(rng.integers(0, w - cw + 1))
        img = img[i : i + ch, j : j + cw].copy()
        target = T._crop_target(target, (i, j, ch, cw))
        return img, target

    def _getitem_from_id(self, image_id, shared_seed, jitter=False):
        """Shared-seed augmentation so the previous frame sees the same
        transform draw (reference coco.py:48-86); ``jitter`` crops first,
        with its own generator."""
        img, target = self._load(image_id)
        if jitter:
            jrng = np.random.default_rng((shared_seed * 7919 + 13) % 2**31)
            img, target = self._add_random_jitter(img, target, jrng)
        rng = np.random.default_rng(shared_seed)
        img, target = self.transforms(img, target, rng)
        return img, target

    def sample_prev_image_id(self, idx, rng):
        """COCO: the same image re-augmented (reference coco.py:146-164)."""
        return self.ids[idx]

    def __getitem__(self, idx):
        image_id = self.ids[idx]
        seed = self._item_seed(idx)
        img, target = self._getitem_from_id(image_id, seed, jitter=False)
        sample = {"image": img, "target": target}
        if self._prev_frame:
            rng = np.random.default_rng(seed + 1)
            prev_id = self.sample_prev_image_id(idx, rng)
            prev_img, prev_target = self._getitem_from_id(
                prev_id, seed, jitter=True
            )
            sample["prev_image"] = prev_img
            sample["prev_target"] = prev_target
            if self._prev_prev_frame:
                pp_id = self.sample_prev_image_id(idx, rng)
                pp_img, pp_target = self._getitem_from_id(pp_id, seed, jitter=True)
                sample["prev_prev_image"] = pp_img
                sample["prev_prev_target"] = pp_target
        return sample
