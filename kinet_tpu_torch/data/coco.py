"""COCO-style annotations and the frame loading of the MOT dataset (the
port's own copy of the parts of ``kinet_tpu/data/coco.py`` that ``MOT``
uses, without the MOTS masks; reference: src/trackformer/datasets/coco.py).

Self-contained COCO json handling (pycocotools is not available in this
environment); annotations are converted to numpy target dicts
(≙ ConvertCocoPolysToMask, reference coco.py:191-267) with:
- crowd/ignore annotations split into `*_ignore` fields (reference :71-76),
- track_ids (or per-annotation synthetic ids for static images),
- a shared RNG seed, so a previous frame re-applies the current frame's
  augmentation draw (reference :48-86 `_getitem_from_id`).

The COCO dataset itself (a static image and its jittered copy as the
previous frame) comes with the other datasets (ROADMAP.md).
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np
from PIL import Image

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
    if any("segmentation" in a for a in anns):
        raise NotImplementedError(
            "segmentation masks (MOTS) are not ported to kinet_tpu_torch yet "
            "(ROADMAP.md, 'Modules to port': MOTS)"
        )
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
    # split ignore-region annotations (reference coco.py:71-76)
    ig = target["ignore"].astype(bool)
    for k in ("boxes", "labels", "area", "iscrowd", "track_ids"):
        target[f"{k}_ignore"] = target[k][ig]
        target[k] = target[k][~ig]
    del target["ignore"]
    return target


class CocoDetection:
    """Frames of a COCO json: loading, target conversion and seeded
    augmentation; ``MOT`` adds the sampling of previous frames."""

    def __init__(
        self,
        img_folder: str,
        ann_file: str,
        split: str,
        img_transform=None,
        overflow_boxes: bool = False,
        prev_frame: bool = False,
        prev_prev_frame: bool = False,
    ):
        self.root = img_folder
        self.coco = CocoIndex(ann_file)
        self.ids = list(self.coco.img_ids)
        self.split = split
        self.transforms = T.make_coco_transforms(
            "train" if split == "train" else "val", img_transform, overflow_boxes
        )
        self._prev_frame = prev_frame
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

    def _getitem_from_id(self, image_id, shared_seed):
        """Shared-seed augmentation so the previous frame sees the same
        transform draw (reference coco.py:48-86)."""
        img, target = self._load(image_id)
        rng = np.random.default_rng(shared_seed)
        img, target = self.transforms(img, target, rng)
        return img, target
