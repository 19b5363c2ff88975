"""COCO panoptic dataset (port of ``kinet_tpu/data/coco_panoptic.py``;
reference: src/trackformer/datasets/coco_panoptic.py).

Panoptic annotations: one json + per-image PNG id maps where the segment id
is encoded as R + 256·G + 256²·B (panopticapi's rgb2id — implemented here
directly since panopticapi is unavailable). Produces target dicts with
per-segment masks, boxes (from mask extents) and labels.

As in the JAX package, each item's augmentation draws its seed from an
unseeded generator, so the ``train`` split's samples are not repeatable;
the ``val`` transform draws nothing.
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np
from PIL import Image

from . import transforms as T


def rgb2id(color: np.ndarray) -> np.ndarray:
    color = color.astype(np.int64)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    out = np.zeros((*id_map.shape, 3), np.uint8)
    rem = id_map.astype(np.int64)
    for i in range(3):
        out[..., i] = rem % 256
        rem //= 256
    return out


class CocoPanoptic:
    def __init__(
        self,
        img_folder: str,
        ann_folder: str,
        ann_file: str,
        split: str = "train",
        img_transform=None,
        return_masks: bool = True,
    ):
        with open(ann_file) as f:
            self.coco = json.load(f)
        # sort to align images with annotations (reference does the same)
        self.coco["images"] = sorted(
            self.coco["images"], key=lambda x: x["id"]
        )
        self.anns = {a["image_id"]: a for a in self.coco["annotations"]}
        self.img_folder = img_folder
        self.ann_folder = ann_folder
        self.return_masks = return_masks
        self.transforms = T.make_coco_transforms(
            "train" if split == "train" else "val", img_transform
        )

    def __len__(self):
        return len(self.coco["images"])

    def __getitem__(self, idx):
        info = self.coco["images"][idx]
        ann = self.anns[info["id"]]
        img = np.asarray(
            Image.open(
                osp.join(self.img_folder, info["file_name"])
            ).convert("RGB")
        ).astype(np.float32)
        seg_png = np.asarray(
            Image.open(
                osp.join(
                    self.ann_folder,
                    ann["file_name"],
                )
            )
        )
        id_map = rgb2id(seg_png)

        masks, labels, boxes = [], [], []
        for seg in ann["segments_info"]:
            m = id_map == seg["id"]
            ys, xs = np.nonzero(m)
            if not len(xs):
                continue
            masks.append(m)
            labels.append(seg["category_id"])
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        target = {
            "image_id": info["id"],
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "orig_size": np.asarray(img.shape[:2]),
            "size": np.asarray(img.shape[:2]),
            "track_ids": np.arange(len(labels)),
        }
        if self.return_masks:
            target["masks"] = np.stack(masks) if masks else np.zeros(
                (0, *img.shape[:2]), bool
            )
        rng = np.random.default_rng(
            int(np.random.default_rng().integers(2**31))
        )
        img, target = self.transforms(img, target, rng)
        return {"image": img, "target": target}
