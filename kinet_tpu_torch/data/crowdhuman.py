"""CrowdHuman dataset (the port's own copy of
``kinet_tpu/data/crowdhuman.py``; reference:
src/trackformer/datasets/crowdhuman.py): CocoDetection over CrowdHuman
COCO-converted jsons with tracking prev-frame simulation (same image,
shared-seed augs + jitter)."""
from __future__ import annotations

import os.path as osp

from .coco import CocoDetection


def build_crowdhuman(split: str, cfg):
    root = cfg.crowdhuman_path
    split_name = (
        cfg.crowdhuman_train_split if split == "train" and cfg.crowdhuman_train_split
        else split
    )
    return CocoDetection(
        img_folder=osp.join(root, split_name),
        ann_file=osp.join(root, "annotations", f"{split_name}.json"),
        split=split,
        img_transform=cfg.img_transform,
        overflow_boxes=cfg.overflow_boxes,
        prev_frame=cfg.tracking,
        prev_frame_rnd_augs=cfg.coco_and_crowdhuman_prev_frame_rnd_augs,
        prev_prev_frame=cfg.track_prev_prev_frame,
        min_num_objects=cfg.coco_min_num_objects,
    )
