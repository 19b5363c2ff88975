"""Dataset dispatch (port of ``kinet_tpu/data/builder.py``; reference:
src/trackformer/datasets/__init__.py:29-52): coco, coco_person, mot,
mot_kine, crowdhuman, mot_crowdhuman, mot_coco_person, coco_panoptic."""
from __future__ import annotations

import os.path as osp

from .coco import CocoDetection
from .coco_panoptic import CocoPanoptic
from .crowdhuman import build_crowdhuman
from .kinematic import build_mot_kine
from .mot import MOT, WeightedConcatDataset


def _build_coco(split: str, cfg, mode="instances", sel=None):
    root = cfg.coco_path
    # reference coco.py:315-333: the {split}_split key selects which COCO
    # half ('train' -> train2017, 'val' -> val2017) regardless of the
    # engine-level split being built; mot_coco_person routes
    # coco_person_train_split here instead (mot.py:614-621)
    if sel is None:
        sel = cfg.get(f"{split}_split") or split
    split_name = "train2017" if sel == "train" else "val2017"
    return CocoDetection(
        img_folder=osp.join(root, split_name),
        ann_file=osp.join(root, "annotations", f"{mode}_{split_name}.json"),
        split=split,
        img_transform=cfg.img_transform,
        overflow_boxes=cfg.overflow_boxes,
        prev_frame=cfg.tracking,
        prev_frame_rnd_augs=cfg.coco_and_crowdhuman_prev_frame_rnd_augs,
        prev_prev_frame=cfg.track_prev_prev_frame,
        min_num_objects=cfg.coco_min_num_objects,
    )


def _build_mot(split: str, cfg):
    root = cfg.mot_path_train if split == "train" else cfg.mot_path_val
    split_name = cfg.train_split if split == "train" else cfg.val_split
    return MOT(
        img_folder=osp.join(root, "train"),
        ann_file=osp.join(root, "annotations", f"{split_name}.json"),
        split=split,
        img_transform=cfg.img_transform,
        overflow_boxes=cfg.overflow_boxes,
        prev_frame=cfg.tracking,
        prev_prev_frame=cfg.track_prev_prev_frame,
        prev_frame_range=cfg.track_prev_frame_range,
    )


def build_dataset(split: str, cfg):
    name = cfg.dataset
    if name == "coco":
        return _build_coco(split, cfg)
    if name == "coco_person":
        return _build_coco(split, cfg, mode="person_keypoints")
    if name == "mot":
        return _build_mot(split, cfg)
    if name == "mot_kine":
        return build_mot_kine(split, cfg)
    if name == "crowdhuman":
        return build_crowdhuman(split, cfg)
    if name == "mot_crowdhuman":
        # reference mot.py:595-611: with train_split null, train on
        # CrowdHuman alone (the MOT half is skipped entirely)
        if split == "train":
            ch = build_crowdhuman("train", cfg)
            if cfg.get("train_split") is None:
                return ch
            return WeightedConcatDataset([_build_mot(split, cfg), ch])
        return _build_mot(split, cfg)
    if name == "mot_coco_person":
        # reference mot.py:614-630: coco_person_train_split picks the COCO
        # half; with train_split null, train on COCO persons alone
        if split == "train":
            coco = _build_coco(
                "train", cfg, mode="person_keypoints",
                sel=cfg.get("coco_person_train_split") or "train",
            )
            if cfg.get("train_split") is None:
                return coco
            return WeightedConcatDataset([_build_mot(split, cfg), coco])
        return _build_mot(split, cfg)
    if name == "coco_panoptic":
        split_name = "train2017" if split == "train" else "val2017"
        root = cfg.coco_panoptic_path
        return CocoPanoptic(
            img_folder=osp.join(cfg.coco_path, split_name),
            ann_folder=osp.join(root, f"panoptic_{split_name}"),
            ann_file=osp.join(root, f"annotations/panoptic_{split_name}.json"),
            split=split,
            img_transform=cfg.img_transform,
            return_masks=cfg.masks,
        )
    raise ValueError(f"unknown dataset {name}")
