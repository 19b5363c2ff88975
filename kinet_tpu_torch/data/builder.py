"""Dataset dispatch (port of the ``mot`` branch of
``kinet_tpu/data/builder.py``). The other datasets of the JAX package raise
NotImplementedError naming their ROADMAP item."""
from __future__ import annotations

import os.path as osp

from .mot import MOT


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
    if cfg.dataset == "mot":
        return _build_mot(split, cfg)
    raise NotImplementedError(
        f"dataset {cfg.dataset!r} is not ported to kinet_tpu_torch yet "
        "(ROADMAP.md, 'Modules to port': Other datasets)"
    )
