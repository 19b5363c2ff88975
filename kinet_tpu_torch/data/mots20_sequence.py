"""MOTS20 sequence dataset (port of ``kinet_tpu/data/mots20_sequence.py``;
reference: src/trackformer/datasets/tracking/mots20_sequence.py:17-194).

GT file format per line: `frame id class_id img_height img_width rle`
where id encodes class*1000+instance (class 2 = pedestrian, id 10000 =
ignore region); masks are pycocotools-compressed RLEs decoded by
``utils/rle.py``. GT boxes are derived from mask extents.
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..utils.rle import mask_to_rle, rle_to_mask
from .sequences import MOT17Sequence


def load_mots_gt(gt_file: str) -> dict:
    """frame -> list of {mask, track_id, class_id, bbox} (reference :150-194)."""
    objects_per_frame = {}
    with open(gt_file) as f:
        for line in f:
            fields = line.strip().split(" ")
            if not fields or fields[0] == "":
                continue
            frame = int(fields[0])
            obj_id = int(fields[1])
            class_id = int(fields[2])
            h, w = int(fields[3]), int(fields[4])
            mask = rle_to_mask(fields[5], (h, w))
            ys, xs = np.nonzero(mask)
            if len(xs):
                bbox = np.array(
                    [xs.min(), ys.min(), xs.max(), ys.max()], np.float32
                )
            else:
                bbox = np.zeros(4, np.float32)
            objects_per_frame.setdefault(frame, []).append(
                {
                    "mask": mask,
                    "track_id": obj_id % 1000,
                    "full_id": obj_id,
                    "class_id": class_id,
                    "bbox": bbox,
                    "ignore": obj_id == 10000,
                }
            )
    return objects_per_frame


class MOTS20Sequence(MOT17Sequence):
    """(reference mots20_sequence.py:17-148): MOT17 layout but GT from the
    MOTS txt format; results are written as RLE lines."""

    data_folder = "MOTS20"

    def __init__(self, root_dir="data", seq_name=None, vis_threshold=0.0,
                 img_transform=None, **kw):
        super().__init__(
            root_dir, seq_name, dets=None, vis_threshold=vis_threshold,
            img_transform=img_transform,
        )

    def get_track_boxes_and_visbility(self):
        boxes = {i: {} for i in range(1, self.seq_length + 1)}
        vis = {i: {} for i in range(1, self.seq_length + 1)}
        gt_file = self.get_gt_file_path()
        if not osp.exists(gt_file):
            return boxes, vis
        per_frame = load_mots_gt(gt_file)
        for frame, objs in per_frame.items():
            for o in objs:
                if o["class_id"] == 2 and not o["ignore"]:
                    boxes[frame][o["track_id"]] = o["bbox"]
                    vis[frame][o["track_id"]] = 1.0
        return boxes, vis

    def get_gt_file_path(self):
        return osp.join(self.get_seq_path(), "gt", "gt.txt")

    def load_masks(self, frame: int):
        gt_file = self.get_gt_file_path()
        if not osp.exists(gt_file):
            return []
        return load_mots_gt(gt_file).get(frame, [])

    def write_results(self, results: dict, output_dir: str):
        """MOTS format: `frame id class h w rle` (reference :119-148), one
        line for each result with a ``mask``, at the mask's own size (the
        tracker's is the padded input size)."""
        os.makedirs(output_dir, exist_ok=True)
        path = osp.join(output_dir, f"{self._seq_name}.txt")
        lines = []
        for tid, track in results.items():
            for frame, data in track.items():
                if "mask" not in data:
                    continue
                mask = np.asarray(data["mask"], bool)
                rle = mask_to_rle(mask)
                h, w = rle["size"]
                lines.append(
                    f"{frame + 1} {2000 + tid + 1} 2 {h} {w} {rle['counts']}"
                )
        with open(path, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
