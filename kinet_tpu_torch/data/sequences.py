"""Tracking sequence datasets and MOTChallenge result IO: the port's copy of
``kinet_tpu/data/sequences.py`` (reference: TrackFormer's
mot17_sequence.py, mot20_sequence.py, demo_sequence.py, mot_wrapper.py,
factory.py).

Framework-free python classes producing numpy blobs for the Tracker:
{images [1,H,W,3] normalized+padded, pad_mask, orig_size, dets, gt, vis}.
Detection files are read by ``data/mot_csv.py``.

MOTChallenge line format (1-based frames/ids/pixels), as the reference
writer has it: frame+1, id+1, x1+1, y1+1, w(x2-x1+1), h(y2-y1+1), -1, -1,
-1, -1.

MOTS20 sequences (``MOTS20-02`` ..., ``MOTS20-TRAIN``) are
``data/mots20_sequence.py``'s.
"""
from __future__ import annotations

import configparser
import csv
import os
import os.path as osp
from typing import List, Optional

import numpy as np
from PIL import Image

from .mot_csv import parse_mot_csv
from .transforms import make_coco_transforms


def _load_image(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB")).astype(np.float32)


class MOT17Sequence:
    """One MOT17 sequence (reference mot17_sequence.py:20-271)."""

    data_folder = "MOT17"

    def __init__(
        self,
        root_dir: str = "data",
        seq_name: Optional[str] = None,
        dets: Optional[str] = "",
        vis_threshold: float = 0.0,
        img_transform=None,
    ):
        self._seq_name = seq_name
        self._dets = dets
        self._vis_threshold = vis_threshold
        self._data_dir = osp.join(root_dir, self.data_folder)
        self._train_folders = (
            os.listdir(osp.join(self._data_dir, "train"))
            if osp.isdir(osp.join(self._data_dir, "train"))
            else []
        )
        self._test_folders = (
            os.listdir(osp.join(self._data_dir, "test"))
            if osp.isdir(osp.join(self._data_dir, "test"))
            else []
        )
        self.transforms = make_coco_transforms(
            "val", img_transform, overflow_boxes=True
        )
        self.data: List[dict] = []
        self.no_gt = True
        if seq_name is not None:
            full = self._full_seq_name
            assert full in self._train_folders or full in self._test_folders, (
                f"Image set does not exist: {full}"
            )
            self.data = self._sequence()
            self.no_gt = not osp.exists(self.get_gt_file_path())

    @property
    def _full_seq_name(self):
        if self._dets:
            return f"{self._seq_name}-{self._dets}"
        return self._seq_name

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        data = self.data[idx]
        img = _load_image(data["im_path"])
        h0, w0 = img.shape[:2]
        rng = np.random.default_rng(0)  # val pipeline is deterministic
        img_t, _ = self.transforms(img, {"boxes": np.zeros((0, 4))}, rng)
        h, w = img_t.shape[:2]
        return {
            "images": img_t[None],
            "pad_mask": np.zeros((1, h, w), bool),
            "orig_size": (h0, w0),
            "size": (h, w),
            "dets": np.asarray(
                [d[:4] for d in data["dets"]], np.float32
            ).reshape(-1, 4),
            "dets_conf": np.asarray(
                [d[4] if len(d) > 4 else 1.0 for d in data["dets"]],
                np.float32,
            ).reshape(-1),
            "gt": data["gt"],
            "vis": data["vis"],
            "img_path": data["im_path"],
        }

    # -- file layout ---------------------------------------------------
    def get_seq_path(self):
        sub = "train" if self._full_seq_name in self._train_folders else "test"
        return osp.join(self._data_dir, sub, self._full_seq_name)

    def get_config_file_path(self):
        return osp.join(self.get_seq_path(), "seqinfo.ini")

    def get_gt_file_path(self):
        return osp.join(self.get_seq_path(), "gt", "gt.txt")

    def get_det_file_path(self):
        if self._dets is None:
            return ""
        return osp.join(self.get_seq_path(), "det", "det.txt")

    @property
    def config(self):
        cfg = configparser.ConfigParser()
        cfg.read(self.get_config_file_path())
        return cfg

    @property
    def seq_length(self) -> int:
        return int(self.config["Sequence"]["seqLength"])

    def __str__(self):
        return f"{self._seq_name}-{self._dets}" if self._dets else self._seq_name

    # -- parsing -------------------------------------------------------
    def _sequence(self) -> List[dict]:
        dets = {i: [] for i in range(1, self.seq_length + 1)}
        det_file = self.get_det_file_path()
        if det_file and osp.exists(det_file):
            rows = parse_mot_csv(det_file)
            for frame, _, x, y, w, h, conf in rows:
                x1, y1 = x - 1, y - 1
                x2, y2 = x1 + w - 1, y1 + h - 1
                f = int(frame)
                if f in dets:
                    dets[f].append(
                        np.array([x1, y1, x2, y2, conf], np.float32)
                    )
        img_dir = osp.join(self.get_seq_path(), self.config["Sequence"]["imDir"])
        boxes, vis = self.get_track_boxes_and_visbility()
        return [
            {
                "gt": boxes[i],
                "im_path": osp.join(img_dir, f"{i:06d}.jpg"),
                "vis": vis[i],
                "dets": dets[i],
            }
            for i in range(1, self.seq_length + 1)
        ]

    def get_track_boxes_and_visbility(self):
        boxes = {i: {} for i in range(1, self.seq_length + 1)}
        vis = {i: {} for i in range(1, self.seq_length + 1)}
        gt_file = self.get_gt_file_path()
        if not osp.exists(gt_file):
            return boxes, vis
        for row in csv.reader(open(gt_file), delimiter=","):
            # pedestrian class, considered, above visibility threshold
            # (reference mot17_sequence.py:130-148)
            if (
                int(row[6]) == 1
                and int(row[7]) == 1
                and float(row[8]) >= self._vis_threshold
            ):
                x1 = int(row[2]) - 1
                y1 = int(row[3]) - 1
                x2 = x1 + int(row[4]) - 1
                y2 = y1 + int(row[5]) - 1
                frame, tid = int(row[0]), int(row[1])
                boxes[frame][tid] = np.array([x1, y1, x2, y2], np.float32)
                vis[frame][tid] = float(row[8])
        return boxes, vis

    # -- results IO ----------------------------------------------------
    @property
    def results_file_name(self):
        return f"{self}.txt"

    def write_results(self, results: dict, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        path = osp.join(output_dir, self.results_file_name)
        with open(path, "w") as f:
            writer = csv.writer(f, delimiter=",")
            for tid, track in results.items():
                for frame, data in track.items():
                    x1, y1, x2, y2 = data["bbox"][:4]
                    writer.writerow(
                        [frame + 1, tid + 1, x1 + 1, y1 + 1,
                         x2 - x1 + 1, y2 - y1 + 1, -1, -1, -1, -1]
                    )

    def load_results(self, results_dir):
        results = {}
        if results_dir is None:
            return results
        path = osp.join(results_dir, self.results_file_name)
        if not osp.isfile(path):
            return results
        for row in csv.reader(open(path), delimiter=","):
            frame, tid = int(row[0]) - 1, int(row[1]) - 1
            x1 = float(row[2]) - 1
            y1 = float(row[3]) - 1
            x2 = float(row[4]) - 1 + x1
            y2 = float(row[5]) - 1 + y1
            results.setdefault(tid, {})[frame] = {
                "bbox": [x1, y1, x2, y2],
                "score": 1.0,
            }
        return results


class MOT20Sequence(MOT17Sequence):
    """(reference mot20_sequence.py:9-15)"""

    data_folder = "MOT20"

    def __init__(self, root_dir="data", seq_name=None, vis_threshold=0.0,
                 img_transform=None, **kw):
        super().__init__(
            root_dir, seq_name, dets=None, vis_threshold=vis_threshold,
            img_transform=img_transform,
        )


class DemoSequence(MOT17Sequence):
    """Folder of images (reference demo_sequence.py:22-112)."""

    def __init__(self, root_dir="data", img_transform=None, **kw):
        self._seq_name = osp.basename(osp.normpath(root_dir))
        self._dets = None
        self._vis_threshold = 0.0
        self._data_dir = root_dir
        self._train_folders = []
        self._test_folders = []
        self.transforms = make_coco_transforms(
            "val", img_transform, overflow_boxes=True
        )
        exts = (".jpg", ".jpeg", ".png")
        files = sorted(
            osp.join(root_dir, f)
            for f in os.listdir(root_dir)
            if f.lower().endswith(exts)
        )
        self.data = [
            {"gt": {}, "im_path": p, "vis": {}, "dets": []} for p in files
        ]
        self.no_gt = True

    def __str__(self):
        return self._seq_name

    @property
    def results_file_name(self):
        return f"{self._seq_name}.txt"


TRAIN_SEQS_17 = [f"MOT17-{i:02d}" for i in (2, 4, 5, 9, 10, 11, 13)]
TEST_SEQS_17 = [f"MOT17-{i:02d}" for i in (1, 3, 6, 7, 8, 12, 14)]
TRAIN_SEQS_20 = [f"MOT20-{i:02d}" for i in (1, 2, 3, 5)]
TEST_SEQS_20 = [f"MOT20-{i:02d}" for i in (4, 6, 7, 8)]
DETS_17 = ["DPM", "FRCNN", "SDP"]


def _expand_mot17(split: str, dets: str):
    """'MOT17-ALL-ALL' style split expansion (reference mot_wrapper.py:14-122,
    factory.py:15-73)."""
    if split == "ALL":
        seqs = TRAIN_SEQS_17 + TEST_SEQS_17
    elif split == "TRAIN":
        seqs = TRAIN_SEQS_17
    elif split == "TEST":
        seqs = TEST_SEQS_17
    else:
        seqs = [split if split.startswith("MOT17") else f"MOT17-{int(split):02d}"]
    det_list = DETS_17 if dets == "ALL" else [dets]
    return [(s, d) for s in seqs for d in det_list]


class TrackDatasetFactory:
    """Dataset-name registry (reference factory.py:15-73): names like
    'MOT17-ALL-ALL', 'MOT17-02-FRCNN', 'MOT20-TRAIN', 'DEMO'.

    Accepts a list of names or a comma-separated string (the reference
    factory accepts `datasets: Union[str, list]`, factory.py:44-46)."""

    def __init__(self, dataset_name, root_dir="data", img_transform=None,
                 vis_threshold=0.0):
        if isinstance(dataset_name, str):
            dataset_name = [n.strip() for n in dataset_name.split(",") if n.strip()]
        if not dataset_name:
            raise ValueError("empty dataset_name")
        if len(dataset_name) != 1:
            self._datasets = []
            for name in dataset_name:
                self._datasets.extend(
                    TrackDatasetFactory(
                        name, root_dir=root_dir, img_transform=img_transform,
                        vis_threshold=vis_threshold,
                    )._datasets
                )
            return
        dataset_name = dataset_name[0]
        self._datasets: List[MOT17Sequence] = []
        parts = dataset_name.split("-")
        if dataset_name.upper().startswith("DEMO"):
            self._datasets.append(
                DemoSequence(root_dir=root_dir, img_transform=img_transform)
            )
        elif parts[0] == "MOT17":
            split = parts[1] if len(parts) > 1 else "ALL"
            dets = parts[2] if len(parts) > 2 else "ALL"
            for seq, det in _expand_mot17(split, dets):
                self._datasets.append(
                    MOT17Sequence(
                        root_dir=root_dir, seq_name=seq, dets=det,
                        vis_threshold=vis_threshold, img_transform=img_transform,
                    )
                )
        elif parts[0] == "MOT20":
            split = parts[1] if len(parts) > 1 else "ALL"
            if split == "ALL":
                seqs = TRAIN_SEQS_20 + TEST_SEQS_20
            elif split == "TRAIN":
                seqs = TRAIN_SEQS_20
            elif split == "TEST":
                seqs = TEST_SEQS_20
            else:
                seqs = [f"MOT20-{int(split):02d}"]
            for seq in seqs:
                self._datasets.append(
                    MOT20Sequence(
                        root_dir=root_dir, seq_name=seq,
                        vis_threshold=vis_threshold, img_transform=img_transform,
                    )
                )
        elif parts[0] == "MOTS20":
            from .mots20_sequence import MOTS20Sequence

            split = parts[1] if len(parts) > 1 else "ALL"
            seqs = (
                [f"MOTS20-{int(split):02d}"]
                if split not in ("ALL", "TRAIN", "TEST")
                else {
                    "ALL": ["MOTS20-02", "MOTS20-05", "MOTS20-09", "MOTS20-11"],
                    "TRAIN": ["MOTS20-02", "MOTS20-05", "MOTS20-09", "MOTS20-11"],
                    "TEST": ["MOTS20-01", "MOTS20-06", "MOTS20-07", "MOTS20-12"],
                }[split]
            )
            for seq in seqs:
                self._datasets.append(
                    MOTS20Sequence(
                        root_dir=root_dir, seq_name=seq,
                        vis_threshold=vis_threshold, img_transform=img_transform,
                    )
                )
        else:
            raise NotImplementedError(f"Dataset name: {dataset_name}")

    def __len__(self):
        return len(self._datasets)

    def __iter__(self):
        return iter(self._datasets)

    def __getitem__(self, i):
        return self._datasets[i]
