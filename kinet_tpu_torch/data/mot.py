"""MOT training datasets (the port's own copy of the ``MOT`` and
``WeightedConcatDataset`` of ``kinet_tpu/data/mot.py``; reference:
src/trackformer/datasets/mot.py).

- MOT: CocoDetection over the MOT->COCO converted jsons; the previous
  frame is a REAL frame sampled within prev_frame_range of the current one
  using the extended json fields frame_id / first_frame_image_id /
  seq_length (reference mot.py:58-79); items are weighted by 1 / seq_length
  for the sampler. Its frames are never jittered.
- WeightedConcatDataset: datasets concatenated, each item keeping its
  dataset's sample weight, or 1 / len for a dataset without one
  (reference mot.py:501-513). As in the JAX package it has no
  ``set_epoch``, so its datasets replay epoch 0's augmentation draws in
  every epoch (ROADMAP.md, faults: inherited semantics).
"""
from __future__ import annotations

import numpy as np

from .coco import CocoDetection


class MOT(CocoDetection):
    def __init__(self, *args, prev_frame_range: int = 1, **kw):
        super().__init__(*args, **kw)
        self._prev_frame_range = prev_frame_range

    def seq_length(self, image_id):
        return self.coco.imgs[image_id]["seq_length"]

    def sample_weight(self, idx):
        return 1.0 / self.seq_length(self.ids[idx])

    def __getitem__(self, idx):
        image_id = self.ids[idx]
        seed = self._item_seed(idx)
        img, target = self._getitem_from_id(image_id, seed)
        sample = {"image": img, "target": target}

        if self._prev_frame:
            info = self.coco.imgs[image_id]
            frame_id = info["frame_id"]
            rng = np.random.default_rng(seed + 1)
            lo = max(0, frame_id - self._prev_frame_range)
            hi = min(
                frame_id + self._prev_frame_range, self.seq_length(image_id) - 1
            )
            prev_frame_id = int(rng.integers(lo, hi + 1))
            prev_image_id = info["first_frame_image_id"] + prev_frame_id
            prev_img, prev_target = self._getitem_from_id(prev_image_id, seed)
            sample["prev_image"] = prev_img
            sample["prev_target"] = prev_target

            if self._prev_prev_frame:
                # equidistant on the other side (reference mot.py:73-78)
                pp_frame_id = min(
                    max(0, prev_frame_id + prev_frame_id - frame_id),
                    self.seq_length(image_id) - 1,
                )
                pp_image_id = info["first_frame_image_id"] + pp_frame_id
                pp_img, pp_target = self._getitem_from_id(pp_image_id, seed)
                sample["prev_prev_image"] = pp_img
                sample["prev_prev_target"] = pp_target
        return sample


class WeightedConcatDataset:
    """Concat datasets, sampling each by per-item weights
    (reference mot.py:501-513)."""

    def __init__(self, datasets):
        self.datasets = datasets
        self.cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.cum[-1])

    def _locate(self, idx):
        d = int(np.searchsorted(self.cum, idx, side="right"))
        return self.datasets[d], idx - (0 if d == 0 else int(self.cum[d - 1]))

    def __getitem__(self, idx):
        ds, i = self._locate(idx)
        return ds[i]

    def sample_weight(self, idx):
        ds, i = self._locate(idx)
        if hasattr(ds, "sample_weight"):
            return ds.sample_weight(i)
        return 1.0 / len(ds)
