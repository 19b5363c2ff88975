"""Batch containers (port of ``kinet_tpu/structs.py``).

Layouts stay those of the JAX package, so the two compare like with like:
- images are [B, H, W, 3] float (ImageNet-normalized); the model permutes
  them to NCHW for its convolutions,
- ``pad_mask`` is True at padded pixels,
- track-query state lives in ``num_track_queries`` fixed slots with a mask;
- ``KineBatch`` carries the KineT family's input: external detections and
  their metadata in fixed slots, True = padding.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class ImageBatch:
    images: torch.Tensor  # [B, H, W, 3]
    pad_mask: torch.Tensor  # [B, H, W] bool, True = padding

    def to(self, device) -> "ImageBatch":
        return ImageBatch(self.images.to(device), self.pad_mask.to(device))


@dataclass
class Targets:
    """Per-image GT padded to a fixed number of objects, plus the
    track-query state the online tracker injects (zeros/False when off)."""

    boxes: torch.Tensor  # [B, N, 4] cxcywh, normalized
    labels: torch.Tensor  # [B, N] int64
    valid: torch.Tensor  # [B, N] bool
    track_ids: torch.Tensor  # [B, N] int64 (-1 when absent)
    track_query_embeds: torch.Tensor  # [B, T, D]
    track_query_boxes: torch.Tensor  # [B, T, 4] cxcywh normalized
    track_query_mask: torch.Tensor  # [B, T] bool, slot holds a track query
    track_query_fp_mask: torch.Tensor  # [B, T] bool, false-positive slot
    track_query_match_ids: torch.Tensor  # [B, T] int64, GT index or -1
    masks: Optional[torch.Tensor] = None  # [B, N, Hm, Wm]

    @classmethod
    def create(
        cls,
        boxes,
        labels,
        valid,
        track_ids=None,
        num_track_queries: int = 0,
        hidden_dim: int = 256,
        device=None,
    ) -> "Targets":
        boxes = torch.as_tensor(boxes, dtype=torch.float32, device=device)
        dev = boxes.device
        labels = torch.as_tensor(labels, dtype=torch.int64, device=dev)
        b, n = labels.shape
        t = num_track_queries
        if track_ids is None:
            track_ids = torch.full((b, n), -1, dtype=torch.int64, device=dev)
        return cls(
            boxes=boxes,
            labels=labels,
            valid=torch.as_tensor(valid, dtype=torch.bool, device=dev),
            track_ids=torch.as_tensor(track_ids, dtype=torch.int64, device=dev),
            track_query_embeds=torch.zeros(b, t, hidden_dim, device=dev),
            track_query_boxes=torch.zeros(b, t, 4, device=dev),
            track_query_mask=torch.zeros(b, t, dtype=torch.bool, device=dev),
            track_query_fp_mask=torch.zeros(b, t, dtype=torch.bool, device=dev),
            track_query_match_ids=torch.full(
                (b, t), -1, dtype=torch.int64, device=dev
            ),
        )

    @property
    def num_track_slots(self) -> int:
        return self.track_query_mask.shape[1]

    def replace(self, **kw) -> "Targets":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Targets":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        })


@dataclass
class KineBatch:
    """KineT input: per-frame external detections and their metadata,
    padded to a fixed number of detection slots."""

    detections: torch.Tensor  # [B, N, 4] cxcywh normalized
    metadata: torch.Tensor  # [B, N, M] confidence (+ class)
    pad_mask: torch.Tensor  # [B, N] bool, True = padding

    def to(self, device) -> "KineBatch":
        return KineBatch(self.detections.to(device),
                         self.metadata.to(device), self.pad_mask.to(device))


def pick_bucket(h: int, w: int, buckets) -> tuple[int, int]:
    """Smallest (short, long) bucket that fits an h x w image (host-side)."""
    short, long = min(h, w), max(h, w)
    for bs, bl in buckets:
        if short <= bs and long <= bl:
            return (bs, bl) if h <= w else (bl, bs)
    bs, bl = buckets[-1]
    return (bs, bl) if h <= w else (bl, bs)


def pad_image_to(img: np.ndarray, ph: int, pw: int):
    """Host-side zero-pad HWC image to (ph, pw); returns (padded, pad_mask)."""
    h, w, c = img.shape
    out = np.zeros((ph, pw, c), img.dtype)
    out[:h, :w] = img
    mask = np.ones((ph, pw), bool)
    mask[:h, :w] = False
    return out, mask
