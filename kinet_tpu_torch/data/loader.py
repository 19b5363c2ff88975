"""Batching (port of ``kinet_tpu/data/loader.py``).

Images are padded to bucketed shapes (``size_buckets``) and annotations to
``max_objects`` with validity masks; a batch is collated into CPU torch
tensors (``ImageBatch``, ``Targets``) that the train loop moves to the
device. Background threads prepare the next batches while the device
steps, and a reorder buffer keeps the sampler's order.

``WeightedRandomSampler`` weights samples by the dataset's
``sample_weight`` (1 / seq_length for MOT; reference util/misc.py:580-606,
train.py:131), ``RandomSampler`` permutes them; both draw from a numpy
generator seeded by (seed + epoch) and take every ``world_size``-th index
from ``rank``, as the JAX package's samplers do.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..structs import ImageBatch, Targets, pick_bucket


def pad_targets(targets: list[dict], max_objects: int,
                num_track_queries: int, hidden_dim: int,
                mask_hw: tuple[int, int] | None = None) -> Targets:
    """Targets padded to ``max_objects``; with ``mask_hw`` and instance
    masks in a target, ``masks`` f32 [b, max_objects, *mask_hw] (each mask
    at the top left, zeros elsewhere)."""
    b = len(targets)
    boxes = np.zeros((b, max_objects, 4), np.float32)
    labels = np.zeros((b, max_objects), np.int64)
    valid = np.zeros((b, max_objects), bool)
    track_ids = np.full((b, max_objects), -1, np.int64)
    has_masks = mask_hw is not None and any("masks" in t for t in targets)
    masks = (np.zeros((b, max_objects, *mask_hw), np.float32)
             if has_masks else None)
    for i, t in enumerate(targets):
        n = min(len(t["boxes"]), max_objects)
        if n:
            boxes[i, :n] = t["boxes"][:n]
            labels[i, :n] = t["labels"][:n]
            valid[i, :n] = True
            if "track_ids" in t and len(t["track_ids"]) >= n:
                track_ids[i, :n] = t["track_ids"][:n]
            if has_masks and "masks" in t and len(t["masks"]) >= n:
                m = t["masks"][:n]
                mh, mw = min(m.shape[1], mask_hw[0]), min(m.shape[2], mask_hw[1])
                masks[i, :n, :mh, :mw] = m[:, :mh, :mw]
    out = Targets.create(
        torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(valid), torch.from_numpy(track_ids),
        num_track_queries=num_track_queries, hidden_dim=hidden_dim,
    )
    return out if masks is None else out.replace(masks=torch.from_numpy(masks))


def pad_images(images: list[np.ndarray], buckets) -> ImageBatch:
    """Pad HWC images to the smallest bucket that fits them all."""
    hs = [im.shape[0] for im in images]
    ws = [im.shape[1] for im in images]
    ph, pw = pick_bucket(max(hs), max(ws), buckets)
    ph, pw = max(ph, max(hs)), max(pw, max(ws))
    b = len(images)
    out = np.zeros((b, ph, pw, 3), np.float32)
    mask = np.ones((b, ph, pw), bool)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        out[i, :h, :w] = im
        mask[i, :h, :w] = False
    return ImageBatch(torch.from_numpy(out), torch.from_numpy(mask))


def collate_tracking(samples: list[dict], buckets, max_objects: int,
                     num_track_queries: int, hidden_dim: int) -> dict:
    """Collate {image, target, prev_image?, prev_target?, ...} samples into
    {image, target, prev_image, prev_target, prev_prev_image,
    prev_prev_target} (None where absent), with each sample's
    ``image_ids`` and (h, w) ``orig_sizes`` as numpy arrays."""
    out = {}
    for key, tkey in (("image", "target"), ("prev_image", "prev_target"),
                      ("prev_prev_image", "prev_prev_target")):
        if key not in samples[0]:
            out[key] = out[tkey] = None
            continue
        out[key] = pad_images([s[key] for s in samples], buckets)
        out[tkey] = pad_targets([s[tkey] for s in samples], max_objects,
                                num_track_queries, hidden_dim,
                                mask_hw=tuple(out[key].images.shape[1:3]))
    out["image_ids"] = np.asarray(
        [s["target"].get("image_id", -1) for s in samples], np.int64)
    out["orig_sizes"] = np.asarray(
        [s["target"].get("orig_size", s["image"].shape[:2]) for s in samples],
        np.float32)
    return out


class WeightedRandomSampler:
    """Epoch-length weighted sampling with replacement, every
    ``world_size``-th draw from ``rank``."""

    def __init__(self, dataset, rank=0, world_size=1, seed=0):
        self.dataset = dataset
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        n = len(self.dataset)
        w = np.array([self.dataset.sample_weight(i) for i in range(n)])
        rng = np.random.default_rng(self.seed + self.epoch)
        idx = rng.choice(n, size=n, replace=True, p=w / w.sum())
        return iter(idx[self.rank :: self.world_size].tolist())

    def __len__(self):
        return len(self.dataset) // self.world_size


class RandomSampler:
    """A permutation per epoch, every ``world_size``-th index from ``rank``."""

    def __init__(self, dataset, rank=0, world_size=1, seed=0):
        self.dataset = dataset
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        idx = rng.permutation(len(self.dataset))
        return iter(idx[self.rank :: self.world_size].tolist())

    def __len__(self):
        return len(self.dataset) // self.world_size


class DataLoader:
    """Threaded prefetching loader of collated, statically padded batches,
    delivered in the sampler's order; a last, partial batch is dropped
    unless ``drop_last`` is False (evaluation). ``collate_fn(samples)``
    replaces the image collate (the KineT datasets' ``collate_kine``)."""

    def __init__(self, dataset, batch_size: int, sampler, buckets,
                 max_objects: int, num_track_queries: int = 0,
                 hidden_dim: int = 256, num_workers: int = 2,
                 drop_last: bool = True, collate_fn=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.buckets = buckets
        self.max_objects = max_objects
        self.num_track_queries = num_track_queries
        self.hidden_dim = hidden_dim
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        indices = list(self.sampler)
        batches = [indices[i : i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        q: queue.Queue = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()
        errors: list = []

        def put(item):
            # a bounded put that gives up once the consumer has stopped
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker(batch_list):
            try:
                for bi, idxs in batch_list:
                    if stop.is_set():
                        return
                    samples = [self.dataset[i] for i in idxs]
                    if self.collate_fn is not None:
                        put((bi, self.collate_fn(samples)))
                    else:
                        put((bi, collate_tracking(
                            samples, self.buckets, self.max_objects,
                            self.num_track_queries, self.hidden_dim,
                        )))
            except Exception as e:  # re-raised by the consumer
                errors.append(e)
            finally:
                put(None)  # the sentinel lands even after an error

        indexed = list(enumerate(batches))
        threads = [
            threading.Thread(target=worker,
                             args=(indexed[i :: self.num_workers],),
                             daemon=True)
            for i in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        done, next_bi, pending = 0, 0, {}
        try:
            while done < self.num_workers or pending:
                if next_bi in pending:
                    yield pending.pop(next_bi)
                    next_bi += 1
                    continue
                if done >= self.num_workers:
                    break
                item = q.get()
                if item is None:
                    done += 1
                    if errors:
                        raise errors[0]
                    continue
                bi, data = item
                pending[bi] = data
            if errors:
                raise errors[0]
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
