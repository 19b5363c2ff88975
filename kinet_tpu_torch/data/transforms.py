"""Host-side box-aware image transforms (the port's own copy of
``kinet_tpu/data/transforms.py``; reference
src/trackformer/datasets/transforms.py).

numpy/cv2 implementation (the reference uses PIL + torchvision tensors).
Images flow as float32 HWC RGB in [0, 255] until `Normalize`; boxes are
absolute xyxy; targets are plain dicts of numpy arrays.

Each transform is callable (image, target, rng) -> (image, target) where
rng is a numpy Generator: the *caller* controls the random state, which is
how a previous frame gets the same augmentation draw as the current one
(reference coco.py:48-86 re-seeds python random with a shared seed).
Instance masks (``masks`` [N, H, W]) follow the crop, the flip and the
resize (nearest neighbour), as in the JAX package.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _crop_target(target, region, overflow_boxes=False):
    """region = (top, left, h, w) (reference transforms.py:17-82)."""
    i, j, h, w = region
    target = dict(target)
    target["size"] = np.array([h, w])
    if "boxes" in target and len(target["boxes"]):
        boxes = target["boxes"] - np.array([j, i, j, i], np.float32)
        if not overflow_boxes:
            boxes = np.stack(
                [
                    boxes[:, 0].clip(0, w), boxes[:, 1].clip(0, h),
                    boxes[:, 2].clip(0, w), boxes[:, 3].clip(0, h),
                ],
                axis=1,
            )
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        target["boxes"] = boxes
        for k in ("boxes", "labels", "area", "iscrowd", "track_ids"):
            if k in target and len(target[k]) == len(keep):
                target[k] = target[k][keep]
        if "masks" in target and len(target["masks"]):
            target["masks"] = target["masks"][:, i : i + h, j : j + w]
            target["masks"] = target["masks"][keep[: len(target["masks"])]]
    return target


class Compose:
    def __init__(self, transforms):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, image, target, rng):
        for t in self.transforms:
            image, target = t(image, target, rng)
        return image, target


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, image, target, rng):
        if rng.uniform() < self.p:
            h, w = image.shape[:2]
            image = image[:, ::-1].copy()
            target = dict(target)
            if "boxes" in target and len(target["boxes"]):
                b = target["boxes"].copy()
                b[:, [0, 2]] = w - b[:, [2, 0]]
                target["boxes"] = b
            if "masks" in target and len(target["masks"]):
                target["masks"] = target["masks"][:, :, ::-1].copy()
        return image, target


def get_size_with_aspect_ratio(hw, size, max_size=None):
    """DETR resize rule (reference transforms.py:121-140): shorter side ->
    `size`, longer side capped at `max_size`."""
    h, w = hw
    if max_size is not None:
        min_original = float(min(h, w))
        max_original = float(max(h, w))
        if max_original / min_original * size > max_size:
            size = int(round(max_size * min_original / max_original))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


def resize(image, target, size, max_size=None):
    h, w = image.shape[:2]
    oh, ow = get_size_with_aspect_ratio((h, w), size, max_size)
    if cv2 is not None:
        out = cv2.resize(image, (ow, oh), interpolation=cv2.INTER_LINEAR)
    else:  # pragma: no cover
        from PIL import Image

        out = np.asarray(
            Image.fromarray(image.astype(np.uint8)).resize((ow, oh))
        ).astype(np.float32)
    if target is None:
        return out, None
    target = dict(target)
    rw, rh = ow / w, oh / h
    if "boxes" in target and len(target["boxes"]):
        target["boxes"] = target["boxes"] * np.array([rw, rh, rw, rh], np.float32)
    if "area" in target and len(target["area"]):
        target["area"] = target["area"] * (rw * rh)
    target["size"] = np.array([oh, ow])
    if "masks" in target and len(target["masks"]):
        m = target["masks"].astype(np.uint8)
        target["masks"] = np.stack([
            cv2.resize(mi, (ow, oh), interpolation=cv2.INTER_NEAREST) for mi in m
        ]).astype(bool)
    return out, target


class RandomResize:
    def __init__(self, sizes, max_size=None):
        self.sizes = list(sizes)
        self.max_size = max_size

    def __call__(self, image, target, rng):
        size = self.sizes[rng.integers(len(self.sizes))]
        return resize(image, target, size, self.max_size)


class RandomSizeCrop:
    def __init__(self, min_size, max_size, overflow_boxes=False):
        self.min_size = min_size
        self.max_size = max_size
        self.overflow_boxes = overflow_boxes

    def __call__(self, image, target, rng):
        h, w = image.shape[:2]
        cw = int(rng.integers(self.min_size, min(w, self.max_size) + 1))
        ch = int(rng.integers(self.min_size, min(h, self.max_size) + 1))
        i = int(rng.integers(0, h - ch + 1))
        j = int(rng.integers(0, w - cw + 1))
        image = image[i : i + ch, j : j + cw].copy()
        target = _crop_target(target, (i, j, ch, cw), self.overflow_boxes)
        return image, target


class RandomSelect:
    """Pick transform a with prob p else b (reference transforms.py:334-345)."""

    def __init__(self, a, b, p=0.5):
        self.a, self.b, self.p = a, b, p

    def __call__(self, image, target, rng):
        if rng.uniform() < self.p:
            return self.a(image, target, rng)
        return self.b(image, target, rng)


class Normalize:
    """To ImageNet-normalized float + boxes to normalized cxcywh
    (reference transforms.py:457-473)."""

    def __call__(self, image, target, rng=None):
        image = image.astype(np.float32) / 255.0
        image = (image - IMAGENET_MEAN) / IMAGENET_STD
        if target is None:
            return image, None
        target = dict(target)
        h, w = image.shape[:2]
        if "boxes" in target and len(target["boxes"]):
            b = target["boxes"].astype(np.float32)
            cxcywh = np.stack(
                [
                    (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                    b[:, 2] - b[:, 0], b[:, 3] - b[:, 1],
                ],
                axis=1,
            )
            target["boxes"] = cxcywh / np.array([w, h, w, h], np.float32)
        return image, target


def make_coco_transforms(
    image_set: str, img_transform=None, overflow_boxes: bool = False
):
    """Train/val pipelines (reference coco.py:270-312)."""
    max_size = 1333
    val_width = 800
    if img_transform is not None:
        max_size = int(img_transform.max_size)
        val_width = int(img_transform.val_width)
    scales = [int(max_size / 1333 * s) for s in
              (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)]
    random_resizes = [int(max_size / 1333 * s) for s in (400, 500, 600)]
    random_size_crop = (int(max_size / 1333 * 384), int(max_size / 1333 * 600))

    if image_set == "train":
        return Compose(
            [
                RandomHorizontalFlip(),
                RandomSelect(
                    RandomResize(scales, max_size=max_size),
                    Compose(
                        [
                            RandomResize(random_resizes),
                            RandomSizeCrop(*random_size_crop, overflow_boxes),
                            RandomResize(scales, max_size=max_size),
                        ]
                    ),
                ),
                Normalize(),
            ]
        )
    if image_set == "val":
        return Compose([RandomResize([val_width], max_size=max_size), Normalize()])
    raise ValueError(image_set)
