"""COCO-style run-length mask encoding (the port's own copy of
``kinet_tpu/utils/rle.py``), self-contained: pycocotools' exact RLE wire
format (maskApi.c rleFrString/rleToString semantics):
- runs are column-major (Fortran order), alternating background/foreground
  starting with background,
- the compressed string packs counts 5 bits per char (chr(48+x), 0x20 as
  the continuation bit) with delta coding against counts[i-2].

Used by the COCO/MOT datasets' ``segmentation`` masks, the MOTS20 GT
loader and the MOTS20 result writer (reference
datasets/tracking/mots20_sequence.py:150-194 loads pycocotools RLEs).
"""
from __future__ import annotations

import numpy as np


def rle_decode_counts(s: str) -> list[int]:
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_encode_counts(counts: list[int]) -> str:
    out = []
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5  # python arithmetic shift: negative stays -1
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(48 + c))
    return "".join(out)


def rle_to_mask(counts, size_hw) -> np.ndarray:
    """counts (list or compressed str) + (h, w) -> bool mask [h, w]."""
    if isinstance(counts, str):
        counts = rle_decode_counts(counts)
    h, w = size_hw
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    val = False
    for c in counts:
        flat[pos : pos + c] = val
        pos += c
        val = not val
    return flat.reshape((w, h)).T  # column-major


def mask_to_rle(mask: np.ndarray) -> dict:
    """bool [h, w] -> {'size': [h, w], 'counts': compressed str}."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)  # column-major
    # run lengths, starting with background
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": rle_encode_counts(counts)}
