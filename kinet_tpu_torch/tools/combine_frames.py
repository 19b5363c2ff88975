"""Side-by-side frame composite (port of
``kinet_tpu/tools/combine_frames.py``; reference: src/combine_frames.py):
joins the same frame from two result-image directories (e.g. two runs'
``write_images`` output) into one image, to compare two trackers.

    python -m kinet_tpu_torch.tools.combine_frames <dir_a> <dir_b> <out_dir>
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
from PIL import Image


def combine(dir_a: str, dir_b: str, out_dir: str, axis: int = 1):
    """Writes every file name the two directories share, the two images
    cut to their common size and joined along ``axis`` (1: side by side,
    0: stacked); returns how many."""
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(set(os.listdir(dir_a)) & set(os.listdir(dir_b)))
    for name in names:
        a = np.asarray(Image.open(osp.join(dir_a, name)))
        b = np.asarray(Image.open(osp.join(dir_b, name)))
        h = min(a.shape[0], b.shape[0])
        w = min(a.shape[1], b.shape[1])
        comp = np.concatenate([a[:h, :w], b[:h, :w]], axis=axis)
        Image.fromarray(comp).save(osp.join(out_dir, name))
    return len(names)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dir_a")
    p.add_argument("dir_b")
    p.add_argument("out_dir")
    p.add_argument("--axis", type=int, default=1)
    args = p.parse_args(argv)
    n = combine(args.dir_a, args.dir_b, args.out_dir, args.axis)
    print(f"combined {n} frames")


if __name__ == "__main__":
    main()
