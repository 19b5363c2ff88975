"""CrowdHuman odgt -> COCO json (port of
``kinet_tpu/tools/generate_coco_from_crowdhuman.py``; reference:
src/generate_coco_from_crowdhuman.py:15-114), the annotation file that
``data/crowdhuman.py`` reads.

Each odgt line is a json record with ``ID`` and ``gtboxes`` (tag
'person' or 'mask'; full-body box ``fbox``; ``extra.ignore``). Boxes
tagged 'mask' and boxes flagged ignore become ``ignore`` annotations, as
in the reference.

    python -m kinet_tpu_torch.tools.generate_coco_from_crowdhuman \
        --odgt annotation_train.odgt --img-dir CrowdHuman/train \
        --out CrowdHuman/annotations/train.json
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp


def generate_coco_from_crowdhuman(odgt_file: str, img_dir: str) -> dict:
    """The COCO dict of an odgt file; each image's size is read from
    ``img_dir/<ID>.jpg`` (0 x 0 when the image is missing)."""
    from PIL import Image

    images, annotations = [], []
    ann_id = 0
    with open(odgt_file) as f:
        for img_id, line in enumerate(f):
            rec = json.loads(line)
            fname = f"{rec['ID']}.jpg"
            path = osp.join(img_dir, fname)
            if osp.exists(path):
                with Image.open(path) as im:
                    w, h = im.size
            else:
                w = h = 0
            images.append(
                {"id": img_id, "file_name": fname, "height": h, "width": w}
            )
            for gt in rec.get("gtboxes", []):
                ignore = int(
                    gt.get("tag") != "person"
                    or gt.get("extra", {}).get("ignore", 0) == 1
                )
                x, y, bw, bh = gt["fbox"]
                annotations.append(
                    {
                        "id": ann_id,
                        "image_id": img_id,
                        "category_id": 1,
                        "bbox": [x, y, bw, bh],
                        "area": bw * bh,
                        "iscrowd": 0,
                        "ignore": ignore,
                        "track_id": ann_id,  # static images: unique ids
                    }
                )
                ann_id += 1
    return {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": 1, "name": "person"}],
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--odgt", required=True)
    p.add_argument("--img-dir", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    coco = generate_coco_from_crowdhuman(args.odgt, args.img_dir)
    os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(coco, f)
    print(f"wrote {len(coco['images'])} images, {len(coco['annotations'])} anns")


if __name__ == "__main__":
    main()
