"""MOT -> COCO-json converter (port of
``kinet_tpu/tools/generate_coco_from_mot.py``; reference:
src/generate_coco_from_mot.py).

Produces the extended COCO jsons that ``data/mot.py`` reads, with the
fields the reference adds (generate_coco_from_mot.py:36-262): per image
``seq_length``, ``first_frame_image_id``, ``frame_id``; per annotation
``track_id``, ``seq``, ``ignore`` (from the gt class and visibility
rules); and a top-level ``sequences`` list and ``frame_range``. Also:
- MOTS ground truth -> COCO json with RLE ``segmentation``
  (``generate_coco_from_mots``, on the port's ``utils/rle.py``),
- public detections -> COCO json for KineT (``generate_det_json_from_mot``),
- cross-validation splits by sequence (:583-598).

    python -m kinet_tpu_torch.tools.generate_coco_from_mot \
        --mot-dir data/MOT17 --split train --out data/MOT17/annotations
"""
from __future__ import annotations

import argparse
import configparser
import csv
import json
import os
import os.path as osp

VIS_THRESHOLD = 0.25

# MOT15 sequences ship no seqinfo.ini; the reference hardcodes their
# geometry (generate_coco_from_mot.py:26-33 MOT_15_SEQS_INFO) and skips
# the gt class-column filter for them (:178 — MOT15 gt has no class col)
MOT15_SEQS_INFO = {
    "ETH-Bahnhof": {"width": 640, "height": 480, "seq_length": 1000},
    "ETH-Sunnyday": {"width": 640, "height": 480, "seq_length": 354},
    "KITTI-13": {"width": 1242, "height": 375, "seq_length": 340},
    "KITTI-17": {"width": 1224, "height": 370, "seq_length": 145},
    "PETS09-S2L1": {"width": 768, "height": 576, "seq_length": 795},
    "TUD-Campus": {"width": 640, "height": 480, "seq_length": 71},
    "TUD-Stadtmitte": {"width": 640, "height": 480, "seq_length": 179},
}


def _read_seqinfo(seq_path):
    ini = osp.join(seq_path, "seqinfo.ini")
    seq_name = osp.basename(seq_path)
    if not osp.exists(ini) and seq_name in MOT15_SEQS_INFO:
        m = MOT15_SEQS_INFO[seq_name]
        return {
            "name": seq_name, "img_dir": "img1",
            "seq_length": m["seq_length"], "width": m["width"],
            "height": m["height"], "ext": ".jpg",
        }
    cfg = configparser.ConfigParser()
    cfg.read(ini)
    s = cfg["Sequence"]
    return {
        "name": s["name"],
        "img_dir": s["imDir"],
        "seq_length": int(s["seqLength"]),
        "width": int(s["imWidth"]),
        "height": int(s["imHeight"]),
        "ext": s.get("imExt", ".jpg"),
    }


def generate_coco_from_mot(
    mot_dir: str,
    split: str = "train",
    seqs: list[str] | None = None,
    frame_range=(0.0, 1.0),
    vis_threshold: float = VIS_THRESHOLD,
):
    """Returns the COCO dict for the given sequences."""
    base = osp.join(mot_dir, "train")
    if seqs is None:
        seqs = sorted(os.listdir(base))
    images, annotations = [], []
    img_id = 0
    ann_id = 0
    for seq in seqs:
        seq_path = osp.join(base, seq)
        info = _read_seqinfo(seq_path)
        start = int(frame_range[0] * info["seq_length"])
        end = int(frame_range[1] * info["seq_length"])
        first_image_id = img_id
        for f in range(start, end):
            images.append(
                {
                    "id": img_id,
                    "file_name": f"{seq}_{f + 1:06d}{info['ext']}",
                    "height": info["height"],
                    "width": info["width"],
                    "frame_id": f - start,
                    "first_frame_image_id": first_image_id,
                    "seq_length": end - start,
                    "seq": seq,
                }
            )
            img_id += 1

        gt_file = osp.join(seq_path, "gt", "gt.txt")
        if osp.exists(gt_file):
            for row in csv.reader(open(gt_file)):
                frame = int(row[0]) - 1
                if not (start <= frame < end):
                    continue
                mot15 = seq in MOT15_SEQS_INFO
                cls = int(row[7]) if len(row) > 7 and not mot15 else 1
                conf = int(row[6]) if len(row) > 6 else 1
                vis = (
                    float(row[8]) if len(row) > 8 and not mot15 else 1.0
                )
                # pedestrian-ish classes; distractors become ignore
                # (reference :139-187; MOT15 gt carries no class column
                # so every conf==1 row is a person, reference :178)
                if cls not in (1, 2, 7, 8, 12):
                    continue
                ignore = (
                    cls in (2, 7, 8, 12) or conf == 0 or vis < vis_threshold
                )
                x, y, w, h = (float(row[2]) - 1, float(row[3]) - 1,
                              float(row[4]), float(row[5]))
                annotations.append(
                    {
                        "id": ann_id,
                        "image_id": first_image_id + (frame - start),
                        "category_id": 1,
                        "bbox": [x, y, w, h],
                        "area": w * h,
                        "iscrowd": 0,
                        "ignore": int(ignore),
                        "track_id": int(row[1]),
                        "seq": seq,
                        "visibility": vis,
                    }
                )
                ann_id += 1
    return {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": 1, "name": "person"}],
        "sequences": seqs,
        "frame_range": {"start": frame_range[0], "end": frame_range[1]},
    }


def generate_coco_from_mots(
    mots_dir: str,
    split: str = "train",
    seqs: list[str] | None = None,
    frame_range=(0.0, 1.0),
):
    """MOTS GT (space-delimited `frame id class h w rle`) -> COCO json with
    RLE `segmentation` per annotation (reference generate_coco_from_mot.py
    mots branch, :133-169 + load_mots_gt): bbox from the decoded mask,
    class 1 (car) skipped, class 10 / id 10000 = ignore region, track_id =
    id % 1000. The RLE counts string is carried into the json verbatim.
    """
    from ..utils.rle import rle_to_mask

    base = osp.join(mots_dir, "train")
    if seqs is None:
        seqs = sorted(
            s for s in os.listdir(base) if osp.isdir(osp.join(base, s))
        )
    images, annotations = [], []
    img_id = 0
    ann_id = 0
    for seq in seqs:
        seq_path = osp.join(base, seq)
        info = _read_seqinfo(seq_path)
        start = int(frame_range[0] * info["seq_length"])
        end = int(frame_range[1] * info["seq_length"])
        first_image_id = img_id
        frame_to_img = {}
        for f in range(start, end):
            frame_to_img[f + 1] = img_id
            images.append(
                {
                    "id": img_id,
                    "file_name": f"{seq}_{f + 1:06d}{info['ext']}",
                    "height": info["height"],
                    "width": info["width"],
                    "frame_id": f - start,
                    "first_frame_image_id": first_image_id,
                    "seq_length": end - start,
                    "seq": seq,
                }
            )
            img_id += 1

        gt_file = osp.join(seq_path, "gt", "gt.txt")
        if not osp.exists(gt_file):
            continue
        for line in open(gt_file):
            fields = line.strip().split(" ")
            if len(fields) < 6:
                continue
            frame = int(fields[0])
            if frame not in frame_to_img:
                continue
            obj_id = int(fields[1])
            class_id = int(fields[2])
            h, w = int(fields[3]), int(fields[4])
            rle = fields[5]
            if class_id == 1:  # car class in KITTI-MOTS; not person
                continue
            mask = rle_to_mask(rle, (h, w))
            ys, xs = mask.nonzero()
            if len(xs):
                bbox = [
                    float(xs.min()), float(ys.min()),
                    float(xs.max() - xs.min() + 1),
                    float(ys.max() - ys.min() + 1),
                ]
            else:
                bbox = [0.0, 0.0, 0.0, 0.0]
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": frame_to_img[frame],
                    "category_id": 1,
                    "bbox": bbox,
                    "area": bbox[2] * bbox[3],
                    "iscrowd": 0,
                    "ignore": int(class_id == 10 or obj_id == 10000),
                    "track_id": obj_id % 1000,
                    "seq": seq,
                    "visibility": 1.0,
                    "segmentation": {"size": [h, w], "counts": rle},
                }
            )
            ann_id += 1
    return {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": 1, "name": "person"}],
        "sequences": seqs,
        "frame_range": {"start": frame_range[0], "end": frame_range[1]},
    }


def generate_det_json_from_mot(
    mot_dir: str, seqs: list[str], gt_json: dict
) -> dict:
    """Public det.txt files -> COCO detections json aligned with gt image
    ids (reference generate_det_json_from_mot)."""
    img_by_key = {
        (im["seq"], im["frame_id"]): im["id"] for im in gt_json["images"]
    }
    annotations = []
    ann_id = 0
    for seq in seqs:
        det_file = osp.join(mot_dir, "train", seq, "det", "det.txt")
        if not osp.exists(det_file):
            continue
        for row in csv.reader(open(det_file)):
            frame = int(float(row[0])) - 1
            key = (seq, frame)
            if key not in img_by_key:
                continue
            x, y, w, h = (float(row[2]) - 1, float(row[3]) - 1,
                          float(row[4]), float(row[5]))
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_by_key[key],
                    "category_id": 1,
                    "bbox": [x, y, w, h],
                    "area": w * h,
                    "iscrowd": 0,
                    "confidence": float(row[6]),
                }
            )
            ann_id += 1
    return {
        "images": gt_json["images"],
        "annotations": annotations,
        "categories": gt_json["categories"],
        "sequences": gt_json["sequences"],
    }


def cross_val_splits(seqs: list[str], n_folds: int = 3):
    """Leave-sequences-out folds (reference :583-598 builds seq-level and
    frame-level cross-val splits)."""
    folds = []
    for i in range(n_folds):
        val = seqs[i::n_folds]
        train = [s for s in seqs if s not in val]
        folds.append((train, val))
    return folds


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mot-dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--out", required=True)
    p.add_argument("--frame-range", nargs=2, type=float, default=[0.0, 1.0])
    p.add_argument("--dets", action="store_true",
                   help="also write det_{split}.json for KineT")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    coco = generate_coco_from_mot(
        args.mot_dir, args.split, frame_range=tuple(args.frame_range)
    )
    with open(osp.join(args.out, f"{args.split}.json"), "w") as f:
        json.dump(coco, f)
    if args.dets:
        dets = generate_det_json_from_mot(
            args.mot_dir, coco["sequences"], coco
        )
        with open(osp.join(args.out, f"det_{args.split}.json"), "w") as f:
            json.dump(dets, f)
    print(
        f"wrote {len(coco['images'])} images / "
        f"{len(coco['annotations'])} annotations"
    )


if __name__ == "__main__":
    main()
