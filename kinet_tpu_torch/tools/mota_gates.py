"""The synthetic-MOT accuracy gates: a tiny tracking model trained to
overfit a synthetic sequence, then tracked over it and scored with
CLEAR-MOT / IDF1. These are the recipes of the JAX package's gates
(``tests/test_synthetic_mota.py``, ``tests/test_synthetic_mota_hard.py``),
held to the same thresholds:

- ``simple``: two boxes moving apart over 8 frames of 64x96, 350 steps of
  the flagship flags at hidden 36 (resnet_test, 2 + 2 layers, 8 queries),
  then ``main_track`` over the sequence written as MOT17-05-FRCNN from a
  saved run: MOTA > 0.5, IDF1 > 0.5, ID switches <= 2;
- ``hard``: ``data/synthetic.py::hard_scene`` (crossings, an occlusion
  behind a pillar, noisy public detections) over 26 frames, 780 steps
  with an lr drop at 620 and every eighth step (and every first frame)
  with empty previous targets, then the ``Tracker`` with public-detection
  filtering: MOTA > 0.6, IDF1 > 0.55, ID switches <= 4, at least one
  re-identification and the occluded object's identity kept;
- ``kine`` (``tests/test_synthetic_mota_kine.py``): the encoder-only KineT
  (``train_kinet2``, hidden 64, 2 heads, trails of 3 sine-encoded at 4)
  trained 2400 steps of batch 4 through the real ``mot_kine`` path (COCO
  and det jsons -> ``collate_kine`` -> ``make_kine_train_step``) on two
  constant-velocity objects over 40 frames of 64x192 with +-1 px jittered
  public detections, then ``main_track`` with ``track_kinet.yaml``:
  MOTA > 0.75, IDF1 > 0.85, ID switches <= 2;
- ``kine_dual``: the dual-stream KineT (``train_kinet``, 50 queries, raw
  trails, Hungarian matching) on the same scene, 3600 steps: MOTA > 0.6,
  IDF1 > 0.8, ID switches <= 2.

    python -m kinet_tpu_torch.tools.mota_gates [--gate simple|hard|kine|kine_dual] [--device cpu]

runs a gate (on the card by default) and prints its scores as one JSON
line; it exits 1 if a threshold is missed.
"""
from __future__ import annotations

import argparse
import configparser
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..config import load_config, save_config
from ..data.builder import build_dataset
from ..data.loader import DataLoader, RandomSampler
from ..data.synthetic import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    SceneGTSeq,
    hard_scene,
    scene_frame_tensors,
)
from ..engine.state import Optimizer
from ..engine.track import main_track
from ..engine.train_step import kine_collate, make_kine_train_step, make_train_step
from ..models.build import build_criterion, build_model, resolve_device
from ..models.postprocess import build_postprocessors
from ..structs import ImageBatch, Targets
from ..tracking.tracker import Tracker
from ..utils.checkpoint import CheckpointManager
from ..utils.mot_metrics import evaluate_mot_accums, get_mot_accum

FLAGSHIP = ["train_deformable", "train_tracking", "train_multi_frame"]
TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=36, nheads=2,
    enc_layers=2, dec_layers=2, dim_feedforward=64, max_track_queries=8,
    dropout=0.0, aux_loss=False, num_feature_levels=4, dec_n_points=2,
    enc_n_points=2, with_box_refine=False, lr=1e-3, lr_backbone=1e-4,
    weight_decay=0.0, clip_max_norm=0.1,
    track_query_false_negative_prob=0.4, track_query_false_positive_prob=0.1,
)

# the simple gate's scene (tests/test_synthetic_mota.py)
SIMPLE_SEQ, SIMPLE_FRAMES, SIMPLE_H, SIMPLE_W = "MOT17-05-FRCNN", 8, 64, 96
SIMPLE_STEPS, HARD_STEPS = 350, 780
THRESHOLDS = {
    "simple": {"mota": 0.5, "idf1": 0.5, "num_switches": 2},
    "hard": {"mota": 0.6, "idf1": 0.55, "num_switches": 4, "num_reids": 1},
    "kine": {"mota": 0.75, "idf1": 0.85, "num_switches": 2},
    "kine_dual": {"mota": 0.6, "idf1": 0.8, "num_switches": 2},
}
# the KineT gates' scene (tests/test_synthetic_mota_kine.py)
KINE_SEQ, KINE_FRAMES, KINE_H, KINE_W = "MOT17-09-FRCNN", 40, 64, 192
KINE_STEPS = {"kine": 2400, "kine_dual": 3600}


def _boxes_at(f):
    """Two objects on deterministic paths; xywh pixels."""
    return [(4 + 4 * f, 8, 24, 30), (66 - 3 * f, 28, 20, 26)]


def _render(f):
    img = np.full((SIMPLE_H, SIMPLE_W, 3), 20, np.uint8)
    for k, (x, y, w, h) in enumerate(_boxes_at(f)):
        img[y:y + h, x:x + w] = (255, 80, 80) if k == 0 else (80, 80, 255)
    return img


def write_simple_sequence(root: Path) -> None:
    """The simple scene as MOT17/train/MOT17-05-FRCNN (JPEG frames, gt and
    det files with every box)."""
    seq_dir = root / "MOT17" / "train" / SIMPLE_SEQ
    for d in ("img1", "gt", "det"):
        (seq_dir / d).mkdir(parents=True)
    (root / "MOT17" / "test").mkdir(parents=True, exist_ok=True)
    info = configparser.ConfigParser()
    info["Sequence"] = {
        "name": SIMPLE_SEQ, "imDir": "img1", "frameRate": "30",
        "seqLength": str(SIMPLE_FRAMES), "imWidth": str(SIMPLE_W),
        "imHeight": str(SIMPLE_H), "imExt": ".jpg",
    }
    with open(seq_dir / "seqinfo.ini", "w") as fh:
        info.write(fh)
    gt, det = [], []
    for f in range(SIMPLE_FRAMES):
        Image.fromarray(_render(f)).save(seq_dir / "img1" / f"{f + 1:06d}.jpg")
        for tid, (x, y, w, h) in enumerate(_boxes_at(f), start=1):
            gt.append(f"{f + 1},{tid},{x},{y},{w},{h},1,1,1.0")
            det.append(f"{f + 1},-1,{x},{y},{w},{h},0.95,-1,-1")
    (seq_dir / "gt" / "gt.txt").write_text("\n".join(gt) + "\n")
    (seq_dir / "det" / "det.txt").write_text("\n".join(det) + "\n")


def _simple_frame(f):
    img = (_render(f).astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    boxes = [[(x + w / 2) / SIMPLE_W, (y + h / 2) / SIMPLE_H, w / SIMPLE_W,
              h / SIMPLE_H] for x, y, w, h in _boxes_at(f)]
    batch = ImageBatch(torch.from_numpy(img)[None],
                       torch.zeros(1, SIMPLE_H, SIMPLE_W, dtype=torch.bool))
    targets = Targets.create(
        torch.tensor([boxes]), torch.zeros(1, 2), torch.ones(1, 2),
        track_ids=torch.tensor([[1, 2]]), num_track_queries=8, hidden_dim=36)
    return batch, targets


def simple_cfg():
    return load_config("train.yaml", named=FLAGSHIP).replace(
        num_queries=8, **TINY,
        **{"img_transform.max_size": 128, "img_transform.val_width": 64})


def hard_cfg():
    # the encoder and decoder sample every level, as the JAX gate pins them
    return load_config("train.yaml", named=FLAGSHIP).replace(
        num_queries=10, lr_drop=1, enc_lite_high_klevels=0, dec_klevels=0,
        **TINY)


def _train(cfg, frames, steps, steps_per_epoch, device, prev_of, empty_prev):
    """Trains a fresh model on consecutive-frame pairs; returns it, its
    optimizer and the last loss."""
    model, _ = build_model(cfg, device=device, seed=0)
    model.train()
    optimizer = Optimizer(model, cfg, steps_per_epoch)
    step = make_train_step(model, build_criterion(cfg), optimizer, cfg)
    frames = [(b.to(device), t.to(device)) for b, t in frames]
    loss = None
    for it in range(steps):
        f = it % len(frames) if prev_of is None else prev_of(it)
        batch, targets = frames[f]
        pbatch, ptargets = frames[max(f - 1, 0)]
        if empty_prev(it, f):
            ptargets = ptargets.replace(valid=torch.zeros_like(ptargets.valid))
        loss = float(step(batch, targets, pbatch, ptargets)["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"the last training loss is {loss}")
    model.eval()
    return model, optimizer, loss


def run_simple(device=None) -> dict:
    """The simple gate; returns its scores ({mota, idf1, num_switches,
    last_loss, train_s, ...})."""
    device = resolve_device(device)
    cfg = simple_cfg()
    t0 = time.perf_counter()
    model, optimizer, loss = _train(
        cfg, [_simple_frame(f) for f in range(SIMPLE_FRAMES)], SIMPLE_STEPS,
        1000, device, prev_of=lambda it: 1 + it % (SIMPLE_FRAMES - 1),
        empty_prev=lambda it, f: False)
    train_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_simple_sequence(tmp / "data")
        save_config(cfg, tmp / "model")
        CheckpointManager(str(tmp / "model")).save_epoch(
            model, optimizer, SIMPLE_STEPS, 0)
        track_cfg = load_config("track.yaml").replace(
            obj_detect_checkpoint_dir=str(tmp / "model"),
            data_root_dir=str(tmp / "data"), dataset_name=SIMPLE_SEQ,
            output_dir=str(tmp / "results"), device=str(device),
            **{"tracker_cfg.detection_obj_score_thresh": 0.3,
               "tracker_cfg.track_obj_score_thresh": 0.3,
               "tracker_cfg.detection_nms_thresh": 0.5})
        summary = main_track(track_cfg)
    m = summary[SIMPLE_SEQ]
    return {**{k: m[k] for k in ("mota", "idf1", "num_switches",
                                 "num_false_positives", "num_misses")},
            "last_loss": loss, "train_s": train_s, "steps": SIMPLE_STEPS}


def _covering_id(results, box_xywh, f):
    """The track id whose box at frame f overlaps ``box_xywh`` most (IoU
    >= 0.4), or None."""
    x, y, w, h = box_xywh
    gt = np.array([x, y, x + w, y + h])
    best, best_iou = None, 0.0
    for tid, track in results.items():
        if f not in track:
            continue
        b = np.asarray(track[f]["bbox"][:4])
        x0, y0 = np.maximum(gt[:2], b[:2])
        x1, y1 = np.minimum(gt[2:], b[2:])
        inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
        union = (gt[2] - gt[0]) * (gt[3] - gt[1]) + (b[2] - b[0]) * (b[3] - b[1])
        iou = inter / max(union - inter, 1e-9)
        if iou > best_iou:
            best, best_iou = tid, iou
    return best if best_iou >= 0.4 else None


def run_hard(device=None) -> dict:
    """The hard gate; returns its scores ({mota, idf1, num_switches,
    num_reids, identity_kept, ...})."""
    device = resolve_device(device)
    scene = hard_scene(n_frames=26, pillar_frac=0.58)
    cfg = hard_cfg()
    frames = [scene_frame_tensors(scene, f, hidden_dim=36, n_slots=3,
                                  n_track_queries=8)
              for f in range(scene.n_frames)]
    t0 = time.perf_counter()
    model, _, loss = _train(
        cfg, frames, HARD_STEPS, 620, device, prev_of=None,
        empty_prev=lambda it, f: f == 0 or it % 8 == 7)
    train_s = time.perf_counter() - t0
    tracker = Tracker(
        model, build_postprocessors(cfg)["bbox"],
        dict(detection_obj_score_thresh=0.2, track_obj_score_thresh=0.3,
             detection_nms_thresh=0.4, track_nms_thresh=0.9,
             public_detections="min_iou_0_5", inactive_patience=10,
             reid_sim_threshold=0.0, reid_sim_only=False,
             reid_score_thresh=0.3, reid_greedy_matching=True,
             prev_frame_dist=1, steps_termination=1),
        num_object_queries=int(cfg.num_queries),
        num_track_slots=int(cfg.max_track_queries),
        hidden_dim=int(cfg.hidden_dim))
    for f in range(scene.n_frames):
        img = (scene.render(f).astype(np.float32) / 255.0
               - IMAGENET_MEAN) / IMAGENET_STD
        dets = np.array([b for b, _ in scene.dets[f]], np.float32).reshape(-1, 4)
        dets[:, 2:] += dets[:, :2]
        tracker.step({"images": img[None],
                      "pad_mask": np.zeros((1, scene.h, scene.w), bool),
                      "orig_size": (scene.h, scene.w), "dets": dets})
    results = tracker.get_results()
    m = evaluate_mot_accums([get_mot_accum(results, SceneGTSeq(scene))],
                            ["hard"], generate_overall=False)["hard"]
    # the occluded object (id 3) is covered by one track id before and
    # after its occlusion
    hide_f, show_f = scene.occlusion_spans()[3]
    pre = {_covering_id(results, scene.gt_at(f)[3], f)
           for f in range(hide_f)} - {None}
    post = {_covering_id(results, scene.gt_at(f)[3], f)
            for f in range(show_f + 1, scene.n_frames)} - {None}
    return {**{k: m[k] for k in ("mota", "idf1", "num_switches",
                                 "num_false_positives", "num_misses")},
            "num_reids": tracker.num_reids,
            "identity_kept": bool(pre & post), "last_loss": loss,
            "train_s": train_s, "steps": HARD_STEPS}


def _kine_boxes_at(f):
    """Two well-separated constant-velocity objects; xywh pixels."""
    return [(4 + 3 * f, 8, 22, 28), (166 - 3 * f, 30, 20, 26)]


def _kine_dets_at(f):
    """Public detections: the boxes with a seeded +-1 px jitter."""
    rng = np.random.default_rng(1000 + f)
    out = []
    for (x, y, w, h) in _kine_boxes_at(f):
        dx, dy, dw, dh = (int(v) for v in rng.integers(-1, 2, 4))
        out.append((x + dx, y + dy, max(w + dw, 4), max(h + dh, 4)))
    return out


def write_kine_scene(root: Path) -> None:
    """The KineT gates' scene twice: MOT17/train/MOT17-09-FRCNN (black
    JPEG frames, gt, det) for tracking and ``coco/annotations/train.json``
    + ``det_train.json`` for ``mot_kine`` training."""
    seq_dir = root / "MOT17" / "train" / KINE_SEQ
    for d in ("img1", "gt", "det"):
        (seq_dir / d).mkdir(parents=True)
    (root / "MOT17" / "test").mkdir(parents=True, exist_ok=True)
    info = configparser.ConfigParser()
    info["Sequence"] = {
        "name": KINE_SEQ, "imDir": "img1", "frameRate": "30",
        "seqLength": str(KINE_FRAMES), "imWidth": str(KINE_W),
        "imHeight": str(KINE_H), "imExt": ".jpg",
    }
    with open(seq_dir / "seqinfo.ini", "w") as fh:
        info.write(fh)
    black = Image.fromarray(np.zeros((KINE_H, KINE_W, 3), np.uint8))
    gt, det, images, anns, det_anns = [], [], [], [], []
    for f in range(KINE_FRAMES):
        black.save(seq_dir / "img1" / f"{f + 1:06d}.jpg")
        images.append({
            "id": f, "file_name": f"{KINE_SEQ}_{f + 1:06d}.jpg",
            "height": KINE_H, "width": KINE_W, "frame_id": f,
            "first_frame_image_id": 0, "seq_length": KINE_FRAMES,
            "seq": KINE_SEQ,
        })
        for tid, (x, y, w, h) in enumerate(_kine_boxes_at(f), start=1):
            gt.append(f"{f + 1},{tid},{x},{y},{w},{h},1,1,1.0")
            anns.append({"id": len(anns), "image_id": f, "category_id": 1,
                         "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0,
                         "track_id": tid})
        for (x, y, w, h) in _kine_dets_at(f):
            det.append(f"{f + 1},-1,{x},{y},{w},{h},0.95,-1,-1")
            det_anns.append({"id": len(det_anns), "image_id": f,
                             "category_id": 1, "bbox": [x, y, w, h],
                             "area": w * h, "iscrowd": 0, "confidence": 0.95})
    (seq_dir / "gt" / "gt.txt").write_text("\n".join(gt) + "\n")
    (seq_dir / "det" / "det.txt").write_text("\n".join(det) + "\n")
    ann_dir = root / "coco" / "annotations"
    ann_dir.mkdir(parents=True)
    coco = {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "person"}],
            "sequences": [KINE_SEQ]}
    (ann_dir / "train.json").write_text(json.dumps(coco))
    (ann_dir / "det_train.json").write_text(
        json.dumps({**coco, "annotations": det_anns}))


def kine_cfg(gate: str, root) -> object:
    """The JAX KineT gate's training config over the scene at ``root``."""
    common = dict(
        dataset="mot_kine", mot_path_train=str(Path(root) / "coco"),
        mot_path_val=str(Path(root) / "coco"), hidden_dim=64, nheads=2,
        dim_feedforward=128, max_objects=6, max_number_detection=8,
        max_track_queries=8, track_prev_frame_range=3, tracking=True,
        dropout=0.0, batch_size=4, num_workers=1, lr=5e-4, weight_decay=0.0,
        clip_max_norm=0.1, ratio_add_tracklets=1.0,
        kine_random_tracklet_count=True, ratio_add_detections=0.5,
    )
    if gate == "kine":
        return load_config("train.yaml", named=["train_kinet2"]).replace(
            encoding_dim_tracklets=4, use_encoding_tracklets=True, **common)
    return load_config("train.yaml", named=["train_kinet"]).replace(
        num_queries=50, **common)


def train_kine(gate: str, root, device) -> tuple:
    """Trains a KineT gate's model on the scene written at ``root``;
    returns (model in eval mode, optimizer, cfg, last loss, seconds)."""
    steps = KINE_STEPS[gate]
    cfg = kine_cfg(gate, root)
    # the dataset draws its augmentation base seed from the global numpy
    # state when it is built
    np.random.seed(0)
    dataset = build_dataset("train", cfg)
    model, _ = build_model(cfg, device=device, seed=0)
    model.train()
    optimizer = Optimizer(model, cfg, steps_per_epoch=10_000)
    step = make_kine_train_step(model, build_criterion(cfg), optimizer, cfg,
                                generator=torch.Generator().manual_seed(1))
    loader = DataLoader(
        dataset, batch_size=int(cfg.batch_size),
        sampler=RandomSampler(dataset, seed=0), buckets=cfg.size_buckets,
        max_objects=int(cfg.max_objects), num_workers=1,
        collate_fn=kine_collate(cfg))
    t0, it, loss = time.perf_counter(), 0, None
    while it < steps:
        for batch in loader:
            if it >= steps:
                break
            loss = float(step(batch)["loss"])
            it += 1
    train_s = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise FloatingPointError(f"the last training loss is {loss}")
    model.eval()
    return model, optimizer, cfg, loss, train_s


def kine_track_cfg(root, model_dir, out_dir, device, **over):
    """``track_kinet.yaml`` over the scene with the JAX gate's tracker
    settings (score thresholds 0.3, detection NMS 0.5, boxes snapped to the
    public detections)."""
    return load_config("track_kinet.yaml").replace(
        obj_detect_checkpoint_dir=str(model_dir), data_root_dir=str(root),
        dataset_name=KINE_SEQ, output_dir=str(out_dir), device=str(device),
        **{"tracker_cfg.detection_obj_score_thresh": 0.3,
           "tracker_cfg.track_obj_score_thresh": 0.3,
           "tracker_cfg.detection_nms_thresh": 0.5,
           "tracker_cfg.snap_to_detections": True, **over})


def run_kine(gate: str = "kine", device=None) -> dict:
    """A KineT gate (``kine``: encoder-only, ``kine_dual``: dual-stream):
    train, save the run, ``main_track`` from it; returns the scores
    ({mota, idf1, num_switches, last_loss, train_s, ms_per_step, ...})."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_kine_scene(tmp / "data")
        model, optimizer, cfg, loss, train_s = train_kine(
            gate, tmp / "data", device)
        save_config(cfg, tmp / "model")
        CheckpointManager(str(tmp / "model")).save_epoch(
            model, optimizer, KINE_STEPS[gate], 0)
        summary = main_track(kine_track_cfg(
            tmp / "data", tmp / "model", tmp / "results", device))
    m = summary[KINE_SEQ]
    steps = KINE_STEPS[gate]
    return {**{k: m[k] for k in ("mota", "idf1", "num_switches",
                                 "num_false_positives", "num_misses")},
            "last_loss": loss, "train_s": train_s,
            "ms_per_step": 1e3 * train_s / steps, "steps": steps}


def misses(gate: str, scores: dict) -> list:
    """The thresholds of ``gate`` that ``scores`` miss (empty if none)."""
    lim = THRESHOLDS[gate]
    out = [f"{k} {scores[k]:.4f} <= {lim[k]}" for k in ("mota", "idf1")
           if not scores[k] > lim[k]]
    if scores["num_switches"] > lim["num_switches"]:
        out.append(f"num_switches {scores['num_switches']} > "
                   f"{lim['num_switches']}")
    if gate == "hard":
        if scores["num_reids"] < lim["num_reids"]:
            out.append(f"num_reids {scores['num_reids']} < {lim['num_reids']}")
        if not scores["identity_kept"]:
            out.append("the occluded object's identity was lost")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="synthetic-MOT accuracy gates")
    p.add_argument("--gate", choices=tuple(THRESHOLDS), default="simple")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.gate in KINE_STEPS:
        scores = run_kine(args.gate, device=args.device)
    else:
        run = run_simple if args.gate == "simple" else run_hard
        scores = run(device=args.device)
    missed = misses(args.gate, scores)
    print(json.dumps({"gate": args.gate, **scores, "missed": missed}))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
