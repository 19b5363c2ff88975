"""Synthetic MOT scenes: the port's own copy of
``kinet_tpu/data/synthetic.py`` (the same scenes, pixels and detections),
with ``scene_frame_tensors`` giving torch tensors.

No real MOT17 data or trained checkpoint is in the repo, so the accuracy
gates train on a synthetic scene that has the failure modes MOTA and IDF1
punish on real data:

- **path crossings**: objects moving in opposite directions pass through
  each other — ID-switch pressure on the track-query association,
- **K-frame occlusions**: an object disappears behind a pillar long
  enough to terminate its track, then reappears — forces the inactive →
  reid machinery (reference tracker.py:170-267),
- **noisy public detections**: jittered boxes, dropped detections, and
  spurious false positives in the det file — exercises the
  public-detection filtering (reference tracker.py:127-168).

The scene is parametric (frame count, resolution, object count).

Scene geometry: K objects in horizontal linear motion, alternating
directions with vertically interleaved rows so opposite-direction
neighbors cross mid-sequence; one vertical pillar occludes the last
object's row band ("deep" occlusion: the object is fully hidden while
its box overlaps the pillar's x-range).
"""
from __future__ import annotations

import colorsys
import configparser
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


@dataclass
class SceneObject:
    track_id: int  # 1-based (MOT convention)
    size: tuple  # (w, h) px
    row: int  # top y
    x0: float  # x at frame 0
    vx: float  # px / frame
    color: tuple  # RGB uint8

    def box_at(self, f: int) -> np.ndarray:
        """xywh (pixel, top-left) at frame f."""
        return np.array(
            [self.x0 + self.vx * f, self.row, *self.size], np.float32
        )


@dataclass
class Scene:
    n_frames: int
    h: int
    w: int
    objects: list
    pillar: Optional[tuple] = None  # (x0, x1, y0, y1) occluder rect
    background: int = 20
    pillar_color: int = 90
    # per-frame public detections: list of (box_xywh, score) incl. noise
    dets: list = field(default_factory=list)

    def visible(self, obj: SceneObject, f: int) -> bool:
        """Fully hidden while the box CENTER is inside the pillar columns
        (and the rows overlap) — a deep doorway/pole occlusion; approach
        frames show partial occlusion (the pillar renders over the box)."""
        if self.pillar is None:
            return True
        x, y, w, h = obj.box_at(f)
        px0, px1, py0, py1 = self.pillar
        in_rows = (y < py1) and (y + h > py0)
        cx = x + w / 2
        return not (in_rows and px0 <= cx <= px1)

    def gt_at(self, f: int) -> dict:
        """{track_id: xywh} of visible objects (hidden objects carry no GT
        row — the tracker should not report them)."""
        return {
            o.track_id: o.box_at(f)
            for o in self.objects
            if self.visible(o, f)
        }

    def render(self, f: int) -> np.ndarray:
        img = np.full((self.h, self.w, 3), self.background, np.uint8)
        for o in self.objects:
            if not self.visible(o, f):
                continue
            x, y, w, h = o.box_at(f)
            x, y = int(round(x)), int(round(y))
            img[max(y, 0) : y + int(h), max(x, 0) : x + int(w)] = o.color
        if self.pillar is not None:
            px0, px1, py0, py1 = (int(v) for v in self.pillar)
            img[py0:py1, px0:px1] = self.pillar_color
        return img

    def occlusion_spans(self) -> dict:
        """{track_id: (first_hidden, first_visible_again)} for objects that
        undergo a full occlusion (None entries filtered)."""
        spans = {}
        for o in self.objects:
            vis = [self.visible(o, f) for f in range(self.n_frames)]
            hidden = [f for f, v in enumerate(vis) if not v]
            if hidden and hidden[-1] + 1 < self.n_frames:
                spans[o.track_id] = (hidden[0], hidden[-1] + 1)
        return spans


def _palette(k: int) -> list:
    """k well-separated bright colors (golden-angle hues)."""
    cols = []
    for i in range(k):
        r, g, b = colorsys.hsv_to_rgb((i * 0.381966) % 1.0, 0.9, 0.95)
        cols.append((int(r * 255), int(g * 255), int(b * 255)))
    return cols


def hard_scene(
    n_frames: int = 24,
    h: int = 80,
    w: int = 128,
    n_objects: int = 3,
    obj_w: int = 22,
    obj_h: int = 26,
    speed: float = 4.0,
    pillar_w: int = 16,
    row_gap: int = 6,
    pillar_frac: float = 0.5,  # pillar center along the occludee's travel
    occ_speed: float | None = None,  # occludee speed (default 0.75 * speed)
    seed: int = 0,
    det_jitter: float = 2.0,
    det_drop: float = 0.08,
    det_spurious: float = 0.25,
) -> Scene:
    """The hard benchmark scene (see module docstring).

    Rows: objects 0..K-2 alternate direction in an interleaved band at the
    top (crossings); object K-1 moves L->R in its own bottom row behind a
    pillar (occlusion -> reid). Detection noise is seeded + deterministic,
    and an object's detection is never dropped on its reappearance frame
    or the one after (so reid timing is deterministic too).
    """
    assert n_objects >= 2
    rng = np.random.default_rng(seed)
    colors = _palette(n_objects)
    travel = speed * (n_frames - 1)
    objects = []
    # crossing band: alternate L->R / R->L, rows offset by row_gap px
    for i in range(n_objects - 1):
        ltr = i % 2 == 0
        row = 4 + row_gap * i
        x0 = 2.0 + 3.0 * i if ltr else (w - obj_w - 2.0 - 3.0 * i)
        objects.append(
            SceneObject(
                track_id=i + 1, size=(obj_w, obj_h), row=row,
                x0=x0, vx=speed if ltr else -speed, color=colors[i],
            )
        )
    # occluded object: own row, a bit larger and slower (the greedy
    # center-distance reid gate is dist^2 <= box area — size and speed
    # together bound the reappearance jump), L->R behind the pillar
    if occ_speed is None:
        occ_speed = speed * 0.75
    ow, oh = obj_w + 4, obj_h + 4
    occ_row = 4 + row_gap * (n_objects - 1) + obj_h + 4
    assert occ_row + oh <= h, "scene height too small for object count"
    occ_travel = occ_speed * (n_frames - 1)
    objects.append(
        SceneObject(
            track_id=n_objects, size=(ow, oh), row=occ_row,
            x0=2.0, vx=occ_speed, color=colors[-1],
        )
    )
    # pillar over the occluded object's row band, at pillar_frac of its path
    px0 = int(2.0 + ow / 2 + occ_travel * pillar_frac - pillar_w / 2)
    pillar = (px0, px0 + pillar_w, occ_row - 4, min(h, occ_row + oh + 4))
    scene = Scene(n_frames=n_frames, h=h, w=w, objects=objects, pillar=pillar)

    # public detections: GT + jitter, with drops and spurious boxes
    reappear = {tid: span[1] for tid, span in scene.occlusion_spans().items()}
    for f in range(n_frames):
        frame_dets = []
        for o in objects:
            if not scene.visible(o, f):
                continue
            protected = f in (
                reappear.get(o.track_id, -99),
                reappear.get(o.track_id, -99) + 1,
            ) or f == 0
            if not protected and rng.uniform() < det_drop:
                continue
            box = o.box_at(f).copy()
            box[:2] += rng.uniform(-det_jitter, det_jitter, 2)
            box[2:] += rng.uniform(-det_jitter / 2, det_jitter / 2, 2)
            frame_dets.append((box, float(rng.uniform(0.7, 0.99))))
        if rng.uniform() < det_spurious:
            frame_dets.append(
                (
                    np.array(
                        [
                            rng.uniform(0, w - obj_w),
                            rng.uniform(0, h - obj_h),
                            obj_w * rng.uniform(0.8, 1.2),
                            obj_h * rng.uniform(0.8, 1.2),
                        ],
                        np.float32,
                    ),
                    float(rng.uniform(0.7, 0.99)),
                )
            )
        scene.dets.append(frame_dets)
    return scene


def write_mot17_sequence(root, seq_name: str, scene: Scene):
    """Write the scene as a MOT17 sequence dir (img1/ gt/ det/ seqinfo.ini)
    so the standard sequence dataset + main_track can consume it."""
    import os
    import os.path as osp

    from PIL import Image

    seq_dir = osp.join(root, "MOT17", "train", seq_name)
    for d in ("img1", "gt", "det"):
        os.makedirs(osp.join(seq_dir, d), exist_ok=True)
    os.makedirs(osp.join(root, "MOT17", "test"), exist_ok=True)
    cfgp = configparser.ConfigParser()
    cfgp["Sequence"] = {
        "name": seq_name, "imDir": "img1", "frameRate": "30",
        "seqLength": str(scene.n_frames), "imWidth": str(scene.w),
        "imHeight": str(scene.h), "imExt": ".jpg",
    }
    with open(osp.join(seq_dir, "seqinfo.ini"), "w") as fh:
        cfgp.write(fh)
    gt_lines, det_lines = [], []
    for f in range(scene.n_frames):
        Image.fromarray(scene.render(f)).save(
            osp.join(seq_dir, "img1", f"{f + 1:06d}.jpg")
        )
        for tid, (x, y, w, h) in scene.gt_at(f).items():
            gt_lines.append(
                f"{f + 1},{tid},{x:.2f},{y:.2f},{w:.2f},{h:.2f},1,1,1.0"
            )
        for box, score in scene.dets[f]:
            x, y, w, h = box
            det_lines.append(
                f"{f + 1},-1,{x:.2f},{y:.2f},{w:.2f},{h:.2f},{score:.2f},-1,-1"
            )
    with open(osp.join(seq_dir, "gt", "gt.txt"), "w") as fh:
        fh.write("\n".join(gt_lines) + "\n")
    with open(osp.join(seq_dir, "det", "det.txt"), "w") as fh:
        fh.write("\n".join(det_lines) + "\n")
    return seq_dir


# ImageNet normalization (reference datasets/transforms.py Normalize)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def scene_frame_tensors(scene, f: int, *, hidden_dim: int, n_slots: int,
                        n_track_queries: int):
    """One scene frame as (ImageBatch, Targets) train-step inputs on the
    CPU: the ImageNet-normalized image and up to ``n_slots`` GT boxes
    (normalized cxcywh, label 0, their track ids)."""
    from ..structs import ImageBatch, Targets

    img = scene.render(f).astype(np.float32) / 255.0
    img = (img - IMAGENET_MEAN) / IMAGENET_STD
    gt = scene.gt_at(f)
    boxes = np.full((n_slots, 4), 0.5, np.float32)
    valid = np.zeros((n_slots,), bool)
    tids = np.zeros((n_slots,), np.int64)
    for i, (tid, (x, y, w, h)) in enumerate(sorted(gt.items())):
        boxes[i] = [
            (x + w / 2) / scene.w, (y + h / 2) / scene.h,
            w / scene.w, h / scene.h,
        ]
        valid[i] = True
        tids[i] = tid
    batch = ImageBatch(
        torch.from_numpy(img)[None],
        torch.zeros((1, scene.h, scene.w), dtype=torch.bool),
    )
    targets = Targets.create(
        torch.from_numpy(boxes)[None], torch.zeros((1, n_slots)),
        torch.from_numpy(valid)[None], track_ids=torch.from_numpy(tids)[None],
        num_track_queries=n_track_queries, hidden_dim=hidden_dim,
    )
    return batch, targets


class SceneGTSeq:
    """Minimal sequence view over a Scene for get_mot_accum: len() +
    per-frame GT xyxy dicts."""

    def __init__(self, scene):
        self.data = []
        for f in range(scene.n_frames):
            gt = {}
            for tid, (x, y, w, h) in scene.gt_at(f).items():
                gt[tid] = np.array([x, y, x + w, y + h], np.float32)
            self.data.append({"gt": gt})

    def __len__(self):
        return len(self.data)
