"""Evaluation during training (port of the detection and tracking
branches of ``kinet_tpu/engine/evaluate.py``; reference:
src/trackformer/engine.py:179-364).

- detection: the model's forward and the criterion over the val set in
  eval mode without gradients, every image included (the loader keeps a
  last, partial batch), the losses logged (the mask losses too, for a
  model with a mask head), the postprocessed boxes in each image's
  original size scored by the self-contained ``CocoEvaluator`` (masks are
  not scored, as in the JAX package);
- tracking (``tracking_eval`` with a tracking model): ``main_track`` with
  the live model on ``track.yaml`` over ``mot_path_val``
  (``tracking_eval_dataset`` names the sequences; MOTS20 sequences
  for a model with a mask head), on the evaluation's device.

KineT configs batch with ``collate_kine`` and run the model on the
detections with empty track slots (the reference zero-fills them at
evaluation); the tracking eval then runs the kinematic tracker.

Over several processes (``utils/dist.py``) each data group of the
model's mesh (``parallel/mesh.py``; every process is its own data group
without tensor parallelism) evaluates every data_world-th image from its
data_rank, and the evaluator merges the prediction shards
(``CocoEvaluator.synchronize_between_processes``; the ranks of a model
group give the same predictions), so every process scores the whole val
set; the tracking eval splits the sequences the same way. Every rank of a
model group steps the same images: the tensor-parallel forward's
collectives need all of them.

Returns {"coco_eval_bbox": the 12 COCO stats, "mota"?, "idf1"?}. The
model is left in the mode, and on the device, it had. Runs on the card
unless ``device="cpu"``.
"""
from __future__ import annotations

import torch

from ..config import load_config
from ..data.loader import DataLoader, RandomSampler
from ..models.build import resolve_device
from ..parallel.mesh import mesh_of
from ..utils.coco_eval import CocoEvaluator
from ..utils.logging import MetricLogger
from . import track
from .train_step import kine_batch, kine_collate, kine_targets


def evaluate(model, criterion, postprocessors, dataset_val, cfg, device=None):
    device = resolve_device(device)
    kine = bool(cfg.get("kine", False))
    n_track = int(cfg.max_track_queries) if cfg.tracking else 0
    mesh = mesh_of(model)
    loader = DataLoader(
        dataset_val,
        batch_size=int(cfg.batch_size),
        # each data group its shard (reference engine.py:259-264)
        sampler=RandomSampler(dataset_val, rank=mesh.data_rank,
                              world_size=mesh.data_world, seed=0),
        buckets=cfg.size_buckets,
        max_objects=int(cfg.max_objects),
        num_track_queries=n_track,
        hidden_dim=int(cfg.hidden_dim),
        num_workers=int(cfg.num_workers),
        drop_last=False,
        collate_fn=kine_collate(cfg),
    )
    post = postprocessors["bbox"]
    mode, where = model.training, next(model.parameters()).device
    model.to(device).eval()
    try:
        evaluator = CocoEvaluator(dataset_val.coco)
        logger = MetricLogger(print_freq=int(cfg.log_interval),
                              debug=bool(cfg.debug))
        for batch in logger.log_every(loader, "Eval"):
            # boxes in each image's original size (reference
            # engine.py:203-255)
            sizes = torch.from_numpy(batch["orig_sizes"]).to(device)
            if kine:
                inputs = (kine_batch(batch, device),
                          kine_targets(batch, cfg, device, n_track))
            else:
                inputs = (batch["image"].to(device),
                          batch["target"].to(device))
            with torch.no_grad():
                out = model(*inputs, aux_outputs=True)
                losses = criterion(out, inputs[1])
                results = post(out, sizes)
            logger.update(**{k: float(v) for k, v in losses.items()})
            res = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                   for k, v in results.items()
                   if k in ("boxes", "scores", "labels")}
            evaluator.update({
                int(img_id): {k: v[i] for k, v in res.items()}
                for i, img_id in enumerate(batch["image_ids"].tolist())
            })
        evaluator.synchronize_between_processes()
        evaluator.accumulate()
        stats = {"coco_eval_bbox": evaluator.summarize()}

        if cfg.get("tracking_eval", False) and cfg.tracking:
            overrides = {}
            if cfg.get("tracking_eval_dataset"):
                # e.g. 'MOT17-TRAIN-ALL' or a single sequence; the
                # track.yaml default (MOT17-ALL-ALL) needs every standard
                # sequence under mot_path_val
                overrides["dataset_name"] = cfg.tracking_eval_dataset
            track_cfg = load_config("track.yaml").replace(
                data_root_dir=cfg.mot_path_val, output_dir="",
                device=str(device), **overrides,
            )
            summary = track.main_track(
                track_cfg, obj_detector_model=(model, postprocessors, cfg))
            if summary:
                overall = summary.get("OVERALL") or next(iter(summary.values()))
                stats["mota"] = overall["mota"]
                stats["idf1"] = overall["idf1"]
    finally:
        model.to(where).train(mode)
    return stats
