"""Training entry point (port of ``kinet_tpu/engine/train.py``; reference
src/train.py + src/trackformer/engine.py).

    python -m kinet_tpu_torch.engine.train --config train.yaml \\
        --named train_deformable train_tracking train_multi_frame \\
        train_mot17_crowdhuman -- mot_path_train=data/MOT17 \\
        mot_path_val=data/MOT17 crowdhuman_path=data/CrowdHuman \\
        output_dir=runs/exp1

(``--`` ends the ``--named`` list; ``--device cpu`` trains on the CPU.)

- config composition, dumped to output_dir/config.yaml;
- the model, its criterion and the optimizer with the reference's
  parameter groups;
- the dataset (``data/builder.py``), the weighted sampler where it has
  sample weights (MOT: 1 / seq_length), else a random one, and the loader;
- resume (``resume``, ``resume_optim``);
- the epoch loop of tracking train steps; every ``val_interval`` epochs
  the evaluation (``engine/evaluate.py``: COCO AP and, with
  ``tracking_eval``, MOTA / IDF1), appended to output_dir/metrics.jsonl;
  a checkpoint every epoch and ``checkpoint_best_{metric}.pth`` on each
  improvement; the loss and eval curves (``utils/vis.py``) and the
  ``metrics_sink`` stream.

KineT configs (``kine``, dataset ``mot_kine``) batch with ``collate_kine``
and step with ``make_kine_train_step``.

Runs on the card (``device=None``); ``train(cfg, device="cpu")`` runs on
the CPU.

Over processes (``tools/launch.py`` starts one per card) the run lays the
("data", "model") mesh of ``parallel/mesh.py`` over the group: ``mesh.data``
x ``mesh.model`` must be the process count (``mesh.data`` -1: every
process over ``mesh.model``). Each model group (``mesh.model`` consecutive
ranks) holds one tensor-parallel model (``parallel/tp.py``: the sharded
modules are swapped in before the optimizer is built, so the AdamW
moments are shards too) and steps the same samples: the samplers shard
the data by (data_rank, data_world), and ``np.random`` is seeded with
``seed + data_rank``, so every rank of a model group augments the same
samples; the dropout generator is seeded alike on every rank, so the
replicated activations get identical masks. The step averages the
gradients over the data group (``engine/train_step.py``), so all apply
the same update. With ``mesh.model`` 1 this is plain data parallelism.
Checkpoints hold whole tensors (``utils/checkpoint.py``); only rank 0
writes the config, the checkpoints, the metrics and the curves, and only
rank 0 prints.

Preemption: once a step, the loop polls ``utils/preempt.py``'s flag (on
any process: the flag is reduced over the group); when it is up, rank 0
saves a mid-epoch checkpoint recorded as the previous epoch
(``CheckpointManager.save_preempt``) and ``train`` returns, for the
launcher to requeue and resume.
"""
from __future__ import annotations

import argparse
import json
import math
import os.path as osp
import sys

import numpy as np
import torch

from ..config import load_config, parse_cli_overrides, save_config
from ..data.builder import build_dataset
from ..data.loader import DataLoader, RandomSampler, WeightedRandomSampler
from ..models.build import build_criterion, build_model, resolve_device
from ..parallel.mesh import make_mesh
from ..parallel.tp import shard_params_tp
from ..utils import dist, preempt
from ..utils.checkpoint import CheckpointManager, load_for_resume
from ..utils.logging import MetricLogger
from ..utils.vis import build_visualizers
from .evaluate import evaluate
from .state import Optimizer
from .train_step import kine_collate, make_kine_train_step, make_train_step


def _preempted() -> bool:
    """The preemption flag of any process of the group."""
    flag = torch.tensor(float(preempt.requested()))
    return bool(dist.mean_over_processes(flag) > 0)


def to_device(x, device):
    return None if x is None else x.to(device)


def train(cfg, device=None):
    """Trains as the config says; returns (model, optimizer, step)."""
    device = resolve_device(device)
    mesh = make_mesh(int(cfg.mesh.data), int(cfg.mesh.model))
    main = dist.is_main_process()
    dist.setup_for_distributed(main)
    if cfg.output_dir and main:
        save_config(cfg, cfg.output_dir)
    seed = int(cfg.seed)
    # the datasets' augmentation base seed: one per model group
    np.random.seed(seed + mesh.data_rank)

    model, postprocessors = build_model(cfg, device=device, seed=seed)
    shard_params_tp(model, mesh)
    criterion = build_criterion(cfg)
    dataset = build_dataset("train", cfg)
    sampler = (WeightedRandomSampler if hasattr(dataset, "sample_weight")
               else RandomSampler)(dataset, rank=mesh.data_rank,
                                   world_size=mesh.data_world, seed=seed)
    loader = DataLoader(
        dataset, batch_size=int(cfg.batch_size), sampler=sampler,
        buckets=cfg.size_buckets, max_objects=int(cfg.max_objects),
        num_track_queries=int(cfg.max_track_queries) if cfg.tracking else 0,
        hidden_dim=int(cfg.hidden_dim), num_workers=int(cfg.num_workers),
        collate_fn=kine_collate(cfg),
    )
    steps_per_epoch = max(len(loader), 1)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.2f}M on {device}", flush=True)

    optimizer = Optimizer(model, cfg, steps_per_epoch)
    start_epoch, step = load_for_resume(cfg, model, optimizer)
    model.train()
    kine = bool(cfg.get("kine", False))
    step_fn = (make_kine_train_step if kine else make_train_step)(
        model, criterion, optimizer, cfg,
        generator=torch.Generator().manual_seed(seed),
    )
    # every rank saves (the tensor-parallel gathers are collective); rank 0
    # alone writes
    ckpt = (CheckpointManager(cfg.output_dir, int(cfg.save_model_interval))
            if cfg.output_dir else None)
    visualizers = build_visualizers(cfg) if main else {"train": {}}
    iter_vis = visualizers["train"].get("iter_metrics")
    epoch_vis = visualizers["train"].get("epoch_metrics")

    for epoch in range(start_epoch, int(cfg.epochs) + 1):
        sampler.set_epoch(epoch)
        if hasattr(dataset, "set_epoch"):
            dataset.set_epoch(epoch)  # fresh, run-deterministic augmentations
        logger = MetricLogger(print_freq=int(cfg.log_interval),
                              debug=bool(cfg.debug))
        for batch in logger.log_every(loader, f"Epoch [{epoch}]"):
            if kine:
                losses = step_fn(batch)
            else:
                losses = step_fn(*(to_device(batch[k], device) for k in (
                    "image", "target", "prev_image", "prev_target",
                    "prev_prev_image", "prev_prev_target")))
            step += 1
            scalars = dist.reduce_dict({k: float(v) for k, v in losses.items()})
            if not math.isfinite(scalars["loss"]):
                print("Loss is NaN, stopping (reference engine.py:140-143)")
                sys.exit(1)
            logger.update(**scalars)
            if iter_vis is not None:
                iter_vis.plot([scalars.get(k, 0.0) for k in (
                    "loss", "loss_ce", "loss_bbox", "loss_giou")], step)
            if _preempted():
                # the resumed run runs this epoch again (save_preempt)
                if ckpt is not None:
                    ckpt.save_preempt(model, optimizer, step, epoch)
                print(f"preemption requested: checkpoint saved at step "
                      f"{step}; the requeued run resumes in epoch {epoch}")
                return model, optimizer, step

        eval_stats = None
        if (int(cfg.val_interval) > 0 and epoch % int(cfg.val_interval) == 0
                and not cfg.eval_only):
            try:
                stats = evaluate(model, criterion, postprocessors,
                                 build_dataset("val", cfg), cfg, device=device)
                eval_stats = {
                    "AP": stats["coco_eval_bbox"][0],
                    "AP50": stats["coco_eval_bbox"][1],
                    "mota": stats.get("mota"),
                    "idf1": stats.get("idf1"),
                }
                if cfg.output_dir and main:
                    with open(osp.join(cfg.output_dir, "metrics.jsonl"),
                              "a") as f:
                        f.write(json.dumps({"epoch": epoch, **eval_stats})
                                + "\n")
            except FileNotFoundError as e:
                print(f"eval skipped (no val data): {e}")
        if ckpt is not None:
            ckpt.save_epoch(model, optimizer, step, epoch, eval_stats)
        if epoch_vis is not None and eval_stats:
            epoch_vis.plot([float(eval_stats.get(k) or 0.0)
                            for k in ("AP", "AP50", "mota", "idf1")], epoch)
            epoch_vis.save()
        if iter_vis is not None:
            iter_vis.save()
        if cfg.debug:
            break
    if visualizers.get("sink") is not None:
        visualizers["sink"].close()
    return model, optimizer, step


def main(argv=None):
    p = argparse.ArgumentParser(description="kinet_tpu_torch training")
    p.add_argument("--config", default="train.yaml")
    p.add_argument("--named", nargs="*", default=[])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("overrides", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = load_config(args.config, named=args.named,
                      overrides=parse_cli_overrides(args.overrides))
    return train(cfg, device=args.device)


if __name__ == "__main__":
    main()
