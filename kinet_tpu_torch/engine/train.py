"""Training entry point (port of ``kinet_tpu/engine/train.py``; reference
src/train.py + src/trackformer/engine.py).

    python -m kinet_tpu_torch.engine.train --config train.yaml \\
        --named train_deformable train_tracking train_multi_frame -- \\
        dataset=mot mot_path_train=data/MOT17 val_interval=0 output_dir=runs/exp1

(``--`` ends the ``--named`` list; ``--device cpu`` trains on the CPU.)

- config composition, dumped to output_dir/config.yaml;
- the model, its criterion and the optimizer with the reference's
  parameter groups;
- the MOT dataset, the 1/seq_length weighted sampler and the loader;
- resume (``resume``, ``resume_optim``);
- the epoch loop of tracking train steps, a checkpoint every epoch.

Runs on the card (``device=None``); ``train(cfg, device="cpu")`` runs on
the CPU. What the JAX trainer does that is not ported yet raises
NotImplementedError naming its ROADMAP item: evaluation
(``val_interval > 0``), a metrics sink, a device mesh of more than one
device, KineT, and datasets other than ``mot``.
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from ..config import load_config, parse_cli_overrides, save_config
from ..data.builder import build_dataset
from ..data.loader import DataLoader, WeightedRandomSampler
from ..models.build import (
    build_criterion,
    build_model,
    not_ported,
    resolve_device,
)
from ..utils.checkpoint import CheckpointManager, load_for_resume
from ..utils.logging import MetricLogger
from .state import Optimizer
from .train_step import make_train_step


def _check_supported(cfg, device: torch.device):
    if cfg.get("kine", False):
        not_ported("KineT training", "KineT")
    if int(cfg.val_interval) > 0:
        not_ported("evaluation during training (val_interval > 0)",
                    "Evaluation")
    if cfg.get("metrics_sink"):
        not_ported("the metrics sink", "Evaluation")
    n_model, n_data = int(cfg.mesh.model), int(cfg.mesh.data)
    if n_data == -1:
        n_data = torch.cuda.device_count() if device.type == "cuda" else 1
    n_data = math.gcd(n_data, int(cfg.batch_size)) or 1
    if n_model * n_data > 1:
        not_ported(f"a device mesh of {n_data} x {n_model} devices",
                    "Scale-out")


def to_device(x, device):
    return None if x is None else x.to(device)


def train(cfg, device=None):
    """Trains as the config says; returns (model, optimizer, step)."""
    device = resolve_device(device)
    _check_supported(cfg, device)
    if cfg.output_dir:
        save_config(cfg, cfg.output_dir)
    seed = int(cfg.seed)
    np.random.seed(seed)  # the datasets' augmentation base seed

    model, _ = build_model(cfg, device=device, seed=seed)
    criterion = build_criterion(cfg)
    dataset = build_dataset("train", cfg)
    sampler = WeightedRandomSampler(dataset, seed=seed)
    loader = DataLoader(
        dataset, batch_size=int(cfg.batch_size), sampler=sampler,
        buckets=cfg.size_buckets, max_objects=int(cfg.max_objects),
        num_track_queries=int(cfg.max_track_queries) if cfg.tracking else 0,
        hidden_dim=int(cfg.hidden_dim), num_workers=int(cfg.num_workers),
    )
    steps_per_epoch = max(len(loader), 1)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.2f}M on {device}", flush=True)

    optimizer = Optimizer(model, cfg, steps_per_epoch)
    start_epoch, step = load_for_resume(cfg, model, optimizer)
    model.train()
    step_fn = make_train_step(
        model, criterion, optimizer, cfg,
        generator=torch.Generator().manual_seed(seed),
    )
    ckpt = (CheckpointManager(cfg.output_dir, int(cfg.save_model_interval))
            if cfg.output_dir else None)

    for epoch in range(start_epoch, int(cfg.epochs) + 1):
        sampler.set_epoch(epoch)
        dataset.set_epoch(epoch)  # fresh, run-deterministic augmentations
        logger = MetricLogger(print_freq=int(cfg.log_interval),
                              debug=bool(cfg.debug))
        for batch in logger.log_every(loader, f"Epoch [{epoch}]"):
            losses = step_fn(*(to_device(batch[k], device) for k in (
                "image", "target", "prev_image", "prev_target",
                "prev_prev_image", "prev_prev_target")))
            step += 1
            scalars = {k: float(v) for k, v in losses.items()}
            if not math.isfinite(scalars["loss"]):
                print("Loss is NaN, stopping (reference engine.py:140-143)")
                sys.exit(1)
            logger.update(**scalars)
        if ckpt is not None:
            ckpt.save_epoch(model, optimizer, step, epoch)
        if cfg.debug:
            break
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
