"""Optimizer with the reference's parameter groups (port of
``kinet_tpu/engine/state.py``).

Groups (reference src/train.py:103-117), labelled by ``param_labels`` from
each parameter's flax path (``tools/from_jax.flax_path``), with the rules
of the JAX package's ``param_labels``:
- "frozen": every FrozenBatchNorm tensor, the stem convolution and
  ``layer1_*`` of the backbone: never updated, no weight decay;
- "backbone": the rest of the backbone, at ``lr_backbone``;
- "linear_proj": ``sampling_offsets`` / ``reference_points``, at
  ``lr * lr_linear_proj_mult``;
- "track": track-attention layers, at ``lr_track``;
- "base": everything else, at ``lr``.

Each trained group runs AdamW (optax's ``adamw`` defaults: betas 0.9 /
0.999, eps 1e-8, decoupled ``weight_decay``) with its rate dropped x0.1
from update ``lr_drop * steps_per_epoch`` on. Before the update, the
gradients are clipped to global norm ``clip_max_norm`` as
``optax.clip_by_global_norm`` does. As in the JAX package, where the
clipping is chained before the group split, the norm counts the gradients
of the frozen tensors too (upstream TrackFormer gives frozen tensors no
gradient, so its norm leaves them out).
"""
from __future__ import annotations

import torch
from torch import nn

from ..tools.from_jax import flax_path

GROUPS = ("base", "backbone", "linear_proj", "track")


def param_label(path: str, freeze_detr: bool = False) -> str:
    """The optimizer group of the flax path ``path`` ("a/b/c")."""
    segs = path.split("/")
    if freeze_detr:
        return "base" if ("bbox_attention" in path or "mask_head" in path) \
            else "frozen"
    if any(s in ("bn1", "bn2", "bn3", "downsample_bn") for s in segs):
        return "frozen"
    if "backbone" in path:
        if "conv1" in segs and not any(s.startswith("layer") for s in segs):
            return "frozen"
        if any(s.startswith("layer1_") for s in segs):
            return "frozen"
        return "backbone"
    if "sampling_offsets" in path or "reference_points" in path:
        return "linear_proj"
    if "track_layer" in path:
        return "track"
    return "base"


def param_labels(model: nn.Module, cfg=None) -> dict[str, str]:
    """{port parameter name: group}."""
    freeze_detr = bool(cfg is not None and cfg.get("masks")
                       and cfg.get("freeze_detr"))
    return {
        name: param_label("/".join(("params",) + flax_path(model, name)),
                          freeze_detr)
        for name, _ in model.named_parameters()
    }


class Optimizer:
    """Global-norm clipping + one AdamW per parameter group.

    ``step()`` clips the gradients of every parameter (frozen ones
    included), then updates the trained groups; the frozen parameters keep
    their values. ``state_dict`` / ``load_state_dict`` carry the AdamW
    moments and the update count."""

    def __init__(self, model: nn.Module, cfg, steps_per_epoch: int = 1000):
        labels = param_labels(model, cfg)
        named = dict(model.named_parameters())
        self.params = list(named.values())
        self.clip_max_norm = float(cfg.clip_max_norm)
        self.drop_step = int(cfg.lr_drop) * int(steps_per_epoch)
        base_lr = {
            "base": cfg.lr,
            "backbone": cfg.lr_backbone,
            "linear_proj": cfg.lr * cfg.lr_linear_proj_mult,
            "track": cfg.get("lr_track", cfg.lr),
        }
        groups = [
            {"params": [named[n] for n, g in labels.items() if g == group],
             "lr": float(base_lr[group]), "base_lr": float(base_lr[group]),
             "name": group}
            for group in GROUPS
        ]
        self.opt = torch.optim.AdamW(
            [g for g in groups if g["params"]], betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(cfg.weight_decay),
        )
        self.num_updates = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def clip_grads(self) -> torch.Tensor:
        """optax.clip_by_global_norm over every gradient; returns the norm
        before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
        )
        if self.clip_max_norm > 0:
            scale = torch.where(norm < self.clip_max_norm,
                                torch.ones_like(norm),
                                self.clip_max_norm / norm)
            torch._foreach_mul_(grads, scale)
        return norm

    def step(self) -> torch.Tensor:
        """Clip, then one AdamW update at this update's rates. Returns the
        global gradient norm before clipping. A parameter that got no
        gradient takes a zero one, as every leaf does under ``jax.grad``:
        its moments decay and its weight decay applies."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = self.clip_grads()
        drop = 0.1 if self.num_updates >= self.drop_step else 1.0
        for g in self.opt.param_groups:
            g["lr"] = g["base_lr"] * drop
        self.opt.step()
        self.num_updates += 1
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.opt.state_dict(), "num_updates": self.num_updates}

    def load_state_dict(self, state: dict):
        self.opt.load_state_dict(state["adamw"])
        self.num_updates = int(state["num_updates"])
