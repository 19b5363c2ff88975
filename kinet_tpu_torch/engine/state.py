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

Under tensor parallelism (``parallel/tp.py``; build the optimizer after
``shard_params_tp``) the AdamW moments of a sharded parameter are shards
too. The global norm counts each sharded parameter once, by its squared
shard norms summed over the model group, and each replicated parameter
once. ``state_dict`` holds the whole moments, gathered over the model
group, and ``load_state_dict`` takes whole moments and keeps the rank's
shards, so a checkpoint resumes on any number of model shards.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import mesh_of
from ..parallel.tp import _shard, sharded_dims
from ..tools.from_jax import flax_path
from ..utils.dist import all_gather_cat, all_reduce_sum, group_size

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
        self.mesh = mesh_of(model)
        dims = sharded_dims(model)
        # {id(parameter): its shard dimension} of the sharded parameters
        self.shard_dims = {id(p): dims[n] for n, p in named.items()
                           if n in dims}
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
        if self.shard_dims:
            sq = [torch.linalg.vector_norm(p.grad.float()) ** 2
                  for p in self.params if p.grad is not None]
            split = [id(p) in self.shard_dims
                     for p in self.params if p.grad is not None]
            sharded = torch.stack([q for q, s in zip(sq, split) if s]).sum()
            replicated = torch.stack([q for q, s in zip(sq, split)
                                      if not s]).sum()
            norm = torch.sqrt(all_reduce_sum(sharded, self.mesh.model_group)
                              + replicated)
        else:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float())
                             for g in grads])
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

    def _map_moments(self, adamw: dict, fn) -> dict:
        """``adamw`` (a ``torch.optim`` state dict) with ``fn(moment, shard
        dimension)`` applied to each moment of a sharded parameter."""
        ordered = [p for g in self.opt.param_groups for p in g["params"]]
        dims = {i: self.shard_dims[id(p)] for i, p in enumerate(ordered)
                if id(p) in self.shard_dims}
        if not dims:
            return adamw
        state = {i: {k: fn(v, dims[i]) if i in dims and k != "step" else v
                     for k, v in st.items()}
                 for i, st in adamw["state"].items()}
        return {**adamw, "state": state}

    def state_dict(self) -> dict:
        """The AdamW state with whole moments (collective under tensor
        parallelism: every rank of the model group calls it)."""
        group = self.mesh.model_group
        adamw = self._map_moments(self.opt.state_dict(),
                                  lambda v, d: all_gather_cat(v, d, group))
        return {"adamw": adamw, "num_updates": self.num_updates}

    def load_state_dict(self, state: dict):
        n, r = group_size(self.mesh.model_group), self.mesh.model_rank
        self.opt.load_state_dict(self._map_moments(
            state["adamw"], lambda v, d: _shard(v, d, n, r)))
        self.num_updates = int(state["num_updates"])
