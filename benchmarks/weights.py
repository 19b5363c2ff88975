"""Seeded random weights for a configuration, made on the device.

One draw of normal numbers from a ``torch.Generator`` on the device covers
every randomly initialised tensor; each tensor is its slice times its
scale, in the type it is served in. The scheme is the program's own
(LeCun-normal kernels, zero biases, unit norms, identity frozen batch
norm, N(0, 1) query and level embeddings, N(0, 0.02^2) sampling-offset
and attention-weight kernels over the directional offset prior, the focal
prior on the class biases), with every class but class 0 (person) pushed
down by 20, so that random heads detect people. The reference model's
parameter names and shapes are the list: the same state dict loads into
the program and, cast to float32, into the reference.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .reference.detr import FrozenBatchNorm, MSDeformAttn

PERSON_BIAS = -20.0  # added to every class bias but class 0's
BOX_SCALE = 0.01  # the last box layer's kernel scale (Deformable DETR: 0)


def offset_prior(n_heads, n_levels, n_points):
    """Sampling-offset bias: head h points at angle 2 pi h / M, point p at
    radius p + 1 (Deformable DETR's initialisation)."""
    th = torch.arange(n_heads, dtype=torch.float32) * (2.0 * math.pi / n_heads)
    grid = torch.stack([th.cos(), th.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    radius = torch.arange(1, n_points + 1, dtype=torch.float32)
    return (grid * radius[None, None, :, None]).reshape(-1)


def plan(model):
    """{parameter name: ("normal", std) | ("const", tensor)} for ``model``
    (a ``reference.detr.TrackFormer``)."""
    out, attn = {}, []
    for prefix, mod in model.named_modules():
        pre = prefix + "." if prefix else ""
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            out[pre + "weight"] = ("normal", 1.0 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                out[pre + "bias"] = ("const", 0.0)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            out[pre + "weight"] = ("const", 1.0)
            out[pre + "bias"] = ("const", 0.0)
        elif isinstance(mod, FrozenBatchNorm):
            for name, v in (("weight", 1.0), ("bias", 0.0),
                            ("running_mean", 0.0), ("running_var", 1.0)):
                out[pre + name] = ("const", v)
        if isinstance(mod, MSDeformAttn):
            attn.append((pre, mod))
    for pre, mod in attn:  # after their linears' defaults
        out[pre + "sampling_offsets.weight"] = ("normal", 0.02)
        out[pre + "sampling_offsets.bias"] = (
            "const", offset_prior(mod.m, mod.l, mod.p))
        out[pre + "attention_weights.weight"] = ("normal", 0.02)
    for i in range(model.n_dec):
        mlp = getattr(model, f"bbox_embed{i}")
        pre = f"bbox_embed{i}.layer{mlp.n - 1}."
        fan_in = getattr(mlp, f"layer{mlp.n - 1}").weight.shape[1]
        out[pre + "weight"] = ("normal", BOX_SCALE / math.sqrt(fan_in))
        if i == 0:  # the first layer's boxes start at sigmoid(-2) of the frame
            out[pre + "bias"] = ("const", torch.tensor([0.0, 0.0, -2.0, -2.0]))
    out["query_embed"] = ("normal", 1.0)
    out["transformer.level_embed"] = ("normal", 1.0)
    prior = -math.log((1 - 0.01) / 0.01)
    for i in range(model.n_dec):
        n = getattr(model, f"class_embed{i}").bias.numel()
        bias = torch.full((n,), prior + PERSON_BIAS)
        bias[0] = prior
        out[f"class_embed{i}.bias"] = ("const", bias)
    names = {n for n, _ in model.named_parameters()}
    if names != set(out):
        raise ValueError(f"no initialisation for {sorted(names - set(out))}")
    return out


def state_dict(model, seed: int, device, dtype) -> dict:
    """The weights of ``seed`` for ``model``'s parameters, on ``device`` in
    ``dtype``. The same seed on the same device gives the same values."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    how = plan(model)
    normal = [n for n in shapes if how[n][0] == "normal"]
    total = sum(math.prod(shapes[n]) for n in normal)
    gen = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n in normal:
        k = math.prod(shapes[n])
        out[n] = (draw[at:at + k].view(shapes[n]) * how[n][1]).to(dtype)
        at += k
    for n, (kind, v) in how.items():
        if kind == "const":
            t = torch.as_tensor(v, dtype=torch.float32)
            out[n] = t.to(device=device, dtype=dtype).expand(shapes[n]).clone()
    return out
