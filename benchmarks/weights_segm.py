"""Seeded random weights for the MOTS20 configuration (vanilla DETR with
the mask head), made on the device.

The scheme of ``weights.py`` (one draw of normal numbers from a
``torch.Generator`` on the device; LeCun-normal kernels, zero biases, unit
norms, identity frozen batch norm, N(0, 1) query embeddings; each class
bias but class 0's (person) pushed down by 20 and the box sizes' bias at
-2, so that random heads detect people of a person's size), over
``reference.detr_segm.DetrSegm``'s parameters, whose names the program's
``SegmWrapper(DETR)`` shares. ``weights.py`` knows only the deformable
model's heads.

At LeCun's scale alone every decoder row is the same to 1e-3, so every
box is the same box and the tracker's NMS keeps one track a frame: a
frozen backbone's ReLU features share a large positive mean, each
encoder and decoder layer adds a shared vector of its own (near-uniform
attention, the FFN's ReLU), and the track slots, whose embeddings share
it, collapse onto one box. So, as a trained model's weights would keep
rows apart:

- the input projection's bias centres the C5 feature of the seed's first
  frame (``c5_mean``: its mean over positions, as the plain reference's
  float32 backbone gives it on the same weights, ``check_mots.c5_mean``;
  taken in float64 on the host), so that the program gives the reference
  no value of its own;
- the kernels whose output is added to the transformer's residual stream
  (each attention's ``out_proj``, each FFN's ``linear2``) are at
  ``RESIDUAL_SCALE`` times LeCun's scale;
- the query kernels of the decoder's attention are at ``QUERY_SCALE``
  times LeCun's scale, so that a decoder row attends to a few tokens (the
  encoder's stay at LeCun's: sharper attention there turns bfloat16's
  rounding into a tenth of the memory's norm);
- the attention map's query kernel is at ``ATTN_QUERY_SCALE`` times
  (each query's map peaks on a few positions) and the first mask
  convolution's kernel over the attention maps' channels at
  ``ATTN_CHANNEL_SCALE`` times (a peak weighs as much as the projected
  feature), so that each query's mask is its own.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .reference.detr import FrozenBatchNorm
from .weights import PERSON_BIAS

RESIDUAL_SCALE = 0.3
QUERY_SCALE = 16.0
ATTN_QUERY_SCALE = 4.0
ATTN_CHANNEL_SCALE = 100.0


def plan(model):
    """{parameter name: ("normal", std) | ("const", value)} for ``model``
    (a ``reference.detr_segm.DetrSegm``)."""
    out = {}
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
    out["detector.query_embed"] = ("normal", 1.0)
    n = model.detector.class_embed.bias.numel()
    bias = torch.full((n,), PERSON_BIAS)
    bias[0] = 0.0
    if not model.cfg["focal_loss"]:
        bias[-1] = 0.0  # the no-object class
    out["detector.class_embed.bias"] = ("const", bias)
    last = model.detector.bbox_embed.n - 1
    out[f"detector.bbox_embed.layer{last}.bias"] = (
        "const", torch.tensor([0.0, 0.0, -2.0, -2.0]))
    for name, p in model.named_parameters():
        lecun = 1.0 / math.sqrt(p[0].numel()) if p.dim() > 1 else 0.0
        if name.startswith("detector.transformer.") and name.endswith(
                ("out_proj.weight", "linear2.weight")):
            out[name] = ("normal", RESIDUAL_SCALE * lecun)
        if ".decoder." in name and name.endswith("q_proj.weight"):
            out[name] = ("normal", QUERY_SCALE * lecun)
    q = model.bbox_attention.q_linear.weight
    out["bbox_attention.q_linear.weight"] = (
        "normal", ATTN_QUERY_SCALE / math.sqrt(q.shape[1]))
    names = {n for n, _ in model.named_parameters()}
    if names != set(out):
        raise ValueError(f"no initialisation for {sorted(names - set(out))}")
    return out


def state_dict(model, seed: int, device, dtype, c5_mean=None) -> dict:
    """The weights of ``seed`` for ``model``'s parameters, on ``device`` in
    ``dtype``, the input projection centring ``c5_mean`` ([2048] or None:
    a zero bias). The same seed and mean on the same device give the same
    values."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    how = plan(model)
    normal = [n for n in shapes if how[n][0] == "normal"]
    total = sum(math.prod(shapes[n]) for n in normal)
    gen = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n in normal:
        k = math.prod(shapes[n])
        out[n] = draw[at:at + k].view(shapes[n]) * how[n][1]
        at += k
    lay1 = out["mask_head.lay1.weight"]
    d = model.d
    out["mask_head.lay1.weight"] = torch.cat(
        [lay1[:, :d], lay1[:, d:] * ATTN_CHANNEL_SCALE], 1)
    out = {n: t.to(dtype) for n, t in out.items()}
    for n, (kind, v) in how.items():
        if kind == "const":
            t = torch.as_tensor(v, dtype=torch.float32)
            out[n] = t.to(device=device, dtype=dtype).expand(shapes[n]).clone()
    if c5_mean is not None:
        w = out["detector.input_proj.weight"].flatten(1).cpu().double()
        bias = -(w @ torch.as_tensor(c5_mean).cpu().double())
        out["detector.input_proj.bias"] = bias.to(device=device, dtype=dtype)
    return out


def c5_mean(c5) -> torch.Tensor:
    """A frame's C5 feature [1, 2048, h, w] averaged over positions: [2048],
    float64, on the host."""
    return c5[0].flatten(1).double().mean(1).cpu()
