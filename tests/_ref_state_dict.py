"""Reference-named state dicts for the importer's tests and chip_smoke.py.

``reference_state_dict(model, rng=None)`` writes a port model's tensors
under the names a reference TrackFormer / KineT checkpoint gives them (the
inverse of ``kinet_tpu_torch/tools/import_torch_weights.py``): each
attention block's q/k/v projections joined into ``in_proj``, Deformable
DETR's decoder norms 1 and 2 swapped, the segmentation wrapper's
``detector.`` prefix dropped. With ``rng`` (a numpy Generator) the values
are drawn from it (normal; running variances positive), else they are the
model's own. Imports neither JAX nor the JAX package: chip_smoke.py loads
this file too.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_MSDA = r"(sampling_offsets|attention_weights|value_proj|output_proj)"


def reference_name(name: str, deformable: bool) -> tuple[str, str | None]:
    """(reference name, q/k/v part or None) of port tensor ``name``; a
    q/k/v projection's reference name is its block's ``in_proj_*``."""
    name = re.sub(r"^detector\.", "", name)
    rules = [
        (r"backbone\.trunk\.(conv1|bn1)\.(\w+)$", r"backbone.0.body.\1.\2"),
        (r"backbone\.trunk\.layer(\d)_(\d+)\.(conv\d|bn\d)\.(\w+)$",
         r"backbone.0.body.layer\1.\2.\3.\4"),
        (r"backbone\.trunk\.layer(\d)_(\d+)\.downsample_conv\.(\w+)$",
         r"backbone.0.body.layer\1.\2.downsample.0.\3"),
        (r"backbone\.trunk\.layer(\d)_(\d+)\.downsample_bn\.(\w+)$",
         r"backbone.0.body.layer\1.\2.downsample.1.\3"),
        (r"kinet_backbone\.det_backbone\.(.+)$", r"backbone_det.0.layers.0.\1"),
        (r"kinet_backbone\.meta_backbone\.(.+)$",
         r"backbone_metadata.0.layers.0.\1"),
        (r"query_embed_det$", "query_embed_det.weight"),
        (r"query_embed_meta$", "query_embed_metadata.weight"),
        (r"query_embed$", "query_embed.weight"),
        (r"track_proj_det\.layer(\d)\.(\w+)$",
         r"input_proj_tracklets_det.layers.\1.\2"),
        (r"track_proj_meta\.layer(\d)\.(\w+)$",
         r"input_proj_tracklets_metadata.layers.\1.\2"),
        (r"(transformer\.(detection|metadata)_branch\..+)$", r"\1"),
        (r"(input_proj\.(weight|bias))$", r"\1"),
        (r"input_proj(\d+)\.(\w+)$", r"input_proj.\1.0.\2"),
        (r"input_proj_gn(\d+)\.(\w+)$", r"input_proj.\1.1.\2"),
        (r"(class_embed\.(weight|bias))$", r"\1"),
        (r"class_embed(\d+)\.(\w+)$", r"class_embed.\1.\2"),
        (r"bbox_embed\.layer(\d)\.(\w+)$", r"bbox_embed.layers.\1.\2"),
        (r"bbox_embed(\d+)\.layer(\d)\.(\w+)$", r"bbox_embed.\1.layers.\2.\3"),
        (r"((bbox_attention|mask_head)\..+)$", r"\1"),
        (r"(transformer\.level_embed)$", r"\1"),
        (r"(transformer\.(enc_output|pos_trans)(_norm)?\.\w+)$", r"\1"),
        (r"transformer\.reference_points_head\.(\w+)$",
         r"transformer.reference_points.\1"),
        (r"(transformer\.(transformer_\w+\.)?(encoder|decoder)\.norm\.\w+)$",
         r"\1"),
    ]
    for pat, rep in rules:
        if re.match(pat, name):
            return re.sub(pat, rep, name), None
    m = re.match(r"(transformer\.(?:transformer_\w+\.)?)(encoder|decoder)"
                 r"\.layer(\d+)\.(.+)$", name)
    if not m:
        raise KeyError(f"no reference name for {name}")
    pre, side, i, rest = m.groups()
    scope = f"{pre}{side}.layers.{i}"
    if re.match(rf"(self_attn|cross_attn)\.{_MSDA}\.\w+$", rest):
        return f"{scope}.{rest}", None
    m = re.match(r"(self_attn|cross_attn)\.(q|k|v|out)_proj\.(weight|bias)$",
                 rest)
    if m:
        attn, part, leaf = m.groups()
        base = "multihead_attn" if attn == "cross_attn" else attn
        if part == "out":
            return f"{scope}.{base}.out_proj.{leaf}", None
        return f"{scope}.{base}.in_proj_{leaf}", part
    if re.match(r"linear\d\.\w+$", rest):
        return f"{scope}.{rest}", None
    m = re.match(r"norm(\d)\.(\w+)$", rest)
    if m:
        n, leaf = m.groups()
        if side == "decoder" and deformable:
            n = {"1": "2", "2": "1", "3": "3"}[n]
        return f"{scope}.norm{n}.{leaf}", None
    raise KeyError(f"no reference name for {name}")


def reference_state_dict(model, rng=None) -> dict:
    """{reference name: CPU tensor} holding every parameter and buffer of
    the port ``model`` (in its dtype; float32 with ``rng``)."""
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    deformable = any("sampling_offsets" in n for n in tensors)
    out, parts = {}, {}
    for name, t in tensors.items():
        if rng is None:
            val = t.detach().cpu().clone()
        else:
            val = rng.normal(size=tuple(t.shape)).astype(np.float32)
            if name.endswith("running_var"):
                val = np.abs(val) + 0.5
            val = torch.from_numpy(val)
        ref, part = reference_name(name, deformable)
        if part is None:
            out[ref] = val
        else:
            parts.setdefault(ref, {})[part] = val
    for ref, qkv in parts.items():
        out[ref] = torch.cat([qkv["q"], qkv["k"], qkv["v"]], 0)
    return out
