"""Reference (TrackFormer / KineT) checkpoint -> port model (port of
``kinet_tpu/tools/import_torch_weights.py``).

Loads a reference ``state_dict`` (TrackFormer's DETR naming; reference
train.py:176-243 reads the same names for its own resume surgery) into a
port model, the way the JAX package's importer fills its flax tree. Both
sides are PyTorch, so no layout changes: conv weights are [O, I, kH, kW]
and linear weights [O, I] on both. The work is the names:

- ``backbone.0.body.layer{l}.{b}.*`` -> ``backbone.trunk.layer{l}_{b}.*``
  (``downsample.0`` / ``.1`` -> ``downsample_conv`` / ``downsample_bn``);
- an attention block's ``in_proj_weight`` / ``in_proj_bias`` [3D, D] ->
  the rows of ``q_proj`` / ``k_proj`` / ``v_proj``, ``out_proj`` as it is;
  a vanilla decoder's ``multihead_attn`` -> ``cross_attn``;
- Deformable DETR's decoder norms: the reference's ``norm2`` follows the
  self-attention, ``norm1`` the cross-attention and ``norm3`` the FFN
  (deformable_transformer.py:333-355); the port numbers them in call
  order, so reference ``norm2`` -> port ``norm1`` and ``norm1`` ->
  ``norm2``;
- Deformable DETR's ``input_proj.{l}.{0,1}`` -> ``input_proj{l}`` /
  ``input_proj_gn{l}``, ``transformer.reference_points`` ->
  ``transformer.reference_points_head``, the per-layer heads
  ``class_embed.{i}`` / ``bbox_embed.{i}.layers.{j}`` -> ``class_embed{i}``
  / ``bbox_embed{i}.layer{j}``;
- the segmentation wrapper: the detector's tensors under ``detector.``,
  ``bbox_attention`` and ``mask_head`` at the top (the reference's
  DETRSegm state dict is flat, detr_segmentation.py:75-98);
- KineT: ``backbone_{det,metadata}.0.layers.0`` ->
  ``kinet_backbone.{det,meta}_backbone``, ``query_embed_{det,metadata}``,
  ``input_proj_tracklets_{det,metadata}`` -> ``track_proj_{det,meta}``,
  the two streams ``transformer.transformer_{det,metadata}`` and the
  branches ``transformer.{detection,metadata}_branch`` (whose
  ``linear2``, which the reference's forward never applies, stays
  unmapped, as in the JAX package).

Some reference tensors have more than one possible target: ``class_embed.0``
fills ``class_embed0`` and a shared ``class_embed``, whichever the model
has, and likewise ``bbox_embed.0``. Such writes are applied non-strictly
even under ``strict``, which then requires that at least one target of
each group was filled.

Usage::

    from kinet_tpu_torch.tools.import_torch_weights import import_state_dict
    sd = torch.load("checkpoint.pth", map_location="cpu")["model"]
    model, report = import_state_dict(sd, model, nheads=8, strict=True)

or from the shell (the model built from a train config, its weights
written as a checkpoint of the port's training runs)::

    python -m kinet_tpu_torch.tools.import_torch_weights checkpoint.pth \
        --config train.yaml --named train_deformable train_tracking \
        --out runs/imported
"""
from __future__ import annotations

import argparse
import re
import warnings

import numpy as np
import torch
from torch import nn


def _to_tensor(v) -> torch.Tensor:
    return v.detach() if torch.is_tensor(v) else torch.from_numpy(np.array(v))


def _mha_names(prefix, w, b, wo, bo, nheads):
    """{port name: tensor} of one reference attention block: the q/k/v
    rows of ``in_proj`` and ``out_proj``."""
    d = w.shape[1]
    if d % nheads:
        raise ValueError(f"{prefix}: width {d} is not a multiple of "
                         f"{nheads} heads")
    out = {}
    for name, wm, bm in zip(("q_proj", "k_proj", "v_proj"),
                            torch.chunk(w, 3, 0), torch.chunk(b, 3, 0)):
        out[f"{prefix}.{name}.weight"] = wm
        out[f"{prefix}.{name}.bias"] = bm
    out[f"{prefix}.out_proj.weight"] = wo
    out[f"{prefix}.out_proj.bias"] = bo
    return out


def import_state_dict(
    state_dict: dict,
    target,
    nheads: int = 8,
    strict: bool = False,
):
    """Fills ``target`` from the reference ``state_dict`` ({name: tensor
    or array}). ``target`` is a port model, whose tensors are written in
    place (on its device, in its dtype), or its state dict, of which a new
    one is returned with the mapped tensors replaced. Returns (the model
    or the new state dict, {"applied": tensors written, "unmapped":
    reference names nothing reads}).

    ``strict``: a mapped name the target lacks (KeyError), a shape that
    disagrees (ValueError), a group of alternative targets none of which
    was filled, or an unmapped reference name (KeyError) raises. Without
    it, such writes are skipped."""
    if isinstance(target, nn.Module):
        tensors = dict(target.named_parameters())
        tensors.update(target.named_buffers())
    else:
        tensors = {k: v.detach().clone() for k, v in target.items()}
    sd = {k: _to_tensor(v) for k, v in state_dict.items()}
    used = set()
    # deformable checkpoints: the decoder layers number their norms
    # otherwise than the vanilla transformer (see the module docstring)
    deformable = any("sampling_offsets" in k for k in sd)
    dec_norm_map = {"1": "2", "2": "1", "3": "3"} if deformable else None
    if deformable:
        warnings.warn(
            "importing a deformable checkpoint: if it was TRAINED with the "
            "reference fork, set msda_ref_normalizer=True on the model — "
            "the fork divides sampling offsets by (H, W) "
            "(ms_deform_attn.py:79, swapped vs upstream Deformable-DETR); "
            "without the flag the imported offsets sample wrong locations.",
            stacklevel=2,
        )

    def take(k):
        used.add(k)
        return sd[k]

    writes = {}
    alt_groups: dict = {}

    def alt(group_key, names):
        alt_groups.setdefault(group_key, []).extend(names)

    for k in list(sd):
        # ---- backbone ----
        m = re.match(r"backbone\.0\.body\.(conv1|bn1)\.(\w+)$", k)
        if m:
            mod, leaf = m.groups()
            if mod == "conv1":
                writes["backbone.trunk.conv1.weight"] = take(k)
            else:
                writes[f"backbone.trunk.bn1.{leaf}"] = take(k)
            continue
        m = re.match(
            r"backbone\.0\.body\.layer(\d)\.(\d+)\.(conv\d|bn\d)\.(\w+)$", k
        )
        if m:
            layer, block, mod, leaf = m.groups()
            scope = f"backbone.trunk.layer{layer}_{block}"
            if mod.startswith("conv"):
                writes[f"{scope}.{mod}.weight"] = take(k)
            else:
                writes[f"{scope}.{mod}.{leaf}"] = take(k)
            continue
        m = re.match(
            r"backbone\.0\.body\.layer(\d)\.(\d+)\.downsample\.(\d)\.(\w+)$", k
        )
        if m:
            layer, block, idx, leaf = m.groups()
            scope = f"backbone.trunk.layer{layer}_{block}"
            if idx == "0":
                writes[f"{scope}.downsample_conv.weight"] = take(k)
            else:
                writes[f"{scope}.downsample_bn.{leaf}"] = take(k)
            continue
        # ---- KineT dual-stream (reference detr.py:288-425) ----
        m = re.match(
            r"backbone_(det|metadata)\.0\.layers\.0\.(linear\d|norm)\.(weight|bias)$",
            k,
        )
        if m:
            stream, mod, leaf = m.groups()
            branch = "det_backbone" if stream == "det" else "meta_backbone"
            writes[f"kinet_backbone.{branch}.{mod}.{leaf}"] = take(k)
            continue
        if k == "query_embed_det.weight":
            writes["query_embed_det"] = take(k)
            continue
        if k == "query_embed_metadata.weight":
            writes["query_embed_meta"] = take(k)
            continue
        m = re.match(
            r"input_proj_tracklets_(det|metadata)\.layers\.(\d)\.(weight|bias)$",
            k,
        )
        if m:
            stream, i, leaf = m.groups()
            proj = "track_proj_det" if stream == "det" else "track_proj_meta"
            writes[f"{proj}.layer{i}.{leaf}"] = take(k)
            continue
        m = re.match(
            r"transformer\.(detection|metadata)_branch\."
            r"(linear_input1|linear_input2|norm)\.(weight|bias)$",
            k,
        )
        if m:
            branch, mod, leaf = m.groups()
            writes[f"transformer.{branch}_branch.{mod}.{leaf}"] = take(k)
            continue
        # ---- heads & embeds ----
        if k == "query_embed.weight":
            writes["query_embed"] = take(k)
            continue
        if k in ("input_proj.weight", "input_proj.bias"):
            writes[k] = take(k)
            continue
        m = re.match(r"class_embed\.(weight|bias)$", k)
        if m:
            writes[f"class_embed.{m.group(1)}"] = take(k)
            continue
        m = re.match(r"bbox_embed\.layers\.(\d)\.(weight|bias)$", k)
        if m:
            i, leaf = m.groups()
            writes[f"bbox_embed.layer{i}.{leaf}"] = take(k)
            continue
        # ---- segmentation heads (reference detr_segmentation.py) ----
        m = re.match(r"bbox_attention\.(q_linear|k_linear)\.(weight|bias)$", k)
        if m:
            writes[k] = take(k)
            continue
        m = re.match(r"mask_head\.(lay\d|adapter\d|out_lay|gn\d)\.(weight|bias)$", k)
        if m:
            writes[k] = take(k)
            continue
        # ---- deformable-DETR specifics ----
        m = re.match(r"input_proj\.(\d+)\.(0|1)\.(weight|bias)$", k)
        if m:
            i, sub, leaf = m.groups()
            # 1x1 (or 3x3 extra-level) conv, then its GroupNorm
            mod = f"input_proj{i}" if sub == "0" else f"input_proj_gn{i}"
            writes[f"{mod}.{leaf}"] = take(k)
            continue
        if k == "transformer.level_embed":
            writes[k] = take(k)
            continue
        # two-stage heads (reference deformable_transformer.py:52-56)
        m = re.match(
            r"transformer\.(enc_output|pos_trans)(_norm)?\.(weight|bias)$", k
        )
        if m:
            writes[k] = take(k)
            continue
        m = re.match(r"transformer\.reference_points\.(weight|bias)$", k)
        if m:
            writes[f"transformer.reference_points_head.{m.group(1)}"] = take(k)
            continue
        # per-decoder-layer heads (ModuleLists: distinct with box
        # refinement, else the reference repeats one shared instance; index
        # 0 fills the port's shared head as well, whichever exists)
        m = re.match(r"class_embed\.(\d+)\.(weight|bias)$", k)
        if m:
            i, leaf = m.groups()
            val = take(k)
            writes[f"class_embed{i}.{leaf}"] = val
            if i == "0":
                writes[f"class_embed.{leaf}"] = val
                alt(("class_embed", i, leaf),
                    [f"class_embed{i}.{leaf}", f"class_embed.{leaf}"])
            continue
        m = re.match(r"bbox_embed\.(\d+)\.layers\.(\d)\.(weight|bias)$", k)
        if m:
            i, j, leaf = m.groups()
            val = take(k)
            writes[f"bbox_embed{i}.layer{j}.{leaf}"] = val
            if i == "0":
                writes[f"bbox_embed.layer{j}.{leaf}"] = val
                alt(("bbox_embed", i, j, leaf),
                    [f"bbox_embed{i}.layer{j}.{leaf}",
                     f"bbox_embed.layer{j}.{leaf}"])
            continue
        # ---- transformer layers (optionally nested in a KineT stream) ----
        m = re.match(
            r"transformer\.(?:(transformer_det|transformer_metadata)\.)?"
            r"(encoder|decoder)\.layers\.(\d+)\.(.+)$",
            k,
        )
        if m:
            stream, side, i, rest = m.groups()
            pre = "transformer." + (f"{stream}." if stream else "")
            scope = f"{pre}{side}.layer{i}"
            # MSDeformAttn sub-linears (deformable enc self_attn / dec
            # cross_attn; reference ops/modules/ms_deform_attn.py:28-33)
            m2 = re.match(
                r"(self_attn|cross_attn)\."
                r"(sampling_offsets|attention_weights|value_proj|output_proj)"
                r"\.(weight|bias)$",
                rest,
            )
            if m2:
                attn_name, mod, leaf = m2.groups()
                writes[f"{scope}.{attn_name}.{mod}.{leaf}"] = take(k)
                continue
            if rest.startswith("self_attn.") or rest.startswith(
                "multihead_attn."
            ):
                base = rest.split(".", 1)[0]
                if rest.endswith("in_proj_weight"):
                    ref = f"{pre}{side}.layers.{i}.{base}"
                    mha_args = (take(k), sd[f"{ref}.in_proj_bias"],
                                sd[f"{ref}.out_proj.weight"],
                                sd[f"{ref}.out_proj.bias"], nheads)
                    # the vanilla stacks' cross-attention is the port's
                    # cross_attn; the reference's own name is the other
                    # candidate, as in the JAX package
                    port = "cross_attn" if base == "multihead_attn" else base
                    named = _mha_names(f"{scope}.{port}", *mha_args)
                    bare = _mha_names(f"{scope}.{base}", *mha_args)
                    writes.update(named)
                    writes.update(bare)
                    alt((scope, base, "mha"), list(named) + list(bare))
                    used.update({f"{ref}.in_proj_bias",
                                 f"{ref}.out_proj.weight",
                                 f"{ref}.out_proj.bias"})
                continue
            m2 = re.match(r"linear(\d)\.(weight|bias)$", rest)
            if m2:
                writes[f"{scope}.{rest}"] = take(k)
                continue
            m2 = re.match(r"norm(\d)\.(weight|bias)$", rest)
            if m2:
                n, leaf = m2.groups()
                if side == "decoder" and dec_norm_map is not None:
                    n = dec_norm_map[n]
                writes[f"{scope}.norm{n}.{leaf}"] = take(k)
                continue
        m = re.match(
            r"transformer\.(?:(transformer_det|transformer_metadata)\.)?"
            r"(decoder|encoder)\.norm\.(weight|bias)$",
            k,
        )
        if m:
            writes[k] = take(k)
            continue

    if any(name.startswith("detector.") for name in tensors):
        # segmentation wrapper (models/segmentation.py): the DETR core
        # nests under 'detector' while bbox_attention/mask_head stay at the
        # top, whereas the reference's DETRSegm state dict is flat
        def _route(name):
            if name.split(".", 1)[0] in ("bbox_attention", "mask_head"):
                return name
            return "detector." + name

        writes = {_route(n): v for n, v in writes.items()}
        alt_groups = {k: [_route(n) for n in names]
                      for k, names in alt_groups.items()}

    applied = 0
    alt_names = {n for names in alt_groups.values() for n in names}
    alt_applied = set()
    with torch.no_grad():
        for name, val in writes.items():
            in_alt = name in alt_names
            have = tensors.get(name)
            if have is None:
                if strict and not in_alt:
                    raise KeyError(name)
                continue
            if tuple(have.shape) != tuple(val.shape):
                if strict and not in_alt:
                    raise ValueError(f"{name}: {tuple(have.shape)} vs "
                                     f"{tuple(val.shape)}")
                continue
            have.copy_(val)  # in the target's dtype, on its device
            applied += 1
            if in_alt:
                alt_applied.add(name)
    if strict:
        for key, names in alt_groups.items():
            if not any(n in alt_applied for n in names):
                raise KeyError(
                    "no alternative layout resolved for "
                    + "/".join(map(str, key)))
    unused = [k for k in sd if k not in used]
    if strict and unused:
        raise KeyError(f"unmapped reference keys: {unused[:10]}...")
    out = target if isinstance(target, nn.Module) else tensors
    return out, {"applied": applied, "unmapped": unused}


def main(argv=None):
    from ..config import load_config, parse_cli_overrides, save_config
    from ..models.build import build_model
    from ..utils.checkpoint import CheckpointManager

    p = argparse.ArgumentParser(
        description="load a reference checkpoint into a port model built "
                    "from a train config, and save it as a port checkpoint")
    p.add_argument("checkpoint", help="reference .pth (a state dict, or a "
                                      "dict holding it under 'model')")
    p.add_argument("--config", default="train.yaml")
    p.add_argument("--named", nargs="*", default=[])
    p.add_argument("--out", required=True, help="run directory to write")
    p.add_argument("--device", default=None, help="cpu, or the card when unset")
    p.add_argument("--strict", action="store_true")
    p.add_argument("overrides", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = load_config(args.config, named=args.named,
                      overrides=parse_cli_overrides(args.overrides))
    # tensors and plain containers only; the reference's checkpoints also
    # hold its argparse Namespace
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(args.checkpoint, map_location="cpu",
                          weights_only=True)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    model, _ = build_model(cfg, device=args.device)
    _, report = import_state_dict(sd, model, nheads=int(cfg.nheads),
                                  strict=args.strict)
    save_config(cfg, args.out)
    CheckpointManager(args.out).save_epoch(
        model, torch.optim.SGD(model.parameters(), lr=0.0), 0, 0)
    print(f"applied {report['applied']} tensors, "
          f"{len(report['unmapped'])} reference keys unmapped"
          + (f": {report['unmapped'][:10]}" if report["unmapped"] else ""))
    print(f"wrote {args.out} (config.yaml + checkpoint; track it with "
          f"obj_detect_checkpoint_dir={args.out})")


if __name__ == "__main__":
    main()
