"""Weight bridge between a port model and the JAX model's flax parameters.

``load_jax_params(model, params)`` takes the flax tree (``{"params": ...}``
or its inside) with numpy leaves; the caller runs ``jax.device_get`` on it,
this module never imports JAX. The other direction: ``flax_path(model,
name)`` gives a port tensor's flax path, and ``to_flax_layout`` turns a
port tensor (a parameter or its gradient) into the flax leaf's layout.
Mapping:

- conv kernel [kH, kW, I, O] -> weight [O, I, kH, kW],
- Dense kernel [I, O] -> weight [O, I]; a multi-head attention kernel
  ([C, H, dh] for query/key/value, [H, dh, C] for out) is flattened to its
  [in, out] matrix first, and its bias to a vector,
- LayerNorm / GroupNorm ``scale`` -> ``weight``,
- FrozenBatchNorm tensors, ``level_embed`` and ``query_embed`` as they are.

Port modules carry the flax names (``layer0``, ``self_attn``,
``_ValueProjAfterPool`` as ``value_proj`` ...), except the auto-named flax
layers of the transformers: ``norm{i}`` <- ``LayerNorm_{i-1}``,
``linear{i}`` <- ``Dense_{i-1}``, and the attention projections
``q_proj/k_proj/v_proj/out_proj`` <- ``query/key/value/out``. A module
whose flax children are named otherwise says so in a ``flax_names`` dict
{port child: flax path}; e.g. the vanilla and kinematic stacks
(``models/transformer.py``) map ``self_attn`` to
``_SelfAttnBlock_0/MultiHeadDotProductAttention_0`` and the pre-norm
encoder's final ``norm`` to ``LayerNorm_0``, and ``LayerBackboneFC`` keeps
its explicitly named ``linear1..3``.

The two-stage parameters (``transformer/enc_output``, ``enc_output_norm``,
``pos_trans``, ``pos_trans_norm`` and the extra ``class_embed{n}`` /
``bbox_embed{n}`` of the encoder's head), ``merge_frame_features``'
``merge{i}`` convolutions and the one-head ``sampling_offsets`` of
``enc_msda_shared_locs`` carry their flax names and map by the rules
above.

The load is strict: it raises if any flax leaf is left unused or any port
parameter or buffer is left unfilled, or if a shape disagrees.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_SEGMENT = {"q_proj": "query", "k_proj": "key", "v_proj": "value",
            "out_proj": "out"}


def _flax_segment(seg: str) -> str:
    m = re.fullmatch(r"(norm|linear)(\d+)", seg)
    if m:
        kind = "LayerNorm" if m.group(1) == "norm" else "Dense"
        return f"{kind}_{int(m.group(2)) - 1}"
    return _SEGMENT.get(seg, seg)


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, prefix + (k,), out)
        else:
            out[prefix + (k,)] = np.asarray(v)


def _source(module: nn.Module, leaf: str):
    """(flax leaf name, numpy array -> port layout, port array + flax shape
    -> flax layout) for one port tensor."""
    if isinstance(module, nn.Linear):
        if leaf == "weight":
            i, o = module.in_features, module.out_features
            return ("kernel", lambda a: a.reshape(i, o).T,
                    lambda a, shape: a.T.reshape(shape))
        return "bias", lambda a: a.reshape(-1), lambda a, shape: a.reshape(shape)
    if isinstance(module, nn.Conv2d):
        if leaf == "weight":
            return ("kernel", lambda a: a.transpose(3, 2, 0, 1),
                    lambda a, shape: a.transpose(2, 3, 1, 0))
        return "bias", lambda a: a, lambda a, shape: a
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return (("scale" if leaf == "weight" else "bias"), lambda a: a,
                lambda a, shape: a)
    return leaf, lambda a: a, lambda a, shape: a


def _resolve(model: nn.Module, name: str):
    *mod_path, leaf = name.split(".")
    segs, module = [], model
    for seg in mod_path:
        mapped = getattr(module, "flax_names", {}).get(seg)
        segs.extend(mapped.split("/") if mapped else [_flax_segment(seg)])
        module = getattr(module, seg)
    flax_leaf, to_port, to_flax = _source(module, leaf)
    return tuple(segs) + (flax_leaf,), to_port, to_flax


def flax_path(model: nn.Module, name: str) -> tuple:
    """The flax path (inside ``params``) of port tensor ``name``, e.g.
    ``transformer.decoder.layer0.norm1.weight`` ->
    ``("transformer", "decoder", "layer0", "LayerNorm_0", "scale")``."""
    return _resolve(model, name)[0]


def to_flax_layout(model: nn.Module, name: str, array: np.ndarray,
                   flax_shape) -> np.ndarray:
    """Port tensor ``name`` (or its gradient) as a numpy array in the layout
    of its flax leaf of shape ``flax_shape``."""
    out = _resolve(model, name)[2](np.asarray(array), tuple(flax_shape))
    if tuple(out.shape) != tuple(flax_shape):
        raise ValueError(f"{name}: {out.shape} after the layout change, "
                         f"flax has {tuple(flax_shape)}")
    return out


@torch.no_grad()
def load_jax_params(model: nn.Module, params) -> None:
    tree = params["params"] if "params" in params else params
    flat: dict[tuple, np.ndarray] = {}
    _flatten(tree, (), flat)
    used, unfilled = set(), []
    tensors = list(model.named_parameters()) + list(model.named_buffers())
    for name, tensor in tensors:
        path, to_port, _ = _resolve(model, name)
        if path not in flat:
            unfilled.append(f"{name} <- {'/'.join(path)}")
            continue
        arr = np.array(to_port(flat[path]))  # a writable copy
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(
                f"{name}: flax {'/'.join(path)} has shape {arr.shape} after "
                f"the layout change, the port expects {tuple(tensor.shape)}"
            )
        tensor.copy_(torch.from_numpy(arr).to(tensor.dtype))
        used.add(path)
    unused = sorted("/".join(p) for p in flat if p not in used)
    if unfilled or unused:
        raise ValueError(
            "flax parameters do not match the port model: "
            f"{len(unfilled)} port tensors unfilled {unfilled[:8]}, "
            f"{len(unused)} flax leaves unused {unused[:8]}"
        )
