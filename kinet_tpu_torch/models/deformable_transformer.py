"""Deformable transformer (port of
``kinet_tpu/models/deformable_transformer.py``).

- Level shapes are static Python tuples; tokens are flattened level-major
  as [B, S, C], the current frame's levels first.
- ``MSDeformAttn`` samples through ``ops.msda``: the encoder's
  project-then-sample path runs the ``msda_fwd`` kernel, the decoder's
  gather-then-project path (``gather_raw``) the ``msda_raw_pool_fwd``
  kernel, or its int8 instance over the table that ``dec_msda_int8``
  quantizes once a frame for all decoder layers.
- Track queries occupy fixed leading decoder slots with a key-pad mask.
- Sampling offsets are normalized by (W, H) per level; ``ref_normalizer``
  selects the (H, W) order of checkpoints trained with the fork.

Dropout sits where the flax layers have it and acts only in ``train()``
mode, drawing its masks from the model's explicit generator
(``DropoutRNG``). ``remat`` recomputes each encoder layer in the backward
pass (``torch.utils.checkpoint``), replaying the layer's dropout masks.
Module names follow the JAX parameter tree where it names modules
(``layer0``, ``self_attn``, ``value_proj`` ...); ``tools/from_jax.py`` maps
the rest.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.msda import (
    device_constant,
    ms_deform_attn,
    ms_deform_attn_i8,
    ms_deform_attn_raw_pool,
    ms_deform_attn_shared,
    ms_deform_attn_topk,
    quantize_rows,
)


class DropoutRNG:
    """Holds the ``torch.Generator`` that every ``Dropout`` of one model
    draws from. ``build_model`` seeds it on the model's device; a trainer
    may replace it."""

    def __init__(self):
        self.generator: Optional[torch.Generator] = None


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in ``train()`` mode, keep each element with
    probability 1 - p and scale it by 1 / (1 - p); ``broadcast`` lists the
    dimensions that share one draw. The masks come from ``rng.generator``."""

    def __init__(self, p: float, rng: DropoutRNG, broadcast=()):
        super().__init__()
        self.p, self.rng, self.broadcast = float(p), rng, tuple(broadcast)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.rng.generator is None:
            raise RuntimeError("dropout needs the model's generator "
                               "(DropoutRNG.generator)")
        shape = [1 if i in self.broadcast else n for i, n in enumerate(x.shape)]
        keep = torch.rand(shape, generator=self.rng.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def remat(rng: DropoutRNG, module: nn.Module, *args):
    """``module(*args)`` under ``torch.utils.checkpoint``: activations are
    recomputed in the backward pass, with the parameter tensors of this call
    (the bf16 casts of a ``functional_call``, say) and with the dropout
    generator rewound to its state at the first call, so the recomputation
    draws the same masks (the generator is then put back where the forward
    pass left it)."""
    params = dict(module.named_parameters())
    gen = rng.generator
    start = gen.get_state() if gen is not None else None
    calls = []

    def fn(*a):
        return functional_call(module, params, a)

    def run(*a):
        if calls and gen is not None:
            after = gen.get_state()
            gen.set_state(start)
            try:
                return fn(*a)
            finally:
                gen.set_state(after)
        calls.append(1)
        return fn(*a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def offset_grid_init(n_heads, n_levels, n_points) -> torch.Tensor:
    """Directional prior for the sampling-offset bias: head h points at
    angle 2*pi*h/M, point p at radius p+1."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (2.0 * math.pi / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], dim=-1)  # [M, 2]
    grid = grid / grid.abs().max(dim=-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    scale = torch.arange(1, n_points + 1, dtype=torch.float32)[None, None, :, None]
    return (grid * scale).reshape(-1)


def valid_extents(padding_mask: torch.Tensor, spatial_shapes) -> torch.Tensor:
    """[B, S] pad mask -> [B, L, 2] float (valid rows, valid columns) per
    level. Padding is a bottom/right rectangle, as get_valid_ratio
    assumes."""
    b = padding_mask.shape[0]
    ext, cur = [], 0
    for h, w in spatial_shapes:
        m_l = padding_mask[:, cur : cur + h * w].view(b, h, w)
        ext.append(torch.stack(
            [(~m_l[:, :, 0]).sum(1), (~m_l[:, 0, :]).sum(1)], dim=-1
        ))
        cur += h * w
    return torch.stack(ext, dim=1).float()


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention: linears produce per-query sampling
    offsets and softmax attention weights; sampling runs in ``ops.msda``.

    gather_raw: sample RAW src rows and apply the value projection after
    pooling (exact by linearity; ``value_proj`` then acts on pooled rows and
    its bias is restored through the pooled weight sum). ``src_table``
    (gather_raw, inference only): (int8 [B, S, C], scales [B, L]), the
    masked src quantized by the caller; it is sampled in place of src, and
    pooled comes back in src's dtype.

    The encoder's variants, dispatched in the JAX package's order:
    ``shared_locs``, one set of sampling locations for all heads (weights
    stay per head; ``sampling_offsets`` then has 1 * L * P * 2 outputs);
    ``top_k``, per (query, head) only the ``top_k`` samples of largest
    weight, when ``top_k < L * P``; ``int8_values``, in eval mode only, the
    values quantized to int8 with one absmax scale per (batch, head)."""

    def __init__(self, d_model=256, n_levels=4, n_heads=8, n_points=4,
                 gather_raw=False, ref_normalizer=False, shared_locs=False,
                 top_k=0, int8_values=False):
        super().__init__()
        if shared_locs and top_k:
            raise ValueError("shared_locs and top_k are separate variants; "
                             "enable one")
        if gather_raw and (shared_locs or top_k or int8_values):
            raise ValueError("the encoder's MSDA variants do not apply to "
                             "gather_raw")
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.gather_raw = gather_raw
        self.ref_normalizer = ref_normalizer
        self.shared_locs, self.top_k = shared_locs, int(top_k)
        self.int8_values = int8_values
        self.n_loc_heads = 1 if shared_locs else n_heads
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(
            d_model, self.n_loc_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(
        self,
        query: torch.Tensor,  # [B, Lq, C]
        reference_points: torch.Tensor,  # [B, Lq, L, 2 or 4] float32
        src: torch.Tensor,  # [B, S, C]
        spatial_shapes: Sequence[Tuple[int, int]],
        src_padding_mask: Optional[torch.Tensor] = None,  # [B, S] True=pad
        query_mask: Optional[torch.Tensor] = None,  # [B, Lq] True=masked
        src_table=None,  # (int8 [B, S, C], scales [B, L]), gather_raw only
        value=None,  # [B, S, C] the projected, masked values, instead of src
    ) -> torch.Tensor:
        b, lq, _ = query.shape
        m, l, p = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query).view(
            b, lq, self.n_loc_heads, l, p, 2)
        attn = self.attention_weights(query).view(b, lq, m, l * p)
        attn = attn.softmax(-1).view(b, lq, m, l, p)
        if query_mask is not None:
            attn = attn.masked_fill(query_mask[:, :, None, None, None], 0.0)

        if reference_points.shape[-1] == 2:
            norm = device_constant(
                tuple((h, w) if self.ref_normalizer else (w, h)
                      for h, w in spatial_shapes),
                torch.float32, query.device,
            )
            loc = (
                reference_points[:, :, None, :, None, :]
                + offsets / norm[None, None, None, :, None, :]
            )
        else:
            loc = (
                reference_points[:, :, None, :, None, :2]
                + offsets / p * reference_points[:, :, None, :, None, 2:] * 0.5
            )
        loc, attn = loc.float(), attn.float()

        if self.gather_raw:
            ext = None
            if src_padding_mask is not None:
                ext = valid_extents(src_padding_mask, spatial_shapes)
            if src_table is not None:
                pooled, wsum = ms_deform_attn_raw_pool(
                    src_table[0], spatial_shapes, loc, attn, ext,
                    src_table[1], src.dtype,
                )
            else:
                if src_padding_mask is not None:
                    src = src.masked_fill(src_padding_mask[..., None], 0.0)
                pooled, wsum = ms_deform_attn_raw_pool(
                    src, spatial_shapes, loc, attn, ext
                )
            out = self._project_pooled(pooled, wsum)
        else:
            if value is None:
                value = self.value_proj(src)
                if src_padding_mask is not None:
                    value = value.masked_fill(src_padding_mask[..., None],
                                              0.0)
            value = value.view(b, -1, m, self.d_model // m)
            out = self._sample(value, spatial_shapes, loc, attn)
        return self.output_proj(out.to(query.dtype))

    def _sample(self, value, spatial_shapes, loc, attn):
        """The encoder's sampling core, by variant (JAX
        ``deformable_transformer.py`` 212-249)."""
        l, p = self.n_levels, self.n_points
        if self.shared_locs:
            return ms_deform_attn_shared(value, spatial_shapes, loc[:, :, 0],
                                         attn)
        if self.top_k and self.top_k < l * p:
            return ms_deform_attn_topk(value, spatial_shapes, loc, attn,
                                       self.top_k)
        if self.int8_values and not self.training:
            # absmax over (S, D) per (batch, head) in f32; the scale goes to
            # the kernel in the value's type, as the JAX package casts it
            vf = value.float()
            absmax = vf.abs().amax(dim=(1, 3), keepdim=True)  # [B, 1, M, 1]
            scale = torch.clamp(absmax / 127.0, min=1e-8)
            q8 = torch.clamp(torch.round(vf / scale), -127, 127).to(torch.int8)
            return ms_deform_attn_i8(q8, scale[:, 0, :, 0].to(value.dtype),
                                     spatial_shapes, loc, attn)
        return ms_deform_attn(value, spatial_shapes, loc, attn)

    def _project_pooled(self, pooled, wsum):
        """pooled [B, Lq, M, C] raw rows, wsum [B, Lq, M] -> [B, Lq, C]:
        each head's slice of the value projection, plus the bias weighted by
        the head's summed sampling weights. A column-parallel
        ``value_proj`` (``parallel/tp.py``) computes its output rows, each
        from its head's pooled row, and gathers them."""
        b, lq, m, c = pooled.shape
        dh = self.d_model // m
        if self.value_proj.out_features != self.d_model:
            vp = self.value_proj
            heads = torch.div(
                torch.arange(vp.out_features, device=pooled.device)
                + vp.out_start, dh, rounding_mode="floor")
            pooled, wsum = vp.copy_input(pooled), vp.copy_input(wsum)
            out = torch.einsum("bqjc,jc->bqj", pooled[:, :, heads], vp.weight)
            out = out + (wsum[:, :, heads] * vp.bias).to(out.dtype)
            return vp.gather_output(out)
        w = self.value_proj.weight.view(m, dh, c)
        out = torch.einsum("bqmc,mdc->bqmd", pooled, w)
        bias = wsum[..., None] * self.value_proj.bias.view(m, dh)
        return (out + bias.to(out.dtype)).reshape(b, lq, self.d_model)


class DeformableEncoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points,
                 ref_normalizer=False, dropout=0.0, rng=None,
                 shared_locs=False, top_k=0, int8_values=False):
        super().__init__()
        self.self_attn = MSDeformAttn(
            d_model, n_levels, n_heads, n_points, ref_normalizer=ref_normalizer,
            shared_locs=shared_locs, top_k=top_k, int8_values=int8_values,
        )
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        rng = rng or DropoutRNG()
        self.dropout1 = Dropout(dropout, rng)  # attention output
        self.dropout_ffn = Dropout(dropout, rng)  # FFN hidden
        self.dropout2 = Dropout(dropout, rng)  # FFN output

    def forward(self, src, pos, reference_points, spatial_shapes,
                padding_mask=None, src_value=None, value=None):
        # src_value: the value tokens when the queries are a subset of them
        # (Lite-DETR interleaved update); defaults to src. value: the
        # projected, masked value table itself (parallel/sp.py)
        q = src + pos if pos is not None else src
        src2 = self.self_attn(
            q, reference_points, src if src_value is None else src_value,
            spatial_shapes, padding_mask, value=value,
        )
        src = self.norm1(src + self.dropout1(src2))
        h = self.linear2(self.dropout_ffn(F.relu(self.linear1(src))))
        return self.norm2(src + self.dropout2(h))


def encoder_reference_points(spatial_shapes, valid_ratios):
    """Per-token per-level reference grid: token centres normalized by the
    valid (non-padded) extent, then re-scaled per level -> [B, S, L, 2]."""
    refs = []
    dev = valid_ratios.device
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None]
        rx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :]
        ry = ry.expand(h, w).reshape(-1)
        rx = rx.expand(h, w).reshape(-1)
        y = ry[None] / (valid_ratios[:, None, lvl, 1] * h)
        x = rx[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([x, y], dim=-1))  # [B, HW, 2]
    ref = torch.cat(refs, dim=1)
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


class DeformableEncoder(nn.Module):
    """Deformable encoder with the Lite-DETR interleaved update (``lite``):
    all layers but the last update only the high-level tokens (levels
    1..L-1) as queries, sampling the ``lite_high_klevels`` finest levels
    (0 = all); the last layer updates the level-0 tokens, sampling the
    ``lite_low_klevels`` finest levels (0 = all). ``shared_locs``, ``top_k``
    and ``int8_values`` go to every layer's ``MSDeformAttn``; a layer's own
    L * P decides whether ``top_k`` prunes."""

    def __init__(self, num_layers, d_model, d_ffn, n_levels, n_heads,
                 n_points, lite=False, lite_low_klevels=0,
                 lite_high_klevels=0, ref_normalizer=False, dropout=0.0,
                 rng=None, remat=False, shared_locs=False, top_k=0,
                 int8_values=False):
        super().__init__()
        self.n_levels = n_levels
        self.remat = remat
        self.rng = rng or DropoutRNG()
        self.modes = []  # per layer: ("all" | "high" | "low", levels)
        for i in range(num_layers):
            last_lite = lite and i == num_layers - 1 and n_levels > 1
            high_lite = lite and i < num_layers - 1 and n_levels > 1
            k = n_levels
            if last_lite and lite_low_klevels:
                k = min(lite_low_klevels, k)
            if high_lite and lite_high_klevels:
                k = min(lite_high_klevels, k)
            mode = "high" if high_lite else "low" if last_lite else "all"
            self.modes.append((mode, k))
            self.add_module(f"layer{i}", DeformableEncoderLayer(
                d_model, d_ffn, k, n_heads, n_points,
                ref_normalizer=ref_normalizer, dropout=dropout, rng=self.rng,
                shared_locs=shared_locs, top_k=top_k, int8_values=int8_values,
            ))

    def _layer(self, i, *args):
        layer = getattr(self, f"layer{i}")
        if self.remat and self.training and torch.is_grad_enabled():
            return remat(self.rng, layer, *args)
        return layer(*args)

    def forward(self, src, spatial_shapes, valid_ratios, pos=None,
                padding_mask=None):
        if len(spatial_shapes) != self.n_levels:
            raise ValueError(
                f"encoder built for {self.n_levels} levels, got {spatial_shapes}"
            )
        ref = encoder_reference_points(spatial_shapes, valid_ratios)
        split0 = spatial_shapes[0][0] * spatial_shapes[0][1]
        out = src
        for i, (mode, k) in enumerate(self.modes):
            if mode == "all":
                out = self._layer(i, out, pos, ref, spatial_shapes, padding_mask)
                continue
            s_k = sum(h * w for h, w in spatial_shapes[:k])
            rows = slice(split0, None) if mode == "high" else slice(0, split0)
            upd = self._layer(
                i, out[:, rows],
                pos[:, rows] if pos is not None else None,
                ref[:, rows, :k], tuple(spatial_shapes[:k]),
                padding_mask[:, :s_k] if padding_mask is not None else None,
                out[:, :s_k],  # values: the k finest levels
            )
            if mode == "high":
                out = torch.cat([out[:, :split0], upd], dim=1)
            else:
                out = torch.cat([upd, out[:, split0:]], dim=1)
        return out


class MultiheadAttention(nn.Module):
    """Multi-head dot-product attention with the semantics of flax's
    ``MultiHeadDotProductAttention``: the query is scaled by 1/sqrt(d_head)
    and masked keys get the dtype's most negative logit; in ``train()`` mode
    the attention weights get dropout with one mask shared by the batch and
    the heads (flax's ``broadcast_dropout``). A query whose keys are all
    masked attends uniformly, as in flax, not NaN. ``return_weights`` also
    returns the softmax weights [B, H, Lq, Lk] before dropout (what flax's
    ``sow_weights`` records)."""

    def __init__(self, d_model, n_heads, dropout=0.0, rng=None):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.attn_dropout = Dropout(dropout, rng or DropoutRNG(), (0, 1))

    def forward(self, q, k, v, key_valid=None, return_weights=False):
        # key_valid [B, Lk] bool
        b, lq, c = q.shape
        h = self.n_heads
        dh = c // h
        qh = self.q_proj(q).view(b, lq, h, dh).transpose(1, 2) / math.sqrt(dh)
        kh = self.k_proj(k).view(b, -1, h, dh).transpose(1, 2)
        vh = self.v_proj(v).view(b, -1, h, dh).transpose(1, 2)
        logits = qh @ kh.transpose(-1, -2)  # [B, H, Lq, Lk]
        if key_valid is not None:
            logits = logits.masked_fill(
                ~key_valid[:, None, None, :], torch.finfo(logits.dtype).min
            )
        weights = logits.softmax(-1)
        out = self.attn_dropout(weights) @ vh
        out = self.out_proj(out.transpose(1, 2).reshape(b, lq, c))
        return (out, weights) if return_weights else out


class DeformableDecoderLayer(nn.Module):
    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points,
                 gather_raw=False, ref_normalizer=False, dropout=0.0,
                 rng=None):
        super().__init__()
        rng = rng or DropoutRNG()
        self.self_attn = MultiheadAttention(d_model, n_heads, dropout, rng)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(
            d_model, n_levels, n_heads, n_points, gather_raw=gather_raw,
            ref_normalizer=ref_normalizer,
        )
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout1 = Dropout(dropout, rng)  # self-attention output
        self.dropout2 = Dropout(dropout, rng)  # cross-attention output
        self.dropout_ffn = Dropout(dropout, rng)  # FFN hidden
        self.dropout3 = Dropout(dropout, rng)  # FFN output

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                src_padding_mask=None, query_pad_mask=None, src_table=None):
        q = tgt + query_pos if query_pos is not None else tgt
        key_valid = ~query_pad_mask if query_pad_mask is not None else None
        tgt = self.norm1(
            tgt + self.dropout1(self.self_attn(q, q, tgt, key_valid))
        )
        tgt2 = self.cross_attn(
            tgt + query_pos if query_pos is not None else tgt,
            reference_points, src, spatial_shapes, src_padding_mask,
            query_mask=query_pad_mask, src_table=src_table,
        )
        tgt = self.norm2(tgt + self.dropout2(tgt2))
        h = self.linear2(self.dropout_ffn(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + self.dropout3(h))


class DeformableDecoder(nn.Module):
    """Decoder with iterative box refinement: with ``bbox_embeds`` (one head
    per layer) each layer updates the reference points through
    inverse-sigmoid residuals."""

    def __init__(self, num_layers, d_model, d_ffn, n_levels, n_heads,
                 n_points, gather_raw=False, ref_normalizer=False,
                 dropout=0.0, rng=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", DeformableDecoderLayer(
                d_model, d_ffn, n_levels, n_heads, n_points,
                gather_raw=gather_raw, ref_normalizer=ref_normalizer,
                dropout=dropout, rng=rng,
            ))

    def forward(self, tgt, reference_points, src, spatial_shapes,
                valid_ratios, query_pos=None, src_padding_mask=None,
                query_pad_mask=None, bbox_embeds=None, src_table=None):
        output = tgt
        intermediates, inter_refs = [], []
        for i in range(self.num_layers):
            if reference_points.shape[-1] == 4:
                ref_input = (
                    reference_points[:, :, None]
                    * torch.cat([valid_ratios, valid_ratios], -1)[:, None]
                )
            else:
                ref_input = reference_points[:, :, None] * valid_ratios[:, None]
            output = getattr(self, f"layer{i}")(
                output, query_pos, ref_input, src, spatial_shapes,
                src_padding_mask, query_pad_mask, src_table,
            )
            if bbox_embeds is not None:
                tmp = bbox_embeds[i](output).float()
                if reference_points.shape[-1] == 4:
                    new_ref = torch.sigmoid(tmp + inverse_sigmoid(reference_points))
                else:
                    xy = tmp[..., :2] + inverse_sigmoid(reference_points)
                    new_ref = torch.sigmoid(torch.cat([xy, tmp[..., 2:]], -1))
                reference_points = new_ref.detach()
            intermediates.append(output)
            inter_refs.append(reference_points)
        return torch.stack(intermediates), torch.stack(inter_refs)


def get_valid_ratio(mask: torch.Tensor) -> torch.Tensor:
    """[B, H, W] pad mask -> [B, 2] (w_ratio, h_ratio)."""
    _, h, w = mask.shape
    valid_h = (~mask[:, :, 0]).sum(1).float()
    valid_w = (~mask[:, 0, :]).sum(1).float()
    return torch.stack([valid_w / w, valid_h / h], dim=-1)


def proposal_pos_embed(proposals: torch.Tensor, num_pos_feats: int = 128):
    """Sine embedding of unactivated proposal boxes [B, Q, 4] ->
    [B, Q, 4 * num_pos_feats]: per coordinate, sin of the even and cos of
    the odd frequencies, interleaved (sin f0, cos f1, sin f2, ...)."""
    t = torch.arange(num_pos_feats, dtype=torch.float32,
                     device=proposals.device)
    dim_t = 10000.0 ** (2 * torch.floor(t / 2) / num_pos_feats)
    pos = torch.sigmoid(proposals.float())[..., None] * (2 * math.pi) / dim_t
    pos = torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1)
    return pos.reshape(*proposals.shape[:-1], -1)


def descending_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, ties to the
    lower index, as ``jax.lax.top_k`` breaks them (a stable descending
    sort; ``torch.topk`` promises no order among ties)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


class DeformableTransformer(nn.Module):
    """Encoder + decoder over the flattened multi-level tokens.

    With ``multi_frame_attention_separate_encoder`` the levels are two
    frames' halves, encoded separately, current frame first.
    ``frame_agnostic_levels`` gives both halves the same level embeds, so a
    frame's encoded memory is the same as current or as previous frame, and
    the caller can pass last step's memory as ``prev_encoded``.

    ``dec_msda_int8`` (with ``dec_gather_raw``; inference only, a no-op in
    ``train()`` mode, as in the JAX package): the decoder's cross-attention
    samples an int8 table of its masked memory, made once a frame for all
    layers, with one scale per frame's half in the cached-memory path and
    one for the whole table otherwise (see ``_dec_table``).

    ``two_stage``: the decoder's queries come from the encoder. Every memory
    token is a proposal box (``gen_encoder_output_proposals``), scored by
    ``class_embed_fn`` and refined by ``bbox_embed_fn`` (the model's extra
    heads); the ``two_stage_num_proposals`` best give the reference points
    and, through ``pos_trans``, the query embeddings. As in the JAX package
    this branch takes no track queries: they are ignored and
    query_pad_mask stays None.

    A forward is ``decode(encode(...), ...)``: the model calls the two
    halves itself, so that each is a span of its own (``utils/trace.py``).
    ``decode`` returns (hs, memory, init_reference, inter_references,
    query_pad_mask, enc_outputs_class, enc_outputs_coord_unact);
    query_pad_mask [B, Q] is True at inactive track slots (None without
    track queries); the last two are None without two_stage."""

    def __init__(self, d_model=256, nheads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=1024,
                 num_feature_levels=4, dec_n_points=4,
                 enc_n_points=4, multi_frame_attention_separate_encoder=False,
                 frame_agnostic_levels=False, enc_lite=False,
                 enc_lite_klevels=0, enc_lite_high_klevels=0,
                 dec_gather_raw=False, dec_klevels=0, dec_msda_int8=False,
                 msda_ref_normalizer=False, dropout=0.0, rng=None,
                 remat=False, two_stage=False, two_stage_num_proposals=300,
                 enc_shared_locs=False, enc_topk=0, enc_int8=False):
        super().__init__()
        rng = rng or DropoutRNG()
        self.d_model = d_model
        self.two_stage = two_stage
        self.two_stage_num_proposals = two_stage_num_proposals
        self.num_feature_levels = num_feature_levels
        self.separate_encoder = multi_frame_attention_separate_encoder
        self.frame_agnostic_levels = frame_agnostic_levels
        self.dec_klevels = dec_klevels
        self.dec_int8 = dec_msda_int8 and dec_gather_raw
        enc_levels = num_feature_levels // (2 if self.separate_encoder else 1)
        self.encoder = DeformableEncoder(
            num_encoder_layers, d_model, dim_feedforward,
            enc_levels, nheads, enc_n_points, lite=enc_lite,
            lite_low_klevels=enc_lite_klevels,
            lite_high_klevels=enc_lite_high_klevels,
            ref_normalizer=msda_ref_normalizer, dropout=dropout, rng=rng,
            remat=remat, shared_locs=enc_shared_locs, top_k=enc_topk,
            int8_values=enc_int8,
        )
        frames, _, k = self._dec_frames_half()
        self.decoder = DeformableDecoder(
            num_decoder_layers, d_model, dim_feedforward,
            k * frames, nheads, dec_n_points, gather_raw=dec_gather_raw,
            ref_normalizer=msda_ref_normalizer, dropout=dropout, rng=rng,
        )
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, d_model))
        if two_stage:
            self.enc_output = nn.Linear(d_model, d_model)
            self.enc_output_norm = nn.LayerNorm(d_model, eps=1e-5)
            self.pos_trans = nn.Linear(2 * d_model, 2 * d_model)
            self.pos_trans_norm = nn.LayerNorm(2 * d_model, eps=1e-5)
        else:
            self.reference_points_head = nn.Linear(d_model, 2)

    def gen_encoder_output_proposals(self, memory, memory_pad_mask,
                                     spatial_shapes):
        """Two-stage proposals: one box a memory token, centred on its cell
        (normalized by the level's valid extent) with side 0.05 * 2^level,
        in inverse-sigmoid form, +inf at pad tokens and at boxes not inside
        (0.01, 0.99); and the memory, zeroed at those tokens, through
        ``enc_output`` and its norm. Returns (output memory [B, S, C],
        proposals [B, S, 4] float32)."""
        b = memory.shape[0]
        dev = memory.device
        proposals, cur = [], 0
        for lvl, (h, w) in enumerate(spatial_shapes):
            mask_l = memory_pad_mask[:, cur:cur + h * w].view(b, h, w)
            valid_h = (~mask_l[:, :, 0]).sum(1).float()
            valid_w = (~mask_l[:, 0, :]).sum(1).float()
            gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
            gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
            grid = torch.stack([gx, gy], -1).reshape(1, h * w, 2)
            scale = torch.stack([valid_w, valid_h], -1)[:, None, :]
            grid = (grid + 0.5) / scale
            wh = torch.ones_like(grid) * (0.05 * (2.0 ** lvl))
            proposals.append(torch.cat([grid, wh], -1))
            cur += h * w
        props = torch.cat(proposals, dim=1)  # [B, S, 4]
        valid = ((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
        props = torch.log(props / (1 - props.clamp(1e-6, 1 - 1e-6)))
        bad = memory_pad_mask[..., None] | ~valid
        props = props.masked_fill(bad, float("inf"))
        out_mem = memory.masked_fill(bad, 0.0)
        return self.enc_output_norm(self.enc_output(out_mem)), props

    def _two_stage_queries(self, memory, mask_flat, spatial_shapes,
                           class_embed_fn, bbox_embed_fn):
        """(query_pos, tgt, reference_points, enc_outputs_class,
        enc_outputs_coord_unact) of the two-stage branch (JAX
        ``deformable_transformer.py`` 794-816)."""
        out_mem, props = self.gen_encoder_output_proposals(
            memory, mask_flat, spatial_shapes)
        enc_class = class_embed_fn(out_mem)
        delta = bbox_embed_fn(out_mem)
        # invalid proposals keep their +inf (sigmoid 1 in the criterion)
        inf = torch.isinf(props)
        enc_coord = torch.where(
            inf, props, delta + torch.nan_to_num(props, posinf=0.0))
        score = enc_class[..., 0].masked_fill(inf[..., 0], float("-inf"))
        topk_idx = descending_topk(score, self.two_stage_num_proposals)
        topk_coords = torch.gather(
            enc_coord, 1, topk_idx[..., None].expand(-1, -1, 4)).detach()
        reference_points = torch.sigmoid(topk_coords)
        embed = proposal_pos_embed(topk_coords, self.d_model // 2)
        pos_trans = self.pos_trans_norm(
            self.pos_trans(embed.to(self.pos_trans.weight.dtype)))
        query_pos, tgt = torch.split(pos_trans, self.d_model, dim=-1)
        return query_pos, tgt, reference_points, enc_class, enc_coord

    def _dec_frames_half(self):
        frames = 2 if self.separate_encoder else 1
        half = self.num_feature_levels // frames
        k = min(self.dec_klevels, half) if self.dec_klevels else half
        return frames, half, k

    @staticmethod
    def _dec_table(dec_memory, dec_mask, dec_shapes, halves: bool):
        """The decoder's int8 table (JAX ``deformable_transformer.py``
        881-958): (int8 [B, S, C], per-level scales [B, L]) of the memory
        with pad rows zeroed. With ``halves`` (the cached-memory path) each
        frame's half is quantized on its own, current frame first, each
        with its own scale; otherwise the whole table with one.

        The JAX package caches the previous half's int8 table and scale from
        the step where that frame was current; the port quantizes the
        previous half again from the cached memory. Both are the same bits:
        the cached memory is that step's current-frame memory unchanged
        (same dtype), and its pad mask is downsampled from the same frame's
        pad mask by the same rule, so the masked rows, their absmax, the
        scale and every rounded value are equal."""
        b = dec_memory.shape[0]
        n_l = len(dec_shapes)
        masked = dec_memory.masked_fill(dec_mask[..., None], 0.0)
        if not halves:
            q8, scale = quantize_rows(masked)
            return q8, scale[:, None].expand(b, n_l).contiguous()
        half = n_l // 2
        split = sum(h * w for h, w in dec_shapes[:half])
        q_cur, s_cur = quantize_rows(masked[:, :split])
        q_prev, s_prev = quantize_rows(masked[:, split:])
        scales = torch.cat([s_cur[:, None].expand(b, half),
                            s_prev[:, None].expand(b, n_l - half)], dim=1)
        return torch.cat([q_cur, q_prev], dim=1), scales.contiguous()

    def _flat_inputs(self, srcs, masks, pos_embeds, embed_idx):
        b = srcs[0].shape[0]
        src_flat = torch.cat([_flatten(s) for s in srcs], dim=1)
        mask_flat = torch.cat([m.reshape(b, -1) for m in masks], dim=1)
        pos_flat = torch.cat(
            [
                p.reshape(b, -1, self.d_model) + self.level_embed[embed_idx(i)]
                for i, p in enumerate(pos_embeds)
            ],
            dim=1,
        ).to(src_flat.dtype)
        vr = torch.stack([get_valid_ratio(m) for m in masks], dim=1)
        return src_flat, mask_flat, pos_flat, vr

    def encode(
        self,
        srcs,  # list of [B, C, H, W]
        masks,  # list of [B, H, W] bool
        pos_embeds,  # list of [B, H, W, C]
        prev_encoded=None,  # [B, S_half, C] cached prev-frame memory
        prev_masks=None,  # per-level prev pad masks (with prev_encoded)
        prev_is_current=False,  # first frame: reuse mem_cur as mem_prev
        spatial=None,  # parallel/sp.py: encode this process's tokens
    ):
        """The encoder's half of a forward: (memory [B, S, C], its pad mask
        [B, S], valid ratios [B, L, 2], spatial shapes, the tokens' dtype,
        whether the previous frame's half came cached), as ``decode`` takes
        it."""
        def encode(src, shapes, vr, pos, mask):
            if spatial is None:
                return self.encoder(src, shapes, vr, pos, mask)
            return spatial.encode(self.encoder, src, shapes, vr, pos, mask)

        b = srcs[0].shape[0]
        half_l = self.num_feature_levels // 2
        if prev_encoded is not None or prev_is_current:
            # cached-memory path: srcs/masks/pos carry the CURRENT frame's
            # half only; the prev half comes pre-encoded (or is the current
            # frame's own memory on the first frame)
            if not (self.separate_encoder and self.frame_agnostic_levels):
                raise ValueError(
                    "prev-memory caching needs the separate, frame-agnostic "
                    "encoder (cache_prev_encoder with multi_frame_attention)"
                )
            spatial_cur = tuple((s.shape[2], s.shape[3]) for s in srcs)
            spatial_shapes = spatial_cur + spatial_cur
            src_flat, mask_cur, pos_flat, vr_cur = self._flat_inputs(
                srcs, masks, pos_embeds, lambda i: i
            )
            mem_cur = encode(src_flat, spatial_cur, vr_cur, pos_flat,
                             mask_cur)
            if prev_is_current:
                mem_prev, mask_prev, vr_prev = mem_cur, mask_cur, vr_cur
            else:
                mem_prev = prev_encoded.to(mem_cur.dtype)
                mask_prev = torch.cat(
                    [m.reshape(b, -1) for m in prev_masks], dim=1
                )
                vr_prev = torch.stack(
                    [get_valid_ratio(m) for m in prev_masks], dim=1
                )
            memory = torch.cat([mem_cur, mem_prev], dim=1)
            mask_flat = torch.cat([mask_cur, mask_prev], dim=1)
            valid_ratios = torch.cat([vr_cur, vr_prev], dim=1)
        else:
            spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
            agnostic = self.frame_agnostic_levels and self.separate_encoder
            src_flat, mask_flat, pos_flat, valid_ratios = self._flat_inputs(
                srcs, masks, pos_embeds,
                (lambda i: i % half_l) if agnostic else (lambda i: i),
            )
            if self.separate_encoder:
                # two frames, half the levels each, current frame first
                split = sum(h * w for h, w in spatial_shapes[:half_l])
                mem_cur = encode(
                    src_flat[:, :split], spatial_shapes[:half_l],
                    valid_ratios[:, :half_l], pos_flat[:, :split],
                    mask_flat[:, :split],
                )
                mem_prev = encode(
                    src_flat[:, split:], spatial_shapes[half_l:],
                    valid_ratios[:, half_l:], pos_flat[:, split:],
                    mask_flat[:, split:],
                )
                memory = torch.cat([mem_cur, mem_prev], dim=1)
            else:
                memory = encode(src_flat, spatial_shapes, valid_ratios,
                                pos_flat, mask_flat)
        cached = prev_encoded is not None or prev_is_current
        return (memory, mask_flat, valid_ratios, spatial_shapes,
                src_flat.dtype, cached)

    def decode(
        self,
        enc,  # encode's result
        query_embed,  # [Q, 2C], None with two_stage
        track_query_embeds=None,  # [B, T, C]
        track_query_boxes=None,  # [B, T, 4]
        track_query_active=None,  # [B, T] bool
        bbox_embeds=None,  # per-layer refine heads
        class_embed_fn=None,  # two_stage: the encoder's class head
        bbox_embed_fn=None,  # two_stage: the encoder's box head
    ):
        """The decoder's half of a forward, over ``encode``'s result."""
        memory, mask_flat, valid_ratios, spatial_shapes, dtype, cached = enc
        b = memory.shape[0]
        query_pad_mask = enc_class = enc_coord = None
        if self.two_stage:
            query_pos, tgt, reference_points, enc_class, enc_coord = \
                self._two_stage_queries(memory, mask_flat, spatial_shapes,
                                        class_embed_fn, bbox_embed_fn)
        else:
            query_pos, tgt = torch.split(query_embed, self.d_model, dim=-1)
            query_pos = query_pos[None].expand(b, -1, -1)
            tgt = tgt[None].expand(b, -1, -1).to(dtype)
            reference_points = torch.sigmoid(
                self.reference_points_head(query_pos)
            ).float()
        if track_query_embeds is not None and not self.two_stage:
            t = track_query_embeds.shape[1]
            active = track_query_active
            tq = torch.where(active[..., None], track_query_embeds, 0.0)
            query_pos = torch.cat(
                [query_pos.new_zeros(b, t, self.d_model), query_pos], dim=1
            )
            tgt = torch.cat([tq.to(dtype), tgt], dim=1)
            reference_points = torch.cat(
                [track_query_boxes[..., :2].float(), reference_points], dim=1
            )
            query_pad_mask = torch.cat(
                [~active, active.new_zeros(b, tgt.shape[1] - t)], dim=1
            )
        init_reference = reference_points

        # dec_klevels: the decoder samples only the k finest levels of EACH
        # frame, a contiguous prefix of each frame's half in the level-major
        # layout; the returned memory stays whole
        frames, half, k = self._dec_frames_half()
        if k < half:
            starts = [0]
            for h, w in spatial_shapes:
                starts.append(starts[-1] + h * w)
            spans = [(starts[f * half], starts[f * half + k]) for f in range(frames)]

            def keep_tokens(x):
                return torch.cat([x[:, a:z] for a, z in spans], dim=1)

            dec_shapes = tuple(
                spatial_shapes[f * half + j] for f in range(frames) for j in range(k)
            )
            dec_memory = keep_tokens(memory)
            dec_mask = keep_tokens(mask_flat)
            dec_vr = torch.cat(
                [valid_ratios[:, f * half : f * half + k] for f in range(frames)],
                dim=1,
            )
        else:
            dec_shapes = tuple(spatial_shapes)
            dec_memory, dec_mask, dec_vr = memory, mask_flat, valid_ratios

        # The JAX package caches the decoder's 4C quad table of the previous
        # frame's half. The raw-pool kernel reads src rows directly, so the
        # port caches nothing here: each cross-attention masks the decoder
        # memory (both halves) itself, or samples the int8 table.
        table = None
        if self.dec_int8 and not self.training:
            table = self._dec_table(dec_memory, dec_mask, dec_shapes, cached)
        hs, inter_refs = self.decoder(
            tgt, reference_points, dec_memory, dec_shapes, dec_vr,
            query_pos, dec_mask, query_pad_mask, bbox_embeds, table,
        )
        return (hs, memory, init_reference, inter_refs, query_pad_mask,
                enc_class, enc_coord)
