"""Deformable DETR (port of ``kinet_tpu/models/deformable_detr.py``).

- Multi-scale pyramid from C3..C5: per-level 1x1 input projections +
  GroupNorm, and an extra stride-64 level by a 3x3/s2 convolution.
- Multi-frame attention: the CURRENT frame's levels come first in the
  flattened sequence.
- ``cache_prev_encoder``: the encoder is frame-slot agnostic, so the caller
  passes last frame's ``out["frame_memory"]`` as ``prev_memory`` and the
  previous frame is never re-encoded; ``out["pos_cache"]`` likewise skips
  the sine embeddings while the pad mask is unchanged.
- ``dec_msda_int8`` (inference only, lossy): the decoder samples an int8
  table of its memory, one scale per frame's half (see
  ``DeformableTransformer``).
- Iterative box refinement with per-layer heads; the class-head bias uses
  the focal prior (0.01).
- ``two_stage``: the decoder's queries are the best-scored encoder
  proposals (see ``DeformableTransformer``); there is no ``query_embed``,
  the heads number ``dec_layers + 1`` (per layer, box refinement or not),
  the last scores and refines the proposals, and the output carries
  ``enc_outputs`` (their logits and boxes) for the criterion.
- ``merge_frame_features``: each level of either frame is merged with the
  previous frame's projection of that level by a 1x1 convolution
  (``merge{i}``) over the two, concatenated; the previous frame is the
  current one on a first frame, and its own projection is merged with
  itself. Not with ``cache_prev_encoder``.
- ``enc_msda_shared_locs`` / ``enc_msda_topk`` / ``enc_msda_int8``: the
  encoder's MSDA variants (see ``MSDeformAttn``).
- Track queries occupy fixed leading decoder slots; their boxes give the
  reference points.
- ``hs_embed`` is the decoder's last output (no final norm), the track-query
  feedback of the tracker.
- Training: in ``train()`` mode with ``aux_loss`` the output carries
  ``aux_outputs`` (the heads of the first ``dec_layers - 1`` decoder
  layers) for the criterion; ``query_valid`` marks the active queries.
  Evaluation asks for them in eval mode too (``aux_outputs=True``), as
  the JAX model always gives them.
  Dropout draws from ``self.dropout_rng``.
- ``spatial`` (``parallel/sp.py``, inference): the frame's rows split over
  a process group; the trunk, the input projections (halo convolutions,
  GroupNorm statistics reduced over the group) and the encoder run on
  this process's rows, pad masks and position encodings whole; the memory
  is gathered and the rest runs replicated.
- ``masks``: the backbone gives all four levels C2..C5, the pyramid still
  uses C3..C5, and the output carries the four levels
  (``backbone_features``) and the flattened ``memory`` [B, S, D] (the
  current frame's levels first) for the mask head
  (``models/segmentation.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..structs import ImageBatch, Targets
from ..utils import trace
from .backbone import Backbone, BackboneWithMasksAll, downsample_pad_mask
from .deformable_transformer import (
    DeformableTransformer,
    DropoutRNG,
    inverse_sigmoid,
)
from .detr import MLP
from .position_encoding import sine3d_position_encoding, sine_position_encoding


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm that also normalizes a group of one value (a 1x1 level
    with one channel a group), to its bias as flax's GroupNorm does;
    ``F.group_norm`` refuses such an input."""

    def forward(self, x):
        return torch.group_norm(x, self.num_groups, self.weight, self.bias,
                                self.eps)


class DeformableDETR(nn.Module):
    def __init__(
        self,
        num_classes: int = 20,
        hidden_dim: int = 288,
        num_queries: int = 300,
        nheads: int = 8,
        enc_layers: int = 6,
        dec_layers: int = 6,
        dim_feedforward: int = 1024,
        backbone_name: str = "resnet50",
        dilation: bool = False,
        num_feature_levels: int = 4,
        dec_n_points: int = 4,
        enc_n_points: int = 4,
        with_box_refine: bool = False,
        multi_frame_attention: bool = False,
        multi_frame_encoding: bool = True,
        cache_prev_encoder: bool = False,
        two_stage: bool = False,
        merge_frame_features: bool = False,
        enc_msda_shared_locs: bool = False,
        enc_msda_topk: int = 0,
        enc_msda_int8: bool = False,
        enc_lite: bool = False,
        enc_lite_klevels: int = 0,
        enc_lite_high_klevels: int = 0,
        dec_gather_raw: bool = False,
        dec_klevels: int = 0,
        dec_msda_int8: bool = False,
        msda_ref_normalizer: bool = False,
        num_track_slots: int = 0,
        focal_loss: bool = True,
        dropout: float = 0.0,
        aux_loss: bool = True,
        remat: bool = False,
        masks: bool = False,
    ):
        super().__init__()
        if cache_prev_encoder and not multi_frame_attention:
            raise ValueError("cache_prev_encoder requires multi_frame_attention")
        if cache_prev_encoder and merge_frame_features:
            raise ValueError(
                "cache_prev_encoder is incompatible with merge_frame_features")
        self.hidden_dim = hidden_dim
        self.num_queries = num_queries
        self.dec_layers = dec_layers
        self.num_feature_levels = num_feature_levels
        self.with_box_refine = with_box_refine
        self.multi_frame_attention = multi_frame_attention
        self.multi_frame_encoding = multi_frame_encoding
        self.cache_prev_encoder = cache_prev_encoder
        self.two_stage = two_stage
        self.merge_frame_features = merge_frame_features
        self.num_track_slots = num_track_slots
        self.aux_loss = aux_loss
        self.masks = masks
        self.dropout_rng = DropoutRNG()

        self.backbone = (BackboneWithMasksAll if masks else Backbone)(
            backbone_name, True, dilation)
        chans = self.backbone.num_channels  # [512, 1024, 2048]
        n_backbone_levels = min(num_feature_levels, len(chans))
        gn_groups = math.gcd(32, hidden_dim)
        for i in range(num_feature_levels):
            if i < n_backbone_levels:
                conv = nn.Conv2d(chans[i], hidden_dim, 1)
            else:
                in_ch = chans[-1] if i == n_backbone_levels else hidden_dim
                conv = nn.Conv2d(in_ch, hidden_dim, 3, stride=2, padding=1)
            self.add_module(f"input_proj{i}", conv)
            self.add_module(
                f"input_proj_gn{i}", GroupNorm(gn_groups, hidden_dim, eps=1e-5)
            )
        if merge_frame_features:
            for i in range(num_feature_levels):
                self.add_module(f"merge{i}",
                                nn.Conv2d(2 * hidden_dim, hidden_dim, 1))

        total_levels = num_feature_levels * (2 if multi_frame_attention else 1)
        self.transformer = DeformableTransformer(
            d_model=hidden_dim, nheads=nheads,
            num_encoder_layers=enc_layers, num_decoder_layers=dec_layers,
            dim_feedforward=dim_feedforward,
            num_feature_levels=total_levels, dec_n_points=dec_n_points,
            enc_n_points=enc_n_points,
            multi_frame_attention_separate_encoder=multi_frame_attention,
            frame_agnostic_levels=cache_prev_encoder,
            enc_lite=enc_lite, enc_lite_klevels=enc_lite_klevels,
            enc_lite_high_klevels=enc_lite_high_klevels,
            dec_gather_raw=dec_gather_raw, dec_klevels=dec_klevels,
            dec_msda_int8=dec_msda_int8,
            msda_ref_normalizer=msda_ref_normalizer,
            dropout=dropout, rng=self.dropout_rng, remat=remat,
            two_stage=two_stage, two_stage_num_proposals=num_queries,
            enc_shared_locs=enc_msda_shared_locs, enc_topk=enc_msda_topk,
            enc_int8=enc_msda_int8,
        )
        if not two_stage:
            self.query_embed = nn.Parameter(
                torch.empty(num_queries, hidden_dim * 2))
        out_classes = num_classes + (0 if focal_loss else 1)
        self.class_bias_init = (
            -math.log((1 - 0.01) / 0.01) if focal_loss else 0.0
        )
        # box refinement or two-stage: one head pair per decoder layer (and
        # with two-stage one more, the encoder's), else one shared pair
        self.per_layer_heads = with_box_refine or two_stage
        self.num_heads = dec_layers + (1 if two_stage else 0)
        if self.per_layer_heads:
            for i in range(self.num_heads):
                self.add_module(f"class_embed{i}", nn.Linear(hidden_dim, out_classes))
                self.add_module(f"bbox_embed{i}", MLP(hidden_dim, hidden_dim, 4, 3))
        else:
            self.class_embed = nn.Linear(hidden_dim, out_classes)
            self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)

    def class_head(self, i):
        return getattr(self, f"class_embed{i}") if self.per_layer_heads else self.class_embed

    def bbox_head(self, i):
        return getattr(self, f"bbox_embed{i}") if self.per_layer_heads else self.bbox_embed

    def level_strides(self) -> list:
        """The stride of each pyramid level: C3..C5's, then each extra
        level twice the one before."""
        out = list(self.backbone.trunk.strides[-3:])[:self.num_feature_levels]
        while len(out) < self.num_feature_levels:
            out.append(out[-1] * 2)
        return out

    def _project_levels(self, feats, pad_mask, merge_with=None, spatial=None):
        """Input projections + extra stride-64 level; masks per level. With
        ``merge_with`` (merge_frame_features) each level is merged with that
        level of it, and the next extra level is projected from the merged
        one, as in the JAX package. With ``spatial`` the levels are this
        process's rows (the masks whole)."""
        srcs, masks = [], []
        strides = self.level_strides()
        for i in range(self.num_feature_levels):
            conv = getattr(self, f"input_proj{i}")
            gn = getattr(self, f"input_proj_gn{i}")
            if i < len(feats):
                x = feats[i]
            elif i == len(feats):
                x = feats[-1]  # the extra stride-64 level, from C5
            else:
                x = srcs[-1]
            if spatial is None:
                src = gn(conv(x))
                hw = src.shape[-2:]
            else:
                s_in = strides[i] if i < len(feats) else strides[i - 1]
                src = spatial.group_norm(gn, spatial.conv(conv, x, s_in))
                hw = (spatial.level_height(strides[i]), src.shape[-1])
            if merge_with is not None:
                src = getattr(self, f"merge{i}")(
                    torch.cat([src, merge_with[i]], dim=1))
            srcs.append(src)
            masks.append(downsample_pad_mask(pad_mask, hw))
        return srcs, masks

    def _pos_embeds(self, masks, frame_idx: int):
        pos = []
        for m in masks:
            if self.multi_frame_attention and self.multi_frame_encoding:
                p3 = sine3d_position_encoding(
                    m, self.hidden_dim // 3, num_frames=2,
                    pad_to=self.hidden_dim,
                )
                pos.append(p3[:, frame_idx])
            else:
                pos.append(sine_position_encoding(m, self.hidden_dim // 2))
        return pos

    def _heads(self, i, hs, init_ref, inter_refs):
        """(logits, boxes) of decoder layer ``i``."""
        ref = inverse_sigmoid(init_ref if i == 0 else inter_refs[i - 1])
        tmp = self.bbox_head(i)(hs[i]).float()
        if ref.shape[-1] == 4:
            tmp = tmp + ref
        else:
            tmp = torch.cat([tmp[..., :2] + ref, tmp[..., 2:]], -1)
        return self.class_head(i)(hs[i]), torch.sigmoid(tmp)

    @property
    def image_dtype(self) -> torch.dtype:
        """The dtype the forward casts its images to first: the trackers
        stage frames in it (``tracking/staging.py``)."""
        return self.transformer.level_embed.dtype

    def forward(
        self,
        batch: ImageBatch,
        targets: Optional[Targets] = None,
        prev_features=None,  # (feats list, pad_mask) of the previous frame
        prev_memory=None,  # (encoded memory [B, S_half, C], pad_mask) of the
        # previous frame, as out["frame_memory"] (cache_prev_encoder)
        pos_cache=None,  # out["pos_cache"] of an earlier frame, same pad mask
        aux_outputs: Optional[bool] = None,  # default: in train() mode
        spatial=None,  # parallel/sp.py: this process's rows of the frame
    ) -> dict:
        with trace.span("backbone"):
            images = batch.images.to(self.image_dtype)
            if spatial is None:
                feats_all, _ = self.backbone(images, batch.pad_mask)
            else:
                feats_all = spatial.features(self.backbone, images)
        feats = feats_all[-3:]  # the pyramid's C3..C5
        b = images.shape[0]

        with trace.span("encoder"):
            prev_projected = None
            if self.merge_frame_features:
                # the previous frame's levels, projected with no merge (the
                # current frame's on a first frame)
                prev_projected = self._project_levels(
                    *(prev_features or (feats, batch.pad_mask)),
                    spatial=spatial)[0]
            srcs, masks = self._project_levels(feats, batch.pad_mask,
                                               prev_projected, spatial)
            pos = (list(pos_cache) if pos_cache is not None
                   else self._pos_embeds(masks, 0))

            enc_kwargs = {}
            if self.multi_frame_attention:
                if self.cache_prev_encoder and prev_memory is not None:
                    mem_prev, prev_pad = prev_memory[0], prev_memory[1]
                    p_masks = [downsample_pad_mask(prev_pad, m.shape[-2:])
                               for m in masks]
                    enc_kwargs = dict(prev_encoded=mem_prev,
                                      prev_masks=p_masks)
                elif self.cache_prev_encoder and prev_features is None:
                    # first frame: prev := current; with the frame-agnostic
                    # encoder its memory is exactly mem_cur, one encoder run
                    enc_kwargs = dict(prev_is_current=True)
                else:
                    if prev_features is None:
                        prev_feats, prev_pad = feats, batch.pad_mask
                    else:
                        prev_feats, prev_pad = prev_features
                    p_srcs, p_masks = self._project_levels(
                        prev_feats, prev_pad, prev_projected, spatial)
                    p_pos = self._pos_embeds(
                        p_masks, frame_idx=0 if self.cache_prev_encoder else 1
                    )
                    srcs, masks = srcs + p_srcs, masks + p_masks
                    pos = pos + p_pos
            if spatial is not None:
                # whole-frame levels (zeros outside this process's rows) for
                # the flattening; the encoder reads only its own tokens
                strides = self.level_strides()
                srcs = [spatial.whole(x, strides[i % self.num_feature_levels])
                        for i, x in enumerate(srcs)]
                enc_kwargs["spatial"] = spatial
            enc = self.transformer.encode(srcs, masks, pos, **enc_kwargs)

        with trace.span("decoder"):
            t = self.num_track_slots
            dec_kwargs = {}
            if t > 0:
                dev = images.device
                if targets is None:
                    active = torch.zeros(b, t, dtype=torch.bool, device=dev)
                    tq_embeds = torch.zeros(b, t, self.hidden_dim, device=dev)
                    tq_boxes = torch.full((b, t, 4), 0.5, device=dev)
                else:
                    active = targets.track_query_mask
                    tq_embeds = targets.track_query_embeds
                    tq_boxes = torch.where(
                        active[..., None], targets.track_query_boxes, 0.5
                    )
                dec_kwargs = dict(
                    track_query_embeds=tq_embeds, track_query_boxes=tq_boxes,
                    track_query_active=active,
                )
            if self.two_stage:
                dec_kwargs.update(
                    class_embed_fn=self.class_head(self.dec_layers),
                    bbox_embed_fn=self.bbox_head(self.dec_layers))
            (hs, memory, init_ref, inter_refs, q_pad, enc_class,
             enc_coord) = self.transformer.decode(
                enc, None if self.two_stage else self.query_embed,
                bbox_embeds=(
                    [self.bbox_head(i) for i in range(self.dec_layers)]
                    if self.with_box_refine else None
                ),
                **dec_kwargs,
            )

            # the last decoder layer's heads; the other layers' heads (the
            # aux_outputs) feed only the losses, so inference skips them
            last = self.dec_layers - 1
            if aux_outputs is None:
                aux_outputs = self.training
            layers = (range(last + 1) if self.aux_loss and aux_outputs
                      else [last])
            heads = {i: self._heads(i, hs, init_ref, inter_refs)
                     for i in layers}
            nq = hs.shape[2]
            out = {
                "pred_logits": heads[last][0],
                "pred_boxes": heads[last][1],
                "hs_embed": hs[last],
                "query_valid": (
                    ~q_pad if q_pad is not None
                    else torch.ones(b, nq, dtype=torch.bool, device=hs.device)
                ),
            }
            if len(heads) > 1:
                out["aux_outputs"] = [
                    {"pred_logits": heads[i][0], "pred_boxes": heads[i][1]}
                    for i in range(last)
                ]
            if self.two_stage:
                out["enc_outputs"] = {"pred_logits": enc_class,
                                      "pred_boxes": torch.sigmoid(enc_coord)}
        # features of this frame, reusable as next frame's prev_features
        out["frame_features"] = (feats, batch.pad_mask)
        if self.multi_frame_attention and self.cache_prev_encoder:
            split = sum(
                m.shape[1] * m.shape[2] for m in masks[: self.num_feature_levels]
            )
            out["frame_memory"] = (memory[:, :split], batch.pad_mask)
            out["pos_cache"] = tuple(pos[: self.num_feature_levels])
        if self.masks:
            if spatial is not None:
                feats_all = [spatial.gather(f, st) for f, st in
                             zip(feats_all, self.backbone.strides)]
            out["backbone_features"] = feats_all
            out["memory"] = memory
        return out
