"""DETR and the KineT model family (port of ``kinet_tpu/models/detr.py``;
reference: src/trackformer/models/detr.py).

- ``DETR``: vanilla DETR over the C5 feature with fixed track-query slots
  [T track slots | Q object queries]; inactive slots are masked out of
  self-attention and out of the losses (``query_valid``). Track queries
  enter as decoder input with a zero query position. Called with
  ``attention_maps=True`` its output also carries the last decoder layer's
  cross-attention weights (``attention_weights`` [B, H, T+Q, h*w]) and
  the memory [B, h, w, D], from which the tracker makes per-query maps
  (the JAX model's ``generate_attention_maps``). With ``masks`` the
  backbone gives all four levels C2..C5 (``frame_features``) and the
  output carries what the mask head reads (``models/segmentation.py``):
  the last decoder layer's normed output ``hs_last``, the projected C5
  feature ``src_proj`` [B, D, h, w], the ``memory`` [B, h, w, D] and its
  pad mask ``memory_pad_mask`` [B, h, w].
- ``KineT``: detections -> MLP backbone -> ``KinematicTransformer``
  (kept for parity; no config builds it, as in the JAX package).
- ``KinematicDetectorTransformer``: dual backbone + ``DualKinematicTransformer``;
  the class head reads the metadata stream and the box head the detection
  stream. Track queries arrive as raw trail encodings
  ``[trail (trail_enc_dim) | metadata history (meta_hist_dim)]`` per slot,
  lifted to the model width by two MLPs.
- ``KinematicDetectorEncoder``: encoder-only; projected trails are
  concatenated before the detections in the source sequence and every row
  is a prediction [T trail slots | N detection slots].

``DETR.forward`` runs in the tracer's spans ``backbone``, ``encoder`` (the
input projection, the position encoding and the encoder) and ``decoder``
(the decoder and the heads), named as ``DeformableDETR``'s
(``utils/trace.py``).

``hs_embed`` is the pre-norm decoder output of the last layer (the
track-query feedback). Heads of the other decoder layers (``aux_outputs``)
are computed in ``train()`` mode or when asked (``aux_outputs=True``).
Dropout draws from ``self.dropout_rng``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..structs import ImageBatch, KineBatch, Targets
from ..utils import trace
from .backbone import Backbone, BackboneWithMasksAll, KinetBackbone
from .deformable_transformer import DropoutRNG
from .position_encoding import sine_detection_encoding, sine_position_encoding
from .transformer import DualKinematicEncoder, DualKinematicTransformer, Transformer


class MLP(nn.Module):
    """Multi-layer perceptron with ReLU between layers ``layer0..``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x


def _query_slots(query_embed, targets, b, t, dtype):
    """(query_pos, tgt, tgt_pad) for [t track slots | Q object queries]:
    the active track slots' embeddings as decoder input with a zero
    position, inactive slots masked."""
    q, d = query_embed.shape
    dev = query_embed.device
    obj_pos = query_embed.to(dtype)[None].expand(b, q, d)
    zeros_q = torch.zeros(b, q, d, dtype=dtype, device=dev)
    no_pad = torch.zeros(b, q, dtype=torch.bool, device=dev)
    if t == 0:
        return obj_pos, zeros_q, no_pad
    if targets is None:
        active = torch.zeros(b, t, dtype=torch.bool, device=dev)
        tq = torch.zeros(b, t, d, dtype=dtype, device=dev)
    else:
        active = targets.track_query_mask
        tq = torch.where(active[..., None], targets.track_query_embeds,
                         0.0).to(dtype)
    zeros_t = torch.zeros(b, t, d, dtype=dtype, device=dev)
    return (torch.cat([zeros_t, obj_pos], 1), torch.cat([tq, zeros_q], 1),
            torch.cat([~active, no_pad], 1))


def _outputs(logits_of, boxes_of, n_layers, want_aux):
    """pred_logits / pred_boxes of the last layer, plus aux_outputs of the
    others when wanted."""
    last = n_layers - 1
    out = {"pred_logits": logits_of(last), "pred_boxes": boxes_of(last)}
    if want_aux and last > 0:
        out["aux_outputs"] = [
            {"pred_logits": logits_of(i), "pred_boxes": boxes_of(i)}
            for i in range(last)
        ]
    return out


class DETR(nn.Module):
    def __init__(
        self,
        num_classes: int = 20,
        hidden_dim: int = 256,
        num_queries: int = 100,
        nheads: int = 8,
        enc_layers: int = 6,
        dec_layers: int = 6,
        dim_feedforward: int = 2048,
        dropout: float = 0.1,
        pre_norm: bool = False,
        aux_loss: bool = True,
        backbone_name: str = "resnet50",
        dilation: bool = False,
        num_track_slots: int = 0,
        track_attention: bool = False,
        focal_loss: bool = False,
        masks: bool = False,
    ):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_queries = num_queries
        self.num_track_slots = num_track_slots
        self.aux_loss = aux_loss
        self.masks = masks
        self.dropout_rng = DropoutRNG()
        self.backbone = (BackboneWithMasksAll(backbone_name, True, dilation)
                         if masks else Backbone(backbone_name, False, dilation))
        self.input_proj = nn.Conv2d(self.backbone.num_channels[-1], hidden_dim, 1)
        self.query_embed = nn.Parameter(torch.empty(num_queries, hidden_dim))
        self.transformer = Transformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward,
            dropout, pre_norm, track_attention, num_track_slots,
            self.dropout_rng)
        self.class_embed = nn.Linear(hidden_dim,
                                     num_classes + (0 if focal_loss else 1))
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)

    @property
    def image_dtype(self) -> torch.dtype:
        """The dtype the forward casts its images to first: the trackers
        stage frames in it (``tracking/staging.py``)."""
        return self.query_embed.dtype

    def forward(self, batch: ImageBatch, targets: Optional[Targets] = None,
                prev_features=None,  # accepted for the tracker; single-frame
                aux_outputs: Optional[bool] = None,
                attention_maps: bool = False, spatial=None) -> dict:
        # spatial: parallel/sp.py's split of the frame's rows; the trunk
        # runs on this process's rows, the rest on the gathered features
        with trace.span("backbone"):
            images = batch.images.to(self.image_dtype)
            feats, masks = self.backbone(images, batch.pad_mask, spatial)
        with trace.span("encoder"):
            src, pad = self.input_proj(feats[-1]), masks[-1]
            b, d, h, w = src.shape
            pos = sine_position_encoding(pad, self.hidden_dim // 2)
            src_flat = src.flatten(2).transpose(1, 2)
            pos_flat = pos.reshape(b, h * w, d).to(src.dtype)
            pad_flat = pad.reshape(b, h * w)
            memory = self.transformer.encoder(src_flat, pos_flat, pad_flat)
        with trace.span("decoder"):
            query_pos, tgt, tgt_pad = _query_slots(
                self.query_embed, targets, b, self.num_track_slots, src.dtype)
            hs, hs_raw, weights = self.transformer.decoder(
                tgt, memory, query_pos, pos_flat, pad_flat, tgt_pad,
                return_weights=attention_maps)
            out = _outputs(
                lambda i: self.class_embed(hs[i]),
                lambda i: torch.sigmoid(self.bbox_embed(hs[i])),
                hs.shape[0],
                self.aux_loss and (self.training if aux_outputs is None
                                   else aux_outputs))
        out["hs_embed"] = hs_raw[-1]
        out["query_valid"] = ~tgt_pad
        # the frame's features, as the JAX model returns them; the next
        # frame's forward accepts and ignores them
        out["frame_features"] = (feats, batch.pad_mask)
        if weights is not None:
            out["attention_weights"] = weights
        if weights is not None or self.masks:
            out["memory"] = memory.reshape(b, h, w, d)
        if self.masks:
            out.update(hs_last=hs[-1], src_proj=src, memory_pad_mask=pad)
        return out


class KineT(nn.Module):
    """Image-free tracking transformer over external detections: detection
    and metadata vectors -> MLP backbone (summed) -> KinematicTransformer.
    Its backbone runs without dropout, as the JAX model calls it
    deterministically."""

    def __init__(
        self,
        num_classes: int = 20,
        hidden_dim: int = 288,
        num_queries: int = 150,
        nheads: int = 8,
        enc_layers: int = 1,
        dec_layers: int = 1,
        dim_feedforward: int = 2048,
        dropout: float = 0.1,
        pre_norm: bool = False,
        aux_loss: bool = True,
        num_track_slots: int = 0,
        max_detections: int = 60,
        focal_loss: bool = False,
        det_dim: int = 4,
        meta_dim: int = 1,
    ):
        super().__init__()
        self.num_track_slots = num_track_slots
        self.max_detections = max_detections
        self.aux_loss = aux_loss
        self.dropout_rng = DropoutRNG()
        self.det_backbone = KinetBackbone(det_dim, meta_dim, hidden_dim, 0.0)
        self.query_embed = nn.Parameter(torch.empty(num_queries, hidden_dim))
        self.transformer = Transformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward,
            dropout, pre_norm, rng=self.dropout_rng)
        self.class_embed = nn.Linear(hidden_dim,
                                     num_classes + (0 if focal_loss else 1))
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)

    def forward(self, batch: KineBatch, targets: Optional[Targets] = None,
                aux_outputs: Optional[bool] = None) -> dict:
        det_emb, meta_emb = self.det_backbone(batch.detections, batch.metadata)
        src = det_emb + meta_emb
        b, _, d = src.shape
        pos = sine_detection_encoding(
            batch.pad_mask, d // 2, max_detections=self.max_detections
        ).to(src.dtype)
        query_pos, tgt, tgt_pad = _query_slots(
            self.query_embed, targets, b, self.num_track_slots, src.dtype)
        hs, hs_raw, _, _ = self.transformer(
            src, pos, query_pos, tgt=tgt, src_key_pad_mask=batch.pad_mask,
            tgt_key_pad_mask=tgt_pad)
        out = _outputs(
            lambda i: self.class_embed(hs[i]),
            lambda i: torch.sigmoid(self.bbox_embed(hs[i])),
            hs.shape[0],
            self.aux_loss and (self.training if aux_outputs is None
                               else aux_outputs))
        out["hs_embed"] = hs_raw[-1]
        out["query_valid"] = ~tgt_pad
        return out


class KinematicDetectorTransformer(nn.Module):
    """Dual-stream KineT. ``trail_enc_dim`` 0 means the track embeddings are
    already [det | meta] at twice the model width."""

    def __init__(
        self,
        trail_enc_dim: int = 0,
        meta_hist_dim: int = 0,
        num_classes: int = 20,
        hidden_dim: int = 288,
        num_queries: int = 150,
        nheads: int = 8,
        enc_layers: int = 1,
        dec_layers: int = 1,
        dim_feedforward: int = 2048,
        dropout: float = 0.1,
        pre_norm: bool = False,
        aux_loss: bool = True,
        num_track_slots: int = 0,
        max_detections: int = 60,
        focal_loss: bool = False,
        det_dim: int = 4,
        meta_dim: int = 1,
    ):
        super().__init__()
        self.trail_enc_dim = trail_enc_dim
        self.meta_hist_dim = meta_hist_dim
        self.hidden_dim = hidden_dim
        self.num_queries = num_queries
        self.num_track_slots = num_track_slots
        self.max_detections = max_detections
        self.aux_loss = aux_loss
        self.dropout_rng = DropoutRNG()
        self.kinet_backbone = KinetBackbone(det_dim, meta_dim, hidden_dim,
                                            dropout, self.dropout_rng)
        self.query_embed_det = nn.Parameter(torch.empty(num_queries, hidden_dim))
        self.query_embed_meta = nn.Parameter(torch.empty(num_queries, hidden_dim))
        self.transformer = DualKinematicTransformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward,
            dropout, pre_norm, self.dropout_rng)
        self.class_embed = nn.Linear(hidden_dim,
                                     num_classes + (0 if focal_loss else 1))
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)
        if trail_enc_dim:
            # 3-layer MLPs, the metadata one through a hidden_dim // 2
            # bottleneck
            self.track_proj_det = MLP(trail_enc_dim, hidden_dim, hidden_dim, 3)
            self.track_proj_meta = MLP(meta_hist_dim, hidden_dim // 2,
                                       hidden_dim, 3)

    def forward(self, batch: KineBatch, targets: Optional[Targets] = None,
                aux_outputs: Optional[bool] = None) -> dict:
        det_emb, meta_emb = self.kinet_backbone(batch.detections,
                                                batch.metadata)
        b, _, d = det_emb.shape
        dtype, dev = det_emb.dtype, det_emb.device
        pos = sine_detection_encoding(
            batch.pad_mask, d // 2, max_detections=self.max_detections
        ).to(dtype)
        q = self.num_queries
        qp_det = self.query_embed_det.to(dtype)[None].expand(b, q, d)
        qp_meta = self.query_embed_meta.to(dtype)[None].expand(b, q, d)
        zeros_q = torch.zeros(b, q, d, dtype=dtype, device=dev)
        tgt_pad = torch.zeros(b, q, dtype=torch.bool, device=dev)
        tgt_det = tgt_meta = zeros_q
        t = self.num_track_slots
        if t > 0:
            split = self.trail_enc_dim or d
            meta_w = self.meta_hist_dim if self.trail_enc_dim else d
            if targets is None:
                active = torch.zeros(b, t, dtype=torch.bool, device=dev)
                emb = torch.zeros(b, t, split + meta_w, dtype=dtype, device=dev)
            else:
                active = targets.track_query_mask
                emb = targets.track_query_embeds.to(dtype)
            tq_det, tq_meta = emb[..., :split], emb[..., split:]
            if self.trail_enc_dim:
                tq_det = self.track_proj_det(tq_det)
                tq_meta = self.track_proj_meta(tq_meta)
            tq_det = torch.where(active[..., None], tq_det, 0.0).to(dtype)
            tq_meta = torch.where(active[..., None], tq_meta, 0.0).to(dtype)
            zeros_t = torch.zeros(b, t, d, dtype=dtype, device=dev)
            qp_det = torch.cat([zeros_t, qp_det], 1)
            qp_meta = torch.cat([zeros_t, qp_meta], 1)
            tgt_det = torch.cat([tq_det, zeros_q], 1)
            tgt_meta = torch.cat([tq_meta, zeros_q], 1)
            tgt_pad = torch.cat([~active, tgt_pad], 1)

        hs_det, hs_meta, _, _ = self.transformer(
            det_emb, meta_emb, pos, qp_det, qp_meta, tgt_det=tgt_det,
            tgt_meta=tgt_meta, src_key_pad_mask=batch.pad_mask,
            tgt_key_pad_mask=tgt_pad)
        out = _outputs(
            lambda i: self.class_embed(hs_meta[i]),
            lambda i: torch.sigmoid(self.bbox_embed(hs_det[i])),
            hs_det.shape[0],
            self.aux_loss and (self.training if aux_outputs is None
                               else aux_outputs))
        out["hs_embed"] = torch.cat([hs_det[-1], hs_meta[-1]], dim=-1)
        out["query_valid"] = ~tgt_pad
        # the input detections, for the ordered-transformer matcher
        out["detections"] = batch.detections
        out["det_valid"] = ~batch.pad_mask
        return out


class KinematicDetectorEncoder(nn.Module):
    """Encoder-only KineT over [T trail slots | N detection slots]."""

    def __init__(
        self,
        num_classes: int = 20,
        hidden_dim: int = 288,
        nheads: int = 8,
        enc_layers: int = 1,
        dim_feedforward: int = 2048,
        dropout: float = 0.1,
        pre_norm: bool = False,
        num_track_slots: int = 60,
        max_detections: int = 60,
        focal_loss: bool = False,
        det_dim: int = 4,
        meta_dim: int = 1,
        trail_dim: int = 20,
    ):
        super().__init__()
        self.num_track_slots = num_track_slots
        self.max_detections = max_detections
        self.dropout_rng = DropoutRNG()
        self.kinet_backbone = KinetBackbone(det_dim, meta_dim, hidden_dim,
                                            dropout, self.dropout_rng)
        self.trail_proj = nn.Linear(trail_dim, hidden_dim)
        self.encoder = DualKinematicEncoder(
            hidden_dim, nheads, enc_layers, dim_feedforward, dropout,
            pre_norm, self.dropout_rng)
        self.class_embed = nn.Linear(hidden_dim,
                                     num_classes + (0 if focal_loss else 1))
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)

    def forward(self, batch: KineBatch, targets: Optional[Targets] = None,
                aux_outputs: Optional[bool] = None) -> dict:
        det_emb, meta_emb = self.kinet_backbone(batch.detections,
                                                batch.metadata)
        b, _, d = det_emb.shape
        dtype, dev = det_emb.dtype, det_emb.device
        if targets is not None:
            active = targets.track_query_mask
            trails = torch.where(active[..., None],
                                 targets.track_query_embeds, 0.0)
            trail_emb = self.trail_proj(trails.to(dtype))
        else:
            t = self.num_track_slots
            active = torch.zeros(b, t, dtype=torch.bool, device=dev)
            trail_emb = torch.zeros(b, t, d, dtype=dtype, device=dev)
        pad = torch.cat([~active, batch.pad_mask], 1)
        pos = sine_detection_encoding(
            pad, d // 2, max_detections=self.max_detections).to(dtype)
        enc_det, enc_meta = self.encoder(
            torch.cat([trail_emb, det_emb], 1),
            torch.cat([trail_emb, meta_emb], 1), pos, src_key_pad_mask=pad)
        hs = enc_det + enc_meta
        return {
            "pred_logits": self.class_embed(hs),
            "pred_boxes": torch.sigmoid(self.bbox_embed(hs)),
            "hs_embed": hs,
            "query_valid": ~pad,
            "detections": batch.detections,
            "det_valid": ~batch.pad_mask,
        }
