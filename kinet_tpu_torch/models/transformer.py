"""Vanilla and kinematic transformers (port of
``kinet_tpu/models/transformer.py``; reference:
src/trackformer/models/transformer.py).

Layout is [B, L, D] batch-first. Attention is ``MultiheadAttention`` with
flax's semantics (query scaled by 1/sqrt(d_head), masked keys at the
dtype's most negative logit, so a query whose keys are all masked attends
uniformly); masks are boolean key-padding masks, True = padding.

- ``Transformer``: encoder + decoder, post- or pre-norm, LayerNorm eps 1e-5;
  the decoder returns every layer's output after the shared final norm
  (``hs``) and without it (``hs_raw``, the track-query feedback);
- ``track_attention``: before each decoder layer the leading
  ``num_track_slots`` queries get a self-attention block of their own;
- ``KinematicTransformer``: the single KineT stream;
- ``DualKinematicTransformer``: box and metadata streams fused after the
  decoders by two ``IntertwinedBranch`` (the metadata branch reads the
  updated detection stream);
- ``DualKinematicEncoder``: the encoder-only variant (the metadata branch
  reads the pre-fusion detection stream).

Dropout acts in ``train()`` mode only, drawing from the model's
``DropoutRNG``. Module names follow the flax tree; ``flax_names`` gives the
flax path of a child where the auto-named flax modules differ
(``tools/from_jax.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from .deformable_transformer import Dropout, DropoutRNG, MultiheadAttention

_SELF_ATTN = "_SelfAttnBlock_0/MultiHeadDotProductAttention_0"


def _valid(pad_mask):
    return None if pad_mask is None else ~pad_mask


def _with_pos(x, pos):
    return x if pos is None else x + pos


class TransformerEncoderLayer(nn.Module):
    flax_names = {"self_attn": _SELF_ATTN}

    def __init__(self, d_model, nheads, dim_feedforward, dropout=0.1,
                 pre_norm=False, rng=None):
        super().__init__()
        rng = rng or DropoutRNG()
        self.pre_norm = pre_norm
        self.self_attn = MultiheadAttention(d_model, nheads, dropout, rng)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.dropout1 = Dropout(dropout, rng)  # self-attention output
        self.dropout_ffn = Dropout(dropout, rng)  # FFN hidden
        self.dropout2 = Dropout(dropout, rng)  # FFN output

    def _ffn(self, x):
        return self.linear2(self.dropout_ffn(torch.relu(self.linear1(x))))

    def forward(self, src, pos, key_pad_mask=None):
        valid = _valid(key_pad_mask)

        def sa(x):
            q = _with_pos(x, pos)
            return self.self_attn(q, q, x, valid)

        if self.pre_norm:
            src = src + self.dropout1(sa(self.norm1(src)))
            return src + self.dropout2(self._ffn(self.norm2(src)))
        src = self.norm1(src + self.dropout1(sa(src)))
        return self.norm2(src + self.dropout2(self._ffn(src)))


class TransformerDecoderLayer(nn.Module):
    flax_names = {"self_attn": _SELF_ATTN,
                  "cross_attn": "cross_attn/MultiHeadDotProductAttention_0"}

    def __init__(self, d_model, nheads, dim_feedforward, dropout=0.1,
                 pre_norm=False, rng=None):
        super().__init__()
        rng = rng or DropoutRNG()
        self.pre_norm = pre_norm
        self.self_attn = MultiheadAttention(d_model, nheads, dropout, rng)
        self.cross_attn = MultiheadAttention(d_model, nheads, dropout, rng)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.dropout1 = Dropout(dropout, rng)  # self-attention output
        self.dropout2 = Dropout(dropout, rng)  # cross-attention output
        self.dropout_ffn = Dropout(dropout, rng)  # FFN hidden
        self.dropout3 = Dropout(dropout, rng)  # FFN output

    def forward(self, tgt, memory, query_pos, mem_pos, mem_key_pad_mask=None,
                tgt_key_pad_mask=None, return_weights=False):
        """-> tgt, or (tgt, cross-attention weights [B, H, Lq, Lk]) with
        ``return_weights``."""
        tgt_valid, mem_valid = _valid(tgt_key_pad_mask), _valid(mem_key_pad_mask)
        mem_k = _with_pos(memory, mem_pos)
        weights = None

        def self_attn(x):
            q = _with_pos(x, query_pos)
            return self.self_attn(q, q, x, tgt_valid)

        def cross_attn(x):
            nonlocal weights
            out = self.cross_attn(_with_pos(x, query_pos), mem_k, memory,
                                  mem_valid, return_weights=return_weights)
            if return_weights:
                out, weights = out
            return out

        def ffn(x):
            return self.linear2(self.dropout_ffn(torch.relu(self.linear1(x))))

        if self.pre_norm:
            tgt = tgt + self.dropout1(self_attn(self.norm1(tgt)))
            tgt = tgt + self.dropout2(cross_attn(self.norm2(tgt)))
            tgt = tgt + self.dropout3(ffn(self.norm3(tgt)))
        else:
            tgt = self.norm1(tgt + self.dropout1(self_attn(tgt)))
            tgt = self.norm2(tgt + self.dropout2(cross_attn(tgt)))
            tgt = self.norm3(tgt + self.dropout3(ffn(tgt)))
        return (tgt, weights) if return_weights else tgt


class TransformerDecoderLayerTrack(nn.Module):
    """Self-attention block over the track queries only."""

    flax_names = {"self_attn": _SELF_ATTN}

    def __init__(self, d_model, nheads, dropout=0.1, rng=None):
        super().__init__()
        rng = rng or DropoutRNG()
        self.self_attn = MultiheadAttention(d_model, nheads, dropout, rng)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout1 = Dropout(dropout, rng)

    def forward(self, tgt, query_pos, key_pad_mask=None):
        q = _with_pos(tgt, query_pos)
        h = self.self_attn(q, q, tgt, _valid(key_pad_mask))
        return self.norm1(tgt + self.dropout1(h))


class TransformerEncoder(nn.Module):
    # the pre-norm stack's final LayerNorm is auto-named in flax
    flax_names = {"norm": "LayerNorm_0"}

    def __init__(self, num_layers, d_model, nheads, dim_feedforward,
                 dropout=0.1, pre_norm=False, rng=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                d_model, nheads, dim_feedforward, dropout, pre_norm, rng))
        self.norm = nn.LayerNorm(d_model, eps=1e-5) if pre_norm else None

    def forward(self, src, pos, key_pad_mask=None):
        for i in range(self.num_layers):
            src = getattr(self, f"layer{i}")(src, pos, key_pad_mask)
        return src if self.norm is None else self.norm(src)


class TransformerDecoder(nn.Module):
    """Returns (hs, hs_raw, weights): every layer's output stacked
    [num_layers, B, Lq, D] after the shared final norm and without it, and
    the last layer's cross-attention weights when asked (else None)."""

    def __init__(self, num_layers, d_model, nheads, dim_feedforward,
                 dropout=0.1, pre_norm=False, track_attention=False,
                 num_track_slots=0, rng=None):
        super().__init__()
        self.num_layers = num_layers
        self.track_slots = num_track_slots if track_attention else 0
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        for i in range(num_layers):
            if self.track_slots:
                self.add_module(f"track_layer{i}", TransformerDecoderLayerTrack(
                    d_model, nheads, dropout, rng))
            self.add_module(f"layer{i}", TransformerDecoderLayer(
                d_model, nheads, dim_feedforward, dropout, pre_norm, rng))

    def forward(self, tgt, memory, query_pos, mem_pos, mem_key_pad_mask=None,
                tgt_key_pad_mask=None, return_weights=False):
        raw, weights = [], None
        t = self.track_slots
        for i in range(self.num_layers):
            if t:
                updated = getattr(self, f"track_layer{i}")(
                    tgt[:, :t],
                    None if query_pos is None else query_pos[:, :t],
                    None if tgt_key_pad_mask is None else tgt_key_pad_mask[:, :t],
                )
                tgt = torch.cat([updated, tgt[:, t:]], dim=1)
            last = return_weights and i == self.num_layers - 1
            tgt = getattr(self, f"layer{i}")(
                tgt, memory, query_pos, mem_pos, mem_key_pad_mask,
                tgt_key_pad_mask, return_weights=last,
            )
            if last:
                tgt, weights = tgt
            raw.append(tgt)
        raw = torch.stack(raw)
        return self.norm(raw), raw, weights


class Transformer(nn.Module):
    """DETR transformer over a flattened memory: src/src_pos [B, L, D],
    query_pos [B, Q, D]. Returns (hs, hs_raw, memory, weights)."""

    def __init__(self, d_model=256, nheads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 pre_norm=False, track_attention=False, num_track_slots=0,
                 rng=None):
        super().__init__()
        self.encoder = TransformerEncoder(
            num_encoder_layers, d_model, nheads, dim_feedforward, dropout,
            pre_norm, rng)
        self.decoder = TransformerDecoder(
            num_decoder_layers, d_model, nheads, dim_feedforward, dropout,
            pre_norm, track_attention, num_track_slots, rng)

    def forward(self, src, src_pos, query_pos, tgt=None, src_key_pad_mask=None,
                tgt_key_pad_mask=None, return_weights=False):
        memory = self.encoder(src, src_pos, src_key_pad_mask)
        if tgt is None:
            tgt = torch.zeros_like(query_pos)
        hs, hs_raw, weights = self.decoder(
            tgt, memory, query_pos, src_pos, src_key_pad_mask,
            tgt_key_pad_mask, return_weights=return_weights)
        return hs, hs_raw, memory, weights


class IntertwinedBranch(nn.Module):
    """One-directional cross-stream fusion, src1 updated from src2:
    ``norm(dropout(relu(cat(linear_input1(src1), linear_input2(src2)))) +
    src1)``."""

    def __init__(self, d_model, dropout=0.1, rng=None):
        super().__init__()
        self.linear_input1 = nn.Linear(d_model, d_model // 2)
        self.linear_input2 = nn.Linear(d_model, d_model // 2)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout, rng or DropoutRNG())

    def forward(self, src1, src2):
        x = torch.relu(torch.cat(
            [self.linear_input1(src1), self.linear_input2(src2)], dim=-1))
        return self.norm(self.dropout(x) + src1)


class KinematicTransformer(nn.Module):
    """One KineT stream: encoder over the detection sequence + decoder.
    Returns (hs, hs_raw, memory)."""

    def __init__(self, d_model=288, nheads=8, num_encoder_layers=1,
                 num_decoder_layers=1, dim_feedforward=2048, dropout=0.1,
                 pre_norm=False, rng=None):
        super().__init__()
        self.encoder = TransformerEncoder(
            num_encoder_layers, d_model, nheads, dim_feedforward, dropout,
            pre_norm, rng)
        self.decoder = TransformerDecoder(
            num_decoder_layers, d_model, nheads, dim_feedforward, dropout,
            pre_norm, rng=rng)

    def forward(self, src, pos, query_pos, tgt=None, src_key_pad_mask=None,
                tgt_key_pad_mask=None):
        if tgt is None:
            tgt = torch.zeros_like(query_pos)
        memory = self.encoder(src, pos, src_key_pad_mask)
        hs, hs_raw, _ = self.decoder(tgt, memory, query_pos, pos,
                                     src_key_pad_mask, tgt_key_pad_mask)
        return hs, hs_raw, memory


class DualKinematicTransformer(nn.Module):
    """Box and metadata streams, each a ``KinematicTransformer``, fused over
    the whole decoder stack: the detection branch is updated from the
    metadata stream, then the metadata branch from the updated detection
    stream. Returns (hs_det, hs_meta, memory_det, memory_meta)."""

    def __init__(self, d_model=288, nheads=8, num_encoder_layers=1,
                 num_decoder_layers=1, dim_feedforward=2048, dropout=0.1,
                 pre_norm=False, rng=None):
        super().__init__()
        args = (d_model, nheads, num_encoder_layers, num_decoder_layers,
                dim_feedforward, dropout, pre_norm, rng)
        self.transformer_det = KinematicTransformer(*args)
        self.transformer_metadata = KinematicTransformer(*args)
        self.detection_branch = IntertwinedBranch(d_model, dropout, rng)
        self.metadata_branch = IntertwinedBranch(d_model, dropout, rng)

    def forward(self, src_det, src_meta, pos, query_pos_det, query_pos_meta,
                tgt_det=None, tgt_meta=None, src_key_pad_mask=None,
                tgt_key_pad_mask=None):
        hs_det, _, mem_det = self.transformer_det(
            src_det, pos, query_pos_det, tgt_det, src_key_pad_mask,
            tgt_key_pad_mask)
        hs_meta, _, mem_meta = self.transformer_metadata(
            src_meta, pos, query_pos_meta, tgt_meta, src_key_pad_mask,
            tgt_key_pad_mask)
        hs_det = self.detection_branch(hs_det, hs_meta)
        hs_meta = self.metadata_branch(hs_meta, hs_det)
        return hs_det, hs_meta, mem_det, mem_meta


class DualKinematicEncoder(nn.Module):
    """Encoder-only KineT: two encoders over the [trails | detections]
    sequence, fused by two ``IntertwinedBranch`` that both read the
    pre-fusion streams. Returns (fused_det, fused_meta)."""

    def __init__(self, d_model=288, nheads=8, num_encoder_layers=1,
                 dim_feedforward=2048, dropout=0.1, pre_norm=False, rng=None):
        super().__init__()
        args = (num_encoder_layers, d_model, nheads, dim_feedforward, dropout,
                pre_norm, rng)
        self.encoder_det = TransformerEncoder(*args)
        self.encoder_meta = TransformerEncoder(*args)
        self.detection_branch = IntertwinedBranch(d_model, dropout, rng)
        self.metadata_branch = IntertwinedBranch(d_model, dropout, rng)

    def forward(self, src_det, src_meta, pos, src_key_pad_mask=None):
        enc_a = self.encoder_det(src_det, pos, src_key_pad_mask)
        enc_b = self.encoder_meta(src_meta, pos, src_key_pad_mask)
        return (self.detection_branch(enc_a, enc_b),
                self.metadata_branch(enc_b, enc_a))
