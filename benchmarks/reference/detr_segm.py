"""Plain reference of TrackFormer's MOTS20 forward, in float32.

TrackFormer (arXiv:2101.02702) with ``cfgs/train_mots20.yaml``: vanilla
DETR (arXiv:2005.12872) with track queries and DETR's panoptic mask head.
ResNet-50 with frozen batch norm (C2..C5); the C5 feature projected to the
hidden width; a 2-D sine position encoding; a post-norm encoder over the
C5 tokens; a post-norm decoder over [track slots | object queries], the
track slots entering as decoder input with a zero query position and the
empty ones masked out of self-attention; one shared final norm; the class
and box heads of the last layer; ``MHAttentionMap`` (each query's
attention logits over the memory, softmaxed over heads and positions
jointly) and ``MaskHeadSmallConv`` (an FPN of convolutions over
[projected C5 | attention maps] with skips from C4, C3 and C2, GroupNorm
and ReLU) on every decoder row.

Written from those equations (upstream ``detr_segmentation.py:105-216``)
with the parameter names of the served program (``SegmWrapper`` over
``DETR``), so that one state dict loads into both. Only plain ``torch``
operations; inference only. Every stage is a method of its own, so that a
check can run each on the program's own input of that stage.

Departures from upstream, all the program's:

- the nearest resize of the mask head's skips samples at half-pixel
  centres, ``floor((i + 0.5) * n_in / n_out)`` (the JAX package's rule);
  upstream's ``F.interpolate(mode="nearest")`` takes ``floor(i * n_in /
  n_out)``. The two agree at every factor-of-two size and differ where a
  level's size is not twice the next one's (``resize_nearest``);
- the sine encoding counts positions from the pixel's centre (``y - 0.5``,
  Deformable DETR's form, which TrackFormer's code uses for both models);
- attention masks a padded key with the type's most negative logit
  (flax's rule), not ``-inf``; a query with every key padded then attends
  evenly;
- GroupNorm takes ``gcd(8, C)`` groups: 8, as upstream, at every published
  width; fewer only at the test widths.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .detr import MLP, Backbone, SelfAttention


def trunk_levels(trunk, images):
    """[B, H, W, 3] -> [C2, C3, C4, C5] of ``reference.detr.Trunk``."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(torch.relu(trunk.bn1(trunk.conv1(x))), 3, 2, 1)
    feats = []
    for i, (s, name) in enumerate(trunk.names):
        x = getattr(trunk, name)(x)
        if i + 1 == len(trunk.names) or trunk.names[i + 1][0] != s:
            feats.append(x)
    return feats


def nearest_index(n_in, n_out, device):
    """Source index of each of ``n_out`` samples of ``n_in`` at half-pixel
    centres, in exact integer arithmetic."""
    i = torch.arange(n_out, device=device)
    return ((2 * i + 1) * n_in) // (2 * n_out)


def resize_nearest(x, hw):
    """[N, C, H, W] -> [N, C, *hw] by ``nearest_index``."""
    rows = nearest_index(x.shape[-2], hw[0], x.device)
    cols = nearest_index(x.shape[-1], hw[1], x.device)
    return x[:, :, rows][:, :, :, cols]


def sine2d(pad, d):
    """[B, h, w] pad mask (True = pad) -> [B, h, w, d]: d / 2 features of
    the row, then d / 2 of the column, sine on even and cosine on odd
    features, temperature 10000."""
    f = d // 2
    not_mask = (~pad).float()
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    eps, scale = 1e-6, 2 * math.pi
    y = (y - 0.5) / (y[:, -1:, :] + eps) * scale
    x = (x - 0.5) / (x[:, :, -1:] + eps) * scale
    t = torch.arange(f, dtype=torch.float32, device=pad.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(t / 2.0) / f)

    def enc(a):
        a = a[..., None] / dim_t
        return torch.stack([a[..., 0::2].sin(), a[..., 1::2].cos()],
                           -1).flatten(-2)

    return torch.cat([enc(y), enc(x)], -1)


class EncoderLayer(nn.Module):
    def __init__(self, d, heads, ffn):
        super().__init__()
        self.self_attn = SelfAttention(d, heads)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, src, pos, valid):
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src, valid))
        return self.norm2(src + self.linear2(torch.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    def __init__(self, d, heads, ffn):
        super().__init__()
        self.self_attn = SelfAttention(d, heads)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn = SelfAttention(d, heads)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, tgt, query_pos, memory, mem_pos, mem_valid, tgt_valid):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt, tgt_valid))
        tgt = self.norm2(tgt + self.cross_attn(tgt + query_pos,
                                               memory + mem_pos, memory,
                                               mem_valid))
        return self.norm3(tgt + self.linear2(torch.relu(self.linear1(tgt))))


class Detr(nn.Module):
    """The detector: ``backbone.trunk``, ``input_proj``, ``query_embed``,
    ``transformer.{encoder,decoder}``, ``class_embed``, ``bbox_embed``."""

    def __init__(self, cfg):
        super().__init__()
        d, heads, ffn = cfg["hidden_dim"], cfg["nheads"], cfg["dim_feedforward"]
        self.backbone = Backbone(cfg["backbone"])
        self.input_proj = nn.Conv2d(2048, d, 1)
        self.query_embed = nn.Parameter(torch.empty(cfg["num_queries"], d))
        self.transformer = nn.Module()
        self.transformer.encoder = nn.Module()
        for i in range(cfg["enc_layers"]):
            self.transformer.encoder.add_module(f"layer{i}",
                                                EncoderLayer(d, heads, ffn))
        self.transformer.decoder = nn.Module()
        for i in range(cfg["dec_layers"]):
            self.transformer.decoder.add_module(f"layer{i}",
                                                DecoderLayer(d, heads, ffn))
        self.transformer.decoder.norm = nn.LayerNorm(d, eps=1e-5)
        self.class_embed = nn.Linear(
            d, cfg["num_classes"] + (0 if cfg["focal_loss"] else 1))
        self.bbox_embed = MLP(d, d, 4, 3)


class MHAttentionMap(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.q_linear = nn.Linear(d, d)
        self.k_linear = nn.Linear(d, d)


class MaskHeadSmallConv(nn.Module):
    def __init__(self, dim, context, fpn_channels=(1024, 512, 256)):
        super().__init__()
        inter = [dim, context // 2, context // 4, context // 8, context // 16]
        ins = [dim] + inter[:4]
        for i in range(5):
            self.add_module(f"lay{i + 1}", nn.Conv2d(ins[i], inter[i], 3,
                                                     padding=1))
            self.add_module(f"gn{i + 1}", nn.GroupNorm(math.gcd(8, inter[i]),
                                                       inter[i], eps=1e-5))
        for i, c in enumerate(fpn_channels):
            self.add_module(f"adapter{i + 1}", nn.Conv2d(c, inter[i + 1], 1))
        self.out_lay = nn.Conv2d(inter[4], 1, 3, padding=1)

    def block(self, i, x):
        return torch.relu(getattr(self, f"gn{i}")(getattr(self, f"lay{i}")(x)))


class DetrSegm(nn.Module):
    """TrackFormer's MOTS20 model: ``detector`` (vanilla DETR with track
    slots), ``bbox_attention`` and ``mask_head``."""

    def __init__(self, cfg):
        super().__init__()
        for key, want in (("deformable", False), ("masks", True),
                          ("pre_norm", False), ("track_attention", False),
                          ("dilation", False)):
            if bool(cfg.get(key, want)) != want:
                raise ValueError(f"the reference has no {key}={cfg[key]}")
        self.cfg = cfg
        self.d = cfg["hidden_dim"]
        self.detector = Detr(cfg)
        self.bbox_attention = MHAttentionMap(self.d, cfg["nheads"])
        self.mask_head = MaskHeadSmallConv(self.d + cfg["nheads"], self.d)

    # -- stages ---------------------------------------------------------------
    def features(self, images):
        """images [B, H, W, 3] -> [C2, C3, C4, C5] (NCHW)."""
        return trunk_levels(self.detector.backbone.trunk, images)

    @staticmethod
    def level_pad(pad, hw):
        """The [B, H, W] pad mask at a level of size ``hw``."""
        rows = nearest_index(pad.shape[1], hw[0], pad.device)
        cols = nearest_index(pad.shape[2], hw[1], pad.device)
        return pad[:, rows][:, :, cols]

    def encode(self, c5, pad):
        """The encoder over C5 [B, 2048, h, w] and the frame's pad mask
        [B, H, W]: {memory [B, h * w, D], pos [B, h * w, D], pad [B, h * w],
        src_proj [B, D, h, w]}."""
        src = self.detector.input_proj(c5)
        b, d, h, w = src.shape
        lvl_pad = self.level_pad(pad, (h, w))
        pos = sine2d(lvl_pad, d).reshape(b, h * w, d)
        flat_pad = lvl_pad.reshape(b, h * w)
        x = src.flatten(2).transpose(1, 2)
        enc = self.detector.transformer.encoder
        for i in range(self.cfg["enc_layers"]):
            x = getattr(enc, f"layer{i}")(x, pos, ~flat_pad)
        return dict(memory=x, pos=pos, pad=flat_pad, src_proj=src)

    def slots(self, tq_embeds, tq_mask):
        """(query_pos, tgt, tgt_pad) over [T track slots | Q object
        queries] for the slots' embeddings [B, T, D] and mask [B, T]."""
        b, t = tq_mask.shape
        qe = self.detector.query_embed
        q = qe.shape[0]
        query_pos = torch.cat([qe.new_zeros(b, t, self.d),
                               qe[None].expand(b, q, -1)], 1)
        tgt = torch.cat([torch.where(tq_mask[..., None], tq_embeds, 0.0),
                         qe.new_zeros(b, q, self.d)], 1)
        tgt_pad = torch.cat([~tq_mask, tq_mask.new_zeros(b, q)], 1)
        return query_pos, tgt, tgt_pad

    def decoder_layer(self, i, tgt, query_pos, tgt_pad, enc):
        """Decoder layer ``i`` over its input ``tgt`` [B, T + Q, D] (before
        the shared norm) and the encoding ``enc``."""
        layer = getattr(self.detector.transformer.decoder, f"layer{i}")
        return layer(tgt, query_pos, enc["memory"], enc["pos"], ~enc["pad"],
                     ~tgt_pad)

    def heads(self, last, orig_size):
        """The last decoder layer's output [B, T + Q, D] (before the shared
        norm) and the frames' sizes [B, 2] (h, w) -> {scores, labels,
        boxes (xyxy px), hs_last (the normed output)}."""
        det = self.detector
        hs = det.transformer.decoder.norm(last)
        logits = det.class_embed(hs)
        box = torch.sigmoid(det.bbox_embed(hs))
        if self.cfg["focal_loss"]:
            scores, labels = torch.sigmoid(logits).max(-1)
        else:
            scores, labels = logits.softmax(-1)[..., :-1].max(-1)
        cx, cy, w, h = box.unbind(-1)
        xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        hh, ww = orig_size[:, 0], orig_size[:, 1]
        xyxy = xyxy * torch.stack([ww, hh, ww, hh], -1)[:, None]
        return dict(scores=scores, labels=labels, boxes=xyxy, hs_last=hs)

    def attention_map(self, hs_last, memory, pad):
        """hs_last [B, Q, D], memory [B, h, w, D], pad [B, h * w] ->
        [B, Q, heads, h, w]: the scaled query-key products, padded keys at
        the most negative logit, softmaxed over heads and positions
        together."""
        att = self.bbox_attention
        b, nq, d = hs_last.shape
        h, w = memory.shape[1:3]
        m = att.heads
        qh = att.q_linear(hs_last).view(b, nq, m, d // m) * (d // m) ** -0.5
        kh = att.k_linear(memory).view(b, h * w, m, d // m)
        logits = torch.einsum("bqnc,bpnc->bqnp", qh, kh)
        logits = logits.masked_fill(pad[:, None, None, :],
                                    torch.finfo(logits.dtype).min)
        return logits.flatten(2).softmax(-1).view(b, nq, m, h, w)

    def mask_logits(self, hs_last, memory, pad, src_proj, fpns):
        """The mask head of one frame: hs_last [Q, D], memory [h, w, D], pad
        [h * w], src_proj [D, h, w], fpns C4, C3, C2 [C, Hf, Wf] ->
        [Q, H4, W4]."""
        mh = self.mask_head
        bbox_mask = self.attention_map(hs_last[None], memory[None],
                                       pad[None])[0]
        nq = bbox_mask.shape[0]
        x = torch.cat([src_proj[None].expand(nq, -1, -1, -1), bbox_mask], 1)
        x = mh.block(2, mh.block(1, x))
        for i, fpn in enumerate(fpns):
            skip = getattr(mh, f"adapter{i + 1}")(fpn[None])
            x = skip.expand(nq, -1, -1, -1) + resize_nearest(x, skip.shape[-2:])
            x = mh.block(i + 3, x)
        return mh.out_lay(x)[:, 0]

    # -- the whole forward ----------------------------------------------------
    def forward(self, images, pad, tq_embeds, tq_mask, orig_size):
        """images [B, H, W, 3], pad [B, H, W], the track slots [B, T, D] and
        [B, T], sizes [B, 2] -> {scores, labels, boxes, hs_embed (the last
        layer's output before the norm), pred_masks [B, T + Q, H4, W4],
        layers, feats, memory}."""
        feats = self.features(images)
        enc = self.encode(feats[-1], pad)
        query_pos, tgt, tgt_pad = self.slots(tq_embeds, tq_mask)
        layers, x = [], tgt
        for i in range(self.cfg["dec_layers"]):
            x = self.decoder_layer(i, x, query_pos, tgt_pad, enc)
            layers.append(x)
        out = self.heads(x, orig_size)
        b, d, h, w = enc["src_proj"].shape
        mem = enc["memory"].view(b, h, w, d)
        out["pred_masks"] = torch.stack([
            self.mask_logits(out["hs_last"][i], mem[i], enc["pad"][i],
                             enc["src_proj"][i], [f[i] for f in feats[-2::-1]])
            for i in range(b)])
        return dict(out, hs_embed=x, layers=layers, feats=feats,
                    memory=enc["memory"])
