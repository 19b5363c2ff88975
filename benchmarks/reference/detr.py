"""Plain reference of the served TrackFormer forward, in float32.

TrackFormer (arXiv:2101.02702) on Deformable DETR (arXiv:2010.04159):
ResNet with frozen batch norm, C3..C5 plus a stride-64 level, each
projected to the hidden width and group-normed; sine position encodings
with a frame axis (multi-frame encoding); a deformable encoder; a
deformable decoder over the current and the previous frame's encoded
memory, with iterative box refinement and per-layer focal heads; track
queries in fixed leading decoder slots with a key-pad mask.

Written from those equations with the parameter names of the served
program, so that one state dict loads into both. Only plain ``torch``
operations: every convolution, linear and attention as one call, the
deformable sampling through ``grid_sample`` (``msda.py``), no cache of its
own beyond what the caller passes. What the program derives at run time it
derives again here: the encoded memory of each frame (the caller encodes
the previous frame again), the sine encodings, the int8 decoder table and
its scales. Inference only.

Options of the cells' configurations (``model`` of a configuration file):
``enc_lite`` with ``enc_lite_klevels`` / ``enc_lite_high_klevels``
(Lite-DETR's interleaved update: all but the last encoder layer update
only levels 1.., sampling the k finest levels; the last updates level 0);
``dec_klevels`` (the decoder samples the k finest levels of each frame);
``dec_msda_int8`` (the decoder samples an int8 copy of each frame's
memory, one absmax scale a frame). The decoder's cross-attention is taken
in its published form, projection first and then sampling; the program's
``dec_gather_raw`` pools raw rows first and projects after, the same sum
in another order. Departures from TrackFormer that the configurations
state: the previous frame's memory is encoded as a current frame was
(``cache_prev_encoder``: level embeddings 0..L-1 and frame index 0 for
both halves), and at most ``max_track_queries`` track slots.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .msda import ms_deform_attn, quantize_rows

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet_test": (1, 1, 1, 1)}


class FrozenBatchNorm(nn.Module):
    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.running_mean = nn.Parameter(torch.zeros(n))
        self.running_var = nn.Parameter(torch.ones(n))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: the stride on the 3x3 convolution."""

    def __init__(self, in_ch, width, stride, downsample):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(width * 4)
        if downsample:
            self.downsample_conv = nn.Conv2d(in_ch, width * 4, 1,
                                             stride=stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(width * 4)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + x)


class Trunk(nn.Module):
    def __init__(self, stages):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.names = []
        in_ch = 64
        for s, (n, width) in enumerate(zip(stages, (64, 128, 256, 512))):
            for b in range(n):
                name = f"layer{s + 1}_{b}"
                stride = 2 if (s > 0 and b == 0) else 1
                self.add_module(name, Bottleneck(in_ch, width, stride, b == 0))
                self.names.append((s, name))
                in_ch = width * 4

    def forward(self, x):
        """[B, 3, H, W] -> [C3, C4, C5]."""
        x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = []
        for i, (s, name) in enumerate(self.names):
            x = getattr(self, name)(x)
            if i + 1 == len(self.names) or self.names[i + 1][0] != s:
                feats.append(x)
        return feats[1:]


class Backbone(nn.Module):
    def __init__(self, arch):
        super().__init__()
        self.trunk = Trunk(STAGES[arch])


class MLP(nn.Module):
    def __init__(self, d_in, d_hidden, d_out, n):
        super().__init__()
        self.n = n
        dims = [d_in] + [d_hidden] * (n - 1) + [d_out]
        for i in range(n):
            self.add_module(f"layer{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


class MSDeformAttn(nn.Module):
    def __init__(self, d, n_levels, n_heads, n_points):
        super().__init__()
        self.d, self.l, self.m, self.p = d, n_levels, n_heads, n_points
        self.value_proj = nn.Linear(d, d)
        self.sampling_offsets = nn.Linear(d, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, ref, src, shapes, pad, query_mask=None):
        """query [B, Lq, C]; ref [B, Lq, L, 2 or 4]; src [B, S, C] (pad
        rows are zeroed after the projection); pad [B, S] True = pad."""
        b, lq, _ = query.shape
        m, l, p = self.m, self.l, self.p
        off = self.sampling_offsets(query).view(b, lq, m, l, p, 2)
        aw = self.attention_weights(query).view(b, lq, m, l * p)
        aw = aw.softmax(-1).view(b, lq, m, l, p)
        if query_mask is not None:
            aw = aw.masked_fill(query_mask[:, :, None, None, None], 0.0)
        if ref.shape[-1] == 2:
            norm = torch.tensor([(w, h) for h, w in shapes],
                                dtype=query.dtype, device=query.device)
            loc = ref[:, :, None, :, None, :] + \
                off / norm[None, None, None, :, None, :]
        else:
            loc = ref[:, :, None, :, None, :2] + \
                off / p * ref[:, :, None, :, None, 2:] * 0.5
        value = self.value_proj(src).masked_fill(pad[..., None], 0.0)
        value = value.view(b, -1, m, self.d // m)
        return self.output_proj(ms_deform_attn(value, shapes, loc, aw))


class EncoderLayer(nn.Module):
    def __init__(self, d, d_ffn, n_levels, n_heads, n_points):
        super().__init__()
        self.self_attn = MSDeformAttn(d, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = nn.Linear(d, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, src, pos, ref, shapes, pad, values, value_pad):
        src = self.norm1(src + self.self_attn(src + pos, ref, values, shapes,
                                              value_pad))
        return self.norm2(src + self.linear2(torch.relu(self.linear1(src))))


class SelfAttention(nn.Module):
    """Multi-head attention as flax's MultiHeadDotProductAttention: the
    projected query scaled by 1/sqrt(d_head), masked keys at the type's
    most negative logit."""

    def __init__(self, d, n_heads):
        super().__init__()
        self.h = n_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, key_valid):
        b, lq, c = q.shape
        h, dh = self.h, c // self.h
        qh = self.q_proj(q).view(b, lq, h, dh).transpose(1, 2) / math.sqrt(dh)
        kh = self.k_proj(k).view(b, -1, h, dh).transpose(1, 2)
        vh = self.v_proj(v).view(b, -1, h, dh).transpose(1, 2)
        logits = (qh @ kh.transpose(-1, -2)).masked_fill(
            ~key_valid[:, None, None, :], torch.finfo(qh.dtype).min)
        out = logits.softmax(-1) @ vh
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, c))


class DecoderLayer(nn.Module):
    def __init__(self, d, d_ffn, n_levels, n_heads, n_points):
        super().__init__()
        self.self_attn = SelfAttention(d, n_heads)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn = MSDeformAttn(d, n_levels, n_heads, n_points)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = nn.Linear(d, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, tgt, query_pos, ref, memory, shapes, pad, query_pad):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt, ~query_pad))
        tgt = self.norm2(tgt + self.cross_attn(tgt + query_pos, ref, memory,
                                               shapes, pad, query_pad))
        return self.norm3(tgt + self.linear2(torch.relu(self.linear1(tgt))))


class Transformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, heads = cfg["hidden_dim"], cfg["nheads"]
        ffn, lv = cfg["dim_feedforward"], cfg["num_feature_levels"]
        self.modes = []
        self.encoder = nn.Module()
        n_enc = cfg["enc_layers"]
        lite = cfg["enc_lite"] and lv > 1
        for i in range(n_enc):
            last = i == n_enc - 1
            mode, k = "all", lv
            if lite:
                mode = "low" if last else "high"
                kk = cfg["enc_lite_klevels"] if last else \
                    cfg["enc_lite_high_klevels"]
                k = min(kk, lv) if kk else lv
            self.modes.append((mode, k))
            self.encoder.add_module(f"layer{i}", EncoderLayer(
                d, ffn, k, heads, cfg["enc_n_points"]))
        k = cfg["dec_klevels"]
        self.dec_k = min(k, lv) if k else lv
        self.decoder = nn.Module()
        for i in range(cfg["dec_layers"]):
            self.decoder.add_module(f"layer{i}", DecoderLayer(
                d, ffn, 2 * self.dec_k, heads, cfg["dec_n_points"]))
        self.level_embed = nn.Parameter(torch.empty(2 * lv, d))
        self.reference_points_head = nn.Linear(d, 2)


def downsample_mask(pad, hw):
    """Nearest resize of a [B, H, W] pad mask at half-pixel centres."""
    _, h, w = pad.shape
    rows = torch.floor((torch.arange(hw[0], device=pad.device) + 0.5)
                       * h / hw[0]).long()
    cols = torch.floor((torch.arange(hw[1], device=pad.device) + 0.5)
                       * w / hw[1]).long()
    return pad[:, rows][:, :, cols]


def sine3d_frame0(mask, d):
    """The multi-frame sine encoding of frame 0 of 2: [B, H, W] -> [B, H,
    W, d], d // 3 features each for the frame, row and column axes, the
    remainder zero."""
    f = d // 3
    not_mask = (~mask).float()
    scale, eps = 2 * math.pi, 1e-6
    z = torch.full_like(not_mask, 1.0) * not_mask / (2 * not_mask + eps) * scale
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    y = y / (y[:, -1:, :] + eps) * scale
    x = x / (x[:, :, -1:] + eps) * scale
    t = torch.arange(f, dtype=torch.float32, device=mask.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(t / 2.0) / f)

    def enc(a):
        a = a[..., None] / dim_t
        return torch.stack([a[..., 0::2].sin(), a[..., 1::2].cos()],
                           -1).flatten(-2)

    pos = torch.cat([enc(z), enc(y), enc(x)], -1)
    return F.pad(pos, (0, d - pos.shape[-1]))


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


class TrackFormer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        for key, want in (("two_stage", False), ("masks", False),
                          ("with_box_refine", True), ("focal_loss", True),
                          ("multi_frame_attention", True),
                          ("multi_frame_encoding", True),
                          ("cache_prev_encoder", True),
                          ("msda_ref_normalizer", False),
                          ("merge_frame_features", False),
                          ("dilation", False)):
            if bool(cfg.get(key, want)) != want:
                raise ValueError(f"the reference has no {key}={cfg[key]}")
        self.cfg = cfg
        d = self.d = cfg["hidden_dim"]
        self.levels = cfg["num_feature_levels"]
        self.int8 = bool(cfg.get("dec_msda_int8", False))
        self.backbone = Backbone(cfg["backbone"])
        chans = [512, 1024, 2048]
        for i in range(self.levels):
            if i < 3:
                conv = nn.Conv2d(chans[i], d, 1)
            else:
                conv = nn.Conv2d(chans[-1] if i == 3 else d, d, 3, 2, 1)
            self.add_module(f"input_proj{i}", conv)
            self.add_module(f"input_proj_gn{i}",
                            nn.GroupNorm(math.gcd(32, d), d, eps=1e-5))
        self.transformer = Transformer(cfg)
        self.query_embed = nn.Parameter(torch.empty(cfg["num_queries"], 2 * d))
        self.n_dec = cfg["dec_layers"]
        for i in range(self.n_dec):
            self.add_module(f"class_embed{i}",
                            nn.Linear(d, cfg["num_classes"]))
            self.add_module(f"bbox_embed{i}", MLP(d, d, 4, 3))

    # -- encoder: one frame -------------------------------------------------
    def encode(self, images, pad):
        """images [B, H, W, 3], pad [B, H, W] -> the frame's encoded memory
        {memory [B, S, C], pad [B, S], shapes, ratios [B, L, 2]}."""
        feats = self.backbone.trunk(images.permute(0, 3, 1, 2))
        srcs = []
        for i in range(self.levels):
            x = feats[i] if i < 3 else (feats[-1] if i == 3 else srcs[-1])
            srcs.append(getattr(self, f"input_proj_gn{i}")(
                getattr(self, f"input_proj{i}")(x)))
        b = images.shape[0]
        shapes = tuple(tuple(s.shape[-2:]) for s in srcs)
        lay = self.layout(pad, shapes)
        masks, flat_pad, ratios = lay["masks"], lay["pad"], lay["ratios"]
        emb = self.transformer.level_embed
        src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        pos = torch.cat([sine3d_frame0(m, self.d).reshape(b, -1, self.d)
                         + emb[i] for i, m in enumerate(masks)], 1)
        # each token's reference point on every level
        refs = []
        for lvl, (h, w) in enumerate(shapes):
            ry = (torch.arange(h, device=src.device) + 0.5)[:, None].expand(
                h, w).reshape(-1)
            rx = (torch.arange(w, device=src.device) + 0.5)[None, :].expand(
                h, w).reshape(-1)
            refs.append(torch.stack([
                rx[None] / (ratios[:, None, lvl, 0] * w),
                ry[None] / (ratios[:, None, lvl, 1] * h)], -1))
        ref = torch.cat(refs, 1)[:, :, None] * ratios[:, None]
        split0 = shapes[0][0] * shapes[0][1]
        out = src
        for i, (mode, k) in enumerate(self.transformer.modes):
            layer = getattr(self.transformer.encoder, f"layer{i}")
            if mode == "all":
                out = layer(out, pos, ref, shapes, flat_pad, out, flat_pad)
                continue
            s_k = sum(h * w for h, w in shapes[:k])
            rows = slice(split0, None) if mode == "high" else slice(0, split0)
            upd = layer(out[:, rows], pos[:, rows], ref[:, rows, :k],
                        shapes[:k], None, out[:, :s_k], flat_pad[:, :s_k])
            out = torch.cat([out[:, :split0], upd] if mode == "high"
                            else [upd, out[:, split0:]], 1)
        return dict(memory=out, pad=flat_pad, shapes=shapes, ratios=ratios)

    def layout(self, pad, shapes):
        """A frame's level pad masks, flat pad mask [B, S] and valid ratios
        [B, L, 2] from its pad mask [B, H, W] and its level shapes."""
        masks = [downsample_mask(pad, hw) for hw in shapes]
        return dict(masks=masks, shapes=tuple(shapes),
                    pad=torch.cat([m.reshape(pad.shape[0], -1) for m in masks],
                                  1),
                    ratios=torch.stack([self.valid_ratio(m) for m in masks], 1))

    @staticmethod
    def valid_ratio(mask):
        _, h, w = mask.shape
        return torch.stack([(~mask[:, 0, :]).sum(1).float() / w,
                            (~mask[:, :, 0]).sum(1).float() / h], -1)

    # -- decoder: a frame over its own and the previous frame's memory --------
    def decode(self, cur, prev, tq_embeds, tq_boxes, tq_mask, orig_size,
               given=None):
        """cur / prev: ``encode``'s outputs (the same on a first frame);
        tq_*: the track slots [B, T, ...]; orig_size [B, 2] (h, w).
        Returns {scores, labels, boxes (xyxy px), hs_embed, layers (each
        decoder layer's output)} over [track slots | object queries].
        ``given``: each decoder layer's output as another forward made it;
        then each layer takes the given output of the layer before it, the
        box refinement and the heads take the given outputs, and ``layers``
        holds what each layer makes of its given input."""
        k, d = self.transformer.dec_k, self.d
        halves = []
        for enc in (cur, prev):
            n = sum(h * w for h, w in enc["shapes"][:k])
            mem = enc["memory"][:, :n].masked_fill(enc["pad"][:, :n, None],
                                                   0.0)
            if self.int8:
                q, scale = quantize_rows(mem)
                mem = q * scale[:, None, None]
            halves.append((mem, enc["pad"][:, :n], enc["shapes"][:k],
                           enc["ratios"][:, :k]))
        memory = torch.cat([h[0] for h in halves], 1)
        pad = torch.cat([h[1] for h in halves], 1)
        shapes = halves[0][2] + halves[1][2]
        ratios = torch.cat([h[3] for h in halves], 1)

        b, t = tq_mask.shape
        query_pos, tgt = torch.split(self.query_embed, d, -1)
        ref = torch.sigmoid(self.transformer.reference_points_head(query_pos))
        tq = torch.where(tq_mask[..., None], tq_embeds, 0.0)
        boxes = torch.where(tq_mask[..., None], tq_boxes, 0.5)
        query_pos = torch.cat([query_pos.new_zeros(b, t, d),
                               query_pos[None].expand(b, -1, -1)], 1)
        tgt = torch.cat([tq, tgt[None].expand(b, -1, -1)], 1)
        ref = torch.cat([boxes[..., :2], ref[None].expand(b, -1, -1)], 1)
        query_pad = torch.cat([~tq_mask, tq_mask.new_zeros(
            b, tgt.shape[1] - t)], 1)
        refs = [ref]
        out, layers = tgt, []
        for i in range(self.n_dec):
            r = refs[-1]
            scale = ratios if r.shape[-1] == 2 else torch.cat([ratios, ratios],
                                                              -1)
            out = getattr(self.transformer.decoder, f"layer{i}")(
                out, query_pos, r[:, :, None] * scale[:, None], memory,
                shapes, pad, query_pad)
            layers.append(out)
            if given is not None:
                out = given[i]
            delta = getattr(self, f"bbox_embed{i}")(out)
            if r.shape[-1] == 4:
                refs.append(torch.sigmoid(delta + inverse_sigmoid(r)))
            else:
                refs.append(torch.sigmoid(torch.cat(
                    [delta[..., :2] + inverse_sigmoid(r), delta[..., 2:]], -1)))
        last = self.n_dec - 1
        logits = getattr(self, f"class_embed{last}")(out)
        box = refs[-1]  # the last layer's refined boxes, cxcywh
        prob = torch.sigmoid(logits)
        scores, labels = prob.max(-1)
        cx, cy, w, h = box.unbind(-1)
        xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        hh, ww = orig_size[:, 0], orig_size[:, 1]
        xyxy = xyxy * torch.stack([ww, hh, ww, hh], -1)[:, None]
        return dict(scores=scores, labels=labels, boxes=xyxy, hs_embed=out,
                    layers=layers)
