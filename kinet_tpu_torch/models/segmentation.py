"""Segmentation heads (port of ``kinet_tpu/models/segmentation.py``;
reference: src/trackformer/models/detr_segmentation.py).

- ``MHAttentionMap``: per-query multi-head attention logits over the memory
  map, softmaxed over heads AND positions jointly (reference :214 flattens
  both before the softmax); padded positions take -1e9;
- ``MaskHeadSmallConv``: FPN-style convolution decoder over [projected
  feature | attention maps] with skips from C4, C3 and C2, GroupNorm with
  gcd(8, C) groups (eps 1e-5); each skip first resizes the running map to
  the skip's size by nearest sampling at half-pixel centres (the rule of
  ``jax.image.resize(method="nearest")``);
- ``SegmWrapper``: any detector plus the mask head (the attention map and
  the mask head run in the tracer's span ``mask_head``; the counter
  ``mask_rows`` counts the decoder rows they ran on). Vanilla DETR: the
  query is the last decoder layer's NORMED output (``hs_last``), the
  attention runs over the encoder memory with its pad mask, and the mask
  head's source is the projected C5 feature (``src_proj``). Deformable
  DETR: the query is the pre-norm ``hs_embed``, and the memory and the
  source are both the stride-8 slice of the flattened memory (the current
  frame's finest level);
- ``postprocess_segm``: sigmoid, then a bilinear resize to the original
  size (antialiased when it shrinks, as ``jax.image.resize`` is), then the
  threshold. No entry point calls it; the tracker resizes the logits first
  (``tracking/tracker.py``).

Convolutions run NCHW; ``pred_masks`` is [B, Q, H/4, W/4] logits.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..structs import ImageBatch, Targets
from ..utils import trace
from .backbone import nearest_index
from .deformable_detr import GroupNorm


class MHAttentionMap(nn.Module):
    """Query-to-image attention weights [B, Q, heads, h, w]."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.q_linear = nn.Linear(hidden_dim, hidden_dim)
        self.k_linear = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, q, memory, pad_mask=None):
        """q [B, Q, D]; memory [B, h, w, D]; pad_mask [B, h * w] or None."""
        b, nq, _ = q.shape
        h, w = memory.shape[1], memory.shape[2]
        d_head = self.hidden_dim // self.num_heads
        qh = self.q_linear(q).reshape(b, nq, self.num_heads, d_head)
        kh = self.k_linear(memory).reshape(b, h * w, self.num_heads, d_head)
        logits = torch.einsum("bqnd,bpnd->bqnp", qh, kh) / (d_head ** 0.5)
        if pad_mask is not None:
            logits = logits.masked_fill(pad_mask.reshape(b, 1, 1, h * w), -1e9)
        attn = logits.reshape(b, nq, self.num_heads * h * w).softmax(-1)
        return attn.reshape(b, nq, self.num_heads, h, w)


def resize_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, *hw] by ``jax.image.resize``'s nearest rule."""
    rows = nearest_index(x.shape[-2], hw[0], x.device)
    cols = nearest_index(x.shape[-1], hw[1], x.device)
    return x[:, :, rows][:, :, :, cols]


class MaskHeadSmallConv(nn.Module):
    """FPN-style mask decoder; the queries fold into the batch axis."""

    def __init__(self, dim: int, context_dim: int,
                 fpn_channels=(1024, 512, 256)):
        super().__init__()
        inter = [dim, context_dim // 2, context_dim // 4, context_dim // 8,
                 context_dim // 16]
        ins = [dim] + inter[:4]
        for i in range(5):
            self.add_module(f"lay{i + 1}", nn.Conv2d(ins[i], inter[i], 3,
                                                     padding=1))
            self.add_module(f"gn{i + 1}", GroupNorm(math.gcd(8, inter[i]),
                                                    inter[i], eps=1e-5))
        # each adapter maps a skip to the width of the map it is added to
        for i, c in enumerate(fpn_channels):
            self.add_module(f"adapter{i + 1}", nn.Conv2d(c, inter[i + 1], 1))
        self.out_lay = nn.Conv2d(inter[4], 1, 3, padding=1)

    def _block(self, i, x):
        return torch.relu(getattr(self, f"gn{i}")(getattr(self, f"lay{i}")(x)))

    def forward(self, x, bbox_mask, fpns):
        """x [B, D, h, w]; bbox_mask [B, Q, heads, h, w]; fpns C4, C3, C2
        [B, C, Hf, Wf] -> mask logits [B, Q, H4, W4]."""
        b, nq = bbox_mask.shape[:2]
        x = torch.cat([x[:, None].expand(b, nq, *x.shape[1:]), bbox_mask], 2)
        x = self._block(2, self._block(1, x.flatten(0, 1)))
        for i, fpn in enumerate(fpns):
            adapted = getattr(self, f"adapter{i + 1}")(fpn)
            adapted = adapted.repeat_interleave(nq, dim=0)  # match B * Q
            x = adapted + resize_nearest(x, adapted.shape[-2:])
            x = self._block(i + 3, x)
        x = self.out_lay(x)
        return x.reshape(b, nq, *x.shape[-2:])


class SegmWrapper(nn.Module):
    """Detector + mask head: the detector's output dict with
    ``pred_masks`` added. Attributes it lacks are the detector's
    (``num_track_slots``, ``cache_prev_encoder``, ``dropout_rng`` ...)."""

    def __init__(self, detector: nn.Module, hidden_dim: int, nheads: int,
                 fpn_channels=(1024, 512, 256)):
        super().__init__()
        self.detector = detector
        self.bbox_attention = MHAttentionMap(hidden_dim, nheads)
        self.mask_head = MaskHeadSmallConv(hidden_dim + nheads, hidden_dim,
                                           fpn_channels)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name == "detector":
                raise
            return getattr(self.detector, name)

    def forward(self, batch: ImageBatch, targets: Optional[Targets] = None,
                **kw) -> dict:
        out = self.detector(batch, targets, **kw)
        feats = out.get("backbone_features")
        if feats is None:
            feats = out["frame_features"][0]
        fpns = [feats[-2], feats[-3], feats[-4]]  # C4, C3, C2
        memory = out["memory"]
        if memory.dim() == 3:
            # deformable: the stride-8 level (the pyramid's first, C3) is
            # the flattened memory's first h8 * w8 rows
            h8, w8 = feats[-3].shape[-2:]
            memory = memory[:, : h8 * w8].reshape(memory.shape[0], h8, w8, -1)
            pad, src = None, memory.permute(0, 3, 1, 2)
        else:
            pad = out["memory_pad_mask"].flatten(1)
            src = out["src_proj"]
        hs_q = out.get("hs_last", out["hs_embed"])
        with trace.span("mask_head"):
            bbox_mask = self.bbox_attention(hs_q, memory, pad)
            out["pred_masks"] = self.mask_head(src, bbox_mask, fpns)
        trace.count("mask_rows", hs_q.shape[0] * hs_q.shape[1])
        return out


def postprocess_segm(results: dict, outputs: dict, orig_size,
                     threshold: float = 0.5) -> dict:
    """``masks_probs`` [B, Q, h, w] at ``orig_size`` (h, w) and ``masks``
    (probability > threshold) added to ``results``."""
    masks = outputs["pred_masks"]
    h, w = int(orig_size[0]), int(orig_size[1])
    probs = F.interpolate(torch.sigmoid(masks), size=(h, w), mode="bilinear",
                          align_corners=False, antialias=True)
    return {**results, "masks_probs": probs, "masks": probs > threshold}
