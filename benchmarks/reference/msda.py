"""Plain multi-scale deformable attention sampling, in float32.

Per level, bilinear sampling of the value map with
``grid_sample(align_corners=False, padding_mode="zeros")`` at the sampling
locations, weighted by the attention weights and summed over levels and
points (Deformable DETR, arXiv:2010.04159, eq. 3; TrackFormer uses it
unchanged). Shapes:

  value              [B, S, M, D]   S = sum_l H_l * W_l
  sampling_locations [B, Lq, M, L, P, 2]  (x, y) in [0, 1]
  attention_weights  [B, Lq, M, L, P]
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights):
    """-> [B, Lq, M * D] in value's floating type (float32 at least)."""
    n, _, m, d = value.shape
    _, lq, _, _, p, _ = sampling_locations.shape
    ct = torch.promote_types(value.dtype, torch.float32)
    values = value.to(ct).split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2.0 * sampling_locations.to(ct) - 1.0
    out = torch.zeros(n * m, d, lq, dtype=ct, device=value.device)
    for lid, (h, w) in enumerate(spatial_shapes):
        v = values[lid].flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)  # [NM, Lq, P, 2]
        sampled = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                align_corners=False)  # [NM, D, Lq, P]
        aw = attention_weights[:, :, :, lid].to(ct).transpose(1, 2).reshape(
            n * m, 1, lq, p)
        out += (sampled * aw).sum(-1)
    return out.view(n, m, d, lq).permute(0, 3, 1, 2).reshape(n, lq, m * d)


def quantize_rows(x):
    """[B, S, C] -> (int8 values as float32 [B, S, C], scale [B]): symmetric
    int8 with one scale per batch element, max(absmax / 127, 1e-8), values
    rounded half to even and clipped to +-127."""
    x = x.float()
    absmax = x.abs().amax(dim=(1, 2))
    scale = torch.clamp(absmax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x / scale[:, None, None]), -127, 127)
    return q, scale
