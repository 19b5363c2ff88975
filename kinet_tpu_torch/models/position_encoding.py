"""Sine position encodings (port of ``kinet_tpu/models/position_encoding.py``).

Pure functions of the pad mask (True = padded pixel), channel-last like the
JAX package: [B, H, W] -> [B, H, W, C].
- sine_position_encoding   : 2-D image sine,
- sine3d_position_encoding : adds a frame axis for multi-frame attention;
                             the hidden % 3 channel remainder is zero-padded,
- sine_detection_encoding  : 1-D detection-slot encoding of the KineT
                             family, [B, N] -> [B, N, C].
"""
from __future__ import annotations

import math

import torch


def _dim_t(num_pos_feats: int, temperature: float, device) -> torch.Tensor:
    t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(t / 2.0) / num_pos_feats)


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    """pos [..., F] -> [..., F] with sin on even, cos on odd input slots."""
    s = torch.sin(pos[..., 0::2])
    c = torch.cos(pos[..., 1::2])
    return torch.stack([s, c], dim=-1).flatten(-2)


def sine_position_encoding(
    pad_mask: torch.Tensor,
    num_pos_feats: int = 64,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """pad_mask [B, H, W] (True = pad) -> pos [B, H, W, 2*num_pos_feats]."""
    if scale is None:
        scale = 2 * math.pi
    not_mask = (~pad_mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if normalize:
        eps = 1e-6
        y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
        x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = _dim_t(num_pos_feats, temperature, pad_mask.device)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine3d_position_encoding(
    pad_mask: torch.Tensor,
    num_pos_feats: int,
    num_frames: int = 2,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float | None = None,
    pad_to: int | None = None,
) -> torch.Tensor:
    """pad_mask [B, H, W] -> pos [B, num_frames, H, W, C].

    C = 3*num_pos_feats, zero-padded up to ``pad_to`` channels if given.
    The frame index enters as a cumsum along the frame axis."""
    if scale is None:
        scale = 2 * math.pi
    b, h, w = pad_mask.shape
    not_mask = (~pad_mask)[:, None].float().expand(b, num_frames, h, w)
    z_embed = not_mask.cumsum(1)
    y_embed = not_mask.cumsum(2)
    x_embed = not_mask.cumsum(3)
    if normalize:
        eps = 1e-6
        z_embed = z_embed / (z_embed[:, -1:, :, :] + eps) * scale
        y_embed = y_embed / (y_embed[:, :, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, :, -1:] + eps) * scale
    dim_t = _dim_t(num_pos_feats, temperature, pad_mask.device)
    pos_z = _interleave_sin_cos(z_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos = torch.cat([pos_z, pos_y, pos_x], dim=-1)
    if pad_to is not None and pos.shape[-1] < pad_to:
        pos = torch.nn.functional.pad(pos, (0, pad_to - pos.shape[-1]))
    return pos


def sine_detection_encoding(
    pad_mask: torch.Tensor,
    num_pos_feats: int,
    temperature: float = 10000.0,
    scale: float | None = None,
    max_detections: int = 60,
) -> torch.Tensor:
    """Detection-slot index encoding: pad_mask [B, N] -> [B, N, 2*F].

    Not the paired variant: the slot index is the cumsum of the valid slots
    taken mod ``max_detections``, ``dim_t = T**(t/F)``, and the output is
    ``stack([sin, cos], -1)`` flattened per frequency."""
    if scale is None:
        scale = 2 * math.pi
    not_mask = (~pad_mask).float()
    y_embed = not_mask.cumsum(1) % max_detections
    y_embed = (y_embed - 0.5) / max_detections * scale
    t = torch.arange(num_pos_feats, dtype=torch.float32, device=pad_mask.device)
    dim_t = temperature ** (t / num_pos_feats)
    pos = y_embed[..., None] / dim_t
    return torch.stack([pos.sin(), pos.cos()], dim=-1).flatten(-2)
