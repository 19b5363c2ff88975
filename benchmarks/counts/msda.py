"""Bytes and operations of one multi-scale deformable attention call, from
the semantic call: its table, its shapes and its own sample locations.

Two kinds of call reach the device on the served path:
- ``msda`` (project, then sample): value [B, S, M, D] -> out [B, Lq, M*D]
  float32. It reads the (batch, cell, head) slices that some bilinear
  corner of some sample touches, each once;
- ``raw_pool`` (sample raw rows, project after): src [B, S, C] (float or
  int8, with per-level scales) -> pooled [B, Lq, M, C] and the weight sums
  wsum [B, Lq, M] float32. It reads the (batch, cell) rows that some
  corner touches, each once.

Both read the locations [B, Lq, M, L, P, 2] and weights [B, Lq, M, L, P]
float32 once (and the raw pool its valid extents and scales) and write
their outputs once. A corner counts as touched when the kernels read it:
inside the level and inside the valid extent (the rule of the program's
``corner_at``; a corner outside reads nothing). Operations: a multiply and
an add a channel for each in-bounds corner, and the four bilinear corner
weights (one multiply each) a sample.
"""
from __future__ import annotations

import torch


def level_starts(shapes):
    out, cur = [], 0
    for h, w in shapes:
        out.append(cur)
        cur += h * w
    return out


def corner_rows(loc, shapes, ext=None):
    """The table row (level start + cell) of each bilinear corner of each
    sample, [B, Lq, M, L, P, 4] int64, -1 where nothing is read."""
    b, lq, m, l, p, _ = loc.shape
    rows = torch.full((b, lq, m, l, p, 4), -1, dtype=torch.long,
                      device=loc.device)
    for lid, ((h, w), start) in enumerate(zip(shapes, level_starts(shapes))):
        x = loc[:, :, :, lid, :, 0].float() * w - 0.5
        y = loc[:, :, :, lid, :, 1].float() * h - 0.5
        x0, y0 = x.floor(), y.floor()
        xmax = torch.full_like(x, w - 1.0)
        ymax = torch.full_like(y, h - 1.0)
        if ext is not None:
            xmax = torch.minimum(xmax, ext[:, lid, 1].view(b, 1, 1, 1) - 1.0)
            ymax = torch.minimum(ymax, ext[:, lid, 0].view(b, 1, 1, 1) - 1.0)
        for c, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi <= xmax) & (yi >= 0) & (yi <= ymax)
            cell = start + yi.clamp(0, h - 1).long() * w + \
                xi.clamp(0, w - 1).long()
            rows[..., lid, :, c] = torch.where(inside, cell, -1)
    return rows


def call_counts(kind, table, shapes, loc, aw, ext=None, out_bytes=None):
    """(bytes, operations) of one call. ``table``: the msda value [B, S, M,
    D] or the raw pool's src [B, S, C] (its element size is what a row
    costs); ``out_bytes``: the element size of the raw pool's pooled output
    (default: the table's, float32 for an int8 table)."""
    b, lq, m, l, p, _ = loc.shape
    s = table.shape[1]
    esize = table.element_size()
    rows = corner_rows(loc, shapes, ext)
    valid = rows >= 0
    bidx = torch.arange(b, device=loc.device).view(b, 1, 1, 1, 1, 1)
    samples = b * lq * m * l * p
    side = samples * 2 * 4 + samples * 4  # locations and weights, float32
    if kind == "msda":
        d = table.shape[3]
        heads = torch.arange(m, device=loc.device).view(1, 1, m, 1, 1, 1)
        keys = (bidx * s + rows) * m + heads
        read = torch.unique(keys[valid]).numel() * d * esize
        written = b * lq * m * d * 4
        chans = d
    elif kind == "raw_pool":
        c = table.shape[2]
        keys = bidx * s + rows
        read = torch.unique(keys[valid]).numel() * c * esize
        if ext is not None:
            side += ext.numel() * 4
        if table.dtype == torch.int8:
            side += b * l * 4  # the per-level scales
        if out_bytes is None:
            out_bytes = 4 if table.dtype == torch.int8 else esize
        written = b * lq * m * c * out_bytes + b * lq * m * 4
        chans = c
    else:
        raise ValueError(f"unknown MSDA call kind {kind!r}")
    ops = int(valid.sum()) * 2 * chans + samples * 4
    return read + side + written, ops


def bound_s(nbytes, ops, peaks):
    """The least time the chip could take: the larger of the bytes over the
    memory bandwidth and the operations over the float32 rate (the kernels
    compute in float32 outside the tensor cores)."""
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["f32_flops_per_s"])
