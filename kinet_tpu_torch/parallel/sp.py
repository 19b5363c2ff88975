"""Spatial parallelism: one frame's height split over the processes of a
group, to serve ONE stream at a lower latency (port of
``kinet_tpu/parallel/sp.py``).

In the JAX package this is a layout: the image's height is sharded over a
mesh axis and GSPMD partitions the convolutions (halo exchanges), the
flattened encoder tokens, and gathers where an op needs a whole tensor.
PyTorch has no GSPMD, so here each piece is written out
(``SpatialParallel``), and the models call it where they take a
``spatial`` argument (``models/backbone.py``, ``deformable_detr.py``,
``deformable_transformer.py``, ``detr.py``):

- **Rows.** Rank r owns a contiguous block of input rows whose bounds are
  multiples of the model's coarsest stride (32, or 64 with the extra
  stride-64 level): the coarsest level's rows are dealt out as evenly as
  they go, the first ranks taking one more. At every level a rank owns
  the rows its input block maps to. A rank that would own no row of the
  coarsest level raises ValueError.
- **Halo convolutions.** Every convolution and the max pool of the ResNet
  trunk, and the extra level's 3x3/s2 projection, take the input rows
  their own output rows read (from the kernel, stride, padding and
  dilation) from the ranks that own them (one all-gather of the rows
  anybody needs); at the frame's true top and bottom edges the op keeps
  its own padding (zeros; -inf for the max pool).
- **GroupNorm** of the input projections: group statistics reduced over
  the group (the padded pixels count, as they do unsharded).
- **Pad masks, position encodings, valid ratios and the encoder's
  reference points** are computed whole from the replicated pad mask; a
  rank takes its own rows.
- **Deformable encoder.** A rank's queries are its own tokens of every
  level, in the level-major order; each layer's value table is the whole
  frame: the rank's own projected (and masked) values are all-gathered in
  level-major order, one all-gather a layer. The Lite modes intersect the
  rank's tokens with the updated levels. After the last layer the memory
  is all-gathered; the decoder, two-stage proposals, heads and
  postprocessing run replicated, so the outputs are replicated on every
  rank.
- **Vanilla DETR and the mask head** get the sharded trunk, all-gathered:
  the rest runs on the whole features.

Inference only.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from ..utils.dist import all_gather_uneven, all_reduce_sum, group_size


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class SpatialParallel:
    """The rows of one frame of ``height`` rows over ``group`` (None: one
    process), in blocks of multiples of ``stride`` rows; ``level_strides``
    are the strides of the pyramid levels the encoder reads."""

    def __init__(self, height: int, stride: int, group=None,
                 level_strides=()):
        self.group = group
        self.n = group_size(group)
        self.rank = 0 if group is None else tdist.get_rank(group)
        self.height, self.stride = int(height), int(stride)
        self.level_strides = tuple(level_strides)
        coarse = _ceil_div(self.height, self.stride)
        if coarse < self.n:
            raise ValueError(
                f"spatial parallel over {self.n} processes: a frame of "
                f"{self.height} rows has {coarse} rows at stride "
                f"{self.stride}, so a process would own none")
        per, extra = divmod(coarse, self.n)
        cuts = [0]
        for r in range(self.n):
            cuts.append(cuts[-1] + per + (r < extra))
        # the image rows where each block starts, and the frame's end
        self.cuts = [c * self.stride for c in cuts[:-1]] + [self.height]

    # ---- rows --------------------------------------------------------
    def level_height(self, s: int) -> int:
        """Rows of the level at stride ``s`` (every op of the trunk maps H
        rows to ceil(H / 2) at stride 2)."""
        return _ceil_div(self.height, s)

    def rows(self, s: int) -> list:
        """[(first, end)] row of each rank at stride ``s``."""
        if self.stride % s:
            raise ValueError(f"stride {s} does not divide {self.stride}")
        return [(self.cuts[r] // s,
                 self.cuts[r + 1] // s if r + 1 < self.n
                 else self.level_height(s)) for r in range(self.n)]

    def own(self, s: int) -> tuple:
        return self.rows(s)[self.rank]

    def image_rows(self, images: torch.Tensor) -> torch.Tensor:
        """The rank's rows of [B, H, W, C] images."""
        a, b = self.own(1)
        return images[:, a:b]

    # ---- halo exchange -------------------------------------------------
    def exchange(self, x: torch.Tensor, rows: list, need: list):
        """Rows ``need[rank]`` (first, end) of a level whose rows ``rows``
        are split over the ranks, from ``x`` (this rank's rows, dim 2) and
        the other ranks' rows: each rank contributes the rows of its own
        that a rank above (its first rows) or below (its last rows) needs,
        in one all-gather."""
        n, r = self.n, self.rank
        plan = []
        for q, (a, b) in enumerate(rows):
            top_end = max([need[t][1] for t in range(q)] + [a])
            bot_start = min([need[t][0] for t in range(q + 1, n)] + [b])
            plan.append(((a, min(b, top_end)), (max(a, bot_start), b)))
        sizes = [(t[1] - t[0]) + (u[1] - u[0]) for t, u in plan]
        got = None
        if max(sizes):
            (t0, t1), (u0, u1) = plan[r]
            a = rows[r][0]
            mine = torch.cat([x[:, :, t0 - a:t1 - a], x[:, :, u0 - a:u1 - a]],
                             2)
            got = all_gather_uneven(mine, sizes, 2, self.group)
        lo, hi = need[r]
        segs = []
        for q, (a, b) in enumerate(rows):
            u, v = max(lo, a), min(hi, b)
            if u >= v:
                continue
            if q == r:
                segs.append(x[:, :, u - a:v - a])
                continue
            (t0, t1), (b0, b1) = plan[q]
            if t0 <= u and v <= t1:
                segs.append(got[q][:, :, u - t0:v - t0])
            elif b0 <= u and v <= b1:
                off = t1 - t0
                segs.append(got[q][:, :, off + u - b0:off + v - b0])
            else:
                raise AssertionError(f"rows {u}:{v} of rank {q} not sent")
        return torch.cat(segs, 2)

    def rows_op(self, x, s_in: int, k: int, st: int, p: int, d: int, op,
                fill=0.0):
        """``op`` (with no padding along the height) on the rows of ``x``
        (this rank's rows at stride ``s_in``) that this rank's output rows
        read, for a kernel ``k`` with stride ``st``, padding ``p`` and
        dilation ``d`` along the height; the frame's edges padded with
        ``fill``."""
        h_in = self.level_height(s_in)
        s_out = s_in * st
        if (h_in + 2 * p - d * (k - 1) - 1) // st + 1 != self.level_height(
                s_out):
            raise ValueError(f"an op of kernel {k}, stride {st}, padding "
                             f"{p} does not map {h_in} rows to "
                             f"{self.level_height(s_out)}")
        need = [(oa * st - p, (ob - 1) * st - p + (k - 1) * d + 1)
                for oa, ob in self.rows(s_out)]
        ext = self.exchange(
            x, self.rows(s_in), [(max(lo, 0), min(hi, h_in)) for lo, hi in need])
        lo, hi = need[self.rank]
        top, bottom = max(0, -lo), max(0, hi - h_in)
        if top or bottom:
            ext = F.pad(ext, (0, 0, top, bottom), value=fill)
        return op(ext)

    def conv(self, conv, x, s_in: int):
        """``conv`` (an ``nn.Conv2d``) on this rank's rows ``x`` at stride
        ``s_in``: its output rows."""
        k, st, p, d = (conv.kernel_size[0], conv.stride[0], conv.padding[0],
                       conv.dilation[0])
        if k == 1 and st == 1:
            return conv(x)
        return self.rows_op(x, s_in, k, st, p, d, lambda e: F.conv2d(
            e, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
            conv.dilation, conv.groups))

    def max_pool(self, pool, x, s_in: int):
        k, st, p, d = pool.kernel_size, pool.stride, pool.padding, pool.dilation
        return self.rows_op(x, s_in, k, st, p, d, lambda e: F.max_pool2d(
            e, k, st, (0, p), d, pool.ceil_mode), fill=float("-inf"))

    # ---- the trunk -------------------------------------------------------
    def features(self, backbone, images) -> list:
        """The backbone's levels (``Backbone.select``) of [B, H, W, 3]
        images, this rank's rows (NCHW): ``models/backbone.py::ResNet`` on
        the rank's image rows, its convolutions and max pool through
        ``conv`` and ``max_pool``."""
        x = self.image_rows(images).permute(0, 3, 1, 2)
        return backbone.select(backbone.trunk(x, self.conv, self.max_pool))

    def gather(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """The whole level at stride ``s`` from every rank's rows (dim 2)."""
        sizes = [b - a for a, b in self.rows(s)]
        return torch.cat(all_gather_uneven(x, sizes, 2, self.group), 2)

    def whole(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """A whole-frame [B, C, H_s, W] tensor holding this rank's rows of
        the level at stride ``s`` and zeros elsewhere: the shape the
        transformer's flattening expects; the encoder reads only the
        rank's rows of it."""
        a, b = self.own(s)
        out = x.new_zeros(*x.shape[:2], self.level_height(s), x.shape[3])
        out[:, :, a:b] = x
        return out

    def group_norm(self, gn, x: torch.Tensor) -> torch.Tensor:
        """``gn`` (an ``nn.GroupNorm``) over the whole level from this rank's
        rows: each group's sum and sum of squares (float64) reduced over
        the ranks."""
        b, c = x.shape[:2]
        g = gn.num_groups
        xd = x.double().reshape(b, g, -1)
        stats = torch.stack([xd.sum(-1), (xd * xd).sum(-1),
                             torch.full((b, g), float(xd.shape[-1]),
                                        dtype=torch.float64, device=x.device)])
        stats = all_reduce_sum(stats, self.group)
        mean = stats[0] / stats[2]
        var = (stats[1] / stats[2] - mean * mean).clamp_min(0.0)
        scale = torch.rsqrt(var + gn.eps)
        y = ((x.float().reshape(b, g, -1) - mean[..., None].float())
             * scale[..., None].float()).reshape(x.shape)
        if gn.affine:
            y = y * gn.weight.float()[:, None, None] + gn.bias.float()[:, None, None]
        return y.to(x.dtype)

    # ---- the deformable encoder ----------------------------------------
    def _spans(self, shapes) -> list:
        """[rank][level] (first, end) of the rank's tokens in the flattened
        level-major sequence of ``shapes``."""
        if len(shapes) > len(self.level_strides):
            raise ValueError(f"{len(shapes)} levels, strides known for "
                             f"{len(self.level_strides)}")
        starts, out = [0], [[] for _ in range(self.n)]
        for (h, w), s in zip(shapes, self.level_strides):
            if h != self.level_height(s):
                raise ValueError(f"a level of {h} rows at stride {s}")
            for q, (a, b) in enumerate(self.rows(s)):
                out[q].append((starts[-1] + a * w, starts[-1] + b * w))
            starts.append(starts[-1] + h * w)
        return out

    def _gather_levels(self, x, spans, k):
        """The tokens of levels < ``k`` of every rank, in level-major order,
        from this rank's own tokens ``x`` [B, n, C] of those levels."""
        sizes = [sum(b - a for a, b in sp[:k]) for sp in spans]
        parts = all_gather_uneven(x, sizes, 1, self.group)
        out = []
        for lvl in range(k):
            for q, part in enumerate(parts):
                off = sum(b - a for a, b in spans[q][:lvl])
                a, b = spans[q][lvl]
                out.append(part[:, off:off + b - a])
        return torch.cat(out, 1)

    def encode(self, encoder, src, shapes, valid_ratios, pos, mask):
        """``DeformableEncoder.forward`` over the whole-frame flattened
        ``src`` (of which only this rank's tokens are read), with this
        rank's tokens as the queries and the whole frame as the values;
        returns the whole memory."""
        from ..models.deformable_transformer import encoder_reference_points

        if len(shapes) != encoder.n_levels:
            raise ValueError(
                f"encoder built for {encoder.n_levels} levels, got {shapes}")
        spans = self._spans(shapes)
        own = spans[self.rank]
        idx = torch.cat([torch.arange(a, b, device=src.device)
                         for a, b in own])
        ref = encoder_reference_points(shapes, valid_ratios)[:, idx]
        out = src[:, idx]
        pos = pos[:, idx] if pos is not None else None
        mask = mask[:, idx] if mask is not None else None
        ends = [0]  # where each level's tokens end in the rank's order
        for a, b in own:
            ends.append(ends[-1] + b - a)
        n_lvl = len(shapes)
        for i, (mode, k) in enumerate(encoder.modes):
            layer = getattr(encoder, f"layer{i}")
            kv = n_lvl if mode == "all" else k
            attn = layer.self_attn
            value = attn.value_proj(out[:, :ends[kv]])
            if mask is not None:
                value = value.masked_fill(mask[:, :ends[kv], None], 0.0)
            value = self._gather_levels(value, spans, kv)
            rows = (slice(0, None) if mode == "all" else
                    slice(ends[1], None) if mode == "high" else
                    slice(0, ends[1]))
            upd = layer(out[:, rows], pos[:, rows] if pos is not None else
                        None, ref[:, rows, :kv], tuple(shapes[:kv]),
                        value=value)
            if mode == "all":
                out = upd
            elif mode == "high":
                out = torch.cat([out[:, :ends[1]], upd], dim=1)
            else:
                out = torch.cat([upd, out[:, ends[1]:]], dim=1)
        return self._gather_levels(out, spans, n_lvl)


def spatial_parallel(model, group, height: int) -> SpatialParallel:
    """The ``SpatialParallel`` of ``model`` (``DeformableDETR``, ``DETR`` or
    a ``SegmWrapper`` of either) for frames of ``height`` rows over
    ``group``: blocks of multiples of its coarsest stride."""
    detector = getattr(model, "detector", model)
    trunk_stride = detector.backbone.trunk.strides[-1]
    levels = tuple(detector.level_strides()) if hasattr(
        detector, "level_strides") else ()
    return SpatialParallel(height, max((trunk_stride,) + levels), group,
                           levels)
