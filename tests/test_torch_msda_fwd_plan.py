"""The forward MSDA kernels' plans, modelled in plain PyTorch on the CPU.

The CUDA kernels run only on the card, so their arithmetic is pinned down
here by a plain model of what each one computes, held against the port's
plain versions (``ms_deform_attn_plain``, ``ms_deform_attn_raw_pool_plain``)
and, for the edge samples, against the JAX package's XLA formulations:

- ``csrc/msda_fwd.cu`` and the direct kernel of
  ``csrc/msda_raw_pool_fwd.cu``: every corner of every sample as a
  branch-free entry, its cell clamped to the level's cell 0 and its weight
  0 where ``corner_at`` reads nothing, summed in the kernels' order (level,
  point, corner), whatever the lane width.

``chip_smoke.py::read_stats``, which counts the corner rows and distinct
rows that the replay of the main path reports, is held to the same corner
rule here.

``corner_rule`` is ``csrc/msda_common.cuh::corner_at`` in f32. Locations
lie on a 2^-16 grid, where every pixel coordinate is exact in f32, so the
models and the plain versions differ only in the order of their sums:
rtol 1e-5, atol 1e-6 in float32 against the port, and the 1e-4 / 1e-5 of
the port's JAX parity tests against JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kinet_tpu.ops import msda as jax_msda
from kinet_tpu_torch.ops import msda


def corner_rule(corner, h, w, x, y, vh, vw):
    """(inside, cell in the level, bilinear weight) of corner `corner`
    (dy = corner >> 1, dx = corner & 1) of samples at pixels (x, y), as
    corner_at computes them in f32."""
    x0, y0 = torch.floor(x), torch.floor(y)
    xmax = torch.clamp(vw - 1.0, max=float(w - 1))
    ymax = torch.clamp(vh - 1.0, max=float(h - 1))
    dy, dx = corner >> 1, corner & 1
    yi, xi = y0 + dy, x0 + dx
    wy = (y - y0) if dy else 1.0 - (y - y0)
    wx = (x - x0) if dx else 1.0 - (x - x0)
    inside = (yi >= 0) & (yi <= ymax) & (xi >= 0) & (xi <= xmax)
    return inside, yi.long() * w + xi.long(), wy * wx


def pixels(loc, shapes, lid):
    h, w = shapes[lid]
    return loc[..., lid, :, 0] * w - 0.5, loc[..., lid, :, 1] * h - 0.5


def msda_fwd_model(value, shapes, loc, aw):
    """msda_fwd.cu's sum: out [B, Lq, M * D] in f32."""
    b, s, m, d = value.shape
    lq, p = loc.shape[1], loc.shape[4]
    starts = msda.level_start_index(shapes)
    out = torch.zeros(b, lq, m, d)
    vals = value.float()
    bi = torch.arange(b).view(b, 1, 1)
    mi = torch.arange(m).view(1, 1, m)
    for lid, (h, w) in enumerate(shapes):
        x, y = pixels(loc, shapes, lid)
        for pt in range(p):
            for corner in range(4):
                inside, cell, bil = corner_rule(
                    corner, h, w, x[..., pt], y[..., pt],
                    torch.tensor(float(h)), torch.tensor(float(w)))
                cell = torch.where(inside, cell, 0)  # clamped, weight 0
                wt = torch.where(inside, bil * aw[..., lid, pt], 0.0)
                rows = vals[bi, starts[lid] + cell, mi]  # [B, Lq, M, D]
                out = out + wt[..., None] * rows
    return out.reshape(b, lq, m * d)


def raw_pool_direct_model(src, shapes, loc, aw, ext=None):
    """The direct kernel of msda_raw_pool_fwd.cu: pooled [B, Lq, M, C] and
    wsum [B, Lq, M] in f32."""
    b, _, c = src.shape
    lq, m, _, p = loc.shape[1:5]
    starts = msda.level_start_index(shapes)
    pooled = torch.zeros(b, lq, m, c)
    wsum = torch.zeros(b, lq, m)
    bi = torch.arange(b).view(b, 1, 1)
    for lid, (h, w) in enumerate(shapes):
        x, y = pixels(loc, shapes, lid)
        vh, vw = torch.tensor(float(h)), torch.tensor(float(w))
        if ext is not None:
            vh, vw = ext[:, lid, 0].view(b, 1, 1), ext[:, lid, 1].view(b, 1, 1)
        for pt in range(p):
            for corner in range(4):
                inside, cell, bil = corner_rule(corner, h, w, x[..., pt],
                                                y[..., pt], vh, vw)
                cell = torch.where(inside, cell, 0)  # clamped, weight 0
                wt = torch.where(inside, bil * aw[..., lid, pt], 0.0)
                rows = src.float()[bi, starts[lid] + cell]  # [B, Lq, M, C]
                pooled = pooled + wt[..., None] * rows
                wsum = wsum + wt
    return pooled, wsum


def _grid(a):
    return (np.round(a * 65536.0) / 65536.0).astype(np.float32)


def _inputs(seed, shapes, b=2, lq=5, m=4, p=2, d=8, c=12):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    src = rng.normal(size=(b, s, c)).astype(np.float32)
    loc = _grid(rng.uniform(-0.1, 1.1, size=(b, lq, m, l, p, 2)))
    aw = rng.uniform(size=(b, lq, m, l, p)).astype(np.float32)
    aw = aw / aw.sum(axis=(3, 4), keepdims=True)
    return [torch.from_numpy(a) for a in (value, src, loc, aw)]


def _extents(shapes, b):
    return torch.tensor([[[max(1, h - 1), max(1, w - 2)] for h, w in shapes]]
                        * b, dtype=torch.float32)


SHAPES = [((6, 8), (3, 4)), ((7, 9),), ((6, 8), (3, 4), (2, 3))]


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("shapes", SHAPES)
def test_msda_fwd_model_matches_plain(shapes, p):
    value, _, loc, aw = _inputs(0, shapes, p=p)
    out = msda_fwd_model(value, shapes, loc, aw)
    ref = msda.ms_deform_attn_plain(value, shapes, loc, aw)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("with_extents", [False, True])
@pytest.mark.parametrize("shapes", SHAPES)
def test_raw_pool_model_matches_plain(shapes, with_extents, p):
    _, src, loc, aw = _inputs(1, shapes, p=p)
    ext = _extents(shapes, 2) if with_extents else None
    ref_p, ref_w = msda.ms_deform_attn_raw_pool_plain(src, shapes, loc, aw, ext)
    pooled, wsum = raw_pool_direct_model(src, shapes, loc, aw, ext)
    torch.testing.assert_close(pooled, ref_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(wsum, ref_w, rtol=1e-5, atol=1e-6)


def _shared_cells(m=8, p=3):
    """Every head of a query on head 0's points, with head 0's weights."""
    shapes = ((6, 8), (3, 4))
    _, src, loc, aw = _inputs(2, shapes, m=m, p=p)
    loc[:] = loc[:, :, :1]
    aw[:] = aw[:, :, :1]
    return shapes, src, loc, aw


def test_raw_pool_model_shared_cells():
    """All heads of a query on the same cells: each head reads the same
    rows on its own and pools the same sums as head 0."""
    shapes, src, loc, aw = _shared_cells()
    pooled, wsum = raw_pool_direct_model(src, shapes, loc, aw)
    ref_p, ref_w = msda.ms_deform_attn_raw_pool_plain(src, shapes, loc, aw)
    torch.testing.assert_close(pooled, ref_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(wsum, ref_w, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pooled, pooled[:, :, :1].expand_as(pooled))
    torch.testing.assert_close(wsum, wsum[:, :, :1].expand_as(wsum))


@pytest.mark.parametrize("with_extents", [False, True])
def test_read_stats_counts_corner_rows(with_extents):
    """The replay's counts: ``corners`` is the corners the rule reads,
    ``distinct`` the distinct rows among them, and where every head of a
    query shares head 0's cells, the distinct rows per query are head 0's
    corners."""
    m, c, esize = 8, 12, 2
    shapes, _, loc, _ = _shared_cells(m=m)
    b, lq, _, l, p, _ = loc.shape
    ext = _extents(shapes, b) if with_extents else None
    st = chip_smoke.read_stats(torch, "raw", loc, shapes, ext, c, esize)
    starts = msda.level_start_index(shapes)
    rows = []  # (b, q, m, row) of every corner the rule reads
    for lid, (h, w) in enumerate(shapes):
        x, y = pixels(loc, shapes, lid)
        vh, vw = torch.tensor(float(h)), torch.tensor(float(w))
        if ext is not None:
            vh, vw = ext[:, lid, 0].view(b, 1, 1), ext[:, lid, 1].view(b, 1, 1)
        for pt in range(p):
            for corner in range(4):
                inside, cell, _ = corner_rule(corner, h, w, x[..., pt],
                                              y[..., pt], vh, vw)
                for bi, q, mm in inside.nonzero().tolist():
                    rows.append((bi, q, mm, starts[lid] + int(cell[bi, q, mm])))
    assert st["corners"] == len(rows) > 0
    assert st["distinct"] == len({(bi, r) for bi, _, _, r in rows})
    head0 = [(bi, q, r) for bi, q, mm, r in rows if mm == 0]
    assert st["query_distinct"] == len(set(head0))
    assert st["corners"] == m * len(head0)
    # every corner reads one 24-byte row: one sector, or two across a border
    n_sectors = sum((esize * c * ((bi * sum(h * w for h, w in shapes)) + r)
                     % 32) + esize * c > 32 for bi, _, _, r in rows)
    assert st["l2_bytes"] == 32 * (len(rows) + n_sectors)


def _edge_locs(shapes, m, p):
    """Samples at the corner rule's edges, on level 0: x and y on cell
    borders (integer pixels), at W - 1 and W - 1 + 2^-16, at -1, -0.5 and
    -2^-16, past the far border, and at the valid extents' last column and
    row and one past them (the other levels get the same points, scaled).
    The levels' widths and heights are powers of two, so every pixel
    coordinate, loc * W - 0.5 and grid_sample's alike, is exact in f32."""
    h, w = shapes[0]
    px = [0.0, 1.0, 2.5, w - 1.0, w - 1.0 + 2.0 ** -16, -1.0, -0.5,
          -2.0 ** -16, w - 0.5, w + 0.25, w - 3.0, w - 2.0, w - 2.5]
    py = [0.0, h - 1.0, h - 1.0 + 2.0 ** -16, -0.5, -2.0 ** -16, 1.0,
          h - 2.0, h - 1.5, h + 0.5, 0.5, h - 2.0, 2.0, -1.0]
    n = len(px)
    loc = torch.zeros(1, n, m, len(shapes), p, 2, dtype=torch.float64)
    for lid, (hl, wl) in enumerate(shapes):
        # pixel coordinate c of a W-wide level is loc = (c + 0.5) / W
        for i in range(n):
            loc[0, i, :, lid, :, 0] = (px[i] * wl / w + 0.5) / wl
            loc[0, i, :, lid, :, 1] = (py[i] * hl / h + 0.5) / hl
    # each head a quarter pixel of level 0 right of the one before
    loc[..., 0] += torch.arange(m).view(1, 1, m, 1, 1) * (0.25 / w)
    return loc.float()


@pytest.mark.parametrize("shapes", [((8, 16), (4, 8)), ((8, 16),)])
def test_edge_samples_match_plain_and_jax(shapes):
    m, p, d, c = 4, 2, 8, 12
    loc = _edge_locs(shapes, m, p)
    lq, l = loc.shape[1], len(shapes)
    rng = np.random.default_rng(3)
    s = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.normal(size=(1, s, m, d)).astype(np.float32))
    src = torch.from_numpy(rng.normal(size=(1, s, c)).astype(np.float32))
    aw = torch.from_numpy(rng.uniform(0.1, 1.0, size=(1, lq, m, l, p))
                          .astype(np.float32))
    # the valid extents end at the samples' columns/rows w - 2, h - 2
    ext = torch.tensor([[[hl - 1, wl - 1] for hl, wl in shapes]],
                       dtype=torch.float32)
    out = msda_fwd_model(value, shapes, loc, aw)
    torch.testing.assert_close(
        out, msda.ms_deform_attn_plain(value, shapes, loc, aw),
        rtol=1e-5, atol=1e-6)
    ref_x = np.asarray(jax_msda.ms_deform_attn_quad_unroll(
        jnp.asarray(value.numpy()), shapes, jnp.asarray(loc.numpy()),
        jnp.asarray(aw.numpy())))
    np.testing.assert_allclose(out.numpy(), ref_x, rtol=1e-4, atol=1e-5)
    for e in (None, ext):
        ref = msda.ms_deform_attn_raw_pool_plain(src, shapes, loc, aw, e)
        ref_j = jax_msda.ms_deform_attn_raw_pool(
            jnp.asarray(src.numpy()), shapes, jnp.asarray(loc.numpy()),
            jnp.asarray(aw.numpy()), None,
            None if e is None else jnp.asarray(e.numpy()))
        got = raw_pool_direct_model(src, shapes, loc, aw, e)
        for a, r, j in zip(got, ref, ref_j):
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(a.numpy(), np.asarray(j),
                                       rtol=1e-4, atol=1e-5)


def test_corner_rule_at_the_edges():
    """Which corners of the edge samples are read, by the rule itself: a
    sample at x = W - 1 reads column W - 1 (weight 1) and not W; at
    W - 1 + 2^-16 its left corner still counts, with weight 1 - 2^-16; at
    x = -0.5 only column 0, with weight 0.5; a valid extent of vw columns
    reads nothing at column vw."""
    h, w = 4, 6
    one = torch.tensor(1.0)

    def read(corner, x, y, vh=float(h), vw=float(w)):
        inside, cell, bil = corner_rule(corner, h, w, torch.tensor(x),
                                        torch.tensor(y), torch.tensor(vh),
                                        torch.tensor(vw))
        return bool(inside), int(cell), float(bil)

    assert read(0, w - 1.0, 0.0) == (True, w - 1, 1.0)
    assert read(1, w - 1.0, 0.0)[0] is False
    inside, cell, bil = read(0, w - 1.0 + 2.0 ** -16, 0.0)
    assert inside and cell == w - 1 and bil == 1.0 - 2.0 ** -16
    assert read(1, w - 1.0 + 2.0 ** -16, 0.0)[0] is False
    assert read(0, -0.5, 0.0)[0] is False
    assert read(1, -0.5, 0.0) == (True, 0, 0.5)
    assert read(1, -2.0 ** -16, 0.0) == (True, 0, float(one - 2.0 ** -16))
    # valid extent: 4 columns, so column 3 is read and column 4 is not
    assert read(0, 3.0, 0.0, vw=4.0) == (True, 3, 1.0)
    assert read(1, 3.5, 0.0, vw=4.0)[0] is False
    assert read(2, 0.0, 1.5, vh=2.0)[0] is False
    assert read(0, 0.0, 1.0, vh=2.0) == (True, w, 1.0)
