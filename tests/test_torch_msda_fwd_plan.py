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
- the wide lanes of ``csrc/msda_fwd.cu`` over int8 values
  (``msda_fwd_i8``): 12 channels of a head a thread, read as one 8-byte
  and one 4-byte load in the order the first channel's alignment gives,
  each channel turned into f32 by ``i8_at`` (PRMT + FADD, modelled bit for
  bit), the head's scale folded into its weights.
- the head-shared wide instance (``msda_shared_fwd``): a query's
  12-channel lanes side by side over a corner's whole row, each lane within
  one head, whose weights it applies.
- the top-k wide instance (``msda_topk_fwd``): each lane ranks its
  (query, head)'s weights as ``rank_keep`` does in registers (ties to the
  lower index), loads the four corners of every kept sample and nothing of
  a dropped one, and sums the kept samples in (level, point, corner) order
  into its 8- and 4-channel sums.
- the int8 raw pool's own kernel (``msda_raw_pool_fwd_i8``, K1): a block's
  plan of every corner (row, w * scale, w) in (level, point, corner) order,
  padded to whole groups of 16 with row 0 and weight 0; lanes of 16, 8, 4,
  2 or 1 channels by C and the pointers' alignment, each loading its bytes
  at row * C + lane * V (aligned) and adding them, turned into f32 by
  ``i8_at``, in the plan's order; wsum over the unscaled weights; the block
  shapes, whose plan fits 48 KB and spreads over the banks.

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


# ---------------------------------------------------------------------------
# msda_fwd_i8's wide lanes and msda_shared_fwd's lane maps


def i8_at_model(flipped, k):
    """csrc/msda_common.cuh::i8_at on uint32 words whose sign bits are
    flipped: byte k under the exponent of 2^23 (the PRMT), as f32, minus
    2^23 + 128 (the FADD), in f32."""
    bits = np.uint32(0x4B000000) | ((flipped >> np.uint32(8 * k)) & np.uint32(0xFF))
    return bits.astype(np.uint32).view(np.float32) - np.float32(8388736.0)


def test_i8_at_is_exact_for_every_byte():
    """Every int8 value at every byte of a word, beside random neighbours,
    gives its float32 bit for bit."""
    rng = np.random.default_rng(30)
    vals = np.arange(-128, 128, dtype=np.int32)
    for k in range(4):
        words = rng.integers(0, 2 ** 32, size=vals.size, dtype=np.uint64)
        words &= ~np.uint64(0xFF << (8 * k))
        words |= (vals.astype(np.uint64) & np.uint64(0xFF)) << np.uint64(8 * k)
        flipped = words.astype(np.uint32) ^ np.uint32(0x80808080)
        got = i8_at_model(flipped, k)
        want = vals.astype(np.int8).astype(np.float32)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _words(byte_rows, offset, n):
    """n little-endian uint32 words of int8 rows (int64 bytes 0-255) from
    byte ``offset`` on."""
    w = []
    for i in range(n):
        b = byte_rows[..., offset + 4 * i:offset + 4 * i + 4]
        w.append(b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24)
    return w


def wide12_lanes(m, d):
    """The 12-channel lanes of a row of m heads of d channels (d % 12 == 0):
    (first channel e0, head, 8-channel load's offset, 4-channel load's
    offset), the first load at e0 where e0 % 8 == 0, else at e0 + 4."""
    lanes = []
    for e0 in range(0, m * d, 12):
        odd = (e0 >> 2) & 1
        lanes.append((e0, e0 // d, 4 if odd else 0, 0 if odd else 8))
    return lanes


def msda_fwd_i8_wide_model(q8, scale, shapes, loc, aw):
    """msda_fwd.cu's wide int8 lanes: out [B, Lq, M * D] f32."""
    b, s, m, d = q8.shape
    lq, p = loc.shape[1], loc.shape[4]
    row = m * d
    assert d % 12 == 0 and row % 8 == 0
    starts = msda.level_start_index(shapes)
    flat = q8.reshape(b, s * row).view(torch.uint8).long().view(b, s, row)
    bi = torch.arange(b).view(b, 1)
    sw_all = aw * scale.float().view(b, 1, m, 1, 1)  # the scale, once
    out = torch.zeros(b, lq, row)
    for e0, head, off_big, off_small in wide12_lanes(m, d):
        assert (e0 + off_big) % 8 == 0 and (e0 + off_small) % 4 == 0
        assert e0 + 12 <= (head + 1) * d  # a lane lies in one head
        ab, as_ = torch.zeros(b, lq, 8), torch.zeros(b, lq, 4)
        for lid, (h, w) in enumerate(shapes):
            x, y = pixels(loc[:, :, head], shapes, lid)
            for pt in range(p):
                for corner in range(4):
                    inside, cell, bil = corner_rule(
                        corner, h, w, x[..., pt], y[..., pt],
                        torch.tensor(float(h)), torch.tensor(float(w)))
                    cell = torch.where(inside, cell, 0)
                    wt = torch.where(inside, bil * sw_all[:, :, head, lid, pt],
                                     0.0)
                    rows = flat[bi, starts[lid] + cell]  # [B, Lq, row] bytes
                    for acc, off, n in ((ab, off_big, 2), (as_, off_small, 1)):
                        for j, word in enumerate(_words(rows, e0 + off, n)):
                            f = word.numpy().astype(np.uint32) ^ np.uint32(0x80808080)
                            for k in range(4):
                                v = torch.from_numpy(i8_at_model(f, k))
                                acc[..., 4 * j + k] += wt * v
        odd = (e0 >> 2) & 1
        out[..., e0:e0 + 12] = torch.cat([as_, ab] if odd else [ab, as_], -1)
    return out


@pytest.mark.parametrize("m, d", [(4, 36), (2, 12), (4, 24)])
@pytest.mark.parametrize("shapes", SHAPES[:2])
def test_msda_fwd_i8_wide_model_matches_plain_and_jax(shapes, m, d):
    rng = np.random.default_rng(31)
    s = sum(h * w for h, w in shapes)
    b, lq, p = 2, 5, 2
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(b, s, m, d))
                          .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.001, 0.05, size=(b, m))
                             .astype(np.float32))
    _, _, loc, aw = _inputs(32, shapes, b=b, lq=lq, m=m, p=p)
    out = msda_fwd_i8_wide_model(q8, scale, shapes, loc, aw)
    ref = msda.ms_deform_attn_i8_plain(q8, scale, shapes, loc, aw)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    ref_j = np.asarray(jax_msda.ms_deform_attn_quad_unroll(
        jnp.asarray(q8.numpy()), shapes, jnp.asarray(loc.numpy()),
        jnp.asarray(aw.numpy()), value_scale=jnp.asarray(scale.numpy())))
    np.testing.assert_allclose(out.numpy(), ref_j, rtol=1e-4, atol=1e-5)


def shared_lane_heads(m, d):
    """The head of every channel of every 12-channel lane over a row of m
    heads of d channels (d % 12 == 0): [lanes, 12]."""
    return torch.tensor([[(c0 + t) // d for t in range(12)]
                         for c0 in range(0, m * d, 12)])


def msda_shared_lanes_model(value, shapes, loc, aw):
    """msda_shared_fwd's wide instance: a query's 12-channel lanes over a
    corner's row, each channel weighted by its lane's head, summed over
    (level, point, corner). out [B, Lq, M * D] f32."""
    b, s, m, d = value.shape
    lq, p = loc.shape[1], loc.shape[3]
    row = m * d
    starts = msda.level_start_index(shapes)
    flat = value.float().reshape(b, s, row)
    bi = torch.arange(b).view(b, 1)
    heads = shared_lane_heads(m, d)
    assert (heads == heads[:, :1]).all()  # a lane lies in one head
    head_of = heads.reshape(-1)  # per channel
    out = torch.zeros(b, lq, row)
    for lid, (h, w) in enumerate(shapes):
        x = loc[:, :, lid, :, 0] * w - 0.5
        y = loc[:, :, lid, :, 1] * h - 0.5
        for pt in range(p):
            for corner in range(4):
                inside, cell, bil = corner_rule(
                    corner, h, w, x[..., pt], y[..., pt],
                    torch.tensor(float(h)), torch.tensor(float(w)))
                cell = torch.where(inside, cell, 0)
                bil = torch.where(inside, bil, 0.0)
                rows = flat[bi, starts[lid] + cell]  # [B, Lq, row]
                wt = bil[..., None] * aw[:, :, head_of, lid, pt]
                out = out + wt * rows
    return out


def test_shared_lane_heads():
    """At the flagship's D = 36: 24 lanes a 288-channel row, three a head,
    none across a head's border."""
    heads = shared_lane_heads(8, 36)
    assert heads.shape == (24, 12) and (heads == heads[:, :1]).all()
    assert heads[:, 0].tolist() == [i // 3 for i in range(24)]
    assert (heads.reshape(-1) == torch.arange(288) // 36).all()


@pytest.mark.parametrize("m, d", [(8, 36), (4, 12)])
@pytest.mark.parametrize("shapes", SHAPES)
def test_msda_shared_lanes_model_matches_plain_and_jax(shapes, m, d):
    b, lq, p = 2, 5, 2
    value, _, loc, aw = _inputs(33, shapes, b=b, lq=lq, m=m, p=p, d=d)
    loc = loc[:, :, 0].contiguous()  # one set of locations a query
    out = msda_shared_lanes_model(value, shapes, loc, aw)
    ref = msda.ms_deform_attn_shared_plain(value, shapes, loc, aw)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    ref_j = np.asarray(jax_msda.ms_deform_attn_patch_shared(
        jnp.asarray(value.numpy()), shapes, jnp.asarray(loc.numpy()),
        jnp.asarray(aw.numpy())))
    np.testing.assert_allclose(out.numpy(), ref_j, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# msda_topk_fwd's wide instance


def rank_keep_model(aw, k):
    """csrc/msda_fwd.cu::rank_keep over the last axis of aw [..., LP]: a
    sample's rank is the count of samples with a larger weight, or an equal
    one at a lower index; it is kept iff its rank < k."""
    lp = aw.shape[-1]
    ai, aj = aw[..., :, None], aw[..., None, :]  # [..., i, j]
    lower = torch.arange(lp).view(lp, 1) < torch.arange(lp).view(1, lp)
    rank = ((ai > aj) | ((ai == aj) & lower)).sum(-2)
    return rank < k


def msda_topk_wide_model(value, shapes, loc, aw, k):
    """msda_fwd.cu's top-k wide lanes: (out [B, Lq, M * D] f32, corner
    loads [B, Lq, M] of one lane of each (query, head))."""
    b, s, m, d = value.shape
    lq, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    row = m * d
    assert d % 12 == 0 and row % 8 == 0
    starts = msda.level_start_index(shapes)
    flat = value.float().reshape(b, s, row)
    bi = torch.arange(b).view(b, 1)
    keep = rank_keep_model(aw.reshape(b, lq, m, l * p), k)
    out = torch.zeros(b, lq, row)
    loads = torch.zeros(b, lq, m, dtype=torch.long)
    for e0, head, off_big, off_small in wide12_lanes(m, d):
        ab, as_ = torch.zeros(b, lq, 8), torch.zeros(b, lq, 4)
        n_loads = torch.zeros(b, lq, dtype=torch.long)
        for lid, (h, w) in enumerate(shapes):
            x, y = pixels(loc[:, :, head], shapes, lid)
            for pt in range(p):
                kept = keep[:, :, head, lid * p + pt]
                for corner in range(4):
                    inside, cell, bil = corner_rule(
                        corner, h, w, x[..., pt], y[..., pt],
                        torch.tensor(float(h)), torch.tensor(float(w)))
                    cell = torch.where(inside, cell, 0)
                    wt = torch.where(inside, bil * aw[:, :, head, lid, pt],
                                     0.0)
                    rows = flat[bi, starts[lid] + cell]  # [B, Lq, row]
                    big = rows[..., e0 + off_big:e0 + off_big + 8]
                    small = rows[..., e0 + off_small:e0 + off_small + 4]
                    # a dropped sample: no load, nothing added
                    ab = torch.where(kept[..., None], ab + wt[..., None] * big,
                                     ab)
                    as_ = torch.where(kept[..., None],
                                      as_ + wt[..., None] * small, as_)
                    n_loads += kept.long()
        odd = (e0 >> 2) & 1
        out[..., e0:e0 + 12] = torch.cat([as_, ab] if odd else [ab, as_], -1)
        loads[:, :, head] = n_loads
    return out, loads


def test_rank_keep_model_matches_topk_sample_mask():
    """The register rank keeps what a stable descending sort keeps, on
    ties (every weight equal, pairs of equal weights) and random weights,
    for every k."""
    rng = np.random.default_rng(40)
    rows = [np.full(16, 1.0 / 16), np.repeat(rng.uniform(size=8), 2),
            rng.uniform(size=16), np.tile([0.2, 0.3], 8)]
    aw = torch.from_numpy(np.stack(rows).astype(np.float32)).view(4, 1, 1, 4, 4)
    for k in range(1, 17):
        keep = rank_keep_model(aw.reshape(4, 1, 1, 16), k).view(aw.shape)
        assert torch.equal(keep, msda.topk_sample_mask(aw, k)), k
        assert (keep.sum((-1, -2)) == k).all()
    tied = rank_keep_model(aw[:1].reshape(1, 16), 5)
    assert tied.flatten().tolist() == [True] * 5 + [False] * 11


TOPK_CASES = {
    "lp22_k3": (((6, 8), (3, 4)), 2, 3),
    "lp12_k1": (((7, 9),), 2, 1),
    "lp44_k8": (((8, 12), (4, 6), (2, 3), (1, 2)), 4, 8),
}


@pytest.mark.parametrize("uniform", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_msda_topk_wide_model_matches_plain_and_jax(case, uniform):
    shapes, p, k = TOPK_CASES[case]
    b, lq, m, d = 2, 5, 4, 36
    value, _, loc, aw = _inputs(41, shapes, b=b, lq=lq, m=m, p=p, d=d)
    if uniform:
        aw = torch.full_like(aw, 1.0 / (len(shapes) * p))
    out, loads = msda_topk_wide_model(value, shapes, loc, aw, k)
    assert (loads == 4 * k).all()  # every kept corner, nothing dropped
    ref = msda.ms_deform_attn_topk_plain(value, shapes, loc, aw, k)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    ref_j = np.asarray(jax_msda.ms_deform_attn_topk_quad(
        jnp.asarray(value.numpy()), shapes, jnp.asarray(loc.numpy()),
        jnp.asarray(aw.numpy()), top_k=k))
    np.testing.assert_allclose(out.numpy(), ref_j, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# msda_raw_pool_fwd_i8's own kernel (K1)

I8_MAX_THREADS, I8_MAX_PAIRS, I8_MAX_PLAN = 288, 32, 48 * 1024
I8_GROUP = 16  # corners a lane loads before its FMAs (kI8Group)


def i8_lane_width(c, src_off, pooled_off, out_bytes):
    """csrc/msda_raw_pool_fwd.cu::i8_vec: the widest lane of 16, 8, 4, 2 or
    1 int8 channels that C and the pointers' byte offsets allow; a lane's
    pooled store needs min(V, 16 / out_bytes) channels' alignment."""
    for v in (16, 8, 4, 2, 1):
        kw = min(v, 16 // out_bytes)
        aligned = pooled_off % (kw * out_bytes) == 0
        if c % v == 0 and src_off % v == 0 and aligned:
            return v
    return 1


def i8_block(c, v, l, p, half=False):
    """csrc/msda_raw_pool_fwd.cu::i8_pick / i8_shape: (pairs a block,
    threads, plan corners a pair (4LP rounded up to whole groups), plan
    stride in ints, shared bytes) of the full block (as many whole pairs as
    fit in 288 threads, at most 32 and as many as the 48 KB plan holds), or
    of the half block that a launch of less than two waves of full blocks
    takes."""
    groups = c // v
    kpad = -(-4 * l * p // I8_GROUP) * I8_GROUP
    stride = kpad + 4
    full = 1 if groups >= I8_MAX_THREADS else min(I8_MAX_THREADS // groups,
                                                  I8_MAX_PAIRS)
    full = min(full, I8_MAX_PLAN // (3 * stride * 4))
    pairs = max(1, full // 2) if half and full > 1 else full
    return (pairs, min(pairs * groups, I8_MAX_THREADS), kpad, stride,
            3 * pairs * stride * 4)


def i8_plan(scales, shapes, loc, aw, ext, kpad):
    """The plan a block writes to shared memory: for every (b, q, m), each
    sample's four corners in (level, point, corner) order, padded to kpad
    with row 0 and weight 0: (table row [N, kpad] int64, pooling weight
    w * scale and w [N, kpad] f32)."""
    b, lq, m, l, p, _ = loc.shape
    starts = msda.level_start_index(shapes)
    n = b * lq * m
    rows = np.zeros((n, kpad), np.int64)
    wpool = np.zeros((n, kpad), np.float32)
    wraw = np.zeros((n, kpad), np.float32)
    for lid, (h, w) in enumerate(shapes):
        x, y = pixels(loc, shapes, lid)
        vh, vw = torch.tensor(float(h)), torch.tensor(float(w))
        if ext is not None:
            vh, vw = ext[:, lid, 0].view(b, 1, 1), ext[:, lid, 1].view(b, 1, 1)
        sc = scales[:, lid].view(b, 1, 1)
        for pt in range(p):
            for corner in range(4):
                inside, cell, bil = corner_rule(corner, h, w, x[..., pt],
                                                y[..., pt], vh, vw)
                wt = torch.where(inside, bil * aw[..., lid, pt], 0.0)
                k = 4 * (lid * p + pt) + corner
                cell = torch.where(inside, cell, 0)
                rows[:, k] = (starts[lid] + cell).reshape(n).numpy()
                wpool[:, k] = (wt * sc).reshape(n).numpy()
                wraw[:, k] = wt.reshape(n).numpy()
    return rows, wpool, wraw


def i8_kernel_model(q8, scales, shapes, loc, aw, ext=None, src_off=0,
                    pooled_off=0, out_bytes=4):
    """msda_raw_pool_fwd_i8's kernel: each (b, q, m)'s C / V lanes read the
    plan's rows as V-byte loads at byte row * C + lane * V of the batch
    element's table (aligned to V), turn each byte into f32 by i8_at, and
    add it times the pooling weight in the plan's order, a group of 16
    corners at a time; lane 0 sums the unscaled weights in the same order.
    Returns (pooled [B, Lq, M, C], wsum [B, Lq, M]) in f32."""
    b, s, c = q8.shape
    lq, m, l, p = loc.shape[1:5]
    v = i8_lane_width(c, src_off, pooled_off, out_bytes)
    _, _, kpad, _, _ = i8_block(c, v, l, p)
    g = I8_GROUP
    rows, wpool, wraw = i8_plan(scales, shapes, loc, aw, ext, kpad)
    n = b * lq * m
    batch = np.repeat(np.arange(b), lq * m)
    table = q8.numpy().view(np.uint8).reshape(b, s * c).astype(np.uint32)
    pooled = np.zeros((n, c), np.float32)
    kw = min(v, 16 // out_bytes)
    for lane in range(c // v):
        offs = rows * c + lane * v  # [N, kpad]: bytes into the batch's table
        assert ((src_off + batch[:, None] * s * c + offs) % v == 0).all()
        dst = (np.arange(n) * c + lane * v) * out_bytes + pooled_off
        assert (dst % (kw * out_bytes) == 0).all()
        acc = np.zeros((n, v), np.float32)
        for k0 in range(0, kpad, g):  # the groups, in order
            for k in range(k0, k0 + g):
                raw = table[batch[:, None], offs[:, k:k + 1] + np.arange(v)]
                raw = np.pad(raw, ((0, 0), (0, -v % 4)))  # V = 1, 2: low bytes
                for j in range(v):
                    shifted = raw[:, 4 * (j // 4):4 * (j // 4) + 4] << \
                        np.uint32([0, 8, 16, 24])
                    word = shifted.sum(1, dtype=np.uint32)
                    val = i8_at_model(word ^ np.uint32(0x80808080), j % 4)
                    acc[:, j] += wpool[:, k] * val
        pooled[:, lane * v:(lane + 1) * v] = acc
    wsum = np.zeros(n, np.float32)
    for k in range(4 * l * p):
        wsum += wraw[:, k]
    return (torch.from_numpy(pooled).view(b, lq, m, c),
            torch.from_numpy(wsum).view(b, lq, m))


I8_CASES = {  # (L, P): (shapes, P); the first two are fixed instances
    "lp42": (((6, 8), (3, 4)) * 2, 2),
    "lp22": (((6, 8), (3, 4)), 2),
    "lp31": (((6, 8), (3, 4), (2, 3)), 1),
}


def test_i8_lanes_and_blocks():
    """The lane and block rules at the served width (C = 288: 18 lanes of
    16 bytes; 16 pairs in 288 threads, or 8 in 144; a 36-int plan stride)
    and where C or the pointers allow no wider lane; every plan stride puts
    the int4 reads of neighbouring pairs on other banks (stride / 4 odd)
    and fits the 48 KB of static shared memory."""
    assert i8_lane_width(288, 0, 0, 2) == i8_lane_width(288, 0, 0, 4) == 16
    assert i8_block(288, 16, 4, 2) == (16, 288, 32, 36, 6912)
    assert i8_block(288, 16, 4, 2, half=True) == (8, 144, 32, 36, 3456)
    assert i8_block(288, 16, 2, 2)[:4] == (16, 288, 16, 20)
    assert i8_block(288, 16, 3, 1)[2:4] == (16, 20)  # 12 corners, padded
    assert i8_block(288, 16, 16, 16)[0] == 3  # 1024 corners: the plan's room
    assert i8_lane_width(288, 4, 0, 2) == 4  # a view 4 bytes off
    assert i8_lane_width(288, 8, 0, 4) == 8
    assert i8_lane_width(24, 0, 0, 2) == 8 and i8_lane_width(12, 0, 0, 4) == 4
    assert i8_lane_width(6, 0, 0, 2) == 2 and i8_lane_width(5, 0, 0, 4) == 1
    assert i8_lane_width(16, 0, 2, 2) == 1  # pooled off its 2-byte grid only
    assert i8_lane_width(16, 0, 8, 2) == 4  # 8 bytes: 4 bf16 channels
    for c in (288, 24, 12, 6, 5, 4096):
        for l, p in ((4, 2), (2, 2), (3, 1), (4, 4)):
            v = i8_lane_width(c, 0, 0, 2)
            for half in (False, True):
                pairs, threads, kpad, stride, smem = i8_block(c, v, l, p, half)
                assert 1 <= pairs <= I8_MAX_PAIRS
                assert threads == min(pairs * (c // v), I8_MAX_THREADS)
                assert kpad >= 4 * l * p and kpad % I8_GROUP == 0
                assert (stride // 4) % 2 == 1 and smem <= I8_MAX_PLAN


@pytest.mark.parametrize("with_extents", [False, True])
@pytest.mark.parametrize("c", [12, 24, 16, 32])  # 4-, 8- and 16-byte lanes
@pytest.mark.parametrize("case", list(I8_CASES))
def test_raw_pool_i8_model_matches_plain_and_jax(case, c, with_extents):
    """K1's plan over an int8 table from quantize_rows (each frame's half
    quantized on its own for the (4, 2) case) against the port's plain
    version with quad_scales (1e-5 / 1e-6) and JAX's
    ms_deform_attn_raw_pool over the same int8 rows (1e-4 / 1e-5)."""
    shapes, p = I8_CASES[case]
    b, lq, m = 2, 5, 4
    l = len(shapes)
    _, src, loc, aw = _inputs(50, shapes, b=b, lq=lq, m=m, p=p, c=c)
    halves = [(0, 2), (2, 4)] if l == 4 else [(0, l)]  # each frame's half
    starts = list(msda.level_start_index(shapes))
    starts.append(sum(h * w for h, w in shapes))
    q8_parts, scales = [], np.zeros((b, l), np.float32)
    for lo, hi in halves:
        jq, js = jax_msda.quantize_rows(jnp.asarray(
            src[:, starts[lo]:starts[hi]].numpy() * 3.0))
        q8_parts.append(np.asarray(jq))
        scales[:, lo:hi] = np.asarray(js)[:, None]
    q8 = torch.from_numpy(np.concatenate(q8_parts, axis=1))
    sc = torch.from_numpy(scales)
    ext = _extents(shapes, b) if with_extents else None
    pooled, wsum = i8_kernel_model(q8, sc, shapes, loc, aw, ext)
    ref_p, ref_w = msda.ms_deform_attn_raw_pool_plain(q8, shapes, loc, aw,
                                                      ext, sc)
    torch.testing.assert_close(pooled, ref_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(wsum, ref_w, rtol=1e-5, atol=1e-6)
    ref_j = jax_msda.ms_deform_attn_raw_pool(
        jnp.asarray(q8.numpy(), jnp.float32), shapes, jnp.asarray(loc.numpy()),
        jnp.asarray(aw.numpy()), jax_msda.build_raw_quad(
            jnp.asarray(q8.numpy()), shapes),
        None if ext is None else jnp.asarray(ext.numpy()), jnp.asarray(scales))
    for got, j in zip((pooled, wsum), ref_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5)


def test_raw_pool_i8_model_views():
    """A table view 4 bytes off its allocation (4-byte lanes) and pooled
    views that allow 8-byte lanes or none, at the served width: the same
    sums as the aligned plan, the loads and stores aligned (asserted in
    the model)."""
    shapes, p = I8_CASES["lp42"]
    _, src, loc, aw = _inputs(51, shapes, b=1, lq=3, m=2, p=p, c=288)
    q8, s = msda.quantize_rows(src * 3.0)
    sc = s.view(1, 1).expand(1, len(shapes)).contiguous()
    ref = i8_kernel_model(q8, sc, shapes, loc, aw)
    for src_off, pooled_off, out_bytes, v in ((4, 0, 2, 4), (8, 0, 4, 8),
                                              (0, 2, 2, 1)):
        assert i8_lane_width(288, src_off, pooled_off, out_bytes) == v
        got = i8_kernel_model(q8, sc, shapes, loc, aw, src_off=src_off,
                              pooled_off=pooled_off, out_bytes=out_bytes)
        for a, r in zip(got, ref):
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
