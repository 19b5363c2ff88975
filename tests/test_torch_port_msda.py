"""kinet_tpu_torch MSDA parity: the port's plain versions against the JAX
package's formulations on the same numpy-seeded inputs, and the CUDA
kernels against the plain versions where a card is present.

- ms_deform_attn (plain, per-level grid_sample) vs the XLA
  ms_deform_attn_quad_unroll and vs the Pallas ms_deform_attn_hybrid run in
  interpret mode, as tests/test_msda.py runs it;
- ms_deform_attn_raw_pool (plain, explicit 4-corner gather) vs the XLA
  ms_deform_attn_raw_pool, with and without valid_extents.

Tolerance rtol 1e-4, atol 1e-5 in float32: only the summation order and the
rounding of the pixel coordinates differ.
"""
from unittest import mock

import jax.experimental.pallas as pl_mod
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu.ops import msda as jax_msda
from kinet_tpu.ops import pallas_msda
from kinet_tpu_torch.ops import msda

SHAPES = [
    ((6, 8), (3, 4)),
    ((5, 7), (1, 1)),  # degenerate level
    ((8, 12), (4, 6), (2, 3), (1, 2)),
]


def _inputs(seed, shapes, b=2, m=4, d=8, lq=16, p=3, c=12):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    src = rng.normal(size=(b, s, c)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, size=(b, lq, m, l, p, 2)).astype(np.float32)
    aw = rng.uniform(size=(b, lq, m, l, p)).astype(np.float32)
    aw = aw / aw.sum(axis=(3, 4), keepdims=True)
    return value, src, loc, aw


def _extents(shapes, b, seed):
    """Per-level (rows, columns) valid extents of a bottom/right pad."""
    rng = np.random.default_rng(seed)
    ext = np.zeros((b, len(shapes), 2), np.float32)
    for i, (h, w) in enumerate(shapes):
        ext[:, i, 0] = rng.integers(1, h + 1, size=b)
        ext[:, i, 1] = rng.integers(1, w + 1, size=b)
    return ext


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shapes", SHAPES)
def test_msda_plain_matches_xla_quad_unroll(shapes):
    value, _, loc, aw = _inputs(0, shapes)
    ref = np.asarray(jax_msda.ms_deform_attn_quad_unroll(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw)
    ))
    out = msda.ms_deform_attn(_t(value)[0], shapes, *_t(loc, aw)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shapes", SHAPES)
def test_msda_plain_matches_pallas_hybrid_interpret(shapes):
    value, _, loc, aw = _inputs(1, shapes, lq=16, p=4)
    orig = pl_mod.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with mock.patch("kinet_tpu.ops.pallas_msda.pl.pallas_call", interp):
        # matmul_max_cells=1000: every level here goes through the kernel
        ref = np.asarray(pallas_msda.ms_deform_attn_hybrid(
            jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw), 1000
        ))
    out = msda.ms_deform_attn(_t(value)[0], shapes, *_t(loc, aw)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_extents", [False, True])
@pytest.mark.parametrize("shapes", SHAPES)
def test_raw_pool_plain_matches_xla(shapes, with_extents):
    _, src, loc, aw = _inputs(2, shapes)
    ext = _extents(shapes, src.shape[0], 3) if with_extents else None
    ref_pooled, ref_wsum = jax_msda.ms_deform_attn_raw_pool(
        jnp.asarray(src), shapes, jnp.asarray(loc), jnp.asarray(aw), None,
        None if ext is None else jnp.asarray(ext),
    )
    pooled, wsum = msda.ms_deform_attn_raw_pool(
        *_t(src), shapes, *_t(loc, aw), None if ext is None else _t(ext)[0]
    )
    assert pooled.dtype == torch.float32 and wsum.dtype == torch.float32
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(ref_wsum),
                               rtol=1e-4, atol=1e-5)


def test_raw_pool_extents_zero_pad_corners():
    """A corner in the pad region weighs nothing: with the full-level
    extents the result is the unrestricted one, and with a 1x1 extent only
    cell (0, 0) of each level can contribute."""
    shapes = SHAPES[0]
    _, src, loc, aw = _inputs(4, shapes)
    full = np.array([[list(s) for s in shapes]] * 2, np.float32)
    a = msda.ms_deform_attn_raw_pool(*_t(src), shapes, *_t(loc, aw))
    b = msda.ms_deform_attn_raw_pool(*_t(src), shapes, *_t(loc, aw),
                                     torch.from_numpy(full))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    one = np.ones_like(full)
    src_00 = np.zeros_like(src)
    for start in msda.level_start_index(shapes):
        src_00[:, start] = src[:, start]
    c = msda.ms_deform_attn_raw_pool(*_t(src), shapes, *_t(loc, aw),
                                     torch.from_numpy(one))
    d = msda.ms_deform_attn_raw_pool(*_t(src_00), shapes, *_t(loc, aw),
                                     torch.from_numpy(one))
    np.testing.assert_allclose(c[0].numpy(), d[0].numpy(), atol=1e-6)


def test_wrappers_count_no_launch_on_cpu():
    value, src, loc, aw = _inputs(5, SHAPES[0])
    before = (msda.ms_deform_attn.launches, msda.ms_deform_attn_raw_pool.launches)
    msda.ms_deform_attn(*_t(value), SHAPES[0], *_t(loc, aw))
    msda.ms_deform_attn_raw_pool(*_t(src), SHAPES[0], *_t(loc, aw))
    after = (msda.ms_deform_attn.launches, msda.ms_deform_attn_raw_pool.launches)
    assert after == before


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", SHAPES)
def test_kernels_match_plain_on_gpu(shapes, dtype):
    dev = _cuda()
    value, src, loc, aw = _inputs(6, shapes)
    ext = _extents(shapes, src.shape[0], 7)
    v, s, lc, a, e = (t.to(dev) for t in _t(value, src, loc, aw, ext))
    v, s = v.to(dtype), s.to(dtype)
    out = msda.ms_deform_attn(v, shapes, lc, a)
    ref = msda.ms_deform_attn_plain(v, shapes, lc, a)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    pooled, wsum = msda.ms_deform_attn_raw_pool(s, shapes, lc, a, e)
    ref_p, ref_w = msda.ms_deform_attn_raw_pool_plain(s, shapes, lc, a, e)
    # bf16 pooled rows are rounded once to bf16 by both: one bf16 ulp apart
    # at most (2^-7 relative)
    tol = dict(rtol=1e-2, atol=1e-5) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pooled.float(), ref_p.float(), **tol)
    torch.testing.assert_close(wsum, ref_w, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the forward kernels' own cases: query runs, compiled (L, P) instances and
# the generic one, 16-byte and narrower channel groups, heads that share
# every cell, empty queries


def _grid(a):
    """Locations on a 2^-16 grid: every pixel coordinate is exact in f32,
    so kernel and plain version differ only in the order of their sums."""
    return (np.round(a * 65536.0) / 65536.0).astype(np.float32)


def _case(name, seed, lq=37, d=36):
    """(shapes, value, src, loc, aw, ext) of one named case, B = 2."""
    rng = np.random.default_rng(seed)
    b, m, c = 2, 8, 12
    shapes, p = ((9, 13), (5, 7)), 2
    if name == "generic_lp":  # (L, P) = (3, 3): the generic instance
        shapes, p = ((9, 13), (5, 7), (3, 4)), 3
    elif name == "one_level":  # (L, P) = (1, 2): the low-lite instance
        shapes = ((11, 17),)
    elif name == "wide_rows":  # C * esize a multiple of 16 in bf16 too
        c = 64
    elif name == "four_points":  # (L, P) = (2, 4): the generic instance
        p, c = 4, 64
    l = len(shapes)
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    src = rng.normal(size=(b, s, c)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, size=(b, lq, m, l, p, 2))
    if name == "merged":  # every head of a query on the same point
        loc[:] = loc[:, :, :1]
    if name == "empty":  # query 0 outside every level, query 1 in the pad
        loc[:, 0] = rng.uniform(1.2, 2.0, size=loc[:, 0].shape)
        loc[:, 1] = rng.uniform(0.9, 0.99, size=loc[:, 1].shape)
    aw = rng.uniform(size=(b, lq, m, l, p)).astype(np.float32)
    aw = aw / aw.sum(axis=(3, 4), keepdims=True)
    ext = np.zeros((b, l, 2), np.float32)
    for i, (h, w) in enumerate(shapes):
        ext[:, i] = (max(1, h - 2), max(1, w - 3))
    return shapes, value, src, _grid(loc), aw, ext


FWD_CASES = ["runs", "generic_lp", "one_level", "wide_rows", "four_points",
             "merged", "empty"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FWD_CASES)
def test_forward_kernels_cases_on_gpu(case, dtype):
    dev = _cuda()
    shapes, value, src, loc, aw, ext = _case(case, FWD_CASES.index(case))
    v, s, lc, a, e = (t.to(dev) for t in _t(value, src, loc, aw, ext))
    v, s = v.to(dtype), s.to(dtype)
    out = msda.ms_deform_attn(v, shapes, lc, a)
    ref = msda.ms_deform_attn_plain(v, shapes, lc, a)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    tol = dict(rtol=1e-2, atol=1e-5) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-5)
    for ext_t in (None, e):
        ref_p, ref_w = msda.ms_deform_attn_raw_pool_plain(s, shapes, lc, a,
                                                          ext_t)
        pooled, wsum = msda.ms_deform_attn_raw_pool(s, shapes, lc, a, ext_t)
        torch.testing.assert_close(pooled.float(), ref_p.float(), **tol)
        torch.testing.assert_close(wsum, ref_w, rtol=1e-4, atol=1e-5)
    if case == "empty":
        # nothing of query 0 is read: exact zeros
        assert not out[:, 0].any() and not wsum[:, 0].any()
        assert not pooled[:, 0].float().any()
        # query 1 samples only the pad: nothing is read with the extents
        assert not wsum[:, 1].any() and not pooled[:, 1].float().any()


@pytest.mark.gpu
def test_forward_kernel_runs_match_plain_on_gpu():
    """Enough queries that each block walks a run of several, the last
    run shorter than the others (B * Lq = 2 * 4999, 4999 prime: only runs
    of 1, 2 or 4999 queries would divide it evenly), for both
    compiled (L, P) instances, in f32 (16-byte lanes), in bf16 with D = 36
    (12-channel lanes) and with D = 32 (8-byte lanes)."""
    dev = _cuda()
    for case in ("runs", "one_level"):  # (L, P) = (2, 2) and (1, 2)
        for d in (36, 32):
            shapes, value, _, loc, aw, _ = _case(case, 11, lq=4999, d=d)
            v, lc, a = (t.to(dev) for t in _t(value, loc, aw))
            for dtype in (torch.float32, torch.bfloat16):
                vd = v.to(dtype)
                torch.testing.assert_close(
                    msda.ms_deform_attn(vd, shapes, lc, a),
                    msda.ms_deform_attn_plain(vd, shapes, lc, a),
                    rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_forward_kernels_count_launches_on_gpu():
    dev = _cuda()
    shapes, value, src, loc, aw, ext = _case("runs", 12)
    v, s, lc, a, e = (t.to(dev) for t in _t(value, src, loc, aw, ext))
    before = (msda.ms_deform_attn.launches, msda.ms_deform_attn_raw_pool.launches)
    msda.ms_deform_attn(v.bfloat16(), shapes, lc, a)
    msda.ms_deform_attn_raw_pool(s.bfloat16(), shapes, lc, a, e)
    msda.ms_deform_attn_raw_pool(s, shapes, lc, a)
    after = (msda.ms_deform_attn.launches, msda.ms_deform_attn_raw_pool.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 2)
