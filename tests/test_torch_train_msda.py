"""kinet_tpu_torch MSDA gradients: the port's differentiable wrappers (on
the CPU, autograd through the plain versions) against jax.grad through the
JAX package's XLA formulations, on the same numpy-seeded inputs and
cotangents; a float64 gradcheck of the plain versions; and, where a card is
present, the backward kernels against the plain versions' gradients.

Tolerances (float32): dvalue / dsrc and daw rtol 1e-4, atol 1e-5 (only the
summation order differs); dloc rtol 1e-3, atol 1e-4 on interior samples
(every corner inside the map), where both differentiate the same bilinear
weights; at integer pixel coordinates the one-sided derivatives of the two
formulations may legitimately differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu.ops import msda as jax_msda
from kinet_tpu_torch.ops import msda

SHAPES = [
    ((6, 8), (3, 4)),
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
    ext = np.zeros((b, l, 2), np.float32)
    for i, (h, w) in enumerate(shapes):  # a bottom/right pad
        ext[:, i, 0] = rng.integers(max(h - 2, 1), h + 1, size=b)
        ext[:, i, 1] = rng.integers(max(w - 3, 1), w + 1, size=b)
    return value, src, loc, aw, ext


def _interior(loc, shapes):
    """[B, Lq, M, L, P] True where all four corners lie inside the level."""
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    pix = loc * wh[None, None, None, :, None, :] - 0.5
    lo = np.floor(pix)
    top = wh[None, None, None, :, None, :] - 1
    return ((lo >= 0) & (lo + 1 <= top)).all(-1)


def _torch_grads(fn, cot, *inputs):
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot))
    loss.backward()
    return [t.grad.numpy() for t in ts]


def _check(grads, ref, names, interior):
    for g, r, name in zip(grads, ref, names):
        r = np.asarray(r)
        if name == "dloc":
            g, r = g[interior], r[interior]
            np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shapes", SHAPES)
def test_msda_grads_match_jax_quad_unroll(shapes):
    value, _, loc, aw, _ = _inputs(0, shapes)
    b, lq, m = loc.shape[:3]
    cot = np.random.default_rng(1).normal(
        size=(b, lq, m * value.shape[-1])).astype(np.float32)

    def jloss(v, lc, a):
        out = jax_msda.ms_deform_attn_quad_unroll(v, shapes, lc, a)
        return jnp.sum(out * cot)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw))
    grads = _torch_grads(
        lambda v, lc, a: msda.ms_deform_attn(v, shapes, lc, a), [cot],
        value, loc, aw,
    )
    interior = _interior(loc, shapes)
    assert interior.mean() > 0.1
    _check(grads, ref, ("dvalue", "dloc", "daw"), interior)


@pytest.mark.parametrize("shapes", SHAPES)
def test_raw_pool_grads_match_jax(shapes):
    _, src, loc, aw, ext = _inputs(2, shapes)
    b, lq, m = loc.shape[:3]
    rng = np.random.default_rng(3)
    cot_p = rng.normal(size=(b, lq, m, src.shape[-1])).astype(np.float32)
    cot_w = rng.normal(size=(b, lq, m)).astype(np.float32)

    def jloss(s, lc, a):
        pooled, wsum = jax_msda.ms_deform_attn_raw_pool(
            s, shapes, lc, a, None, jnp.asarray(ext))
        return jnp.sum(pooled * cot_p) + jnp.sum(wsum * cot_w)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(src), jnp.asarray(loc), jnp.asarray(aw))
    grads = _torch_grads(
        lambda s, lc, a: msda.ms_deform_attn_raw_pool(
            s, shapes, lc, a, torch.from_numpy(ext)),
        [cot_p, cot_w], src, loc, aw,
    )
    # interior, and not next to the pad edge, where a corner may be cut
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    top = np.minimum(ext[:, None, None, :, None, ::-1], wh[None, None, None, :, None]) - 1
    lo = np.floor(loc * wh[None, None, None, :, None, :] - 0.5)
    inside = ((lo >= 0) & (lo + 1 <= top)).all(-1)
    assert inside.mean() > 0.1
    _check(grads, ref, ("dsrc", "dloc", "daw"), inside)


def test_plain_versions_pass_gradcheck_in_float64():
    shapes = ((4, 5), (2, 3))
    value, src, loc, aw, ext = _inputs(4, shapes, b=1, m=2, d=3, lq=3, p=2, c=4)
    # keep every sample off the integer pixel grid, where the bilinear
    # weights have kinks
    loc = np.clip(loc, 0.05, 0.95)
    v, s, lc, a = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
                   for x in (value, src, loc, aw))
    e = torch.from_numpy(ext)
    assert torch.autograd.gradcheck(
        lambda v_, l_, a_: msda.ms_deform_attn(v_, shapes, l_, a_),
        (v, lc, a), eps=1e-6, atol=1e-6)
    assert torch.autograd.gradcheck(
        lambda s_, l_, a_: msda.ms_deform_attn_raw_pool(s_, shapes, l_, a_, e),
        (s, lc, a), eps=1e-6, atol=1e-6)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _grads_on(dev, fn, cots, *inputs):
    ts = [x.detach().to(dev).requires_grad_(True) for x in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o.float() * c.to(dev)).sum() for o, c in zip(outs, cots)).backward()
    return outs, [t.grad for t in ts]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", SHAPES)
def test_backward_kernels_match_plain_on_gpu(shapes, dtype):
    """The CUDA outputs carry a grad_fn, the backward launches its kernel,
    and the gradients agree with the plain version's (dvalue / dsrc are
    segment sums in f32 whose order follows int atomics: same tolerances
    as against JAX; bf16 dvalue / dsrc are rounded once to bf16 by
    both)."""
    dev = _cuda()
    value, src, loc, aw, ext = (torch.from_numpy(x) for x in _inputs(5, shapes))
    # on a 2^-16 grid every pixel coordinate is exact in f32
    loc = torch.round(loc * 65536.0) / 65536.0
    b, lq, m = loc.shape[:3]
    gen = torch.Generator().manual_seed(6)
    cot = torch.randn(b, lq, m * value.shape[-1], generator=gen)
    value = value.to(dtype)
    before = msda.ms_deform_attn.bwd_launches
    out, g = _grads_on(dev, lambda v, lc, a: msda.ms_deform_attn(v, shapes, lc, a),
                       [cot], value, loc, aw)
    assert out[0].grad_fn is not None
    assert msda.ms_deform_attn.bwd_launches == before + 1
    _, ref = _grads_on(dev, lambda v, lc, a: msda.ms_deform_attn_plain(v, shapes, lc, a),
                       [cot], value, loc, aw)
    tol = dict(rtol=1e-2, atol=1e-5) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(g[0].float(), ref[0].float(), **tol)
    torch.testing.assert_close(g[1], ref[1], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(g[2], ref[2], rtol=1e-4, atol=1e-5)

    e = ext.to(dev)
    cot_p = torch.randn(b, lq, m, src.shape[-1], generator=gen)
    cot_w = torch.randn(b, lq, m, generator=gen)
    src = src.to(dtype)
    before = msda.ms_deform_attn_raw_pool.bwd_launches
    out, g = _grads_on(
        dev, lambda s, lc, a: msda.ms_deform_attn_raw_pool(s, shapes, lc, a, e),
        [cot_p, cot_w], src, loc, aw)
    assert out[0].grad_fn is not None
    assert msda.ms_deform_attn_raw_pool.bwd_launches == before + 1
    _, ref = _grads_on(
        dev, lambda s, lc, a: msda.ms_deform_attn_raw_pool_plain(s, shapes, lc, a, e),
        [cot_p, cot_w], src, loc, aw)
    torch.testing.assert_close(g[0].float(), ref[0].float(), **tol)
    torch.testing.assert_close(g[1], ref[1], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(g[2], ref[2], rtol=1e-4, atol=1e-5)


def _corner_entries_plain(spatial_shapes, sampling_locations,
                          attention_weights, valid_extents=None,
                          per_head=True):
    """Plain version of the backward kernels' record step
    (``count_corner`` in kinet_tpu_torch/ops/csrc/msda_segment.cuh). Entry
    e = ((bqm * L + l) * P + p) * 4 + corner, corner = 2 * dy + dx, for
    every corner of every sample of (b, q, m) = bqm, whose source row is
    e // (L * P * 4). Returns (keys [E] int64, weights [E] float32): the key
    is the gradient row that the corner adds to, (b * S + cell) * M + m
    (``per_head``, dvalue's rows) or b * S + cell (dsrc's rows), and -1 for
    a corner outside the level or in the bottom/right pad; the weight is
    aw * bilinear weight."""
    b, lq, m, l, p, _ = sampling_locations.shape
    s = sum(h * w for h, w in spatial_shapes)
    keys = torch.full((b, lq, m, l, p, 4), -1, dtype=torch.long)
    weights = torch.zeros(b, lq, m, l, p, 4, dtype=torch.float32)
    loc = sampling_locations.detach().float().cpu()
    aw = attention_weights.detach().float().cpu()
    bidx = torch.arange(b).view(b, 1, 1, 1)
    midx = torch.arange(m).view(1, 1, m, 1)
    for lid, ((h, w), start) in enumerate(
        zip(spatial_shapes, msda.level_start_index(spatial_shapes))
    ):
        x = loc[:, :, :, lid, :, 0] * w - 0.5
        y = loc[:, :, :, lid, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        xmax = torch.full_like(x, float(w - 1))
        ymax = torch.full_like(y, float(h - 1))
        if valid_extents is not None:
            ext = valid_extents[:, lid].detach().float().cpu().view(b, 1, 1, 1, 2)
            ymax = torch.minimum(ymax, ext[..., 0] - 1.0)
            xmax = torch.minimum(xmax, ext[..., 1] - 1.0)
        for dy in (0, 1):
            yi = y0 + dy
            wy = fy if dy else 1.0 - fy
            for dx in (0, 1):
                xi = x0 + dx
                wx = fx if dx else 1.0 - fx
                inside = (xi >= 0) & (xi <= xmax) & (yi >= 0) & (yi <= ymax)
                row = bidx * s + start + (
                    yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
                )
                key = row * m + midx if per_head else row
                keys[:, :, :, lid, :, 2 * dy + dx] = torch.where(inside, key, -1)
                weights[:, :, :, lid, :, 2 * dy + dx] = torch.where(
                    inside, wy * wx * aw[:, :, :, lid], 0.0
                )
    return keys.flatten(), weights.flatten()


def _segment_sum_plain(keys, weights, grad_rows, n_keys):
    """Plain version of the backward kernels' scan, place and sum steps
    (csrc/msda_segment.cuh): offsets [n_keys + 1] are the exclusive prefix
    sum of each key's count of entries; each key's segment lists its
    entries in entry order, and its row is the float32 sum, in that order,
    of weight * grad_rows[e // (E / len(grad_rows))] (a key with no entry
    gives exact zeros). Returns (rows [n_keys, width] float32, offsets)."""
    per_row = keys.numel() // grad_rows.shape[0]
    grad = grad_rows.detach().float().cpu()
    entries = torch.nonzero(keys >= 0).flatten()  # in entry order
    k = keys[entries]
    counts = torch.bincount(k, minlength=n_keys)
    offsets = torch.zeros(n_keys + 1, dtype=torch.long)
    offsets[1:] = torch.cumsum(counts, 0)
    slots = entries[torch.sort(k, stable=True).indices]  # grouped by key
    contrib = weights[slots, None] * grad[slots // per_row]
    out = torch.zeros(n_keys, grad.shape[1], dtype=torch.float32)
    for j in range(int(counts.max()) if counts.numel() else 0):
        has = counts > j
        out[has] += contrib[offsets[:-1][has] + j]
    return out, offsets


def _pad_rule_holds(keys, shapes, ext, s):
    """No recorded corner lies in a level's bottom/right pad."""
    rows = keys[keys >= 0]
    b, cell = rows // s, rows % s
    for lid, ((h, w), start) in enumerate(zip(shapes, msda.level_start_index(shapes))):
        at = (cell >= start) & (cell < start + h * w)
        yi, xi = (cell[at] - start) // w, (cell[at] - start) % w
        if ((yi >= ext[b[at], lid, 0]) | (xi >= ext[b[at], lid, 1])).any():
            return False
    return True


@pytest.mark.parametrize("shapes", SHAPES)
def test_segment_plan_matches_plain_autograd(shapes):
    """The backward kernels' plan for dvalue / dsrc (corner entries keyed by
    their gradient row, offsets from the counts, an ordered sum per
    segment), in plain PyTorch, against autograd through the plain
    versions: the key formula, the weights and the in-bounds and pad rules
    of the kernels' record step."""
    value, src, loc, aw, ext = (torch.from_numpy(x) for x in _inputs(7, shapes))
    b, lq, m, l, p = aw.shape
    s, d, c = value.shape[1], value.shape[-1], src.shape[-1]
    gen = torch.Generator().manual_seed(8)

    cot = torch.randn(b, lq, m * d, generator=gen)
    v = value.clone().requires_grad_(True)
    ref = torch.autograd.grad(msda.ms_deform_attn_plain(v, shapes, loc, aw), v, cot)[0]
    keys, w = _corner_entries_plain(shapes, loc, aw)
    assert keys.numel() == b * lq * m * l * p * 4
    rows, offsets = _segment_sum_plain(keys, w, cot.view(b * lq * m, d), b * s * m)
    torch.testing.assert_close(rows.view(b, s, m, d), ref, rtol=1e-4, atol=1e-5)
    counts = offsets.diff()
    assert offsets[0] == 0 and offsets[-1] == int((keys >= 0).sum())
    assert (counts >= 0).all() and (counts == 0).any()
    assert (rows[counts == 0] == 0).all()  # empty segments: exact zeros

    e = ext
    cot_p = torch.randn(b, lq, m, c, generator=gen)
    sr = src.clone().requires_grad_(True)
    pooled, wsum = msda.ms_deform_attn_raw_pool_plain(sr, shapes, loc, aw, e)
    ref = torch.autograd.grad(pooled, sr, cot_p)[0]  # wsum has no dsrc term
    keys, w = _corner_entries_plain(shapes, loc, aw, e, per_head=False)
    rows, offsets = _segment_sum_plain(keys, w, cot_p.view(b * lq * m, c), b * s)
    torch.testing.assert_close(rows.view(b, s, c), ref, rtol=1e-4, atol=1e-5)
    # the entries of each (b, q, m) carry exactly the weights that wsum sums
    torch.testing.assert_close(w.view(b, lq, m, -1).sum(-1), wsum, rtol=1e-5, atol=1e-6)
    assert _pad_rule_holds(keys, shapes, e, s)
    assert int((keys >= 0).sum()) < int(
        (_corner_entries_plain(shapes, loc, aw, per_head=False)[0] >= 0).sum())


def _heavy_loc(loc, shapes, n_heavy):
    """The first n_heavy queries sample every level at one shared point, so
    each of its corner cells collects n_heavy * M * P entries (per head:
    n_heavy * P), more than one staged chunk of the segment sum; the others
    sample only the left part of each level, so the right part's keys have
    no entry."""
    loc = loc.clone()
    loc[..., 0] *= 0.4
    for lid, (h, w) in enumerate(shapes):
        loc[:, :n_heavy, :, lid, :, 0] = (w // 2 + 0.25) / w
        loc[:, :n_heavy, :, lid, :, 1] = (h // 2 + 0.75) / h
    return loc


def _square_sums(keys, weights, grad_rows, n_keys):
    """Per key and channel, the sum over its entries of (weight * grad)^2,
    in float64 ([n_keys, width])."""
    per_row = keys.numel() // grad_rows.shape[0]
    e = torch.nonzero(keys >= 0).flatten()
    terms = weights[e].double()[:, None] * grad_rows.double().cpu()[e // per_row]
    return torch.zeros(n_keys, grad_rows.shape[1], dtype=torch.float64).index_add_(
        0, keys[e], terms * terms)


def _assert_segment_sums(g, ref64, abs_sum, sq_sum, counts, name):
    """g: a table gradient summed in float32 over segments of n = counts
    terms w * g (w = wy * wx * aw, rounded twice; w * g exact inside a fused
    multiply-add), added one by one in an order that follows int atomics;
    ref64: the same gradient in float64. Two bounds on |g - ref64|, each
    element held to the smaller:
    - whatever the order: gamma(n + 2) * sum |w g|, gamma(k) = k u / (1 -
      k u), u = 2^-24;
    - for an order with no structure, as the atomics give: 8 standard
      deviations of the rounding errors taken as independent, the
      partial sums as a random walk to the total T over the terms:
      var = u^2 / 3 * (n * sum (w g)^2 / 6 + n T^2 / 3 + 4 sum (w g)^2).
    An empty segment gives an exact zero."""
    u = 2.0 ** -24
    n = counts.double()
    worst_case = (n + 2) * u / (1.0 - (n + 2) * u) * abs_sum
    var = u * u / 3.0 * (n * sq_sum / 6.0 + n * ref64 * ref64 / 3.0 + 4.0 * sq_sum)
    bound = torch.minimum(worst_case, 8.0 * var.sqrt())
    err = (g.double() - ref64).abs()
    ratio = torch.where(bound > 0, err / bound, torch.where(err > 0, torch.inf, 0.0))
    worst = int(ratio.argmax())
    assert ratio.max() <= 1.0, (
        f"{name}: error {err.reshape(-1)[worst]:.3e} > bound "
        f"{bound.reshape(-1)[worst]:.3e} (n {int(counts.reshape(-1)[worst])}, "
        f"sum |w g| {abs_sum.reshape(-1)[worst]:.4g})")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_heavy_and_empty_segments_on_gpu(dtype):
    """Segments far longer than one staged chunk (every query of a block on
    one cell) and keys with no entry at all: the backward kernels against
    autograd through the plain versions at the tolerances above; the rows
    of empty keys are exact zeros in the output's type; each backward is
    one launch and its outputs carry a grad_fn.

    The f32 table gradients (dvalue, dsrc) are held to float64 autograd of
    the plain versions within the summation bound of
    ``_assert_segment_sums``: at 1,000-4,600 terms a segment, two f32 sums
    in orders that change from run to run (the kernel's int atomics, the
    reference's f32 atomics) differed by more than rtol 1e-4, atol 1e-5
    in about 1 % of runs, each within the bounds."""
    dev = _cuda()
    shapes = SHAPES[0]
    value, src, loc, aw, ext = (torch.from_numpy(x) for x in _inputs(
        9, shapes, lq=512, p=3))
    loc = torch.round(_heavy_loc(loc, shapes, 384) * 65536.0) / 65536.0
    b, lq, m = loc.shape[:3]
    s = value.shape[1]
    gen = torch.Generator().manual_seed(10)
    tol = dict(rtol=1e-2, atol=1e-5) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-5)

    cot = torch.randn(b, lq, m * value.shape[-1], generator=gen)
    before = msda.ms_deform_attn.bwd_launches
    out, g = _grads_on(dev, lambda v, lc, a: msda.ms_deform_attn(v, shapes, lc, a),
                       [cot], value.to(dtype), loc, aw)
    assert out[0].grad_fn is not None
    assert msda.ms_deform_attn.bwd_launches == before + 1
    assert g[0].dtype == dtype
    plain = lambda v, lc, a: msda.ms_deform_attn_plain(v, shapes, lc, a)  # noqa: E731
    _, ref = _grads_on(dev, plain, [cot], value.to(dtype), loc, aw)
    keys, w = _corner_entries_plain(shapes, loc, aw)
    counts = torch.bincount(keys[keys >= 0], minlength=b * s * m)
    assert counts.max() > 1024 // 3 and (counts == 0).any()
    if dtype == torch.float32:
        f64 = (value.double(), loc.double(), aw.double())
        ref64 = _grads_on(dev, plain, [cot], *f64)[1][0]
        abs_sum = _grads_on(dev, plain, [cot.abs()], *f64)[1][0]
        sq_sum = _square_sums(keys, w, cot.view(b * lq * m, -1), b * s * m)
        _assert_segment_sums(g[0], ref64, abs_sum, sq_sum.view_as(ref64).to(dev),
                             counts.to(dev).view(b, s, m, 1).expand_as(ref64),
                             "dvalue")
    else:
        torch.testing.assert_close(g[0].float(), ref[0].float(), **tol)
    torch.testing.assert_close(g[1], ref[1], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(g[2], ref[2], rtol=1e-4, atol=1e-5)
    assert (g[0].reshape(-1, value.shape[-1])[counts.to(dev) == 0] == 0).all()

    e = ext.to(dev)
    cot_p = torch.randn(b, lq, m, src.shape[-1], generator=gen)
    cot_w = torch.randn(b, lq, m, generator=gen)
    before = msda.ms_deform_attn_raw_pool.bwd_launches
    out, g = _grads_on(
        dev, lambda s_, lc, a: msda.ms_deform_attn_raw_pool(s_, shapes, lc, a, e),
        [cot_p, cot_w], src.to(dtype), loc, aw)
    assert out[0].grad_fn is not None
    assert msda.ms_deform_attn_raw_pool.bwd_launches == before + 1
    assert g[0].dtype == dtype
    plain = lambda s_, lc, a: msda.ms_deform_attn_raw_pool_plain(s_, shapes, lc, a, e)  # noqa: E731
    _, ref = _grads_on(dev, plain, [cot_p, cot_w], src.to(dtype), loc, aw)
    keys, w = _corner_entries_plain(shapes, loc, aw, ext, per_head=False)
    counts = torch.bincount(keys[keys >= 0], minlength=b * s)
    assert counts.max() > 1024 and (counts == 0).any()
    if dtype == torch.float32:
        f64 = (src.double(), loc.double(), aw.double())
        ref64 = _grads_on(dev, plain, [cot_p, cot_w], *f64)[1][0]
        # wsum has no dsrc term: its cotangent adds nothing to the sums
        abs_sum = _grads_on(dev, plain, [cot_p.abs(), cot_w], *f64)[1][0]
        sq_sum = _square_sums(keys, w, cot_p.view(b * lq * m, -1), b * s)
        _assert_segment_sums(g[0], ref64, abs_sum, sq_sum.view_as(ref64).to(dev),
                             counts.to(dev).view(b, s, 1).expand_as(ref64), "dsrc")
    else:
        torch.testing.assert_close(g[0].float(), ref[0].float(), **tol)
    torch.testing.assert_close(g[1], ref[1], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(g[2], ref[2], rtol=1e-4, atol=1e-5)
    assert (g[0].reshape(-1, src.shape[-1])[counts.to(dev) == 0] == 0).all()
