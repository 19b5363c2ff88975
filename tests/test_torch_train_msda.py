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
    and the gradients agree with the plain version's (dvalue / dsrc
    accumulate with f32 atomics, whose order varies: same tolerances as
    against JAX; bf16 dvalue / dsrc are rounded once to bf16 by both)."""
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
