"""kinet_tpu_torch's encoder MSDA variants against the JAX package's: the
int8 values (``enc_msda_int8``), top-k sample pruning (``enc_msda_topk``)
and head-shared sampling locations (``enc_msda_shared_locs``).

- each plain version against its JAX formulation on the same numpy-seeded
  inputs, forward and, for top-k and shared locations, ``jax.grad``; with a
  degenerate level ((5, 7), (1, 1)) and with uniform weights, where every
  sample ties and the order of ties decides what top-k keeps;
- ``MSDeformAttn`` with each flag on bridged weights, in train and eval
  mode, against the flax module (deterministic and not);
- the flagship at a tiny width with each flag against the JAX model, and
  the lossy flags' refusal without ``allow_lossy``;
- ``gpu``-marked: each kernel against its plain version (they skip
  without a card; flax is imported only inside the module tests, so the
  file collects where jax is installed without flax).

Tolerance rtol 1e-4, atol 1e-5 in float32 unless stated: the formulations
differ in the order of their sums and in how they round pixel coordinates.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu.ops import msda as jax_msda
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.models.build import build_model
from kinet_tpu_torch.models.deformable_transformer import MSDeformAttn
from kinet_tpu_torch.ops import msda
from kinet_tpu_torch.tools.from_jax import load_jax_params

SHAPES = [
    ((6, 8), (3, 4)),
    ((5, 7), (1, 1)),  # degenerate level
    ((8, 12), (4, 6), (2, 3), (1, 2)),
]
TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, shapes, b=2, m=4, d=8, lq=16, p=3, uniform=False):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    value = rng.normal(size=(b, s, m, d)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, size=(b, lq, m, l, p, 2)).astype(np.float32)
    if uniform:
        aw = np.full((b, lq, m, l, p), 1.0 / (l * p), np.float32)
    else:
        aw = rng.uniform(size=(b, lq, m, l, p)).astype(np.float32)
        aw = aw / aw.sum(axis=(3, 4), keepdims=True)
    return value, loc, aw


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# plain versions vs the JAX formulations


@pytest.mark.parametrize("shapes", SHAPES)
def test_i8_plain_matches_quad_unroll_with_value_scale(shapes):
    value, loc, aw = _inputs(0, shapes)
    rng = np.random.default_rng(1)
    q8 = rng.integers(-127, 128, size=value.shape).astype(np.int8)
    scale = rng.uniform(0.001, 0.05, size=value.shape[:1] + value.shape[2:3])
    scale = scale.astype(np.float32)
    ref = np.asarray(jax_msda.ms_deform_attn_quad_unroll(
        jnp.asarray(q8), shapes, jnp.asarray(loc), jnp.asarray(aw),
        value_scale=jnp.asarray(scale)))
    q, s, lc, a = _t(q8, scale, loc, aw)
    out = msda.ms_deform_attn_i8(q, s, shapes, lc, a).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_i8_is_forward_only():
    value, loc, aw = _inputs(2, SHAPES[0])
    q, lc, a = _t(value.astype(np.int8), loc, aw)
    with pytest.raises(RuntimeError, match="forward only"):
        msda.ms_deform_attn_i8(q, torch.ones(2, 4), SHAPES[0], lc,
                               a.requires_grad_(True))


@pytest.mark.parametrize("uniform", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("shapes", SHAPES)
def test_topk_plain_matches_topk_quad(shapes, uniform):
    value, loc, aw = _inputs(3, shapes, uniform=uniform)
    lp = aw.shape[3] * aw.shape[4]
    for k in sorted({1, 2, lp // 2, lp - 1}):
        ref = np.asarray(jax_msda.ms_deform_attn_topk_quad(
            jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(aw),
            top_k=k))
        out = msda.ms_deform_attn_topk(*_t(value), shapes, *_t(loc, aw), k)
        np.testing.assert_allclose(out.numpy(), ref, **TOL, err_msg=f"k={k}")


def test_topk_mask_keeps_lower_index_on_ties():
    aw = torch.tensor([0.2, 0.3, 0.2, 0.3, 0.2, 0.2]).view(1, 1, 1, 2, 3)
    keep = msda.topk_sample_mask(aw, 4).flatten().tolist()
    # both 0.3s, then the first two of the four tied 0.2s
    assert keep == [True, True, True, True, False, False]
    _, idx = jax.lax.top_k(jnp.asarray(aw.flatten().numpy()), 4)
    assert sorted(np.asarray(idx).tolist()) == [0, 1, 2, 3]


def _grads_jax(fn, value, loc, aw, cot):
    def loss(v, lc, a):
        return jnp.sum(fn(v, lc, a) * cot)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw))]


def _grads_torch(fn, value, loc, aw, cot):
    ins = [t.requires_grad_(True) for t in _t(value, loc, aw)]
    out = fn(*ins)
    return [g.numpy() for g in torch.autograd.grad(out, ins,
                                                   torch.from_numpy(cot))]


@pytest.mark.parametrize("uniform", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("shapes", SHAPES)
def test_topk_plain_gradients_match_jax_grad(shapes, uniform):
    value, loc, aw = _inputs(4, shapes, uniform=uniform)
    b, lq, m, _, _, _ = loc.shape
    cot = np.random.default_rng(5).normal(
        size=(b, lq, m * value.shape[3])).astype(np.float32)
    k = 3
    ref = _grads_jax(lambda v, lc, a: jax_msda.ms_deform_attn_topk_quad(
        v, shapes, lc, a, top_k=k), value, loc, aw, cot)
    got = _grads_torch(lambda v, lc, a: msda.ms_deform_attn_topk(
        v, shapes, lc, a, k), value, loc, aw, cot)
    for name, g, r in zip(("value", "loc", "aw"), got, ref):
        np.testing.assert_allclose(g, r, **TOL, err_msg=name)


@pytest.mark.parametrize("shapes", SHAPES)
def test_shared_plain_matches_patch_shared(shapes):
    value, loc, aw = _inputs(6, shapes)
    shared = np.ascontiguousarray(loc[:, :, 0])
    ref = np.asarray(jax_msda.ms_deform_attn_patch_shared(
        jnp.asarray(value), shapes, jnp.asarray(shared), jnp.asarray(aw)))
    out = msda.ms_deform_attn_shared(*_t(value), shapes, *_t(shared, aw))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("shapes", SHAPES)
def test_shared_plain_gradients_match_jax_grad(shapes):
    value, loc, aw = _inputs(7, shapes)
    shared = np.ascontiguousarray(loc[:, :, 0])
    b, lq, m = aw.shape[:3]
    cot = np.random.default_rng(8).normal(
        size=(b, lq, m * value.shape[3])).astype(np.float32)
    ref = _grads_jax(lambda v, lc, a: jax_msda.ms_deform_attn_patch_shared(
        v, shapes, lc, a), value, shared, aw, cot)
    got = _grads_torch(lambda v, lc, a: msda.ms_deform_attn_shared(
        v, shapes, lc, a), value, shared, aw, cot)
    for name, g, r in zip(("value", "loc", "aw"), got, ref):
        np.testing.assert_allclose(g, r, **TOL, err_msg=name)


# ---------------------------------------------------------------------------
# MSDeformAttn with each flag, on bridged weights


FLAGS = {
    "int8": dict(int8_values=True),
    "topk": dict(top_k=3),
    "topk_all": dict(top_k=12),  # top_k >= L * P: the exact path
    "shared": dict(shared_locs=True),
}


def _module_pair(flags, seed, perturb=True, d_model=16, l=2, m=4, p=3):
    # flax only here: the card's machine has jax but no flax, and runs this
    # file's gpu cases
    from kinet_tpu.models.deformable_transformer import MSDeformAttn as JaxMSDA

    rng = np.random.default_rng(seed)
    b, lq = 2, 10
    shapes = ((6, 8), (3, 4))[:l]
    s = sum(h * w for h, w in shapes)
    query = rng.normal(size=(b, lq, d_model)).astype(np.float32)
    src = rng.normal(size=(b, s, d_model)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, size=(b, lq, l, 2)).astype(np.float32)
    pad = np.zeros((b, s), bool)
    pad[1, 40:48] = True
    jmod = JaxMSDA(d_model, l, m, p, **flags)
    params = jax.device_get(jmod.init(
        jax.random.PRNGKey(seed), jnp.asarray(query), jnp.asarray(ref),
        jnp.asarray(src), shapes, jnp.asarray(pad)))
    if perturb:
        # the zero-initialised offset / weight kernels get entries, so the
        # samples and weights depend on the query
        for name in ("sampling_offsets", "attention_weights"):
            k = params["params"][name]["kernel"]
            params["params"][name]["kernel"] = (
                k + rng.normal(0, 0.1, k.shape)).astype(np.float32)
    tmod = MSDeformAttn(d_model, l, m, p, **flags)
    load_jax_params(tmod, params)
    return jmod, params, tmod, (query, ref, src, shapes, pad)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_msdeformattn_flags_match_jax(flag, mode):
    jmod, params, tmod, (query, ref, src, shapes, pad) = _module_pair(
        FLAGS[flag], seed=10)
    train = mode == "train"
    want = np.asarray(jmod.apply(
        params, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(src),
        shapes, jnp.asarray(pad), deterministic=not train))
    tmod.train(train)
    with torch.no_grad():
        got = tmod(*_t(query, ref, src), shapes, torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("flag", ["topk", "shared"])
def test_msdeformattn_flags_tied_weights_match_jax(flag):
    """As a fresh model: zero offset / weight kernels, so every sample of a
    (query, head) ties, and the tie order picks top-k's samples."""
    jmod, params, tmod, (query, ref, src, shapes, pad) = _module_pair(
        FLAGS[flag], seed=11, perturb=False)
    want = np.asarray(jmod.apply(
        params, jnp.asarray(query), jnp.asarray(ref), jnp.asarray(src),
        shapes, jnp.asarray(pad)))
    with torch.no_grad():
        got = tmod.eval()(*_t(query, ref, src), shapes, torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_shared_locs_offsets_have_one_head():
    tmod = MSDeformAttn(16, 2, 4, 3, shared_locs=True)
    assert tmod.sampling_offsets.out_features == 1 * 2 * 3 * 2
    with pytest.raises(ValueError, match="separate variants"):
        MSDeformAttn(16, 2, 4, 3, shared_locs=True, top_k=2)


# ---------------------------------------------------------------------------
# the flagship at a tiny width with each flag


FLAGSHIP_FLAGS = {
    "int8": dict(enc_msda_int8=True, allow_lossy=True),
    "topk": dict(enc_msda_topk=3, allow_lossy=True),
    "shared": dict(enc_msda_shared_locs=True),
}


@pytest.mark.parametrize("flag", list(FLAGSHIP_FLAGS))
def test_flagship_with_flag_matches_jax(flag):
    from test_torch_port_model import (
        frame_inputs, jax_inputs, port_model, tiny_params, torch_inputs,
    )

    over = FLAGSHIP_FLAGS[flag]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmodel, params = tiny_params(**over)
        model = port_model(params, **over)
    layer = model.transformer.encoder.layer0.self_attn
    assert (layer.shared_locs, layer.top_k, layer.int8_values) == (
        flag == "shared", 3 if flag == "topk" else 0, flag == "int8")
    fwd = jax.jit(jmodel.apply)
    fwd_cached = jax.jit(
        lambda p, b, t, pm, pc: jmodel.apply(p, b, t, prev_memory=pm,
                                             pos_cache=pc))
    j1 = fwd(params, *jax_inputs(*frame_inputs(0)))
    j2 = fwd_cached(params, *jax_inputs(*frame_inputs(1)),
                    j1["frame_memory"], j1["pos_cache"])
    with torch.no_grad():
        t1 = model(*torch_inputs(*frame_inputs(0)))
        t2 = model(*torch_inputs(*frame_inputs(1)),
                   prev_memory=t1["frame_memory"], pos_cache=t1["pos_cache"])
    for frame, (jo, to) in enumerate(((j1, t1), (j2, t2))):
        for key in ("pred_logits", "pred_boxes", "hs_embed"):
            np.testing.assert_allclose(
                to[key].numpy(), np.asarray(jo[key]), atol=1e-4,
                err_msg=f"frame {frame} {key}")


@pytest.mark.parametrize("flag", ["enc_msda_int8", "enc_msda_topk"])
def test_lossy_encoder_flags_need_allow_lossy(flag):
    from test_torch_port_model import FLAGSHIP, TINY

    cfg = load_config("train.yaml", named=FLAGSHIP).replace(
        **TINY, **{flag: 3 if flag == "enc_msda_topk" else True})
    with pytest.raises(ValueError, match="allow_lossy"):
        build_model(cfg, device="cpu")
    with pytest.warns(UserWarning, match="accuracy-unsafe"):
        build_model(cfg.replace(allow_lossy=True), device="cpu")


# ---------------------------------------------------------------------------
# the kernels against their plain versions (on the card)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", SHAPES)
def test_variant_kernels_match_plain_on_gpu(shapes, dtype):
    dev = _cuda()
    for uniform in (False, True):
        value, loc, aw = _inputs(20, shapes, m=8, d=36, lq=301, p=2,
                                 uniform=uniform)
        v, lc, a = (t.to(dev) for t in _t(value, loc, aw))
        v = v.to(dtype)
        lp = aw.shape[3] * aw.shape[4]
        for k in sorted({1, 3, lp - 1} - {0}):
            torch.testing.assert_close(
                msda.ms_deform_attn_topk(v, shapes, lc, a, k),
                msda.ms_deform_attn_topk_plain(v, shapes, lc, a, k), **TOL)
        sl = lc[:, :, 0].contiguous()
        torch.testing.assert_close(
            msda.ms_deform_attn_shared(v, shapes, sl, a),
            msda.ms_deform_attn_shared_plain(v, shapes, sl, a), **TOL)
    q8 = torch.randint(-127, 128, v.shape, device=dev).to(torch.int8)
    scale = torch.rand(v.shape[0], v.shape[2], device=dev) * 0.05
    torch.testing.assert_close(
        msda.ms_deform_attn_i8(q8, scale, shapes, lc, a),
        msda.ms_deform_attn_i8_plain(q8, scale, shapes, lc, a), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["topk", "shared"])
def test_variant_kernel_gradients_match_plain_on_gpu(kind):
    dev = _cuda()
    shapes = SHAPES[2]
    value, loc, aw = _inputs(21, shapes, m=8, d=36, lq=97, p=2)
    if kind == "shared":
        loc = np.ascontiguousarray(loc[:, :, 0])
    cot = torch.randn(2, 97, 8 * 36, device=dev)
    fns = {
        "topk": (lambda *x: msda.ms_deform_attn_topk(x[0], shapes, *x[1:], 3),
                 lambda *x: msda.ms_deform_attn_topk_plain(x[0], shapes,
                                                           *x[1:], 3)),
        "shared": (lambda *x: msda.ms_deform_attn_shared(x[0], shapes, *x[1:]),
                   lambda *x: msda.ms_deform_attn_shared_plain(x[0], shapes,
                                                               *x[1:])),
    }[kind]
    grads = []
    before = msda.ms_deform_attn.bwd_launches
    for fn in fns:
        ins = [t.to(dev).requires_grad_(True) for t in _t(value, loc, aw)]
        grads.append(torch.autograd.grad(fn(*ins), ins, cot))
    # the kernel's backward is one msda_bwd launch
    assert msda.ms_deform_attn.bwd_launches == before + 1
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, rtol=1e-3,
                                   atol=1e-5 * r.abs().max().item() + 1e-5)


# every instance the forward launchers of csrc/msda_fwd.cu can pick for
# msda_fwd, msda_fwd_i8, msda_shared_fwd and msda_topk_fwd: (D, shapes, P,
# the value's offset in bytes from an aligned buffer, loc / aw offset by one
# float)
INSTANCES = {
    "d36_wide": (36, SHAPES[0], 2, 0, False),  # 12-channel lanes, (2, 2)
    "d36_wide_1level": (36, ((7, 9),), 2, 0, False),  # (1, 2)
    "d12": (12, SHAPES[1], 2, 0, False),  # one 12-channel lane a head
    "d32": (32, SHAPES[0], 2, 0, False),  # D % 12 != 0: 4-channel lanes
    "d6": (6, SHAPES[0], 2, 0, False),  # 2-channel lanes
    "d5": (5, SHAPES[0], 2, 0, False),  # 1-channel lanes
    "sliced_1": (36, SHAPES[0], 2, 1, False),  # a view 1 byte off
    "sliced_4": (36, SHAPES[0], 2, 4, False),  # a view 4 bytes off
    "sliced_samples": (36, SHAPES[0], 2, 0, True),  # loc / aw not 16-aligned
    "lp44": (36, SHAPES[2], 4, 0, False),  # generic (L, P) = (4, 4)
}


def _view_at(t, offset_bytes):
    """t's values in a contiguous view that starts offset_bytes (a multiple
    of its element size, or one element) past an aligned allocation."""
    if offset_bytes == 0:
        return t
    n = max(1, offset_bytes // t.element_size())
    buf = torch.empty(t.numel() + n, dtype=t.dtype, device=t.device)
    view = buf[n:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(INSTANCES))
def test_forward_instances_match_plain_on_gpu(case, dtype):
    """msda_fwd, msda_fwd_i8 (dtype is the scale's, which the model rounds
    to the value's type), msda_shared_fwd and msda_topk_fwd (k = 1,
    L * P / 2, L * P - 1 and L * P, random and tied weights) against their plain
    versions on locations on the 2^-16 grid, where they differ only in the
    order of their sums."""
    dev = _cuda()
    d, shapes, p, off, sliced_samples = INSTANCES[case]
    value, loc, aw = _inputs(22, shapes, m=8, d=d, lq=211, p=p)
    loc = np.round(loc * 65536.0) / 65536.0
    v, lc, a = (t.to(dev) for t in _t(value, loc, aw))
    sl = lc[:, :, 0].contiguous()
    if sliced_samples:
        lc, sl, a = (_view_at(t, 4) for t in (lc, sl, a))
    v = _view_at(v.to(dtype), off)
    torch.testing.assert_close(msda.ms_deform_attn(v, shapes, lc, a),
                               msda.ms_deform_attn_plain(v, shapes, lc, a),
                               **TOL)
    torch.testing.assert_close(msda.ms_deform_attn_shared(v, shapes, sl, a),
                               msda.ms_deform_attn_shared_plain(v, shapes, sl,
                                                                a), **TOL)
    lp = len(shapes) * p
    tied = _view_at(torch.full_like(a, 1.0 / lp), 4 if sliced_samples else 0)
    for w in (a, tied):
        for k in sorted({1, lp // 2, lp - 1, lp}):
            torch.testing.assert_close(
                msda.ms_deform_attn_topk(v, shapes, lc, w, k),
                msda.ms_deform_attn_topk_plain(v, shapes, lc, w, k), **TOL)
    gen = torch.Generator(device=dev).manual_seed(23)
    q8 = _view_at(torch.randint(-127, 128, v.shape, generator=gen, device=dev,
                                dtype=torch.int8), off)
    scale = (torch.rand(v.shape[0], v.shape[2], generator=gen, device=dev)
             * 0.05).to(dtype)
    with torch.no_grad():
        torch.testing.assert_close(
            msda.ms_deform_attn_i8(q8, scale, shapes, lc, a),
            msda.ms_deform_attn_i8_plain(q8, scale, shapes, lc, a), **TOL)
