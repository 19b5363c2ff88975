"""kinet_tpu_torch's int8 decoder table (``dec_msda_int8``) against the JAX
package on the CPU:

- ``quantize_rows`` against JAX's, bit for bit, ties at .5 included;
- the raw pool over an int8 table with per-level ``quad_scales`` (plain
  version, through the wrapper) against JAX's ``ms_deform_attn_raw_pool``
  over ``build_raw_quad`` of the same int8 rows (float32; rtol 1e-4, atol
  1e-5: only the order of the sums and the rounding of pixel coordinates
  differ);
- the whole model over two chained frames with the flag, in eval mode,
  against JAX (atol 1e-4, the float model's tolerance), where the
  previous frame's half, quantized again from the cached memory, must be
  the table and scale that JAX cached when that frame was current;
- the flag does nothing in training mode;
- ``gpu``-marked cases (skipped without a card): the int8 kernel against
  its plain version.

The model tests import the flax-based JAX model inside the test, so that
the kernel cases also collect where flax is not installed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu.ops import msda as jax_msda
from kinet_tpu_torch.models import deformable_transformer as dt
from kinet_tpu_torch.ops import msda

INT8 = dict(dec_msda_int8=True, allow_lossy=True)
SHAPES = [
    ((6, 8), (3, 4)),
    ((6, 8), (3, 4)) * 2,  # the decoder's (current, previous) x 2 levels
    ((8, 12), (4, 6), (2, 3), (1, 2)),
]


def _ties(b=2, s=10, c=12):
    """Rows whose absmax is 127, so the scale is exactly 1 and the values
    k + 0.5 are ties that round half to even (and -127 .. 127 exactly)."""
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 127, size=(b, s, c)).astype(np.float32) + 0.5
    x[:, 0, 0] = 127.0
    x[:, 1, :4] = [0.5, -0.5, 1.5, -2.5]
    return x


@pytest.mark.parametrize("case", ["ties", "normal", "bf16", "zeros", "tiny"])
def test_quantize_rows_matches_jax_bit_for_bit(case):
    rng = np.random.default_rng(1)
    x = {
        "ties": _ties(),
        "normal": rng.normal(size=(3, 40, 12)).astype(np.float32) * 3.0,
        "bf16": rng.normal(size=(2, 40, 12)).astype(np.float32),
        "zeros": np.zeros((2, 5, 4), np.float32),
        "tiny": rng.normal(size=(2, 5, 4)).astype(np.float32) * 1e-12,
    }[case]
    if case == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = jax_msda.quantize_rows(jx)
    tq, ts = msda.quantize_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "ties":  # half to even, as jnp.round
        assert tq[0, 1, :4].tolist() == [0, 0, 2, -2]


def _pool_inputs(seed, shapes, b, lq=16, m=4, p=2, c=12):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    q8 = rng.integers(-127, 128, size=(b, s, c)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, size=(b, l)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, size=(b, lq, m, l, p, 2)).astype(np.float32)
    aw = rng.uniform(size=(b, lq, m, l, p)).astype(np.float32)
    aw = aw / aw.sum(axis=(3, 4), keepdims=True)
    ext = np.zeros((b, l, 2), np.float32)
    for i, (h, w) in enumerate(shapes):
        ext[:, i, 0] = rng.integers(1, h + 1, size=b)
        ext[:, i, 1] = rng.integers(1, w + 1, size=b)
    return q8, scales, loc, aw, ext


@pytest.mark.parametrize("b", [1, 2])  # JAX's B = 1 and batched branches
@pytest.mark.parametrize("shapes", SHAPES)
def test_int8_raw_pool_plain_matches_jax(shapes, b):
    q8, scales, loc, aw, ext = _pool_inputs(2, shapes, b)
    ref_pooled, ref_wsum = jax_msda.ms_deform_attn_raw_pool(
        jnp.asarray(q8, jnp.float32), shapes, jnp.asarray(loc),
        jnp.asarray(aw), jax_msda.build_raw_quad(jnp.asarray(q8), shapes),
        jnp.asarray(ext), jnp.asarray(scales),
    )
    args = [torch.from_numpy(a) for a in (q8, loc, aw, ext, scales)]
    plain = msda.ms_deform_attn_raw_pool_plain(args[0], shapes, *args[1:])
    wrapped = msda.ms_deform_attn_raw_pool(args[0], shapes, *args[1:])
    for pooled, wsum in (plain, wrapped):
        assert pooled.dtype == torch.float32 and wsum.dtype == torch.float32
        np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_pooled),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(wsum.numpy(), np.asarray(ref_wsum),
                                   rtol=1e-4, atol=1e-5)
    # the scales weigh the pooled rows only: unscaled, wsum is unchanged
    # and pooled is the float pool of the int8 rows without scales
    ones = torch.ones_like(args[4])
    p1, w1 = msda.ms_deform_attn_raw_pool_plain(args[0], shapes, *args[1:4], ones)
    pf, wf = msda.ms_deform_attn_raw_pool_plain(args[0].float(), shapes, *args[1:4])
    torch.testing.assert_close(w1, plain[1], rtol=0, atol=0)
    torch.testing.assert_close(p1, pf, rtol=0, atol=0)
    torch.testing.assert_close(wf, w1, rtol=0, atol=0)


def test_int8_raw_pool_is_forward_only():
    shapes = SHAPES[0]
    q8, scales, loc, aw, ext = (torch.from_numpy(a) for a in
                                _pool_inputs(3, shapes, 1))
    with pytest.raises(RuntimeError, match="forward only"):
        msda.ms_deform_attn_raw_pool(q8, shapes, loc.requires_grad_(True), aw,
                                     ext, scales)
    with torch.no_grad():
        pooled, _ = msda.ms_deform_attn_raw_pool(
            q8, shapes, loc, aw, ext, scales, torch.bfloat16)
    assert pooled.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="int8"):
        msda.ms_deform_attn_raw_pool(q8.float(), shapes, loc.detach(), aw, ext,
                                     scales)


def _record_tables(monkeypatch):
    """Every (int8 rows, scale) that the port's decoder quantizes."""
    made = []
    orig = dt.quantize_rows

    def recording(x):
        out = orig(x)
        made.append((x.clone(), out[0].clone(), out[1].clone()))
        return out

    monkeypatch.setattr(dt, "quantize_rows", recording)
    return made


def _round_margin(x, scale):
    """The least distance of x / scale from a rounding boundary (k + 0.5)
    over the values that are not clipped."""
    y = (x.float() / scale[:, None, None]).abs()
    y = y[y < 126.5]
    return float((y - torch.floor(y) - 0.5).abs().min())


def test_model_int8_two_frames_matches_jax(monkeypatch):
    """Frame 1 quantizes the current half (the previous half is the same
    frame); frame 2 quantizes its own half and, again, frame 1's cached
    memory: that must be frame 1's table and scale bit for bit, in the port
    and in JAX's cache. No value to be rounded lies nearer a rounding
    boundary than the port and JAX memories differ, so the two int8 tables
    are equal and the outputs differ only as the float models do."""
    from test_torch_port_model import (frame_inputs, jax_inputs, port_model,
                                       tiny_params, torch_inputs)

    jmodel, params = tiny_params(seed=5, **INT8)
    model = port_model(params, **INT8)
    model.eval()
    made = _record_tables(monkeypatch)
    fwd = jax.jit(jmodel.apply)
    fwd_cached = jax.jit(
        lambda p, b, t, pm, pc: jmodel.apply(p, b, t, prev_memory=pm, pos_cache=pc)
    )
    j1 = fwd(params, *jax_inputs(*frame_inputs(0)))
    j2 = fwd_cached(params, *jax_inputs(*frame_inputs(1)),
                    j1["frame_memory"], j1["pos_cache"])
    with torch.no_grad():
        t1 = model(*torch_inputs(*frame_inputs(0)))
        t2 = model(*torch_inputs(*frame_inputs(1)),
                   prev_memory=t1["frame_memory"], pos_cache=t1["pos_cache"])
    # frame 1: current and previous halves; frame 2: current and previous
    assert len(made) == 4
    (x1, q1, s1), (_, q1p, s1p), (x2, q2, s2), (x2p, q2p, s2p) = made
    assert torch.equal(q1p, q1) and torch.equal(s1p, s1)
    assert torch.equal(q2p, q1) and torch.equal(s2p, s1)  # = frame 1's cache
    assert torch.equal(x2p, x1)

    c = q1.shape[-1]
    for (jtbl, jscale), q, s in ((j1["frame_memory"][2], q1, s1),
                                 (j2["frame_memory"][2], q2, s2)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jtbl)[..., :c])
        np.testing.assert_allclose(s.numpy(), np.asarray(jscale), rtol=1e-6)
    for x, s, jmem in ((x1, s1, j1), (x2, s2, j2)):
        jx = np.asarray(jmem["memory"])[:, :x.shape[1]]
        jx = np.where(x.numpy() == 0.0, 0.0, jx)  # the pad rows, zeroed
        diff = float(np.abs(jx / s.numpy()[:, None, None]
                            - x.numpy() / s.numpy()[:, None, None]).max())
        assert diff < _round_margin(x, s), "a rounding decides the table"

    for frame, (jo, to) in enumerate(((j1, t1), (j2, t2))):
        for key in ("pred_logits", "pred_boxes", "hs_embed"):
            np.testing.assert_allclose(
                to[key].numpy(), np.asarray(jo[key]), atol=1e-4,
                err_msg=f"frame {frame} {key}",
            )


def test_int8_flag_is_a_no_op_in_training_mode(monkeypatch):
    from test_torch_port_model import (frame_inputs, port_model, tiny_params,
                                       torch_inputs)

    _, params = tiny_params(seed=4)
    plain, flagged = port_model(params), port_model(params, **INT8)
    made = _record_tables(monkeypatch)
    outs = []
    for model in (plain, flagged):
        model.train()
        torch.manual_seed(0)
        o1 = model(*torch_inputs(*frame_inputs(0)))
        o2 = model(*torch_inputs(*frame_inputs(1)),
                   prev_memory=o1["frame_memory"], pos_cache=o1["pos_cache"])
        outs.append([o[k].detach() for o in (o1, o2)
                     for k in ("pred_logits", "pred_boxes", "hs_embed")])
    assert not made
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _grid(a):
    """Locations on a 2^-16 grid: every pixel coordinate is exact in f32,
    so kernel and plain version differ only in the order of their sums."""
    return np.round(a * 65536.0) / 65536.0


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
# 16-, 4- and 2-channel lanes, then 8-channel lanes (C not a multiple of 16)
@pytest.mark.parametrize("c", [288, 12, 6, 24, 40])
@pytest.mark.parametrize("shapes,p", [(SHAPES[1], 2), (SHAPES[0], 2),
                                      (SHAPES[2], 3)])
def test_int8_kernel_matches_plain_on_gpu(shapes, p, c, out_dtype):
    """K1 (msda_raw_pool_fwd_i8's kernel) against its plain version: the
    compiled (L, P) = (4, 2) and (2, 2) instances and the generic one,
    16-, 8-, 4- and 2-channel lanes; pooled in f32 and bf16 (rounded once
    to bf16 by both: one bf16 ulp apart at most), wsum f32; one launch a
    call, counted."""
    dev = _cuda()
    q8, scales, loc, aw, ext = _pool_inputs(11, shapes, 2, lq=300, m=8, p=p, c=c)
    q8, scales, loc, aw, ext = (torch.from_numpy(a).to(dev) for a in
                                (q8, scales, _grid(loc), aw, ext))
    before = msda.ms_deform_attn_raw_pool.i8_launches
    with torch.inference_mode():
        pooled, wsum = msda.ms_deform_attn_raw_pool(q8, shapes, loc, aw, ext,
                                                    scales, out_dtype)
        ref_p, ref_w = msda.ms_deform_attn_raw_pool_plain(
            q8, shapes, loc, aw, ext, scales, out_dtype)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn_raw_pool.i8_launches == before + 1
    assert pooled.dtype == out_dtype and wsum.dtype == torch.float32
    tol = dict(rtol=1e-2, atol=1e-5) if out_dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(pooled.float(), ref_p.float(), **tol)
    torch.testing.assert_close(wsum, ref_w, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_int8_kernel_raises_under_autograd_on_gpu():
    dev = _cuda()
    shapes = SHAPES[0]
    q8, scales, loc, aw, ext = (torch.from_numpy(a).to(dev) for a in
                                _pool_inputs(12, shapes, 1))
    before = msda.ms_deform_attn_raw_pool.i8_launches
    with pytest.raises(RuntimeError, match="forward only"):
        msda.ms_deform_attn_raw_pool(q8, shapes, loc, aw.requires_grad_(True),
                                     ext, scales)
    assert msda.ms_deform_attn_raw_pool.i8_launches == before


def _launch_i8(q8, scales, shapes, loc, aw, ext, pooled, wsum):
    """The C entry msda_raw_pool_fwd_i8 into the given outputs (views
    included), as the wrapper launches it."""
    b, s, c = q8.shape
    _, lq, m, l, p, _ = loc.shape
    shapes_t, starts_t = msda._level_tables(shapes, q8.device)
    msda._launch(
        "msda_raw_pool_fwd_i8", [msda._P, msda._P, msda._I] + [msda._P] * 7
        + [msda._I] * 7 + [msda._P], q8.device, q8.data_ptr(),
        scales.data_ptr(), msda._DTYPE_CODE[pooled.dtype], shapes_t.data_ptr(),
        starts_t.data_ptr(), loc.data_ptr(), aw.data_ptr(), ext.data_ptr(),
        pooled.data_ptr(), wsum.data_ptr(), b, s, c, lq, m, l, p,
        lib="msda_raw_pool_fwd")


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("src_off,pooled_off", [(4, 0), (8, 0), (0, 1)])
def test_int8_kernel_views_on_gpu(src_off, pooled_off, out_dtype):
    """K1 at the served width C = 288 on a table view 4 or 8 bytes off its
    allocation (4- and 8-channel lanes) and into a pooled view one element
    off (1-channel lanes), against the plain version; the view of the table
    also through the wrapper."""
    dev = _cuda()
    shapes = SHAPES[1]
    q8, scales, loc, aw, ext = _pool_inputs(13, shapes, 1, lq=300, m=8, p=2,
                                            c=288)
    q8, scales, loc, aw, ext = (torch.from_numpy(a).to(dev) for a in
                                (q8, scales, _grid(loc), aw, ext))
    buf = torch.empty(q8.numel() + src_off, dtype=torch.int8, device=dev)
    view = buf[src_off:].view(q8.shape)
    view.copy_(q8)
    assert view.data_ptr() % 16 == src_off
    out = torch.empty(300 * 8 * 288 + pooled_off, dtype=out_dtype, device=dev)
    pooled = out[pooled_off:].view(1, 300, 8, 288)
    wsum = torch.empty(1, 300, 8, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        _launch_i8(view, scales, shapes, loc, aw, ext, pooled, wsum)
        wrapped, wrapped_w = msda.ms_deform_attn_raw_pool(
            view, shapes, loc, aw, ext, scales, out_dtype)
        ref_p, ref_w = msda.ms_deform_attn_raw_pool_plain(
            q8, shapes, loc, aw, ext, scales, out_dtype)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-2, atol=1e-5) if out_dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-5)
    for got, got_w in ((pooled, wsum), (wrapped, wrapped_w)):
        torch.testing.assert_close(got.float(), ref_p.float(), **tol)
        torch.testing.assert_close(got_w, ref_w, rtol=1e-4, atol=1e-5)
