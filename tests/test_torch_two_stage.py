"""kinet_tpu_torch's two-stage Deformable DETR and ``merge_frame_features``
against the JAX package, on bridged weights at a tiny width, on the CPU:

- ``proposal_pos_embed`` and ``gen_encoder_output_proposals`` (pad tokens
  and out-of-range boxes at +inf);
- the models over two chained frames: two-stage with box refinement
  (flagship and single-frame ``train_deformable`` recipes; the flagship's
  track queries are ignored by the two-stage branch, as in JAX) and
  without it, ``merge_frame_features``; the weight bridge of their new
  parameters;
- the criteria on the models' outputs, the ``_enc`` losses of the encoder
  proposals included;
- one tracking train step of each (previous-frame forward, track-query
  simulation fed JAX's draw, current forward, criterion, backward): every
  loss and every gradient;
- ``Tracker`` steps of each against the JAX ``Tracker``.

Tolerances: forward values at atol 1e-4 (as tests/test_torch_port_model.py),
proposals and embeddings at rtol 1e-4 / atol 1e-5 in float32; the train
step's as tests/test_torch_train_step.py states them.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu.models.deformable_transformer import (
    proposal_pos_embed as jax_proposal_pos_embed,
)
from kinet_tpu_torch.models.build import build_criterion
from kinet_tpu_torch.models.deformable_transformer import (
    descending_topk,
    proposal_pos_embed,
)
from test_torch_port_model import (
    frame_inputs,
    jax_inputs,
    port_model,
    tiny_params,
    torch_inputs,
)

TOL = dict(rtol=1e-4, atol=1e-5)
MODELS = {
    "two_stage": dict(two_stage=True),
    "two_stage_no_refine": dict(two_stage=True, with_box_refine=False),
    "two_stage_one_frame": dict(
        two_stage=True, multi_frame_attention=False,
        cache_prev_encoder=False, tracking=False),
    "merge": dict(merge_frame_features=True, cache_prev_encoder=False),
}


def test_proposal_pos_embed_matches_jax():
    rng = np.random.default_rng(0)
    props = rng.normal(0, 2, size=(2, 7, 4)).astype(np.float32)
    want = np.asarray(jax_proposal_pos_embed(jnp.asarray(props), 18))
    got = proposal_pos_embed(torch.from_numpy(props), 18).numpy()
    assert got.shape == (2, 7, 72)
    np.testing.assert_allclose(got, want, **TOL)


def test_descending_topk_orders_ties_as_jax():
    x = np.array([[0.5, -np.inf, 0.7, 0.5, -np.inf, 0.5, -np.inf]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(x), 7)
    got = descending_topk(torch.from_numpy(x), 7)
    assert got.tolist() == np.asarray(want).tolist()


def _models(name, seed=0):
    over = MODELS[name]
    jmodel, params = tiny_params(seed, **over)
    return jmodel, params, port_model(params, **over), over


def test_gen_encoder_output_proposals_matches_jax():
    jmodel, params, model, _ = _models("two_stage")
    rng = np.random.default_rng(1)
    shapes = ((8, 12), (4, 6))
    s = sum(h * w for h, w in shapes)
    memory = rng.normal(size=(2, s, 36)).astype(np.float32)
    mask = np.zeros((2, s), bool)
    # a bottom/right pad band in image 1 of each level
    for (h, w), start in zip(shapes, (0, 96)):
        m = mask[1, start:start + h * w].reshape(h, w)
        m[h - 2:] = True
        m[:, w - 3:] = True

    def gen(mod, mem, msk):
        return mod.transformer.gen_encoder_output_proposals(mem, msk, shapes)

    j_mem, j_props = jax.jit(lambda p, a, b: jmodel.apply(p, a, b, method=gen))(
        params, jnp.asarray(memory), jnp.asarray(mask))
    with torch.no_grad():
        t_mem, t_props = model.transformer.gen_encoder_output_proposals(
            torch.from_numpy(memory), torch.from_numpy(mask), shapes)
    j_props = np.asarray(j_props)
    inf = np.isinf(j_props)
    assert inf.any() and (~inf).any()
    np.testing.assert_array_equal(np.isinf(t_props.numpy()), inf)
    np.testing.assert_allclose(t_props.numpy()[~inf], j_props[~inf], **TOL)
    np.testing.assert_allclose(t_mem.numpy(), np.asarray(j_mem), **TOL)


def _two_frames(jmodel, params, model):
    jf = jax.jit(jmodel.apply)
    jp = jax.jit(lambda p, b, t, pf: jmodel.apply(p, b, t, prev_features=pf))
    j1 = jf(params, *jax_inputs(*frame_inputs(0)))
    j2 = jp(params, *jax_inputs(*frame_inputs(1)), j1["frame_features"])
    with torch.no_grad():
        t1 = model(*torch_inputs(*frame_inputs(0)))
        t2 = model(*torch_inputs(*frame_inputs(1)),
                   prev_features=t1["frame_features"])
    return (j1, t1), (j2, t2)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    jmodel, params, model, over = _models(name)
    for frame, (jo, to) in enumerate(_two_frames(jmodel, params, model)):
        for key in ("pred_logits", "pred_boxes", "hs_embed"):
            np.testing.assert_allclose(
                to[key].numpy(), np.asarray(jo[key]), atol=1e-4,
                err_msg=f"frame {frame} {key}")
        assert ("enc_outputs" in to) == bool(over.get("two_stage"))
        if "enc_outputs" in to:
            for key in ("pred_logits", "pred_boxes"):
                np.testing.assert_allclose(
                    to["enc_outputs"][key].numpy(),
                    np.asarray(jo["enc_outputs"][key]), atol=1e-4,
                    err_msg=f"frame {frame} enc {key}")
            # the invalid proposals' boxes are sigmoid(+inf) = 1
            assert (to["enc_outputs"]["pred_boxes"] == 1.0).any()
        if over.get("two_stage") and over.get("tracking", True):
            # track queries are ignored: no padded slot, num_queries rows
            assert to["query_valid"].all()
            assert to["pred_logits"].shape[1] == 12


def test_bridge_maps_the_new_parameters():
    _, _, model, _ = _models("two_stage")
    names = {n for n, _ in model.named_parameters()}
    assert {"transformer.enc_output.weight", "transformer.enc_output_norm.weight",
            "transformer.pos_trans.weight", "transformer.pos_trans_norm.bias",
            "class_embed2.weight", "bbox_embed2.layer0.weight"} <= names
    assert "query_embed" not in names
    assert not any("reference_points_head" in n for n in names)
    _, _, merge, _ = _models("merge")
    assert merge.merge3.weight.shape == (36, 72, 1, 1)


@pytest.mark.parametrize("name", ["two_stage", "merge"])
def test_criterion_matches_jax(name):
    from kinet_tpu.config import load_config as jax_load_config
    from kinet_tpu.models.build import build_model as jax_build_model
    from test_torch_train_step import (
        FLAGSHIP, TINY, frames, jax_frame, torch_frame,
    )

    over = MODELS[name]
    jmodel, params, model, _ = _models(name)
    jcfg = jax_load_config("train.yaml", named=FLAGSHIP).replace(
        **{**TINY, **over})
    _, jcrit, _ = jax_build_model(jcfg)
    cur, _ = frames()
    jb, jt = jax_frame(cur)
    jout = jax.jit(jmodel.apply)(params, jb, jt)
    want = {k: float(v) for k, v in jax.jit(jcrit)(jout, jt).items()}
    with torch.no_grad():
        tb, tt = torch_frame(cur)
        got = build_criterion(model_cfg(over))(
            model(tb, tt, aux_outputs=True), tt)
    assert set(want) == set(got)
    assert any(k.endswith("_enc") for k in got) == (name == "two_stage")
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def model_cfg(over):
    from kinet_tpu_torch.config import load_config
    from test_torch_train_step import FLAGSHIP, TINY

    return load_config("train.yaml", named=FLAGSHIP).replace(
        **{**TINY, **over})


@pytest.mark.parametrize("name", ["two_stage", "merge"])
def test_train_step_matches_jax(name, monkeypatch):
    import test_torch_train_step as ts
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import make_train_step
    from kinet_tpu_torch.tools.from_jax import flax_path, to_flax_layout
    from kinet_tpu_torch.tracking import train_augment

    over = MODELS[name]
    jcfg, cfg = ts.configs(**over)
    from kinet_tpu.models.build import build_model as jax_build_model

    jmodel, jcrit, _ = jax_build_model(jcfg)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *ts.jax_frame(ts.frames()[0])))
    rng = np.random.default_rng(ts.PERTURB_SEED)

    def perturb(path, x):
        key = jax.tree_util.keystr(path)
        if ("sampling_offsets" in key or "attention_weights" in key) \
                and "kernel" in key:
            return (x + rng.normal(0, 0.05, x.shape)).astype(x.dtype)
        return np.asarray(x)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    ref_losses, ref_grads, aug = ts._jax_step(jmodel, jcrit, jcfg, params,
                                              monkeypatch)
    samples = ts._record_samples(monkeypatch)
    model = ts.port_model(cfg, params)
    model.train()
    opt = Optimizer(model, cfg, ts.STEPS_PER_EPOCH)
    grads = {}
    clip = opt.clip_grads

    def recording_clip():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return clip()

    opt.clip_grads = recording_clip
    monkeypatch.setattr(train_augment, "add_track_queries_to_targets",
                        lambda *a, **kw: ts.torch_targets(aug))
    cur, prev = ts.frames()
    losses = make_train_step(model, build_criterion(cfg), opt, cfg)(
        *ts.torch_frame(cur), *ts.torch_frame(prev))
    # no sample within 1e-5 px of a bilinear kink (see test_torch_train_step)
    assert ts._kink_distance(samples) > 1e-5
    assert set(ref_losses) <= set(losses)
    assert any(k.endswith("_enc") for k in losses) == (name == "two_stage")
    for k, v in ref_losses.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    jflat = ts.flat(ref_grads)
    np.testing.assert_allclose(float(losses["grad_norm"]),
                               ts._global_norm(ref_grads), rtol=1e-4)
    overall = max(np.abs(g).max() for g in jflat.values())
    for n, g in grads.items():
        path = flax_path(model, n)
        got = to_flax_layout(model, n, g.numpy(), jflat[path].shape)
        scale = np.abs(jflat[path]).max()
        np.testing.assert_allclose(got, jflat[path], rtol=1e-3,
                                   atol=1e-4 * scale + 1e-6 * overall,
                                   err_msg=n)


@pytest.mark.parametrize("name", ["merge", "two_stage"])
def test_tracker_matches_jax_tracker(name):
    from kinet_tpu.models.postprocess import postprocess_focal as jax_post
    from kinet_tpu.tracking.tracker import Tracker as JaxTracker
    from kinet_tpu_torch.models.postprocess import postprocess_focal
    from kinet_tpu_torch.tracking.tracker import Tracker
    from test_torch_port_tracker import TRACKER_CFG, moving_boxes

    jmodel, params, _, over = _models(name, seed=3)

    def bias(path, x):
        key = jax.tree_util.keystr(path)
        if "class_embed" in key and "bias" in key:
            # class 0 near the score thresholds, so tracks spawn and end
            return np.where(np.arange(x.shape[0]) == 0, 0.5, -4.0).astype(
                x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(bias, params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = port_model(params, **over)
    jt = JaxTracker(jmodel, params, jax_post, TRACKER_CFG,
                    num_object_queries=12, num_track_slots=4, hidden_dim=36)
    pt = Tracker(model, postprocess_focal, TRACKER_CFG,
                 num_object_queries=12, num_track_slots=4, hidden_dim=36)
    n_tracked = 0
    for frame, blob in enumerate(moving_boxes(6)):
        jt.step(blob)
        pt.step(blob)
        ids = sorted(t.id for t in jt.tracks)
        assert sorted(t.id for t in pt.tracks) == ids, frame
        n_tracked += len(ids)
    assert n_tracked >= 4, "the sequence must exercise live tracks"
    j_res, p_res = jt.get_results(), pt.get_results()
    assert sorted(j_res) == sorted(p_res)
    for tid, per_frame in j_res.items():
        for f, r in per_frame.items():
            np.testing.assert_allclose(p_res[tid][f]["bbox"], r["bbox"],
                                       atol=1e-3, err_msg=f"{tid} {f}")
