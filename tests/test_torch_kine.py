"""kinet_tpu_torch's KineT family against the JAX package, on the CPU, on
weights bridged by ``tools/from_jax.py`` and numpy-seeded inputs:

- ``sine_detection_encoding`` (the slot index wraps at ``max_detections``);
- the modules: ``KinetBackbone``, ``IntertwinedBranch``,
  ``KinematicTransformer``, ``DualKinematicTransformer``,
  ``DualKinematicEncoder``;
- the models ``KineT``, ``KinematicDetectorTransformer`` (raw and
  sine-encoded trails) and ``KinematicDetectorEncoder`` (with track slots,
  and with its default of ``max_number_detection`` slots), with an empty
  frame whose keys are all padding, and ``build_model``'s rules;
- the matchers ``box_match``, ``ordered_match_from_track_ids`` and
  ``ordered_match_transformer`` (equal indices);
- ``add_kine_track_queries``: its deterministic part against JAX's, its
  random part held to its invariants over many seeds;
- ``MOTKine`` samples and ``collate_kine`` batches bit-identical to JAX's
  over two epochs;
- one train step of each variant (losses and every gradient), the
  optimizer's parameter groups, the kine branch of ``evaluate()`` (every
  image's boxes and scores), and ``train(cfg)`` on a mot_kine tree.

Tolerance: rtol 1e-4 / atol 1e-5 (float32; the ROADMAP's parity
tolerance) for forward values and losses; gradients within rtol 1e-4 and
1e-4 of each tensor's largest entry.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.data import kinematic as jax_kin
from kinet_tpu.data.builder import build_dataset as jax_build_dataset
from kinet_tpu.engine import evaluate as jax_evaluate
from kinet_tpu.engine import state as jax_state
from kinet_tpu.engine.train_step import make_kine_train_step as jax_kine_step
from kinet_tpu.models import backbone as jax_backbone
from kinet_tpu.models import detr as jax_detr
from kinet_tpu.models import matcher as jax_matcher
from kinet_tpu.models import transformer as jax_tf
from kinet_tpu.models.build import build_model as jax_build_model
from kinet_tpu.models.position_encoding import (
    sine_detection_encoding as jax_sine_det,
)
from kinet_tpu.structs import KineBatch as JaxKineBatch
from kinet_tpu.structs import Targets as JaxTargets
from kinet_tpu.tracking import kine_augment as jax_aug
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.data import kinematic as port_kin
from kinet_tpu_torch.data.builder import build_dataset
from kinet_tpu_torch.engine import evaluate as port_evaluate
from kinet_tpu_torch.engine import train_step as port_train_step
from kinet_tpu_torch.engine.state import Optimizer
from kinet_tpu_torch.engine.train import train
from kinet_tpu_torch.models import backbone as port_backbone
from kinet_tpu_torch.models import detr as port_detr
from kinet_tpu_torch.models import matcher as port_matcher
from kinet_tpu_torch.models import transformer as port_tf
from kinet_tpu_torch.models.build import build_criterion, build_model
from kinet_tpu_torch.models.position_encoding import sine_detection_encoding
from kinet_tpu_torch.structs import KineBatch, Targets
from kinet_tpu_torch.tools import mota_gates
from kinet_tpu_torch.tools.from_jax import flax_path, load_jax_params, to_flax_layout
from kinet_tpu_torch.tracking import kine_augment

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 1e-5
B, ND, N, T, L = 2, 8, 6, 4, 3
TINY = dict(dataset="mot_kine", hidden_dim=32, nheads=2, dim_feedforward=48,
            num_queries=8, max_track_queries=T, max_number_detection=ND,
            max_objects=N, track_prev_frame_range=L, dropout=0.0)
# (named config, overrides): the variants the configs build
VARIANTS = {
    "dual-raw": (["train_kinet"], dict(tracking=True)),
    "dual-sine-ordered": (["train_kinet"], dict(
        tracking=True, use_encoding_tracklets=True, encoding_dim_tracklets=4,
        used_ordered_queries=True, num_queries=16)),
    "encoder": (["train_kinet2"], dict(
        tracking=True, use_encoding_tracklets=True, encoding_dim_tracklets=4)),
    "encoder-default-slots": (["train_kinet2"], dict()),
}


def close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def configs(variant, **extra):
    named, over = VARIANTS[variant]
    kw = {**TINY, **over, **extra}
    return (jax_load_config("train.yaml", named=named).replace(**kw),
            load_config("train.yaml", named=named).replace(**kw))


def embed_dim(cfg):
    from kinet_tpu_torch.models.build import kine_dims
    return sum(kine_augment.kine_track_embed_dims(*kine_dims(cfg)))


def kine_inputs(seed, e_dim):
    """Detections with image 1 an empty frame (all padding), and track
    embeddings with image 1's slots all inactive."""
    rng = np.random.default_rng(seed)
    dets = rng.uniform(0.2, 0.8, (B, ND, 4)).astype(np.float32)
    meta = rng.uniform(0.5, 1.0, (B, ND, 1)).astype(np.float32)
    pad = np.zeros((B, ND), bool)
    pad[0, 5:] = True
    pad[1] = True
    embeds = rng.normal(size=(B, T, e_dim)).astype(np.float32)
    mask = np.array([[True, False, True, True], [False] * T])
    return dets, meta, pad, embeds, mask


def jax_kine(dets, meta, pad, embeds, mask):
    t = JaxTargets.create(jnp.zeros((B, 1, 4)), jnp.zeros((B, 1), jnp.int32),
                          jnp.zeros((B, 1), bool), num_track_queries=T,
                          hidden_dim=embeds.shape[-1])
    t = t.replace(track_query_embeds=jnp.asarray(embeds),
                  track_query_mask=jnp.asarray(mask))
    return JaxKineBatch(detections=jnp.asarray(dets), metadata=jnp.asarray(meta),
                        pad_mask=jnp.asarray(pad)), t


def torch_kine(dets, meta, pad, embeds, mask):
    t = Targets.create(torch.zeros(B, 1, 4), torch.zeros(B, 1),
                       torch.zeros(B, 1), num_track_queries=T,
                       hidden_dim=embeds.shape[-1])
    t = t.replace(track_query_embeds=torch.from_numpy(embeds),
                  track_query_mask=torch.from_numpy(mask))
    return KineBatch(*map(torch.from_numpy, (dets, meta, pad))), t


@pytest.mark.parametrize("max_det", [60, 3])
def test_sine_detection_encoding_matches_jax(max_det):
    pad = np.zeros((2, 8), bool)
    pad[0, 5:] = True
    pad[1, ::3] = True
    ref = jax_sine_det(jnp.asarray(pad), 16, max_detections=max_det)
    got = sine_detection_encoding(torch.from_numpy(pad), 16,
                                  max_detections=max_det)
    close(got.numpy(), ref)


def _module_cases():
    rng = np.random.default_rng(3)
    x = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    pad = np.zeros((B, ND), bool)
    pad[0, 6:] = True
    pad[1] = True
    tpad = np.zeros((B, 5), bool)
    tpad[1, :2] = True
    args_tf = (x(B, ND, 32), x(B, ND, 32), x(B, 5, 32), x(B, 5, 32), pad, tpad)
    return {
        "KinetBackbone": (
            jax_backbone.KinetBackbone(32, 0.0),
            port_backbone.KinetBackbone(4, 2, 32, 0.0),
            (x(B, ND, 4), x(B, ND, 2))),
        "IntertwinedBranch": (
            jax_tf.IntertwinedBranch(32, 0.0),
            port_tf.IntertwinedBranch(32, 0.0), (x(B, 5, 32), x(B, 5, 32))),
        "KinematicTransformer": (
            jax_tf.KinematicTransformer(32, 2, 1, 2, 48, 0.0),
            port_tf.KinematicTransformer(32, 2, 1, 2, 48, 0.0), args_tf),
        "KinematicTransformer-prenorm": (
            jax_tf.KinematicTransformer(32, 2, 2, 1, 48, 0.0, pre_norm=True),
            port_tf.KinematicTransformer(32, 2, 2, 1, 48, 0.0, pre_norm=True),
            args_tf),
        "DualKinematicTransformer": (
            jax_tf.DualKinematicTransformer(32, 2, 1, 2, 48, 0.0),
            port_tf.DualKinematicTransformer(32, 2, 1, 2, 48, 0.0),
            (x(B, ND, 32), x(B, ND, 32), x(B, ND, 32), x(B, 5, 32),
             x(B, 5, 32), x(B, 5, 32), x(B, 5, 32), pad, tpad)),
        "DualKinematicEncoder": (
            jax_tf.DualKinematicEncoder(32, 2, 2, 48, 0.0),
            port_tf.DualKinematicEncoder(32, 2, 2, 48, 0.0),
            (x(B, ND, 32), x(B, ND, 32), x(B, ND, 32), pad)),
    }


@pytest.mark.parametrize("name", list(_module_cases()))
def test_kine_modules_match_jax(name):
    jmod, pmod, args = _module_cases()[name]
    jargs = [jnp.asarray(a) for a in args]
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), *jargs))
    ref = jmod.apply(params, *jargs)
    load_jax_params(pmod, params)
    with torch.no_grad():
        got = pmod(*[torch.from_numpy(a) for a in args])
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.isfinite(g).all()
        close(g.numpy(), r, f"{name} output {i}")


def bridged(variant, seed=0, **extra):
    jcfg, cfg = configs(variant, **extra)
    jmodel, jcrit, _ = jax_build_model(jcfg)
    model, _ = build_model(cfg, device="cpu")
    e = embed_dim(cfg)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), *jax_kine(*kine_inputs(0, e))))
    load_jax_params(model, params)
    return jcfg, cfg, jmodel, jcrit, model, params


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kine_models_match_jax(variant):
    _, cfg, jmodel, _, model, params = bridged(variant)
    assert type(model).__name__ == type(jmodel).__name__
    inputs = kine_inputs(1, embed_dim(cfg))
    ref = jax.jit(jmodel.apply)(params, *jax_kine(*inputs))
    with torch.no_grad():
        got = model(*torch_kine(*inputs), aux_outputs=True)
    for key in ("pred_logits", "pred_boxes", "hs_embed", "query_valid"):
        assert torch.isfinite(got[key].float()).all(), key
        close(got[key].numpy(), ref[key], key)


def test_single_stream_kinet_matches_jax():
    """``KineT``: no config builds it (as in the JAX package); built
    directly, with 2 decoder layers and the auxiliary heads."""
    kw = dict(num_classes=20, hidden_dim=32, num_queries=5, nheads=2,
              enc_layers=1, dec_layers=2, dim_feedforward=48, dropout=0.0,
              num_track_slots=T, max_detections=ND)
    jmodel = jax_detr.KineT(**kw)
    inputs = kine_inputs(2, 32)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *jax_kine(*inputs)))
    ref = jax.jit(jmodel.apply)(params, *jax_kine(*inputs))
    model = port_detr.KineT(**kw)
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(*torch_kine(*inputs), aux_outputs=True)
    for key in ("pred_logits", "pred_boxes", "hs_embed"):
        close(got[key].numpy(), ref[key], key)
    close(got["aux_outputs"][0]["pred_boxes"].numpy(),
          ref["aux_outputs"][0]["pred_boxes"])


@pytest.mark.parametrize("variant", ["dual-sine-ordered", "encoder"])
def test_optimizer_groups_match_jax(variant):
    """Every parameter's optimizer group is JAX ``param_labels``' (the MLP
    backbones train at ``lr_backbone``, as there: their path holds
    "backbone")."""
    from kinet_tpu_torch.engine.state import param_labels

    jcfg, cfg, _, _, model, params = bridged(variant)
    ref = flatten_dict(jax_state.param_labels(params, jcfg)["params"])
    labels = param_labels(model, cfg)
    assert {flax_path(model, n) for n in labels} == set(ref)
    for name, group in labels.items():
        assert group == ref[flax_path(model, name)], name
    assert {"backbone", "base"} <= set(labels.values())


def test_build_rules_follow_jax():
    _, cfg = configs("encoder-default-slots")
    model, _ = build_model(cfg, device="cpu")
    assert model.num_track_slots == ND  # tracking off: max_number_detection
    assert build_criterion(cfg).matcher_kind == "ordered_encoder"
    _, cfg = configs("dual-raw")
    model, _ = build_model(cfg, device="cpu")
    assert (model.trail_enc_dim, model.meta_hist_dim) == (L * 4, L)
    assert build_criterion(cfg).matcher_kind == "hungarian"
    _, cfg = configs("dual-sine-ordered", use_class=True)
    model, _ = build_model(cfg, device="cpu")
    assert (model.trail_enc_dim, model.meta_hist_dim) == (L * 16, 2 * L)
    crit = build_criterion(cfg)
    assert (crit.matcher_kind, crit.ordered_n_assign) == ("ordered_transformer", 2)
    # kine without use_encoder_only always builds the dual-stream model
    _, cfg = configs("dual-raw", used_ordered_queries=False)
    assert type(build_model(cfg, device="cpu")[0]).__name__ == \
        "KinematicDetectorTransformer"


def _matcher_inputs(seed):
    rng = np.random.default_rng(seed)
    gt = np.concatenate([rng.uniform(0.2, 0.8, (B, N, 2)),
                         rng.uniform(0.05, 0.2, (B, N, 2))], -1)
    valid = rng.uniform(size=(B, N)) < 0.8
    # detections: jittered GT for some, random boxes for the rest
    dets = np.concatenate([rng.uniform(0.2, 0.8, (B, ND, 2)),
                           rng.uniform(0.05, 0.2, (B, ND, 2))], -1)
    dets[:, :N] = np.where(rng.uniform(size=(B, N, 1)) < 0.7,
                           gt + rng.normal(0, 0.01, gt.shape), dets[:, :N])
    det_valid = rng.uniform(size=(B, ND)) < 0.85
    mask = rng.uniform(size=(B, T)) < 0.8
    fp = mask & (rng.uniform(size=(B, T)) < 0.3)
    mids = np.stack([rng.permutation(N)[:T] for _ in range(B)])
    mids = np.where(mask & ~fp, mids, -1)
    return (gt.astype(np.float32), valid, dets.astype(np.float32),
            det_valid, mask, fp, mids)


@pytest.mark.parametrize("seed", range(4))
def test_matchers_match_jax(seed):
    gt, valid, dets, det_valid, mask, fp, mids = _matcher_inputs(seed)
    jt = JaxTargets.create(gt, np.zeros((B, N), np.int32), valid,
                           num_track_queries=T, hidden_dim=4).replace(
        track_query_mask=jnp.asarray(mask), track_query_fp_mask=jnp.asarray(fp),
        track_query_match_ids=jnp.asarray(mids, jnp.int32))
    pt = Targets.create(torch.from_numpy(gt), torch.zeros(B, N),
                        torch.from_numpy(valid), num_track_queries=T,
                        hidden_dim=4).replace(
        track_query_mask=torch.from_numpy(mask),
        track_query_fp_mask=torch.from_numpy(fp),
        track_query_match_ids=torch.from_numpy(mids))
    jd, jdv = jnp.asarray(dets), jnp.asarray(det_valid)
    td, tdv = torch.from_numpy(dets), torch.from_numpy(det_valid)
    cases = {
        "box_match": (
            jax_matcher.box_match(jd, jdv, jnp.asarray(gt), jnp.asarray(valid)),
            port_matcher.box_match(td, tdv, torch.from_numpy(gt),
                                   torch.from_numpy(valid))),
        "ordered_encoder": (
            jax_matcher.ordered_match_from_track_ids(jt, jd, jdv),
            port_matcher.ordered_match_from_track_ids(pt, td, tdv)),
        "ordered_encoder_no_dets": (
            jax_matcher.ordered_match_from_track_ids(jt),
            port_matcher.ordered_match_from_track_ids(pt)),
        "ordered_transformer": (
            jax_matcher.ordered_match_transformer(jt, jd, jdv, T, 2),
            port_matcher.ordered_match_transformer(pt, td, tdv, T, 2)),
    }
    matched = 0
    for name, (ref, got) in cases.items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=name)
        matched += int((got >= 0).sum())
    assert matched > 0


def _aug_inputs(seed, valid_rows=((1, 1, 1, 1, 0, 0), (1, 1, 0, 0, 0, 0))):
    rng = np.random.default_rng(seed)
    trails = rng.uniform(0.2, 0.8, (B, N, L, 4)).astype(np.float32)
    dets = rng.uniform(0.2, 0.8, (B, ND, 4)).astype(np.float32)
    dets[:, :N] = trails[:, :, -1] + rng.normal(0, 0.005, (B, N, 4))
    meta = rng.uniform(0.5, 1.0, (B, ND, 1)).astype(np.float32)
    det_valid = np.ones((B, ND), bool)
    boxes = trails[:, :, -1].copy()
    valid = np.array(valid_rows, bool)
    return trails, dets.astype(np.float32), meta, det_valid, boxes, valid


def _aug_both(seed, enc, **kw):
    trails, dets, meta, det_valid, boxes, valid = _aug_inputs(seed)
    e = sum(jax_aug.kine_track_embed_dims(L, enc, 1))
    jt = JaxTargets.create(boxes, np.zeros((B, N), np.int32), valid,
                           np.arange(N)[None].repeat(B, 0).astype(np.int32),
                           num_track_queries=T, hidden_dim=e)
    ref = jax.tree_util.tree_map(np.asarray, jax_aug.add_kine_track_queries(
        jax.random.PRNGKey(seed), jt, jnp.asarray(trails), jnp.asarray(dets),
        jnp.asarray(meta), jnp.asarray(det_valid), trail_enc_dim=enc, **kw))
    pt = Targets.create(torch.from_numpy(boxes), torch.zeros(B, N),
                        torch.from_numpy(valid), num_track_queries=T,
                        hidden_dim=e)
    got = kine_augment.add_kine_track_queries(
        torch.Generator().manual_seed(seed), pt, torch.from_numpy(trails),
        torch.from_numpy(dets), torch.from_numpy(meta),
        torch.from_numpy(det_valid), trail_enc_dim=enc, **kw)
    return ref, got, (trails, dets, meta)


@pytest.mark.parametrize("enc", [0, 4])
def test_kine_augment_deterministic_part_matches_jax(enc):
    """Ratio 1, no random count, every matched tail replaced: the slot
    masks are JAX's exactly, the real slots hold the same targets (in the
    packages' own random order), each with JAX's trail, tail box and
    matched metadata tail."""
    ref, got, _ = _aug_both(0, enc, ratio_add_detections=1.0)
    np.testing.assert_array_equal(got.track_query_mask.numpy(),
                                  ref.track_query_mask)
    np.testing.assert_array_equal(got.track_query_fp_mask.numpy(),
                                  ref.track_query_fp_mask)
    tdim = sum(jax_aug.kine_track_embed_dims(L, enc, 1)) - L
    for b in range(B):
        real = ref.track_query_mask[b] & ~ref.track_query_fp_mask[b]
        ids_ref = ref.track_query_match_ids[b][real]
        ids_got = got.track_query_match_ids[b].numpy()[real]
        assert sorted(ids_ref.tolist()) == sorted(ids_got.tolist())
        for slot_g, m in zip(np.flatnonzero(real), ids_got):
            slot_r = np.flatnonzero(ref.track_query_match_ids[b] == m)[0]
            e_g = got.track_query_embeds[b, slot_g].numpy()
            e_r = ref.track_query_embeds[b, slot_r]
            close(e_g[:tdim], e_r[:tdim], f"trail of target {m}")
            close(e_g[-1], e_r[-1], f"metadata tail of target {m}")
            close(got.track_query_boxes[b, slot_g].numpy(),
                  ref.track_query_boxes[b, slot_r])
        assert (got.track_query_match_ids[b].numpy()[~real] == -1).all()


def test_kine_augment_random_part_invariants():
    """Over 40 seeds: the random count lies in 0..ceil(max #targets); false
    positives are moving boxes inside the image with confidence <= 0.5 and
    no match id; about half of the matched tails are replaced; the
    metadata history is ~N(0.9, 0.1)."""
    counts, replaced, hist = set(), [], []
    for seed in range(40):
        ref_kw = dict(random_count=True, ratio_add_tracklets=1.5,
                      ratio_add_detections=0.5)
        trails, dets, meta, det_valid, boxes, valid = _aug_inputs(seed)
        pt = Targets.create(torch.from_numpy(boxes), torch.zeros(B, N),
                            torch.from_numpy(valid), num_track_queries=T,
                            hidden_dim=L * 5)
        out = kine_augment.add_kine_track_queries(
            torch.Generator().manual_seed(seed), pt, torch.from_numpy(trails),
            torch.from_numpy(dets), torch.from_numpy(meta),
            torch.from_numpy(det_valid), trail_enc_dim=0, **ref_kw)
        mask, fp = out.track_query_mask, out.track_query_fp_mask
        n_slots = int(mask.sum(1).max())
        counts.add(n_slots)
        assert n_slots <= min(int(np.ceil(1.5 * 4)), T)
        emb = out.track_query_embeds
        trail = emb[..., : L * 4].reshape(B, T, L, 4)
        conf = emb[..., L * 4:]
        assert (out.track_query_match_ids[fp] == -1).all()
        if fp.any():
            f = trail[fp]  # [n_fp, L, 4]
            wh, cxcy = f[:, 0, 2:], f[:, 0, :2]
            assert ((wh >= 0.05) & (wh <= 0.35)).all()
            assert ((cxcy >= wh / 2 - 1e-6) & (cxcy <= 1 - wh / 2 + 1e-6)).all()
            # every step moves the box by the same (dx, dy, dx, dy) <= 0.06
            steps = f[:, 1:] - f[:, :-1]
            assert torch.allclose(steps, steps[:, :1].expand_as(steps),
                                  atol=1e-6)
            assert torch.allclose(steps[..., :2], steps[..., 2:], atol=1e-6)
            assert ((steps >= 0) & (steps <= 0.06 + 1e-6)).all()
            assert (conf[fp] >= 0).all() and (conf[fp] <= 0.5).all()
        real = mask & ~fp
        for b, s in zip(*np.nonzero(real.numpy())):
            m = int(out.track_query_match_ids[b, s])
            tail_is_det = np.abs(trail[b, s, -1].numpy() - dets[b, m]).max() < 1e-6
            replaced.append(tail_is_det)
            hist.extend(conf[b, s, :-1].tolist())
    assert 0 in counts and len(counts) >= 3
    assert 0.3 < np.mean(replaced) < 0.7
    assert abs(np.mean(hist) - 0.9) < 0.03 and abs(np.std(hist) - 0.1) < 0.03


def _write_kine_jsons(root, split):
    """Two sequences of 5 frames 120x160: boxes that leave the image (so
    they are clipped), a crowd box, objects that appear late (their trails
    default to the current box), detections with 'confidence' or 'score'
    and two classes."""
    rng = np.random.default_rng(5)
    images, anns, dets = [], [], []
    for s, first in enumerate((0, 5)):
        for f in range(5):
            iid = first + f
            images.append({"id": iid, "file_name": f"S{s}_{f}.jpg",
                           "height": 120, "width": 160, "frame_id": f,
                           "first_frame_image_id": first, "seq_length": 5,
                           "seq": f"S{s}"})
            for tid in range(1 + s, 4 + (f > 2)):
                x, y = rng.uniform(-10, 150), rng.uniform(0, 100)
                anns.append({"id": len(anns), "image_id": iid,
                             "category_id": 1, "bbox": [x, y, 20, 30],
                             "area": 600, "iscrowd": int(tid == 2 and f == 1),
                             "track_id": tid + 10 * s})
            for k in range(int(rng.integers(0, 5))):
                key = "confidence" if k % 2 else "score"
                dets.append({"id": len(dets), "image_id": iid,
                             "category_id": int(rng.integers(1, 3)),
                             "bbox": [float(rng.uniform(-5, 150)),
                                      float(rng.uniform(0, 110)), 15, 25],
                             key: float(rng.uniform(0.3, 1.0))})
    base = {"images": images, "categories": [{"id": 1, "name": "person"}]}
    ann_dir = root / "annotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    (ann_dir / f"{split}.json").write_text(json.dumps({**base, "annotations": anns}))
    (ann_dir / f"det_{split}.json").write_text(
        json.dumps({**base, "annotations": dets}))


@pytest.mark.parametrize("use_class, empty_start", [(False, False), (True, True)])
def test_mot_kine_samples_and_batches_are_jax_bits(tmp_path, use_class,
                                                   empty_start):
    for split in ("train", "val"):
        _write_kine_jsons(tmp_path, split)
    over = dict(dataset="mot_kine", mot_path_train=str(tmp_path),
                mot_path_val=str(tmp_path), track_prev_frame_range=3,
                use_class=use_class)
    jcfg = jax_load_config("train.yaml", named=["train_kinet"]).replace(**over)
    cfg = load_config("train.yaml", named=["train_kinet"]).replace(**over)
    for split in ("train", "val"):
        np.random.seed(7)
        jds = jax_build_dataset(split, jcfg)
        np.random.seed(7)
        ds = build_dataset(split, cfg)
        assert type(ds) is port_kin.MOTKine and len(ds) == len(jds) == 10
        kw = dict(max_detections=5, max_objects=4, trail_len=3,
                  meta_dim=2 if use_class else 1, empty_start=empty_start)
        for epoch in (0, 1):
            ds.set_epoch(epoch)
            jds.set_epoch(epoch)
            samples, jsamples = [], []
            for i in range(len(ds)):
                (d, m, t), (jd, jm, jt) = ds[i], jds[i]
                for a, b in ((d, jd), (m, jm)):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                assert t.keys() == jt.keys()
                for k in t:
                    np.testing.assert_array_equal(t[k], jt[k], err_msg=k)
                samples.append((d, m, t))
                jsamples.append((jd, jm, jt))
            got = port_kin.collate_kine(samples, **kw)
            ref = jax_kin.collate_kine(jsamples, **kw)
            assert got.keys() == ref.keys()
            for k in got:
                assert got[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert ds.sample_weight(3) == jds.sample_weight(3)


def _grads_close(model, grads, jgrads):
    jflat = {k: np.asarray(v) for k, v in flatten_dict(jgrads["params"]).items()}
    assert {flax_path(model, n) for n in grads} == set(jflat)
    for name, g in grads.items():
        path = flax_path(model, name)
        got = to_flax_layout(model, name, g.numpy(), jflat[path].shape)
        scale = np.abs(jflat[path]).max()
        np.testing.assert_allclose(got, jflat[path], rtol=RTOL,
                                   atol=1e-4 * scale + ATOL, err_msg=name)


def _kine_batch(seed, cfg):
    """A collate_kine batch of jittered-GT detections with trails."""
    rng = np.random.default_rng(seed)
    trails = rng.uniform(0.25, 0.75, (B, N, L, 4)).astype(np.float32)
    trails[..., 2:] = rng.uniform(0.05, 0.2, (B, N, L, 2))
    valid = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0]], bool)
    boxes = trails[:, :, -1] + rng.normal(0, 0.01, (B, N, 4)).astype(np.float32)
    dets = rng.uniform(0.2, 0.8, (B, ND, 4)).astype(np.float32)
    dets[:, :N] = boxes + rng.normal(0, 0.004, (B, N, 4))
    pad = np.zeros((B, ND), bool)
    pad[1, 6:] = True
    return {
        "detections": dets.astype(np.float32),
        "metadata": rng.uniform(0.6, 1.0, (B, ND, 1)).astype(np.float32),
        "det_pad_mask": pad, "boxes": boxes.astype(np.float32),
        "labels": np.zeros((B, N), np.int32), "valid": valid,
        "track_ids": np.where(valid, np.arange(N)[None] + 1, -1).astype(np.int32),
        "trails": trails, "image_ids": np.arange(B),
        "orig_sizes": np.full((B, 2), 100.0, np.float32),
    }


@pytest.mark.parametrize("variant", ["dual-raw", "dual-sine-ordered", "encoder"])
def test_kine_train_step_matches_jax(variant, monkeypatch):
    """One KineT train step in float32 with dropout 0, the port fed the
    augmented targets that the JAX step drew: every loss and gradient."""
    jcfg, cfg, jmodel, jcrit, model, params = bridged(
        variant, kine_random_tracklet_count=False, ratio_add_tracklets=1.0)
    batch = _kine_batch(4, cfg)
    captured = {}
    make_aug = jax_aug.add_kine_track_queries

    def recording(*a, **kw):
        out = make_aug(*a, **kw)
        jax.debug.callback(lambda t: captured.setdefault("t", t), out)
        return out

    monkeypatch.setattr(jax_aug, "add_kine_track_queries", recording)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    state = jax_state.TrainState.create(params, keep)
    new, ref_losses = jax_kine_step(jmodel, jcrit, keep, jcfg)(
        state, jax.random.PRNGKey(2), jax.tree_util.tree_map(jnp.asarray, batch))
    ref_grads = jax.device_get(new.opt_state)
    jax.effects_barrier()
    aug = jax.tree_util.tree_map(np.asarray, captured["t"])
    assert aug.track_query_mask.any()
    aug_t = Targets(**{k: (torch.from_numpy(np.array(v)).long()
                           if np.asarray(v).dtype == np.int32
                           else torch.from_numpy(np.array(v)))
                       for k, v in vars(aug).items() if v is not None})
    monkeypatch.setattr(port_train_step, "add_kine_track_queries",
                        lambda *a, **kw: aug_t)

    model.train()
    opt = Optimizer(model, cfg, 10)
    grads = {}
    clip = opt.clip_grads

    def recording_clip():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return clip()

    opt.clip_grads = recording_clip
    losses = port_train_step.make_kine_train_step(
        model, build_criterion(cfg), opt, cfg)(batch)
    for k, v in ref_losses.items():
        close(float(losses[k]), float(v), k)
    _grads_close(model, grads, ref_grads)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The KineT gate's scene: MOT17 sequence + coco train/val jsons, with
    the sequence also under the coco root for the tracking eval."""
    root = tmp_path_factory.mktemp("kine")
    mota_gates.write_kine_scene(root)
    ann = root / "coco" / "annotations"
    for kind in ("", "det_"):
        shutil.copy(ann / f"{kind}train.json", ann / f"{kind}val.json")
    shutil.copytree(root / "MOT17", root / "coco" / "MOT17")
    return root


@pytest.mark.parametrize("variant, tracking", [
    ("encoder", False), ("encoder", True), ("dual-raw", True)])
def test_kine_evaluate_matches_jax(scene, variant, tracking, monkeypatch):
    """The kine branch of ``evaluate()`` over the gate scene's 40 val
    frames: every image's boxes and scores as the evaluator receives them
    (with track slots when ``tracking``, none without, as in JAX), and the
    12 stats."""
    from kinet_tpu.models.postprocess import postprocess as jax_post
    from kinet_tpu.utils.coco_eval import CocoEvaluator as JaxEvaluator
    from kinet_tpu_torch.models.postprocess import postprocess as port_post
    from kinet_tpu_torch.utils.coco_eval import CocoEvaluator

    over = dict(mot_path_train=str(scene / "coco"),
                mot_path_val=str(scene / "coco"), batch_size=4,
                num_workers=1, tracking=tracking, tracking_eval=False)
    jcfg, cfg, jmodel, jcrit, model, params = bridged(variant, **over)
    preds = {"jax": {}, "port": {}}
    for cls, key in ((JaxEvaluator, "jax"), (CocoEvaluator, "port")):
        orig = cls.update

        def update(self, p, _orig=orig, _key=key):
            preds[_key].update(p)
            return _orig(self, p)
        monkeypatch.setattr(cls, "update", update)
    ref = jax_evaluate.evaluate(jmodel, jcrit, {"bbox": jax_post}, params,
                                jax_build_dataset("val", jcfg), jcfg)
    got = port_evaluate.evaluate(model, build_criterion(cfg),
                                 {"bbox": port_post}, build_dataset("val", cfg),
                                 cfg, device="cpu")
    assert preds["port"].keys() == preds["jax"].keys()
    assert len(preds["jax"]) == mota_gates.KINE_FRAMES
    for img, r in preds["jax"].items():
        g = preds["port"][img]
        assert g["boxes"].shape == r["boxes"].shape
        np.testing.assert_allclose(g["boxes"], r["boxes"], atol=1e-3)
        close(g["scores"], r["scores"])
        np.testing.assert_array_equal(g["labels"], r["labels"])
    np.testing.assert_allclose(got["coco_eval_bbox"], ref["coco_eval_bbox"],
                               atol=1e-3)


def test_train_entry_trains_and_evaluates_kinet(scene, tmp_path):
    """``train(cfg, device="cpu")`` with ``train_kinet2``: the mot_kine
    loader, the kine step and, each epoch, the kine evaluation with its
    tracking eval (the kinematic tracker over the MOT17 sequence)."""
    _, cfg = configs("encoder")
    cfg = cfg.replace(
        mot_path_train=str(scene / "coco"), mot_path_val=str(scene / "coco"),
        output_dir=str(tmp_path / "out"), batch_size=4, epochs=1,
        num_workers=1, val_interval=1, log_interval=5, tracking_eval=True,
        tracking_eval_dataset=mota_gates.KINE_SEQ)
    model, optimizer, steps = train(cfg, device="cpu")
    assert type(model).__name__ == "KinematicDetectorEncoder"
    assert steps == 10 and optimizer.num_updates == 10 and model.training
    line = json.loads((tmp_path / "out" / "metrics.jsonl").read_text())
    assert all(np.isfinite(line[k]) for k in ("AP", "mota", "idf1")), line
