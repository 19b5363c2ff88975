"""kinet_tpu_torch's vanilla DETR and the transformer stacks of
``models/transformer.py`` against the JAX package, on the CPU, on weights
bridged by ``tools/from_jax.py`` and numpy-seeded inputs:

- the attention block with a query whose keys are all masked (uniform
  weights, as flax's ``finfo.min`` mask gives, never NaN);
- ``Transformer`` post- and pre-norm, with and without track attention,
  with an image whose track slots are all inactive; its last decoder
  layer's cross-attention weights against flax's sowed weights;
- ``DETR`` over two chained frames (the first frame's pre-norm
  ``hs_embed`` fed back as the second frame's track queries), auxiliary
  heads included;
- one vanilla-DETR tracking train step (losses, every gradient) and the
  optimizer's parameter groups;
- the JAX overfit recipe (tests/test_overfit.py) through the port from the
  JAX initial weights, at that test's criteria;
- ``train(cfg)`` with the vanilla DETR on a synthetic MOT dataset.

Tolerance: rtol 1e-4 / atol 1e-5 (float32; the ROADMAP's parity
tolerance) for forward values and losses; gradients, which sum over every
pixel and query in another order, within rtol 1e-4 and 1e-4 of each
tensor's largest entry.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict
from PIL import Image

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.engine import state as jax_state
from kinet_tpu.engine.train_step import make_train_step as jax_make_train_step
from kinet_tpu.models import transformer as jax_tf
from kinet_tpu.models.build import build_model as jax_build_model
from kinet_tpu.structs import ImageBatch as JaxImageBatch
from kinet_tpu.structs import Targets as JaxTargets
from kinet_tpu.tracking import train_augment as jax_augment
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.engine.state import Optimizer
from kinet_tpu_torch.engine.train import train
from kinet_tpu_torch.engine.train_step import make_train_step
from kinet_tpu_torch.models import transformer as port_tf
from kinet_tpu_torch.models.build import build_criterion, build_model
from kinet_tpu_torch.models.deformable_transformer import MultiheadAttention
from kinet_tpu_torch.models.detr import DETR
from kinet_tpu_torch.structs import ImageBatch, Targets
from kinet_tpu_torch.tools.from_jax import flax_path, load_jax_params, to_flax_layout
from kinet_tpu_torch.tracking import train_augment

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=32, nheads=2,
    enc_layers=2, dec_layers=2, dim_feedforward=48, num_queries=6,
    max_track_queries=4, dropout=0.0, compute_dtype="float32",
)
B, H, W, T, D = 2, 64, 96, 4, 32


def close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def configs(**over):
    kw = {**TINY, **over}
    return (jax_load_config("train.yaml", named=["train_tracking"]).replace(**kw),
            load_config("train.yaml", named=["train_tracking"]).replace(**kw))


def frame(seed):
    """Images with a padded bottom band on image 1 and a right band on
    both; track-query embeddings with image 1's slots all inactive."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    pad = np.zeros((B, H, W), bool)
    pad[1, 40:] = True
    pad[:, :, 80:] = True
    embeds = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.array([[True, False, True, True], [False] * T])
    return images, pad, embeds, mask


def jax_inputs(images, pad, embeds, mask):
    t = JaxTargets.create(jnp.zeros((B, 1, 4)), jnp.zeros((B, 1), jnp.int32),
                          jnp.zeros((B, 1), bool), num_track_queries=T,
                          hidden_dim=D)
    t = t.replace(track_query_embeds=jnp.asarray(embeds),
                  track_query_mask=jnp.asarray(mask))
    return JaxImageBatch(images=jnp.asarray(images), pad_mask=jnp.asarray(pad)), t


def torch_inputs(images, pad, embeds, mask):
    t = Targets.create(torch.zeros(B, 1, 4), torch.zeros(B, 1),
                       torch.zeros(B, 1), num_track_queries=T, hidden_dim=D)
    t = t.replace(track_query_embeds=torch.from_numpy(embeds),
                  track_query_mask=torch.from_numpy(mask))
    return ImageBatch(torch.from_numpy(images), torch.from_numpy(pad)), t


def test_all_masked_attention_row_matches_flax():
    """Image 1's keys are all padding: flax gives every masked logit
    finfo.min, so the row's weights are uniform and its output the mean of
    the values; the port's attention block does the same, with no NaN."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    q, kv = (rng.normal(size=(2, n, 16)).astype(np.float32) for n in (3, 5))
    pad = np.zeros((2, 5), bool)
    pad[1] = True
    mha = fnn.MultiHeadDotProductAttention(num_heads=2, qkv_features=16,
                                           out_features=16)
    mask = jax_tf.mha_attention_bias(jnp.asarray(pad))
    params = jax.device_get(mha.init(jax.random.PRNGKey(0), q, kv, kv, mask=mask))
    ref, state = mha.apply(params, q, kv, kv, mask=mask, sow_weights=True,
                           mutable=["intermediates"])
    port = MultiheadAttention(16, 2)
    load_jax_params(port, params)
    with torch.no_grad():
        out, weights = port(torch.from_numpy(q), torch.from_numpy(kv),
                            torch.from_numpy(kv), torch.from_numpy(~pad),
                            return_weights=True)
    assert torch.isfinite(out).all()
    close(out.numpy(), ref)
    close(weights.numpy(), state["intermediates"]["attention_weights"][0])
    torch.testing.assert_close(weights[1], torch.full_like(weights[1], 0.2))


@pytest.mark.parametrize("pre_norm, track_attention", [
    (False, False), (False, True), (True, False), (True, True)])
def test_transformer_matches_jax(pre_norm, track_attention):
    rng = np.random.default_rng(1)
    L, Q = 12, 3
    src, pos = (rng.normal(size=(B, L, D)).astype(np.float32) for _ in range(2))
    qpos = rng.normal(size=(B, T + Q, D)).astype(np.float32)
    tgt = rng.normal(size=(B, T + Q, D)).astype(np.float32)
    src_pad = np.zeros((B, L), bool)
    src_pad[1, 8:] = True
    tgt_pad = np.zeros((B, T + Q), bool)
    tgt_pad[0, 1] = True
    tgt_pad[1, :T] = True  # no active track slot: all-masked track rows
    args = dict(d_model=D, nheads=2, num_encoder_layers=2,
                num_decoder_layers=2, dim_feedforward=48, dropout=0.0,
                pre_norm=pre_norm, track_attention=track_attention,
                num_track_slots=T)
    jmod = jax_tf.Transformer(**args, sow_attention=True)
    jargs = tuple(map(jnp.asarray, (src, pos, qpos, tgt, src_pad, tgt_pad)))
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), *jargs[:3],
                                      *jargs[3:]))
    (hs, hs_raw, memory), state = jmod.apply(
        params, *jargs[:3], *jargs[3:], mutable=["intermediates"])
    sowed = flatten_dict(state["intermediates"])
    (jweights,) = [v[0] for k, v in sowed.items() if k[-1] == "attention_weights"]

    pmod = port_tf.Transformer(
        D, 2, 2, 2, 48, 0.0, pre_norm, track_attention, T)
    load_jax_params(pmod, params)
    with torch.no_grad():
        t = [torch.from_numpy(a) for a in (src, pos, qpos, tgt, src_pad, tgt_pad)]
        p_hs, p_raw, p_mem, p_w = pmod(*t[:3], tgt=t[3], src_key_pad_mask=t[4],
                                       tgt_key_pad_mask=t[5],
                                       return_weights=True)
    for name, got, ref in (("hs", p_hs, hs), ("hs_raw", p_raw, hs_raw),
                           ("memory", p_mem, memory), ("weights", p_w, jweights)):
        assert torch.isfinite(got).all(), name
        close(got.numpy(), ref, name)


@pytest.fixture(scope="module")
def bridged():
    jcfg, cfg = configs(track_attention=True)
    jmodel, jcrit, _ = jax_build_model(jcfg)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *jax_inputs(*frame(0))))
    return jcfg, cfg, jmodel, jcrit, params


def port_model(cfg, params):
    model, _ = build_model(cfg, device="cpu")
    assert type(model) is DETR
    load_jax_params(model, params)
    return model


def test_optimizer_groups_match_jax(bridged):
    """Every parameter's optimizer group is JAX ``param_labels``', the
    track-attention layers in "track"."""
    from kinet_tpu_torch.engine.state import param_labels

    jcfg, cfg, _, _, params = bridged
    model = port_model(cfg, params)
    ref = flatten_dict(jax_state.param_labels(params, jcfg)["params"])
    labels = param_labels(model, cfg)
    assert {flax_path(model, n) for n in labels} == set(ref)
    for name, group in labels.items():
        assert group == ref[flax_path(model, name)], name
    assert set(labels.values()) == {"frozen", "backbone", "track", "base"}


def test_detr_matches_jax_over_two_chained_frames(bridged):
    """Frame 2's track queries are frame 1's pre-norm hs_embed rows of
    three object queries, in each package from its own frame 1."""
    _, cfg, jmodel, _, params = bridged
    model = port_model(cfg, params)
    fwd = jax.jit(jmodel.apply)
    f1, f2 = frame(0), frame(1)
    j1 = fwd(params, *jax_inputs(*f1))
    with torch.no_grad():
        t1 = model(*torch_inputs(*f1), aux_outputs=True)
    rows = [T + 0, T + 2, T + 5]
    j_emb = np.zeros((B, T, D), np.float32)
    j_emb[:, :3] = np.asarray(j1["hs_embed"])[:, rows]
    t_emb = np.zeros((B, T, D), np.float32)
    t_emb[:, :3] = t1["hs_embed"][:, rows].numpy()
    close(t_emb, j_emb, "frame 1 hs_embed feedback")
    f2 = (f2[0], f2[1], None, np.array([[True, True, True, False]] * B))
    j2 = fwd(params, *jax_inputs(*f2[:2], j_emb, f2[3]))
    with torch.no_grad():
        t2 = model(*torch_inputs(*f2[:2], t_emb, f2[3]), aux_outputs=True)
    for n, (jo, to) in enumerate(((j1, t1), (j2, t2))):
        for key in ("pred_logits", "pred_boxes", "hs_embed", "query_valid"):
            close(to[key].numpy(), jo[key], f"frame {n + 1} {key}")
        close(to["aux_outputs"][0]["pred_logits"].numpy(),
              jo["aux_outputs"][0]["pred_logits"], f"frame {n + 1} aux")
    # inference skips the auxiliary heads unless asked
    with torch.no_grad():
        assert "aux_outputs" not in model(*torch_inputs(*f1))


def _jax_step(jmodel, jcrit, jcfg, params, cur, prev, monkeypatch):
    """One JAX tracking train step: (losses, raw gradients, augmented
    targets); the gradients come out through an optimizer that stores them,
    the augmented targets through a debug callback."""
    captured = {}
    make_aug = jax_augment.add_track_queries_to_targets

    def recording(*a, **kw):
        out = make_aug(*a, **kw)
        jax.debug.callback(lambda t: captured.setdefault("targets", t), out)
        return out

    monkeypatch.setattr(jax_augment, "add_track_queries_to_targets", recording)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    state = jax_state.TrainState.create(params, keep)
    step = jax_make_train_step(jmodel, jcrit, keep, jcfg)
    new, losses = step(state, jax.random.PRNGKey(3), *cur, *prev)
    grads = jax.device_get(new.opt_state)
    jax.effects_barrier()
    return ({k: float(v) for k, v in losses.items()}, grads,
            jax.tree_util.tree_map(np.asarray, captured["targets"]))


def _gt(seed):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, 3, 2)),
                            rng.uniform(0.1, 0.3, (B, 3, 2))], -1)
    valid = np.array([[1, 1, 1], [1, 1, 0]], bool)
    return boxes.astype(np.float32), valid


def test_detr_train_step_matches_jax(bridged, monkeypatch):
    """A tracking train step of the vanilla DETR in float32 with dropout 0:
    the port step is fed the augmented targets the JAX step drew."""
    jcfg, cfg, jmodel, jcrit, params = bridged
    ids = {"cur": [[2, 3, 4], [1, 5, -1]], "prev": [[1, 2, 3], [1, 2, -1]]}
    data = {}
    for n, key in enumerate(("cur", "prev")):
        images, pad, _, _ = frame(10 + n)
        boxes, valid = _gt(20 + n)
        data[key] = (images, pad, boxes, valid, np.array(ids[key]))

    def jax_frame(images, pad, boxes, valid, tids):
        return (JaxImageBatch(images=jnp.asarray(images), pad_mask=jnp.asarray(pad)),
                JaxTargets.create(boxes, np.zeros((B, 3), np.int32), valid, tids,
                                  num_track_queries=T, hidden_dim=D))

    def torch_frame(images, pad, boxes, valid, tids):
        t = torch.from_numpy
        return (ImageBatch(t(images), t(pad)),
                Targets.create(t(boxes), torch.zeros(B, 3), t(valid), t(tids),
                               num_track_queries=T, hidden_dim=D))

    ref_losses, ref_grads, aug = _jax_step(
        jmodel, jcrit, jcfg, params, jax_frame(*data["cur"]),
        jax_frame(*data["prev"]), monkeypatch)
    assert aug.track_query_mask.any()

    model = port_model(cfg, params)
    model.train()
    opt = Optimizer(model, cfg, 10)
    grads = {}
    clip = opt.clip_grads

    def recording_clip():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return clip()

    opt.clip_grads = recording_clip
    aug_t = Targets(**{
        k: (torch.from_numpy(np.array(v)).long()
            if np.asarray(v).dtype == np.int32 else torch.from_numpy(np.array(v)))
        for k, v in vars(aug).items() if v is not None})
    monkeypatch.setattr(train_augment, "add_track_queries_to_targets",
                        lambda *a, **kw: aug_t)
    losses = make_train_step(model, build_criterion(cfg), opt, cfg)(
        *torch_frame(*data["cur"]), *torch_frame(*data["prev"]))
    assert set(ref_losses) <= set(losses)
    for k, v in ref_losses.items():
        close(float(losses[k]), v, k)
    jflat = {k: np.asarray(v) for k, v in flatten_dict(ref_grads["params"]).items()}
    assert set(flax_path(model, n) for n in grads) == set(jflat)
    for name, g in grads.items():
        path = flax_path(model, name)
        got = to_flax_layout(model, name, g.numpy(), jflat[path].shape)
        scale = np.abs(jflat[path]).max()
        np.testing.assert_allclose(got, jflat[path], rtol=RTOL,
                                   atol=1e-4 * scale + ATOL, err_msg=name)


def test_detr_overfit_recipe_from_the_jax_weights():
    """tests/test_overfit.py::test_detr_overfits_single_image through the
    port: its config (bf16 recipe), image, targets and 40 steps, from the
    JAX model's initial weights; held to that test's criteria."""
    over = dict(dataset="mot", backbone="resnet_test", hidden_dim=32,
                nheads=2, enc_layers=1, dec_layers=1, dim_feedforward=64,
                num_queries=8, dropout=0.0, aux_loss=False, lr=1e-3,
                lr_backbone=1e-4, clip_max_norm=0.1, weight_decay=0.0)
    jcfg = jax_load_config("train.yaml").replace(**over)
    jmodel, _, _ = jax_build_model(jcfg)
    image = jax.random.normal(jax.random.PRNGKey(0), (1, 64, 64, 3))
    boxes = [[[0.3, 0.3, 0.2, 0.2], [0.7, 0.6, 0.15, 0.25]]]
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1),
        JaxImageBatch(images=image, pad_mask=jnp.zeros((1, 64, 64), bool)),
        JaxTargets.create(jnp.asarray(boxes), jnp.zeros((1, 2), jnp.int32),
                          jnp.ones((1, 2), bool), num_track_queries=0,
                          hidden_dim=32)))
    cfg = load_config("train.yaml").replace(**over)
    model = port_model(cfg, params)
    model.train()
    step = make_train_step(model, build_criterion(cfg),
                           Optimizer(model, cfg, 10_000), cfg)
    batch = ImageBatch(torch.from_numpy(np.array(image)),
                       torch.zeros(1, 64, 64, dtype=torch.bool))
    targets = Targets.create(torch.tensor(boxes), torch.zeros(1, 2),
                             torch.ones(1, 2), num_track_queries=0,
                             hidden_dim=32)
    trace = [step(batch, targets) for _ in range(40)]
    first, last = float(trace[0]["loss"]), float(trace[-1]["loss"])
    assert last < first * 0.55, (first, last)
    assert float(trace[-1]["loss_bbox"]) < 0.35, trace[-1]


def test_train_entry_trains_vanilla_detr(tmp_path):
    """``train(cfg, device="cpu")`` with ``train.yaml`` + ``train_tracking``
    (vanilla DETR) on six 64x96 frames: finite losses and a checkpoint."""
    root = tmp_path / "mot"
    (root / "train").mkdir(parents=True)
    (root / "annotations").mkdir()
    rng = np.random.default_rng(0)
    images, anns = [], []
    for f in range(6):
        name = f"SEQ-01_{f + 1:06d}.jpg"
        Image.fromarray(rng.integers(0, 255, (64, 96, 3)).astype(np.uint8)).save(
            root / "train" / name)
        images.append({"id": f, "file_name": name, "height": 64, "width": 96,
                       "frame_id": f, "first_frame_image_id": 0,
                       "seq_length": 6, "seq": "SEQ-01"})
        for tid in (1, 2):
            anns.append({"id": len(anns), "image_id": f, "category_id": 1,
                         "bbox": [10 + 4 * f + 20 * tid, 12, 18, 30],
                         "area": 540, "iscrowd": 0, "track_id": tid})
    (root / "annotations" / "train.json").write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "person"}], "sequences": ["SEQ-01"]}))
    cfg = load_config("train.yaml", named=["train_tracking"]).replace(
        **{**TINY, "dropout": 0.1, "compute_dtype": "bfloat16"},
        mot_path_train=str(root), mot_path_val=str(root),
        output_dir=str(tmp_path / "out"), max_objects=6, batch_size=2,
        epochs=1, num_workers=1, val_interval=0, log_interval=1,
        **{"img_transform.max_size": 128, "img_transform.val_width": 64,
           "size_buckets": [[64, 96], [96, 128]]})
    model, optimizer, steps = train(cfg, device="cpu")
    assert type(model) is DETR and steps == 3 and optimizer.num_updates == 3
    assert (tmp_path / "out" / "checkpoint.pth").exists()
