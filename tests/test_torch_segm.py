"""kinet_tpu_torch's segmentation (``models/segmentation.py``, the mask
losses, ``freeze_detr`` and the mask-head splice) against the JAX package,
on the CPU, on weights bridged by ``tools/from_jax.py`` and numpy-seeded
inputs:

- ``MHAttentionMap`` with a pad mask (the joint heads x positions softmax);
- ``MaskHeadSmallConv`` where no level is an integer multiple of the
  last, upsampling at every skip, and where the first skip downsamples
  (Deformable DETR's stride 8 -> 16);
- ``SegmWrapper`` on vanilla DETR (``train_tracking`` + ``train_mots20``,
  two chained frames) and on the flagship Deformable DETR with ``masks``
  (a cached second frame, levels of non-integer ratio);
- ``loss_masks`` and ``dice_loss``, with ground-truth masks larger than
  the predictions;
- ``postprocess_segm``, growing and shrinking;
- one ``freeze_detr`` tracking train step: the losses, the gradient norm
  that sets the clip scale (every gradient counts, the detector's too),
  and only ``bbox_attention`` / ``mask_head`` parameters updated;
- ``splice_mask_head`` / ``load_mask_head_from_model`` and the masked
  recipes' configs building.

Tolerance: rtol 1e-4 / atol 1e-5 (float32, the ROADMAP's parity
tolerance) for values and losses; the whole models' masks, which pass
through every layer, atol 1e-4 as the model tests of earlier slices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.engine import state as jax_state
from kinet_tpu.models import segmentation as jax_segm
from kinet_tpu.models.build import build_model as jax_build_model
from kinet_tpu.models.criterion import SetCriterion as JaxCriterion
from kinet_tpu.models.criterion import dice_loss as jax_dice_loss
from kinet_tpu.structs import ImageBatch as JaxImageBatch
from kinet_tpu.structs import Targets as JaxTargets
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.engine.state import Optimizer, param_labels
from kinet_tpu_torch.engine.train_step import make_train_step
from kinet_tpu_torch.models import segmentation as segm
from kinet_tpu_torch.models.build import build_criterion, build_model
from kinet_tpu_torch.models.criterion import SetCriterion, dice_loss
from kinet_tpu_torch.structs import ImageBatch, Targets
from kinet_tpu_torch.tools.from_jax import load_jax_params
from kinet_tpu_torch.tracking import train_augment
from kinet_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_for_resume,
    splice_mask_head,
)

import test_torch_detr as vanilla
import test_torch_port_model as flagship
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 1e-5
MOTS = ["train_tracking", "train_mots20"]


def close(got, ref, msg="", atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=atol, err_msg=msg)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_attention_map_with_pad_mask_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 5, 16)).astype(np.float32)
    memory = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    pad = np.zeros((2, 12), bool)
    pad[1, 7:] = True
    jmod = jax_segm.MHAttentionMap(16, 4)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), q, memory, pad))
    ref = jmod.apply(params, q, memory, pad)
    port = segm.MHAttentionMap(16, 4)
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(q), torch.from_numpy(memory),
                   torch.from_numpy(pad))
    close(got, ref)
    # one softmax over heads and positions together: a query's weights
    # sum to 1 over all heads, and padded positions get none
    torch.testing.assert_close(got.flatten(2).sum(-1), torch.ones(2, 5))
    assert got[1].flatten(2)[..., 7:].abs().max() < 1e-30


@pytest.mark.parametrize("x_hw, fpn_hws", [
    ((5, 7), ((9, 13), (17, 25), (33, 49))),
    ((9, 13), ((5, 7), (9, 13), (17, 25))),
], ids=["upsample", "first-skip-downsamples"])
def test_mask_head_at_non_integer_level_ratios_matches_jax(x_hw, fpn_hws):
    rng = np.random.default_rng(1)
    b, nq, heads, d = 2, 3, 2, 32
    x = rng.normal(size=(b, *x_hw, d)).astype(np.float32)
    attn = rng.uniform(size=(b, nq, heads, *x_hw)).astype(np.float32)
    fpns = [rng.normal(size=(b, *hw, c)).astype(np.float32)
            for hw, c in zip(fpn_hws, (1024, 512, 256))]
    jmod = jax_segm.MaskHeadSmallConv(d + heads, d)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), x, attn, fpns))
    ref = jmod.apply(params, x, attn, fpns)
    port = segm.MaskHeadSmallConv(d + heads, d)
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(nchw(x), torch.from_numpy(attn), [nchw(f) for f in fpns])
    assert got.shape == (b, nq, *fpn_hws[-1])
    close(got, ref)


@pytest.fixture(scope="module")
def vanilla_bridged():
    jcfg = jax_load_config("train.yaml", named=MOTS).replace(**vanilla.TINY)
    cfg = load_config("train.yaml", named=MOTS).replace(**vanilla.TINY)
    jmodel, jcrit, _ = jax_build_model(jcfg)
    assert type(jmodel).__name__ == "SegmWrapper"
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *vanilla.jax_inputs(*vanilla.frame(0))))
    return jcfg, cfg, jmodel, jcrit, params


def port_model(cfg, params):
    model, _ = build_model(cfg, device="cpu")
    assert type(model) is segm.SegmWrapper
    load_jax_params(model, params)
    return model


def test_segm_wrapper_on_vanilla_detr_matches_jax(vanilla_bridged):
    """Two chained frames: frame 2's track queries are frame 1's pre-norm
    hs_embed rows, in each package from its own frame 1."""
    _, cfg, jmodel, _, params = vanilla_bridged
    model = port_model(cfg, params)
    fwd = jax.jit(jmodel.apply)
    T, D, B = vanilla.T, vanilla.D, vanilla.B
    f1 = vanilla.frame(0)
    j1 = fwd(params, *vanilla.jax_inputs(*f1))
    with torch.no_grad():
        t1 = model(*vanilla.torch_inputs(*f1))
    rows = [T + 0, T + 2, T + 5]
    j_emb = np.zeros((B, T, D), np.float32)
    j_emb[:, :3] = np.asarray(j1["hs_embed"])[:, rows]
    t_emb = np.zeros((B, T, D), np.float32)
    t_emb[:, :3] = t1["hs_embed"][:, rows].numpy()
    active = np.array([[True, True, True, False]] * B)
    f2 = vanilla.frame(1)
    j2 = fwd(params, *vanilla.jax_inputs(f2[0], f2[1], j_emb, active))
    with torch.no_grad():
        t2 = model(*vanilla.torch_inputs(f2[0], f2[1], t_emb, active))
    for n, (jo, to) in enumerate(((j1, t1), (j2, t2))):
        assert to["pred_masks"].shape == (B, T + 6, 16, 24)
        for key in ("pred_logits", "pred_boxes", "hs_embed", "hs_last",
                    "pred_masks"):
            close(to[key].numpy(), jo[key], f"frame {n + 1} {key}", atol=1e-4)


def test_segm_wrapper_on_deformable_detr_matches_jax():
    """The flagship with ``masks`` at 72x104: C2..C5 18x26, 9x13, 5x7,
    3x4, so the mask head's first skip (stride 8 -> 16) downsamples by a
    non-integer ratio; frame 2 reuses frame 1's cached memory."""
    jmodel, params = flagship.tiny_params(masks=True)
    assert type(jmodel).__name__ == "SegmWrapper"
    model = flagship.port_model(params, masks=True)
    fwd = jax.jit(jmodel.apply)
    fwd_cached = jax.jit(lambda p, b, t, pm, pc: jmodel.apply(
        p, b, t, prev_memory=pm, pos_cache=pc))
    f1, f2 = (flagship.frame_inputs(s, h=72, w=104) for s in (0, 1))
    j1 = fwd(params, *flagship.jax_inputs(*f1))
    j2 = fwd_cached(params, *flagship.jax_inputs(*f2), j1["frame_memory"],
                    j1["pos_cache"])
    with torch.no_grad():
        t1 = model(*flagship.torch_inputs(*f1))
        t2 = model(*flagship.torch_inputs(*f2), prev_memory=t1["frame_memory"],
                   pos_cache=t1["pos_cache"])
    for n, (jo, to) in enumerate(((j1, t1), (j2, t2))):
        assert to["pred_masks"].shape == (1, 16, 18, 26)
        assert len(to["backbone_features"]) == 4
        for key in ("pred_logits", "pred_boxes", "hs_embed", "pred_masks"):
            close(to[key].numpy(), jo[key], f"frame {n + 1} {key}", atol=1e-4)


def test_mask_losses_match_jax():
    """Predictions at 8x12 against ground truth at 32x48 (resized
    bilinearly), unmatched and invalid targets left out."""
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(2, 5, 8, 12)).astype(np.float32)
    gt = (rng.uniform(size=(2, 3, 32, 48)) > 0.6).astype(np.float32)
    q4t = np.array([[3, 0, -1], [1, 4, 2]], np.int32)
    valid = np.array([[True, True, True], [True, True, False]])
    boxes = rng.uniform(0.2, 0.4, (2, 3, 4)).astype(np.float32)
    jt = JaxTargets.create(boxes, np.zeros((2, 3), np.int32), valid,
                           num_track_queries=0, hidden_dim=8).replace(
        masks=jnp.asarray(gt))
    tt = Targets.create(torch.from_numpy(boxes), torch.zeros(2, 3),
                        torch.from_numpy(valid), num_track_queries=0,
                        hidden_dim=8).replace(masks=torch.from_numpy(gt))
    num_boxes = float(valid.sum())
    wd = {"loss_mask": 1.0, "loss_dice": 1.0}
    ref = JaxCriterion(20, wd, losses=("masks",)).loss_masks(
        {"pred_masks": jnp.asarray(pred)}, jt, jnp.asarray(q4t), num_boxes)
    got = SetCriterion(20, wd, losses=("masks",)).loss_masks(
        {"pred_masks": torch.from_numpy(pred)}, tt,
        torch.from_numpy(q4t).long(), torch.tensor(num_boxes))
    assert set(got) == set(ref) == {"loss_mask", "loss_dice"}
    for k in ref:
        close(float(got[k]), float(ref[k]), k)
    flat_p, flat_t = pred[:, :3].reshape(6, 8, 12), gt[:, :, ::4, ::4].reshape(6, 8, 12)
    v = valid.reshape(-1).astype(np.float32)
    close(float(dice_loss(torch.from_numpy(flat_p), torch.from_numpy(flat_t),
                          num_boxes, torch.from_numpy(v))),
          float(jax_dice_loss(flat_p, flat_t, num_boxes, v)), "dice_loss")


@pytest.mark.parametrize("size", [(20, 30), (5, 7)], ids=["grow", "shrink"])
def test_postprocess_segm_matches_jax(size):
    rng = np.random.default_rng(3)
    logits = rng.normal(scale=3.0, size=(1, 4, 8, 12)).astype(np.float32)
    ref = jax_segm.postprocess_segm({}, {"pred_masks": jnp.asarray(logits)}, size)
    got = segm.postprocess_segm({}, {"pred_masks": torch.from_numpy(logits)},
                                size)
    assert got["masks_probs"].shape == (1, 4, *size)
    close(got["masks_probs"], ref["masks_probs"], "masks_probs")
    far = np.abs(np.asarray(ref["masks_probs"]) - 0.5) > 1e-4
    np.testing.assert_array_equal(got["masks"].numpy()[far],
                                  np.asarray(ref["masks"])[far])


def test_freeze_detr_train_step_matches_jax(vanilla_bridged, monkeypatch):
    """A ``train_mots20`` tracking step in float32 (dropout 0) with masks
    in both frames' targets: the losses, the global gradient norm over
    every parameter (which sets the clip scale at clip_max_norm 0.1), and
    after the update only the mask head's parameters changed."""
    jcfg, cfg, jmodel, jcrit, params = vanilla_bridged
    assert cfg.freeze_detr and cfg.masks
    B, T, D = vanilla.B, vanilla.T, vanilla.D
    rng = np.random.default_rng(4)
    ids = {"cur": [[2, 3, 4], [1, 5, -1]], "prev": [[1, 2, 3], [1, 2, -1]]}
    data = {}
    for n, key in enumerate(("cur", "prev")):
        images, pad, _, _ = vanilla.frame(10 + n)
        boxes, valid = vanilla._gt(20 + n)
        masks = (rng.uniform(size=(B, 3, vanilla.H, vanilla.W)) > 0.5)
        data[key] = (images, pad, boxes, valid, np.array(ids[key]),
                     masks.astype(np.float32))

    def jax_frame(images, pad, boxes, valid, tids, masks):
        return (JaxImageBatch(images=jnp.asarray(images), pad_mask=jnp.asarray(pad)),
                JaxTargets.create(boxes, np.zeros((B, 3), np.int32), valid, tids,
                                  num_track_queries=T, hidden_dim=D).replace(
                    masks=jnp.asarray(masks)))

    def torch_frame(images, pad, boxes, valid, tids, masks):
        t = torch.from_numpy
        return (ImageBatch(t(images), t(pad)),
                Targets.create(t(boxes), torch.zeros(B, 3), t(valid), t(tids),
                               num_track_queries=T, hidden_dim=D).replace(
                    masks=t(masks)))

    ref_losses, ref_grads, aug = vanilla._jax_step(
        jmodel, jcrit, jcfg, params, jax_frame(*data["cur"]),
        jax_frame(*data["prev"]), monkeypatch)
    assert aug.track_query_mask.any()
    ref_norm = float(optax.global_norm(ref_grads))

    model = port_model(cfg, params)
    model.train()
    labels = param_labels(model, cfg)
    assert {n for n, g in labels.items() if g != "frozen"} == {
        n for n in labels if n.startswith(("bbox_attention.", "mask_head."))}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    aug_t = Targets(**{
        k: (torch.from_numpy(np.array(v)).long()
            if np.asarray(v).dtype == np.int32 else torch.from_numpy(np.array(v)))
        for k, v in vars(aug).items() if v is not None})
    monkeypatch.setattr(train_augment, "add_track_queries_to_targets",
                        lambda *a, **kw: aug_t)
    opt = Optimizer(model, cfg, 10)
    losses = make_train_step(model, build_criterion(cfg), opt, cfg)(
        *torch_frame(*data["cur"]), *torch_frame(*data["prev"]))
    assert {"loss_mask", "loss_dice"} <= set(ref_losses)
    for k, v in ref_losses.items():
        close(float(losses[k]), v, k)
    close(float(losses["grad_norm"]), ref_norm, "global gradient norm")
    # the clip scale, JAX's min(1, max_norm / norm), well below 1 here
    scale = min(1.0, float(cfg.clip_max_norm) / float(losses["grad_norm"]))
    close(scale, min(1.0, float(jcfg.clip_max_norm) / ref_norm), "clip scale")
    assert scale < 0.5
    changed = {n for n, p in model.named_parameters()
               if not torch.equal(p, before[n])}
    assert changed and all(
        n.startswith(("bbox_attention.", "mask_head.")) for n in changed)


def test_jax_freeze_labels_match_the_port(vanilla_bridged):
    from flax.traverse_util import flatten_dict

    from kinet_tpu_torch.tools.from_jax import flax_path

    jcfg, cfg, _, _, params = vanilla_bridged
    model = port_model(cfg, params)
    ref = flatten_dict(jax_state.param_labels(params, jcfg)["params"])
    labels = param_labels(model, cfg)
    assert {flax_path(model, n) for n in labels} == set(ref)
    for name, group in labels.items():
        assert group == ref[flax_path(model, name)], name


def test_splice_mask_head(vanilla_bridged, tmp_path):
    """``load_mask_head_from_model`` takes the mask head (and only it) of a
    second run's checkpoint, as the JAX package's splice does on the same
    two weight sets; ``train_coco_person_masks`` resumes with it."""
    from kinet_tpu.utils.checkpoint import splice_mask_head as jax_splice

    from kinet_tpu_torch.tools.from_jax import flax_path

    jcfg, cfg, jmodel, _, params_a = vanilla_bridged
    params_b = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(7), *vanilla.jax_inputs(*vanilla.frame(0))))
    model_a, model_b = port_model(cfg, params_a), port_model(cfg, params_b)
    spliced = splice_mask_head(model_a.state_dict(), model_b.state_dict())
    ref = jax.device_get(jax_splice(params_a, params_b))
    ref_model = port_model(cfg, ref)
    for name, t in ref_model.state_dict().items():
        assert torch.equal(spliced[name], t), name
    head = [n for n in spliced if n.startswith(("bbox_attention.", "mask_head."))]
    assert head and all(torch.equal(spliced[n], model_b.state_dict()[n])
                        for n in head)

    ckpt = CheckpointManager(str(tmp_path / "panoptic"))
    ckpt.save_epoch(model_b, Optimizer(model_b, cfg, 10), 0, 1)
    person = load_config("train.yaml", named=["train_tracking",
                                              "train_coco_person_masks"])
    person = person.replace(**vanilla.TINY,
                            load_mask_head_from_model=str(tmp_path / "panoptic"))
    assert person.masks and person.freeze_detr
    model, _ = build_model(person, device="cpu")
    load_jax_params(model, params_a)
    assert load_for_resume(person, model, Optimizer(model, person, 10)) == (1, 0)
    for name, t in model.state_dict().items():
        assert torch.equal(t, spliced[name]), flax_path(model, name)
