"""kinet_tpu_torch whole-model parity: the port's DeformableDETR against the
JAX DeformableDETR on bridged weights, over a first frame and a second
frame that reuses the first one's cached encoder memory and position
embeddings; plus the weight bridge's strictness and build_model's device
and config rules. CPU only: the port's MSDA wrappers take their plain
versions for CPU tensors."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.models.build import build_model as jax_build_model
from kinet_tpu.structs import ImageBatch as JaxImageBatch
from kinet_tpu.structs import Targets as JaxTargets
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.models.build import build_model
from kinet_tpu_torch.structs import ImageBatch, Targets
from kinet_tpu_torch.tools.from_jax import load_jax_params

FLAGSHIP = ["train_deformable", "train_tracking", "train_multi_frame"]
# the flagship's flags (enc_lite, klevels, dec_gather_raw,
# cache_prev_encoder, ...) at a tiny width and depth
TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=36, nheads=2,
    enc_layers=2, dec_layers=2, dim_feedforward=64, num_queries=12,
    max_track_queries=4, dropout=0.0,
)
T_SLOTS, HIDDEN = 4, 36


def tiny_params(seed=0, **over):
    """JAX model + its params as numpy, with the zero-initialised MSDA
    offset/attention kernels given N(0, 0.05^2) entries so the sampling
    locations and weights depend on the query."""
    cfg = jax_load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **over)
    model, _, _ = jax_build_model(cfg)
    batch, targets = jax_inputs(*frame_inputs(0))
    params = jax.device_get(
        jax.jit(model.init)(jax.random.PRNGKey(seed), batch, targets)
    )
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        key = jax.tree_util.keystr(path)
        if ("sampling_offsets" in key or "attention_weights" in key) and "kernel" in key:
            return (x + rng.normal(0, 0.05, x.shape)).astype(x.dtype)
        return np.asarray(x)

    return model, jax.tree_util.tree_map_with_path(perturb, params)


def frame_inputs(seed, b=1, h=64, w=96):
    rng = np.random.default_rng(100 + seed)
    images = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    pad = np.zeros((b, h, w), bool)
    pad[:, h - 16 :, :] = True  # bottom pad band
    pad[:, :, w - 8 :] = True  # right pad band
    tq_embeds = rng.normal(size=(b, T_SLOTS, HIDDEN)).astype(np.float32)
    tq_boxes = rng.uniform(0.2, 0.6, size=(b, T_SLOTS, 4)).astype(np.float32)
    tq_mask = np.array([[True, True, False, True]] * b)
    return images, pad, tq_embeds, tq_boxes, tq_mask


def jax_inputs(images, pad, tq_embeds, tq_boxes, tq_mask):
    b = images.shape[0]
    targets = JaxTargets.create(
        jnp.zeros((b, 1, 4)), jnp.zeros((b, 1), jnp.int32),
        jnp.zeros((b, 1), bool), num_track_queries=T_SLOTS, hidden_dim=HIDDEN,
    ).replace(
        track_query_embeds=jnp.asarray(tq_embeds),
        track_query_boxes=jnp.asarray(tq_boxes),
        track_query_mask=jnp.asarray(tq_mask),
    )
    return JaxImageBatch(images=jnp.asarray(images), pad_mask=jnp.asarray(pad)), targets


def torch_inputs(images, pad, tq_embeds, tq_boxes, tq_mask):
    b = images.shape[0]
    targets = Targets.create(
        torch.zeros(b, 1, 4), torch.zeros(b, 1), torch.zeros(b, 1),
        num_track_queries=T_SLOTS, hidden_dim=HIDDEN,
    ).replace(
        track_query_embeds=torch.from_numpy(tq_embeds),
        track_query_boxes=torch.from_numpy(tq_boxes),
        track_query_mask=torch.from_numpy(tq_mask),
    )
    return ImageBatch(torch.from_numpy(images), torch.from_numpy(pad)), targets


def port_model(params, **over):
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **over)
    model, _ = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    return model


def test_whole_model_matches_jax_across_cached_frame():
    jmodel, params = tiny_params()
    model = port_model(params)
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

    for frame, (jo, to) in enumerate(((j1, t1), (j2, t2))):
        for key in ("pred_logits", "pred_boxes", "hs_embed"):
            np.testing.assert_allclose(
                to[key].numpy(), np.asarray(jo[key]), atol=1e-4,
                err_msg=f"frame {frame} {key}",
            )
    # the cache the next frame reads is the JAX package's too
    np.testing.assert_allclose(
        t2["frame_memory"][0].numpy(), np.asarray(j2["frame_memory"][0]),
        atol=1e-4,
    )
    for tp, jp in zip(t1["pos_cache"], j1["pos_cache"]):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)


@pytest.mark.parametrize(
    "over",
    [
        # both frames' halves encoded every frame: the prev_features path
        dict(cache_prev_encoder=False),
        # one frame, 2-D sine, all-level encoder, project-first decoder
        dict(multi_frame_attention=False, cache_prev_encoder=False,
             enc_lite=False, dec_gather_raw=False, dec_klevels=0),
    ],
)
def test_other_model_paths_match_jax(over):
    jmodel, params = tiny_params(**over)
    model = port_model(params, **over)
    fwd_prev = jax.jit(
        lambda p, b, t, pf: jmodel.apply(p, b, t, prev_features=pf)
    )
    j1 = jax.jit(jmodel.apply)(params, *jax_inputs(*frame_inputs(0)))
    j2 = fwd_prev(params, *jax_inputs(*frame_inputs(1)), j1["frame_features"])
    with torch.no_grad():
        t1 = model(*torch_inputs(*frame_inputs(0)))
        t2 = model(*torch_inputs(*frame_inputs(1)),
                   prev_features=t1["frame_features"])
    for frame, (jo, to) in enumerate(((j1, t1), (j2, t2))):
        for key in ("pred_logits", "pred_boxes", "hs_embed"):
            np.testing.assert_allclose(
                to[key].numpy(), np.asarray(jo[key]), atol=1e-4,
                err_msg=f"frame {frame} {key}",
            )


def test_load_jax_params_is_strict_both_ways():
    _, params = tiny_params()
    inner = params["params"]
    # a flax leaf the port does not have
    extra = {**inner, "stray_head": {"kernel": np.zeros((3, 3), np.float32)}}
    with pytest.raises(ValueError, match="1 flax leaves unused"):
        port_model({"params": extra})
    # a port parameter that no flax leaf fills
    missing = {k: v for k, v in inner.items() if k != "query_embed"}
    with pytest.raises(ValueError, match="1 port tensors unfilled"):
        port_model({"params": missing})
    # a leaf whose shape does not fit
    bad = {**inner, "query_embed": np.zeros((5, 72), np.float32)}
    with pytest.raises(ValueError, match="query_embed"):
        port_model({"params": bad})


def test_build_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)


@pytest.mark.parametrize(
    "over, item",
    [
        # (config, the part an earlier slice refused); masks are ported
        # (tests/test_torch_segm.py), so with them too
        (dict(masks=True, two_stage=True), "two-stage"),
        (dict(masks=True, merge_frame_features=True), "two-stage"),
        (dict(masks=True, enc_msda_int8=True, allow_lossy=True),
         "off the flagship"),
        (dict(two_stage=True), "two-stage"),
        (dict(merge_frame_features=True), "two-stage"),
        (dict(enc_msda_int8=True, allow_lossy=True), "off the flagship"),
        (dict(enc_msda_topk=4, allow_lossy=True), "off the flagship"),
        (dict(enc_msda_shared_locs=True), "off the flagship"),
    ],
)
def test_configs_outside_the_slice_raise(over, item):
    """The configurations that earlier slices of the port refused (``item``
    names the part) build on the CPU and run two chained frames with finite
    outputs (tests/test_torch_two_stage.py and
    tests/test_torch_msda_variants.py hold them against the JAX package).
    merge_frame_features still refuses the flagship's cache_prev_encoder,
    as the JAX package does, and runs without it."""
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **over)
    if cfg.merge_frame_features:
        with pytest.raises(ValueError, match="merge_frame_features"):
            build_model(cfg, device="cpu")
        cfg = cfg.replace(cache_prev_encoder=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the lossy flags' warning
        model, _ = build_model(cfg, device="cpu")
    with torch.no_grad():
        o1 = model(*torch_inputs(*frame_inputs(0)))
        nxt = (dict(prev_memory=o1["frame_memory"], pos_cache=o1["pos_cache"])
               if cfg.cache_prev_encoder
               else dict(prev_features=o1["frame_features"]))
        o2 = model(*torch_inputs(*frame_inputs(1)), **nxt)
    keys = ["pred_logits", "pred_boxes", "hs_embed"]
    keys += ["pred_masks"] if cfg.masks else []
    for out in (o1, o2):
        for key in keys:
            assert torch.isfinite(out[key]).all(), (item, key)
        assert ("enc_outputs" in out) == bool(cfg.two_stage)


def test_lossy_knobs_need_allow_lossy():
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(
        **TINY, dec_msda_int8=True
    )
    with pytest.raises(ValueError, match="allow_lossy"):
        build_model(cfg, device="cpu")
