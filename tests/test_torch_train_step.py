"""kinet_tpu_torch training against the JAX package on bridged weights
(``tools/from_jax.py``), at the tiny flagship configuration:

- the optimizer's groups equal JAX ``param_labels`` on the bridged tree,
  and one clipped AdamW step equals optax's (clip active, frozen leaves
  counted in the norm, with and without the x0.1 drop);
- one whole tracking train step (previous-frame forward, track-query
  simulation, current forward, criterion, backward, update) in float32
  with dropout 0, with the augmented targets that the JAX step made fed to
  both: every loss, every gradient and the parameters after the update;
- dropout acts only in ``train()`` mode and draws from the model's
  generator; ``remat`` recomputes with the same masks, so the gradients do
  not change;
- a model that served under ``torch.inference_mode`` trains afterwards.

Tolerances (float32, stated where they are used): the two packages run the
same arithmetic in another order (XLA fuses and reassociates), so forward
values agree to ~1e-6 relative and gradients, which sum over every pixel
and query, to ~1e-4 of each tensor's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.engine import state as jax_state
from kinet_tpu.engine.train_step import make_train_step as jax_make_train_step
from kinet_tpu.models.build import build_model as jax_build_model
from kinet_tpu.structs import ImageBatch as JaxImageBatch
from kinet_tpu.structs import Targets as JaxTargets
from kinet_tpu.tracking import train_augment as jax_augment
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.engine.state import Optimizer, param_labels
from kinet_tpu_torch.engine.train_step import make_train_step
from kinet_tpu_torch.models.build import build_criterion, build_model
from kinet_tpu_torch.structs import ImageBatch, Targets
from kinet_tpu_torch.models import deformable_transformer
from kinet_tpu_torch.tools.from_jax import flax_path, load_jax_params, to_flax_layout
from kinet_tpu_torch.tracking import train_augment

FLAGSHIP = ["train_deformable", "train_tracking", "train_multi_frame"]
TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=36, nheads=2,
    enc_layers=2, dec_layers=2, dim_feedforward=64, num_queries=12,
    max_track_queries=4, dropout=0.0, compute_dtype="float32",
)
B, H, W, N, T, HIDDEN = 2, 64, 96, 4, 4, 36
STEPS_PER_EPOCH = 10
# seeds whose draw keeps tracks and injects a false positive, and whose
# samples all lie >= 1e-5 px from a bilinear kink (both asserted)
PERTURB_SEED, STEP_SEED = 11, 1


def configs(**over):
    return (
        jax_load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **over),
        load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **over),
    )


def frames(seed=0):
    """(current, previous) frames as numpy: images, pad mask and padded
    targets. Track 1 vanishes in image 0 and track 2 in image 1."""
    rng = np.random.default_rng(seed)
    valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    ids = {"cur": [[2, 3, 4, -1], [1, 5, -1, -1]],
           "prev": [[1, 2, 3, -1], [1, 2, -1, -1]]}
    out = []
    for key in ("cur", "prev"):
        images = rng.normal(size=(B, H, W, 3)).astype(np.float32)
        pad = np.zeros((B, H, W), bool)
        pad[1, H - 16:] = True
        boxes = np.concatenate([rng.uniform(0.3, 0.7, (B, N, 2)),
                                rng.uniform(0.1, 0.3, (B, N, 2))], -1)
        out.append(dict(images=images, pad=pad, boxes=boxes.astype(np.float32),
                        labels=np.zeros((B, N), np.int64), valid=valid,
                        track_ids=np.array(ids[key], np.int64)))
    return out


def jax_frame(f):
    targets = JaxTargets.create(f["boxes"], f["labels"], f["valid"], f["track_ids"],
                                num_track_queries=T, hidden_dim=HIDDEN)
    return JaxImageBatch(images=jnp.asarray(f["images"]),
                         pad_mask=jnp.asarray(f["pad"])), targets


def torch_frame(f):
    t = torch.from_numpy
    targets = Targets.create(t(f["boxes"]), t(f["labels"]), t(f["valid"]),
                             t(f["track_ids"]), num_track_queries=T,
                             hidden_dim=HIDDEN)
    return ImageBatch(t(f["images"]), t(f["pad"])), targets


def torch_targets(jt) -> Targets:
    """A JAX Targets (numpy leaves) as the port's."""
    conv = {}
    for name in Targets.__dataclass_fields__:
        v = getattr(jt, name)
        if v is None:
            continue
        v = torch.from_numpy(np.array(v))
        conv[name] = v.long() if v.dtype == torch.int32 else v
    return Targets(**conv)


@pytest.fixture(scope="module")
def bridged():
    """The JAX model with seeded weights (the MSDA offset and attention
    kernels perturbed so sampling depends on the query), and the port model
    filled with the same weights."""
    jcfg, cfg = configs()
    jmodel, jcrit, _ = jax_build_model(jcfg)
    params = jax.device_get(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0), *jax_frame(frames()[0]))
    )
    rng = np.random.default_rng(PERTURB_SEED)

    def perturb(path, x):
        key = jax.tree_util.keystr(path)
        if ("sampling_offsets" in key or "attention_weights" in key) and "kernel" in key:
            return (x + rng.normal(0, 0.05, x.shape)).astype(x.dtype)
        return np.asarray(x)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    return jcfg, cfg, jmodel, jcrit, params


def port_model(cfg, params):
    model, _ = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    return model


def flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree["params"]).items()}


def test_param_labels_match_jax(bridged):
    jcfg, cfg, _, _, params = bridged
    model = port_model(cfg, params)
    ref = flatten_dict(jax_state.param_labels(params, jcfg)["params"])
    labels = param_labels(model, cfg)
    paths = {flax_path(model, n): n for n in labels}
    assert set(paths) == set(ref)  # the inverse bridge covers every leaf once
    for path, name in paths.items():
        assert labels[name] == ref[path], (name, path)
    counts = {g: list(labels.values()).count(g) for g in set(labels.values())}
    assert set(counts) == {"frozen", "backbone", "linear_proj", "base"}, counts


@pytest.mark.parametrize("lr_drop", [40, 0])
def test_clipped_adamw_step_matches_optax(bridged, lr_drop):
    """Random gradients with a global norm far above clip_max_norm 0.1,
    frozen leaves included: one port Optimizer step against the JAX
    package's optax chain (rtol 1e-5, atol 1e-8: float32 elementwise math in
    another order); frozen tensors stay bit-exact."""
    jcfg, cfg, _, _, params = bridged
    jcfg, cfg = jcfg.replace(lr_drop=lr_drop), cfg.replace(lr_drop=lr_drop)
    model = port_model(cfg, params)
    rng = np.random.default_rng(1)
    grads, jgrads = {}, {}
    for name, p in model.named_parameters():
        g = rng.normal(0, 1e-3, p.shape).astype(np.float32)
        grads[name] = g
        path = flax_path(model, name)
        jgrads[path] = to_flax_layout(model, name, g, flat(params)[path].shape)
    jtree = {"params": _unflatten(jgrads)}
    tx = jax_state.build_optimizer(jcfg, params, STEPS_PER_EPOCH)
    ref = flat(_optax_step(tx, jtree, params))
    assert _global_norm(jtree) > 10 * cfg.clip_max_norm

    opt = Optimizer(model, cfg, STEPS_PER_EPOCH)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[name].copy())  # clipped in place
    norm = opt.step()
    # the norm sums ~1e7 squares in float32, in another order
    np.testing.assert_allclose(float(norm), _global_norm(jtree), rtol=1e-4)
    labels = param_labels(model, cfg)
    for name, p in model.named_parameters():
        path = flax_path(model, name)
        got = to_flax_layout(model, name, p.detach().numpy(), ref[path].shape)
        if labels[name] == "frozen":
            np.testing.assert_array_equal(got, flat(params)[path], err_msg=name)
        np.testing.assert_allclose(got, ref[path], rtol=1e-5, atol=1e-8, err_msg=name)


def _optax_step(tx, grads, params):
    """params after one update of a fresh ``tx`` (one jitted program: the
    tree has hundreds of leaves, and eager dispatch compiles each op)."""
    return jax.jit(
        lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])
    )(grads, params)


def _global_norm(tree) -> float:
    return float(jax.jit(optax.global_norm)(tree))


def _unflatten(flat_dict):
    out = {}
    for path, v in flat_dict.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _jax_step(jmodel, jcrit, jcfg, params, monkeypatch):
    """One JAX train step; returns (losses, raw gradients, augmented
    targets). The gradients come out through an optimizer that stores them
    as its state; the augmented targets through a debug callback."""
    captured = {}
    make_aug = jax_augment.add_track_queries_to_targets

    def recording(*a, **kw):
        out = make_aug(*a, **kw)
        jax.debug.callback(lambda t: captured.setdefault("targets", t), out)
        return out

    monkeypatch.setattr(jax_augment, "add_track_queries_to_targets", recording)
    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )
    state = jax_state.TrainState.create(params, keep_grads)
    step = jax_make_train_step(jmodel, jcrit, keep_grads, jcfg)
    cur, prev = frames()
    new_state, losses = step(state, jax.random.PRNGKey(STEP_SEED),
                             *jax_frame(cur), *jax_frame(prev))
    grads = jax.device_get(new_state.opt_state)
    jax.effects_barrier()
    return ({k: float(v) for k, v in losses.items()}, grads,
            jax.tree_util.tree_map(np.asarray, captured["targets"]))


def _record_samples(monkeypatch):
    """Records the sampling locations of every MSDA call made with
    autograd on, as (level shapes, locations)."""
    calls = []
    for fn in ("ms_deform_attn", "ms_deform_attn_raw_pool"):
        orig = getattr(deformable_transformer, fn)

        def recording(src, shapes, loc, *rest, _orig=orig):
            if torch.is_grad_enabled():
                calls.append((shapes, loc.detach().double()))
            return _orig(src, shapes, loc, *rest)

        monkeypatch.setattr(deformable_transformer, fn, recording)
    return calls


def _kink_distance(calls) -> float:
    """The smallest distance in pixels from a sample's coordinate to an
    integer, where the bilinear weights have kinks: there the one-sided
    derivatives differ, and float32 rounding of ``loc * W - 0.5`` in either
    package picks a side (tests/test_msda.py:79-86)."""
    dist = 1.0
    for shapes, loc in calls:
        for lvl, (h, w) in enumerate(shapes):
            for c in (loc[..., lvl, :, 0] * w - 0.5, loc[..., lvl, :, 1] * h - 0.5):
                dist = min(dist, float((c - c.round()).abs().min()))
    return dist


def test_train_step_matches_jax(bridged, monkeypatch):
    jcfg, cfg, jmodel, jcrit, params = bridged
    ref_losses, ref_grads, aug = _jax_step(jmodel, jcrit, jcfg, params, monkeypatch)
    # the draw kept tracks and injected a false positive in every image
    assert aug.track_query_mask.sum(1).tolist() == [3, 3]
    assert (aug.track_query_fp_mask.sum(1) >= 1).all()
    samples = _record_samples(monkeypatch)

    model = port_model(cfg, params)
    model.train()
    opt = Optimizer(model, cfg, STEPS_PER_EPOCH)
    grads = {}
    clip = opt.clip_grads

    def recording_clip():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        return clip()

    opt.clip_grads = recording_clip
    monkeypatch.setattr(train_augment, "add_track_queries_to_targets",
                        lambda *a, **kw: torch_targets(aug))
    cur, prev = frames()
    step = make_train_step(model, build_criterion(cfg), opt, cfg)
    losses = step(*torch_frame(cur), *torch_frame(prev))
    assert _kink_distance(samples) > 1e-5

    # losses: every key of the JAX step, aux layers included
    assert set(ref_losses) <= set(losses)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    jflat = flat(ref_grads)
    np.testing.assert_allclose(
        float(losses["grad_norm"]), _global_norm(ref_grads), rtol=1e-4)

    # gradients: per tensor, within 1e-4 of its largest |entry| (rtol 1e-3),
    # plus 1e-6 of the largest gradient overall: the keys' biases in the
    # decoder self-attention have zero gradient analytically (softmax is
    # shift-invariant), so both packages return rounding noise there
    overall = max(np.abs(g).max() for g in jflat.values())
    for name, g in grads.items():
        path = flax_path(model, name)
        got = to_flax_layout(model, name, g.numpy(), jflat[path].shape)
        scale = np.abs(jflat[path]).max()
        np.testing.assert_allclose(got, jflat[path], rtol=1e-3,
                                   atol=1e-4 * scale + 1e-6 * overall, err_msg=name)

    # the update: optax's chain on the JAX gradients. Adam's first step is
    # -lr * g / (|g| + eps) for the clipped g, whose sensitivity to a
    # relative error r of g is lr * r * eps / (|g| + eps); so it is compared
    # where the clipped |g| exceeds 100 eps (1e-6), within 1e-3 lr (r 0.1)
    clip_scale = min(1.0, cfg.clip_max_norm / _global_norm(ref_grads))
    tx = jax_state.build_optimizer(jcfg, params, STEPS_PER_EPOCH)
    ref_new = flat(_optax_step(tx, ref_grads, params))
    before = flat(params)
    labels = param_labels(model, cfg)
    compared = 0
    for name, p in model.named_parameters():
        path = flax_path(model, name)
        got = to_flax_layout(model, name, p.detach().numpy(), ref_new[path].shape)
        if labels[name] == "frozen":
            np.testing.assert_array_equal(got, before[path], err_msg=name)
            continue
        big = np.abs(jflat[path]) * clip_scale > 1e-6
        np.testing.assert_allclose(got[big], ref_new[path][big], rtol=1e-5,
                                   atol=1e-3 * cfg.lr, err_msg=name)
        compared += int(big.sum())
    assert compared > 1000


def _train_forward(model, seed):
    """One forward + backward of the current frame in train() mode, with
    the dropout generator seeded: (pred_logits, gradients)."""
    model.train()
    model.dropout_rng.generator = torch.Generator().manual_seed(seed)
    model.zero_grad()
    cur, _ = frames()
    out = model(*torch_frame(cur))
    (out["pred_logits"].square().sum() + out["pred_boxes"].sum()).backward()
    return out["pred_logits"].detach(), {
        n: p.grad.clone() for n, p in model.named_parameters()
        if p.grad is not None
    }


def test_dropout_only_in_train_mode_and_remat_replays_it(bridged):
    _, cfg, _, _, params = bridged
    cfg = cfg.replace(dropout=0.1)
    model = port_model(cfg, params)
    cur, _ = frames()
    model.eval()
    with torch.no_grad():
        a = model(*torch_frame(cur))["pred_logits"]
        b = model(*torch_frame(cur))["pred_logits"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    l1, g1 = _train_forward(model, 7)
    l2, _ = _train_forward(model, 7)
    l3, _ = _train_forward(model, 8)
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)  # same generator state
    assert not torch.allclose(l1, a) and not torch.allclose(l1, l3)

    remat = port_model(cfg.replace(remat=True), params)
    l4, g4 = _train_forward(remat, 7)
    torch.testing.assert_close(l4, l1, rtol=0, atol=0)
    assert set(g4) == set(g1)
    for n in g1:  # recomputation in the backward draws the same masks
        torch.testing.assert_close(g4[n], g1[n], rtol=1e-5, atol=1e-7, msg=n)


def test_model_trains_after_serving_in_inference_mode(bridged):
    _, cfg, _, _, params = bridged
    model = port_model(cfg, params)
    cur, _ = frames(seed=5)
    with torch.inference_mode():
        model(*torch_frame(cur))  # fills the cached constants
    _, grads = _train_forward(model, 0)
    assert all(torch.isfinite(g).all() for g in grads.values())
