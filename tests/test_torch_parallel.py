"""kinet_tpu_torch's tensor-parallel training (``parallel/mesh.py``,
``parallel/tp.py``) on the CPU, over gloo processes
(``test_torch_dist.py::run_processes``), at JAX ``tests/test_parallel.py``'s
tiny configuration (float32, dropout 0, the track-query simulation's
false positives and negatives off).

- ``make_mesh`` on 4 processes (2 x 2): axis names, ranks and the ranks of
  each subgroup (model groups are consecutive ranks); a product other than
  the process count raises; without a group the mesh is 1 x 1 and a train
  step with it is the step with no mesh, bit for bit;
- ``tp_partition_specs`` gives each parameter the dimension JAX's
  ``tp_partition_specs`` shards, parameter by parameter through
  ``tools/from_jax.py``'s paths and layouts; more than 20 are sharded
  (JAX :259-265);
- the weights are JAX's tiny model's (``tools/from_jax.py``; the MSDA
  offset and weight kernels perturbed so the samples depend on the
  query), and step 0 takes the track queries that JAX's train step drew;
- 2 processes at ``mesh.model = 2`` (both stepping the whole batch of 4)
  and a 2 x 2 mesh (each data rank its half) against 1 process on the
  batch: logits within atol 2e-5 and each step's loss within rtol 5e-3
  (JAX :295-299); every gathered gradient and every parameter after 2
  steps within rtol 1e-4, atol 1e-5; the ranks of a model group hold the
  same whole parameters;
- each of these runs and 1 process against the JAX package on the same
  inputs: logits (``model.apply``) within atol 2e-5 and step 0's loss
  within rtol 5e-3 (JAX :295-299), and step 0's gathered gradient against
  JAX's train step's, each tensor within 1e-4 of its largest entry plus
  1e-6 of the largest gradient (rtol 1e-3), as
  ``test_torch_train_step.py`` holds 1 process;
- the replicated parameters' gradients are averaged over the model group
  (ranks that differ agree afterwards), the shards' never mixed;
- ``evaluate()`` of the stepped models over a MOT tree's 4 val images
  (each data group its shard) gives 1 process's 12 COCO stats and, image
  by image, its scores (atol 1e-4);
- the checkpoint: saved at TP=2 (whole tensors, rank 0 writes), it resumes
  at TP=2 and in 1 process, parameters and AdamW moments bit for bit;
- the row- and column-parallel modules' backward: the input's gradient is
  the unsharded one and the same on both ranks.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_dist import run_processes, write_mot_tree

NAMED = ["train_deformable", "train_tracking"]
TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=32, nheads=2,
    enc_layers=1, dec_layers=1, dim_feedforward=64, num_queries=8,
    max_track_queries=8, dropout=0.0, aux_loss=False,
    num_feature_levels=2, dec_n_points=2, enc_n_points=2,
    with_box_refine=False, compute_dtype="float32", max_objects=2,
    track_query_false_positive_prob=0.0, track_query_false_negative_prob=0.0,
)
B, H, W, STEPS = 4, 64, 64, 2


def _cfg(**over):
    from kinet_tpu_torch.config import load_config

    return load_config("train.yaml", named=NAMED).replace(**{**TINY, **over})


def _frames(step):
    """[(images, boxes)] of the current and the previous frame of the
    batch of B at train step ``step`` (numpy): noise frames and two
    distinct boxes an image (identical boxes tie every matching cost)."""
    out = []
    for f in (0, 1):  # current, previous
        rng = np.random.default_rng(1000 * step + 10 * f)
        imgs = rng.normal(size=(B, H, W, 3)).astype(np.float32)
        boxes = np.tile(np.asarray([[[0.3, 0.3, 0.2, 0.2],
                                     [0.7, 0.6, 0.15, 0.25]]], np.float32),
                        (B, 1, 1))
        boxes[:, :, :2] += rng.uniform(-0.05, 0.05, (B, 2, 2))
        out.append((imgs, boxes))
    return out


def _inputs(images, step):
    """(batch, targets, prev_batch, prev_targets) of ``images`` (indices
    into the batch of B) at train step ``step``."""
    from kinet_tpu_torch.structs import ImageBatch, Targets

    out = []
    n = len(images)
    for imgs, boxes in _frames(step):
        targets = Targets.create(
            torch.from_numpy(boxes[images]),
            torch.zeros(n, 2, dtype=torch.int64),
            torch.ones(n, 2, dtype=torch.bool),
            track_ids=torch.arange(2).expand(n, 2).clone(),
            num_track_queries=8, hidden_dim=32)
        out += [ImageBatch(torch.from_numpy(imgs[images]),
                           torch.zeros(n, H, W, dtype=torch.bool)), targets]
    return out


def _jax_reference():
    """The JAX tiny model on the batch of B at step 0: its weights (numpy;
    MSDA offset and weight kernels perturbed so the samples depend on the
    query), its logits (``model.apply``), and its train step's loss, raw
    gradients (flat by flax path) and augmented targets (the port's
    ``Targets``). The gradients come out through an optimizer that keeps
    them as its state, the targets through a debug callback."""
    import jax.numpy as jnp
    import optax

    from kinet_tpu.config import load_config as jax_load_config
    from kinet_tpu.engine.state import TrainState
    from kinet_tpu.engine.train_step import make_train_step
    from kinet_tpu.models.build import build_model as jax_build_model
    from kinet_tpu.structs import ImageBatch, Targets
    from kinet_tpu.tracking import train_augment
    from test_torch_train_step import flat, torch_targets

    jcfg = jax_load_config("train.yaml", named=NAMED).replace(**TINY)
    model, criterion, _ = jax_build_model(jcfg)
    inputs = []
    for imgs, boxes in _frames(0):
        inputs += [ImageBatch(images=jnp.asarray(imgs),
                              pad_mask=jnp.zeros((B, H, W), bool)),
                   Targets.create(jnp.asarray(boxes),
                                  jnp.zeros((B, 2), jnp.int32),
                                  jnp.ones((B, 2), bool),
                                  jnp.tile(jnp.arange(2), (B, 1)),
                                  num_track_queries=8, hidden_dim=32)]
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(1),
                                                *inputs[:2]))
    rng = np.random.default_rng(1)

    def perturb(path, x):
        key = jax.tree_util.keystr(path)
        if (("sampling_offsets" in key or "attention_weights" in key)
                and "kernel" in key):
            return (x + rng.normal(0, 0.05, x.shape)).astype(x.dtype)
        return np.asarray(x)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    logits = jax.jit(lambda p, b, t: model.apply(
        p, b, t, deterministic=True)["pred_logits"])(params, *inputs[:2])
    captured = {}
    make_aug = train_augment.add_track_queries_to_targets

    def recording(*a, **kw):
        out = make_aug(*a, **kw)
        jax.debug.callback(lambda t: captured.setdefault("targets", t), out)
        return out

    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_augment, "add_track_queries_to_targets", recording)
        step = make_train_step(model, criterion, keep_grads, jcfg)
        state, losses = step(TrainState.create(params, keep_grads),
                             jax.random.PRNGKey(2), *inputs)
        grads = jax.device_get(state.opt_state)
        jax.effects_barrier()
    aug = torch_targets(jax.tree_util.tree_map(np.asarray,
                                               captured["targets"]))
    return dict(params=params, logits=torch.from_numpy(np.array(logits)),
                loss=float(losses["loss"]), grads=flat(grads), aug=aug)


def _take(targets, images):
    """The rows ``images`` of every tensor of ``targets``."""
    from dataclasses import fields, replace

    return replace(targets, **{
        f.name: getattr(targets, f.name)[images] for f in fields(targets)
        if getattr(targets, f.name) is not None})


def _steps(rank, world, tmp, params, aug, n_model=1, use_mesh=True):
    """STEPS train steps of the model with the JAX weights ``params``, step
    0 taking the augmented targets ``aug`` (JAX's draw); returns the logits
    of a forward before them, the losses, step 0's and the last step's
    gathered gradients (unclipped, clipped) and the whole parameters after
    the last (and the mesh, checkpoint and gradient-reduction checks under
    a group)."""
    import torch.distributed as tdist

    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import make_train_step
    from kinet_tpu_torch.models.build import build_criterion, build_model
    from kinet_tpu_torch.parallel.mesh import make_mesh
    from kinet_tpu_torch.parallel.tp import (
        full_state_dict,
        shard_params_tp,
        sharded_dims,
    )
    from kinet_tpu_torch.tools.from_jax import load_jax_params
    from kinet_tpu_torch.tracking import train_augment
    from kinet_tpu_torch.utils.dist import all_gather_cat

    cfg = _cfg(lr=1e-4)
    out = {}
    mesh = None
    if use_mesh:
        mesh = make_mesh(-1, n_model)
        if world == 4:
            out["mesh"] = _mesh_facts(mesh)
            try:
                make_mesh(3, 2)
            except ValueError as e:
                out["bad_product"] = str(e)
    model, _ = build_model(cfg, device="cpu", seed=0)
    load_jax_params(model, params)
    if mesh is not None:
        shard_params_tp(model, mesh)
    model.train()
    images = (list(range(B)) if mesh is None or mesh.data == 1 else
              list(range(B))[mesh.data_rank::mesh.data])
    with torch.no_grad():
        out["logits"] = model(*_inputs(images, 0)[:2])["pred_logits"].clone()
    opt = Optimizer(model, cfg, 100)
    dims = sharded_dims(model)
    group = None if mesh is None else mesh.model_group

    def whole_grads():  # a parameter with no gradient: zeros (as JAX's)
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in model.named_parameters()}
        return {n: all_gather_cat(g, dims[n], group) if n in dims
                else g.clone() for n, g in grads.items()}

    update, make_aug = opt.step, train_augment.add_track_queries_to_targets

    def first_step():  # step 0's gradients, reduced and unclipped
        out["grads0"] = whole_grads()
        opt.step = update
        return update()

    def jax_draw(*a, **kw):  # step 0 takes JAX's augmented targets
        train_augment.add_track_queries_to_targets = make_aug
        return _take(aug, images)

    opt.step, train_augment.add_track_queries_to_targets = first_step, jax_draw
    try:
        step = make_train_step(model, build_criterion(cfg), opt, cfg,
                               generator=torch.Generator().manual_seed(5))
        out["losses"] = [float(step(*_inputs(images, s))["loss"])
                         for s in range(STEPS)]
    finally:
        train_augment.add_track_queries_to_targets = make_aug
    out["grads"] = whole_grads()
    out["params"] = {k: v.clone() for k, v in full_state_dict(model).items()}
    out["sharded"] = len(dims)
    out["eval"] = _evaluate(tmp, model)
    if world > 1:
        out["resume"] = _checkpoint(tmp, world, cfg, mesh, model, opt)
    if world == 2:
        out["backward"] = _parallel_backward(mesh)
    if world > 1:
        out["reduced"] = _reduced_grads(model, opt)
    if use_mesh and world > 1:
        tdist.barrier()
    return out


def _reduced_grads(model, opt):
    """Gives every gradient the value rank + 1 and reduces them as the
    train step does: {parameter name: (smallest, largest) entry, whether
    it is sharded}."""
    import torch.distributed as tdist

    from kinet_tpu_torch.engine.train_step import _reduce_grads
    from kinet_tpu_torch.parallel.tp import sharded_dims

    for p in opt.params:
        p.grad = torch.full_like(p, tdist.get_rank() + 1.0)
    _reduce_grads(opt)
    dims = sharded_dims(model)
    return {n: (float(p.grad.min()), float(p.grad.max()), n in dims)
            for n, p in model.named_parameters()}


def _evaluate(tmp, model):
    """evaluate() of ``model`` over the 4 val images of the MOT tree under
    tmp/mot, each data group its shard (batch 1): the 12 COCO stats and
    the merged predictions' scores by image."""
    from kinet_tpu_torch.data.builder import build_dataset
    from kinet_tpu_torch.engine import evaluate as ev
    from kinet_tpu_torch.models.build import build_criterion
    from kinet_tpu_torch.models.postprocess import build_postprocessors

    merged = {}

    class Recording(ev.CocoEvaluator):
        def accumulate(self):
            merged.update({i: p["scores"] for i, p in self.preds.items()})
            return super().accumulate()

    cfg = _cfg(mot_path_train=f"{tmp}/mot", mot_path_val=f"{tmp}/mot",
               batch_size=1, max_objects=6, num_workers=1,
               tracking_eval=False, size_buckets=[[64, 96]],
               **{"img_transform.max_size": 96,
                  "img_transform.val_width": 64})
    evaluator, ev.CocoEvaluator = ev.CocoEvaluator, Recording
    try:
        stats = ev.evaluate(model, build_criterion(cfg),
                            build_postprocessors(cfg),
                            build_dataset("val", cfg), cfg, device="cpu")
    finally:
        ev.CocoEvaluator = evaluator
    return list(stats["coco_eval_bbox"]), merged


def _mesh_facts(mesh):
    import torch.distributed as tdist

    def ranks(g):
        return None if g is None else tdist.get_process_group_ranks(g)

    return dict(axis_names=mesh.axis_names, shape=mesh.shape,
                data_rank=mesh.data_rank, model_rank=mesh.model_rank,
                data_group=ranks(mesh.data_group),
                model_group=ranks(mesh.model_group))


def _checkpoint(tmp, world, cfg, mesh, model, opt):
    """Saves a checkpoint (every rank; rank 0 writes), resumes it into a
    fresh model on the same mesh; returns whether the resumed whole
    parameters and moments are the saved ones, bit for bit."""
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.parallel.tp import full_state_dict, shard_params_tp
    from kinet_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        load_for_resume,
    )
    import torch.distributed as tdist

    path = f"{tmp}/ckpt{world}"
    CheckpointManager(path).save_epoch(model, opt, STEPS, 1)
    tdist.barrier()
    fresh, _ = build_model(cfg, device="cpu", seed=3)
    shard_params_tp(fresh, mesh)
    fresh_opt = Optimizer(fresh, cfg, 100)
    load_for_resume(cfg.replace(resume=f"{path}/checkpoint.pth",
                                resume_optim=True), fresh, fresh_opt)
    want, got = full_state_dict(model), full_state_dict(fresh)
    same = all(torch.equal(want[k], got[k]) for k in want)
    a, b = opt.state_dict()["adamw"], fresh_opt.state_dict()["adamw"]
    same_moments = all(torch.equal(a["state"][i][k], b["state"][i][k])
                       for i in a["state"] for k in a["state"][i])
    return same, same_moments


def _parallel_backward(mesh):
    """The input gradient of each parallel module against the unsharded
    module's (max error), on replicated inputs."""
    from torch import nn

    from kinet_tpu_torch.parallel.tp import (
        ColumnParallelConv2d,
        ColumnParallelLinear,
        RowParallelLinear,
    )

    g = torch.Generator().manual_seed(11)
    out = {}
    cases = [("row", nn.Linear(8, 6), RowParallelLinear, (3, 5, 8)),
             ("column", nn.Linear(6, 8), ColumnParallelLinear, (3, 6)),
             ("conv", nn.Conv2d(3, 4, 3, padding=1), ColumnParallelConv2d,
              (2, 3, 5, 5))]
    for name, whole, cls, shape in cases:
        with torch.no_grad():
            for p in whole.parameters():
                p.normal_(generator=g)
        x = torch.randn(*shape, generator=g)
        y_whole = whole(x)
        c = torch.randn(y_whole.shape, generator=g)
        x1 = x.clone().requires_grad_()
        (whole(x1) * c).sum().backward()
        x2 = x.clone().requires_grad_()
        part = cls(whole, mesh.model_group)
        y = part(x2)
        (y * c).sum().backward()
        out[name] = (float((y - y_whole).abs().max()),
                     float((x2.grad - x1.grad).abs().max()), x2.grad.clone())
    return out


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    write_mot_tree(tmp / "mot")
    ref = _jax_reference()
    args = (ref["params"], ref["aug"])
    return {
        "one": _steps(0, 1, str(tmp), *args, use_mesh=False),
        "mesh11": _steps(0, 1, str(tmp), *args),
        "tp2": run_processes(_steps, 2, tmp, *args, 2),
        "dp2tp2": run_processes(_steps, 4, tmp, *args, 2),
        "jax": ref,
        "tmp": tmp,
    }


def test_make_mesh_on_four_processes(runs):
    facts = [r["mesh"] for r in runs["dp2tp2"]]
    for rank, f in enumerate(facts):
        assert f["axis_names"] == ("data", "model")
        assert f["shape"] == {"data": 2, "model": 2}
        assert (f["data_rank"], f["model_rank"]) == divmod(rank, 2)
        assert f["model_group"] == [rank - rank % 2, rank - rank % 2 + 1]
        assert f["data_group"] == [rank % 2, rank % 2 + 2]
        assert "mesh.data 3 x mesh.model 2 != 4" in \
            runs["dp2tp2"][rank]["bad_product"]


def test_one_by_one_mesh_is_no_mesh():
    from kinet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    assert (mesh.data, mesh.model, mesh.data_group, mesh.model_group) == (
        1, 1, None, None)
    with pytest.raises(ValueError, match="mesh.data 2 x mesh.model 1 != 1"):
        make_mesh(2, 1)


def test_one_by_one_mesh_step_is_bit_identical(runs):
    one, mesh = runs["one"], runs["mesh11"]
    assert one["losses"] == mesh["losses"]
    assert torch.equal(one["logits"], mesh["logits"])
    for k, v in one["params"].items():
        assert torch.equal(v, mesh["params"][k]), k
    for k, v in one["grads"].items():
        assert torch.equal(v, mesh["grads"][k]), k


def test_tp_specs_agree_with_jax():
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from kinet_tpu.config import load_config as jax_load_config
    from kinet_tpu.models.build import build_model as jax_build_model
    from kinet_tpu.parallel.tp import tp_partition_specs as jax_specs
    from kinet_tpu.structs import ImageBatch as JaxImageBatch
    from kinet_tpu.structs import Targets as JaxTargets
    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.parallel.tp import tp_partition_specs
    from kinet_tpu_torch.tools.from_jax import _resolve, flax_path

    jcfg = jax_load_config("train.yaml", named=NAMED).replace(**{
        k: v for k, v in TINY.items() if not k.startswith("track_query")})
    jmodel, _, _ = jax_build_model(jcfg)
    batch = JaxImageBatch(images=jnp.zeros((1, H, W, 3)),
                          pad_mask=jnp.zeros((1, H, W), bool))
    targets = JaxTargets.create(
        jnp.full((1, 2, 4), 0.5), jnp.zeros((1, 2), jnp.int32),
        jnp.ones((1, 2), bool), num_track_queries=8, hidden_dim=32)
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch,
                            targets)["params"]
    specs = jax_specs(params, 2)
    model, _ = build_model(_cfg(), device="cpu")
    ours = tp_partition_specs(model, 2)
    assert ours.keys() == dict(model.named_parameters()).keys()
    n_sharded = 0
    for name, dim in ours.items():
        path = flax_path(model, name)
        spec, leaf = specs, params
        for seg in path:
            spec, leaf = spec[seg], leaf[seg]
        assert isinstance(spec, P), name
        j = [i for i, a in enumerate(spec) if a == "model"]
        if not j:
            assert dim is None, (name, spec)
            continue
        # the flax dim's index, carried to the port's layout: it varies
        # along the port dimension that holds the shards
        idx = np.indices(leaf.shape)[j[0]]
        port = _resolve(model, name)[1](idx)
        varies = [t for t in range(port.ndim)
                  if np.ptp(port, axis=t).any()]
        assert varies == [dim], (name, spec, varies, dim)
        n_sharded += 1
    assert n_sharded > 20, n_sharded


def _close(a, b, msg, rtol=1e-4, atol=1e-5):
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=msg)


@pytest.mark.parametrize("run", ["tp2", "dp2tp2"])
def test_tensor_parallel_steps_equal_one_process(runs, run):
    one, procs = runs["one"], runs[run]
    n = len(procs)
    assert procs[0]["sharded"] > 20
    for r, got in enumerate(procs):
        images = list(range(B)) if n == 2 else list(range(B))[r // 2::2]
        torch.testing.assert_close(got["logits"], one["logits"][images],
                                   rtol=0, atol=2e-5, msg=f"rank {r} logits")
    for s in range(STEPS):
        loss = np.mean([got["losses"][s] for got in procs])
        assert loss == pytest.approx(one["losses"][s], rel=5e-3), s
    for r, got in enumerate(procs):
        for k, v in one["grads"].items():
            _close(got["grads"][k], v, f"rank {r} gradient {k}")
        for k, v in one["params"].items():
            _close(got["params"][k], v, f"rank {r} parameter {k}")
            assert torch.equal(got["params"][k], procs[r ^ 1]["params"][k])
        # evaluate(): each data group its shard of the val images, every
        # rank of a model group stepping the same ones
        np.testing.assert_allclose(got["eval"][0], one["eval"][0],
                                   atol=1e-6)
        assert sorted(got["eval"][1]) == sorted(one["eval"][1]) == [0, 1, 2, 3]
        for i, scores in one["eval"][1].items():
            np.testing.assert_allclose(got["eval"][1][i], scores, atol=1e-4)


@pytest.mark.parametrize("run", ["one", "tp2", "dp2tp2"])
def test_step_zero_equals_jax(runs, run):
    """The port's logits, step 0's loss and its gathered gradient against
    the JAX package's on the same weights and inputs."""
    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.tools.from_jax import flax_path, to_flax_layout

    ref = runs["jax"]
    procs = runs[run] if run != "one" else [runs["one"]]
    for r, got in enumerate(procs):
        images = (list(range(B)) if len(procs) < 4 else
                  list(range(B))[r // 2::2])
        torch.testing.assert_close(got["logits"], ref["logits"][images],
                                   rtol=0, atol=2e-5, msg=f"rank {r} logits")
    loss = np.mean([got["losses"][0] for got in procs])
    assert loss == pytest.approx(ref["loss"], rel=5e-3)
    # each tensor within 1e-4 of its largest |entry| (rtol 1e-3), plus 1e-6
    # of the largest gradient overall (test_torch_train_step.py: the keys'
    # biases in attention have zero gradient analytically, and both
    # packages return rounding noise there)
    model, _ = build_model(_cfg(), device="cpu")
    overall = max(np.abs(g).max() for g in ref["grads"].values())
    for r, got in enumerate(procs):
        assert got["grads0"].keys() == dict(model.named_parameters()).keys()
        for name, g in got["grads0"].items():
            want = ref["grads"][flax_path(model, name)]
            np.testing.assert_allclose(
                to_flax_layout(model, name, g.numpy(), want.shape), want,
                rtol=1e-3, atol=1e-4 * np.abs(want).max() + 1e-6 * overall,
                err_msg=f"rank {r} gradient {name}")


@pytest.mark.parametrize("run", ["tp2", "dp2tp2"])
def test_replicated_gradients_are_averaged_over_the_model_group(runs, run):
    """Each rank gave every gradient the value rank + 1: after the data
    group's mean, a replicated parameter's gradient is also averaged over
    the model group, so all its copies agree; a shard's stays its data
    group's mean."""
    procs = runs[run]
    n_sharded = 0
    for r, got in enumerate(procs):
        model_rank = r % 2
        data = ([r + 1] if len(procs) == 2 else
                [model_rank + 1, model_rank + 3])  # the data group's ranks
        for name, (lo, hi, sharded) in got["reduced"].items():
            want = (np.mean(data) if sharded else
                    np.mean(range(1, len(procs) + 1)))
            assert lo == hi == want, (r, name, lo, hi, want)
            n_sharded += sharded
    assert n_sharded > 20 * len(procs)


def test_tp_checkpoint_resumes_at_tp2_and_in_one_process(runs):
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.utils.checkpoint import load_for_resume

    for got in runs["tp2"]:
        assert got["resume"] == (True, True)
    path = runs["tmp"] / "ckpt2" / "checkpoint.pth"
    ckpt = torch.load(path, weights_only=True)
    cfg = _cfg(resume=str(path), resume_optim=True)
    model, _ = build_model(cfg, device="cpu", seed=3)
    opt = Optimizer(model, cfg, 100)
    start_epoch, step = load_for_resume(cfg, model, opt)
    assert (start_epoch, step) == (2, STEPS)
    for k, v in model.state_dict().items():
        assert torch.equal(v, runs["tp2"][0]["params"][k]), k
    state = opt.state_dict()["adamw"]["state"]
    for i, st in ckpt["opt_state"]["adamw"]["state"].items():
        for k, v in st.items():
            assert torch.equal(state[i][k], v), (i, k)


@pytest.mark.parametrize("kind", ["row", "column", "conv"])
def test_parallel_module_backward(runs, kind):
    grads = []
    for got in runs["tp2"]:
        y_err, g_err, grad = got["backward"][kind]
        assert y_err <= 1e-5 and g_err <= 1e-5, (kind, y_err, g_err)
        grads.append(grad)
    assert torch.equal(grads[0], grads[1])  # replicated on both ranks
