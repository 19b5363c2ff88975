"""kinet_tpu_torch matcher, LSAP and criterion against the JAX package on
the same numpy-seeded predictions and targets: padded target rows, and
track slots that are pinned (matched), false positive or inactive.

- LSAP: the host solver gives the JAX on-device solver's assignment
  (random continuous costs have one optimum);
- the cost matrix: rtol 1e-5; the matches: identical;
- every loss key, the auxiliary layers' included: rtol 1e-5, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu.models import criterion as jax_criterion
from kinet_tpu.models import matcher as jax_matcher
from kinet_tpu.ops import lap as jax_lap
from kinet_tpu.structs import Targets as JaxTargets
from kinet_tpu_torch.models import criterion, matcher
from kinet_tpu_torch.ops import lap
from kinet_tpu_torch.structs import Targets

B, Q, N, T, C = 2, 14, 5, 4, 3


def _case(seed, focal=True):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, Q, C if focal else C + 1)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)),
                            rng.uniform(0.05, 0.3, (B, Q, 2))], -1).astype(np.float32)
    tboxes = np.concatenate([rng.uniform(0.2, 0.8, (B, N, 2)),
                             rng.uniform(0.05, 0.3, (B, N, 2))], -1).astype(np.float32)
    labels = rng.integers(0, C, (B, N)).astype(np.int32)
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)  # padded rows
    # slot 0 pinned to target 1, slot 1 a false positive, slot 2 a kept
    # track that vanished (fp flag, no match), slot 3 inactive
    tq_mask = np.array([[1, 1, 1, 0]] * B, bool)
    tq_fp = np.array([[0, 1, 1, 0]] * B, bool)
    tq_match = np.array([[1, -1, -1, -1], [2, -1, -1, -1]], np.int32)
    query_valid = np.ones((B, Q), bool)
    query_valid[:, :T] = tq_mask
    aux = [(rng.normal(size=logits.shape).astype(np.float32),
            np.clip(boxes + rng.normal(0, 0.02, boxes.shape), 0.01, 0.99)
            .astype(np.float32))]
    return dict(logits=logits, boxes=boxes, tboxes=tboxes, labels=labels,
                valid=valid, tq_mask=tq_mask, tq_fp=tq_fp, tq_match=tq_match,
                query_valid=query_valid, aux=aux)


def _targets(c, jax_side):
    if jax_side:
        return JaxTargets.create(c["tboxes"], c["labels"], c["valid"],
                                 num_track_queries=T, hidden_dim=8).replace(
            track_query_mask=jnp.asarray(c["tq_mask"]),
            track_query_fp_mask=jnp.asarray(c["tq_fp"]),
            track_query_match_ids=jnp.asarray(c["tq_match"]))
    t = torch.from_numpy
    return Targets.create(t(c["tboxes"]), t(c["labels"]), t(c["valid"]),
                          num_track_queries=T, hidden_dim=8).replace(
        track_query_mask=t(c["tq_mask"]), track_query_fp_mask=t(c["tq_fp"]),
        track_query_match_ids=t(c["tq_match"]).long())


def _outputs(c, jax_side):
    conv = jnp.asarray if jax_side else torch.from_numpy
    out = {"pred_logits": conv(c["logits"]), "pred_boxes": conv(c["boxes"]),
           "query_valid": conv(c["query_valid"])}
    out["aux_outputs"] = [{"pred_logits": conv(lg), "pred_boxes": conv(bx)}
                          for lg, bx in c["aux"]]
    return out


def test_lsap_matches_jax_solver():
    rng = np.random.default_rng(0)
    cost = rng.normal(size=(3, 6, 9)).astype(np.float32)
    valid = rng.uniform(size=(3, 6)) < 0.7
    ref = np.asarray(jax_lap.solve_lsap_masked(jnp.asarray(cost), jnp.asarray(valid)))
    out = lap.solve_lsap_masked(torch.from_numpy(cost), torch.from_numpy(valid))
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError):
        lap.solve_lsap_masked(torch.zeros(1, 4, 3), torch.ones(1, 4, dtype=torch.bool))


@pytest.mark.parametrize("focal", [True, False])
def test_cost_matrix_and_match_match_jax(focal):
    c = _case(1, focal)
    kw = dict(cost_class=2.0, cost_bbox=5.0, cost_giou=2.0, focal_loss=focal,
              focal_alpha=0.25, focal_gamma=2.0)
    ref_cost = np.asarray(jax_matcher.build_cost_matrix(
        jnp.asarray(c["logits"]), jnp.asarray(c["boxes"]), _targets(c, True), **kw))
    cost = matcher.build_cost_matrix(torch.from_numpy(c["logits"]),
                                     torch.from_numpy(c["boxes"]),
                                     _targets(c, False), **kw)
    np.testing.assert_allclose(cost.numpy(), ref_cost, rtol=1e-5, atol=1e-6)
    ref = np.asarray(jax_matcher.hungarian_match(
        jnp.asarray(c["logits"]), jnp.asarray(c["boxes"]), _targets(c, True), **kw))
    q4t = matcher.hungarian_match(torch.from_numpy(c["logits"]),
                                  torch.from_numpy(c["boxes"]),
                                  _targets(c, False), **kw)
    np.testing.assert_array_equal(q4t.numpy(), ref)
    # the pinned target takes its track slot; blocked slots take nothing
    assert q4t[0, 1] == 0 and q4t[1, 2] == 0
    assert not np.isin(q4t.numpy(), [1, 2, 3]).any()
    assert (q4t.numpy()[~c["valid"]] == -1).all()


@pytest.mark.parametrize("focal", [True, False])
def test_criterion_losses_match_jax(focal):
    c = _case(2, focal)
    kw = dict(num_classes=C, eos_coef=0.1, focal_loss=focal, focal_alpha=0.25,
              focal_gamma=2.0, tracking=True,
              track_query_false_positive_eos_weight=True, cost_class=2.0,
              cost_bbox=5.0, cost_giou=2.0)
    wd = {"loss_ce": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0,
          "loss_ce_0": 2.0, "loss_bbox_0": 5.0, "loss_giou_0": 2.0}
    jcrit = jax_criterion.SetCriterion(weight_dict=wd, **kw)
    ref = jax.jit(lambda o, t: (lambda l: (l, jcrit.total_loss(l)))(jcrit(o, t)))(
        _outputs(c, True), _targets(c, True))
    crit = criterion.SetCriterion(weight_dict=wd, **kw)
    losses = crit(_outputs(c, False), _targets(c, False))
    assert set(losses) == set(ref[0])
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(ref[0][k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(crit.total_loss(losses)), float(ref[1]),
                               rtol=1e-5)
