"""kinet_tpu_torch track-query simulation (``tracking/train_augment.py``)
against the JAX package's, on the same numpy-seeded previous-frame outputs.
The two draw from different generators, so:

- the deterministic part (false_negative_prob 0, false_positive_prob 0)
  is compared with JAX: the kept set, its match ids and its false-positive
  flags (vanished tracks), per image; slot order is a random permutation in
  both, so slots are compared as a set;
- the random draws are held to their invariants over many seeds: counts
  shared by the batch and in range, false positives never matched and
  never repeated, distance-weighted false-positive draws;
- the previous-frame chain runs without gradient unless
  ``backprop_prev_frame``.
"""
import jax
import numpy as np
import torch

from kinet_tpu.structs import Targets as JaxTargets
from kinet_tpu.tracking.train_augment import (
    add_track_queries_to_targets as jax_add_track_queries,
)
from kinet_tpu_torch.structs import Targets
from kinet_tpu_torch.tracking.train_augment import (
    add_track_queries_to_targets,
    tracking_train_forward,
)

B, N, Q, D, T = 2, 6, 10, 16, 8
# previous frame: image 0 has tracks 10-13 on queries 0, 3, 5, 7; image 1
# tracks 10-12 on queries 2, 4, 9 (3 matched: the batch keeps at most 3)
PREV_IDS = [[10, 11, 12, 13, -1, -1], [10, 11, 12, -1, -1, -1]]
Q4T = [[0, 3, 5, 7, -1, -1], [2, 4, 9, -1, -1, -1]]
# current frame: image 0 keeps 11 and 13 (10 and 12 vanish), image 1 keeps
# 10 and 12 (11 vanishes); 99 is new
CUR_IDS = [[11, 13, 99, -1, -1, -1], [12, 99, 10, -1, -1, -1]]


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    prev_ids, cur_ids = np.array(PREV_IDS), np.array(CUR_IDS)
    arrays = dict(
        prev_boxes=rng.uniform(0.2, 0.8, (B, N, 4)).astype(np.float32),
        prev_valid=prev_ids >= 0, prev_ids=prev_ids,
        cur_boxes=rng.uniform(0.2, 0.8, (B, N, 4)).astype(np.float32),
        cur_valid=cur_ids >= 0, cur_ids=cur_ids,
        q4t=np.array(Q4T, np.int32),
        hs=rng.normal(size=(B, Q, D)).astype(np.float32),
        boxes=rng.uniform(0, 1, (B, Q, 4)).astype(np.float32),
    )
    return arrays


def _port_inputs(a):
    t = torch.from_numpy
    labels = torch.zeros(B, N, dtype=torch.int64)
    prev = Targets.create(t(a["prev_boxes"]), labels, t(a["prev_valid"]),
                          t(a["prev_ids"]), num_track_queries=T, hidden_dim=D)
    cur = Targets.create(t(a["cur_boxes"]), labels, t(a["cur_valid"]),
                         t(a["cur_ids"]), num_track_queries=T, hidden_dim=D)
    out = {"hs_embed": t(a["hs"]), "pred_boxes": t(a["boxes"])}
    return cur, prev, t(a["q4t"]).long(), out


def _jax_inputs(a):
    labels = np.zeros((B, N), np.int32)
    prev = JaxTargets.create(a["prev_boxes"], labels, a["prev_valid"],
                             a["prev_ids"], num_track_queries=T, hidden_dim=D)
    cur = JaxTargets.create(a["cur_boxes"], labels, a["cur_valid"],
                            a["cur_ids"], num_track_queries=T, hidden_dim=D)
    return cur, prev, a["q4t"], {"hs_embed": a["hs"], "pred_boxes": a["boxes"]}


def _slots(out, hs, i):
    """{query row: (match id, fp flag)} of image i's active slots, the
    query row found from the slot's embedding."""
    res = {}
    for s in np.flatnonzero(np.asarray(out.track_query_mask[i])):
        emb = np.asarray(out.track_query_embeds[i, s])
        rows = [q for q in range(Q) if np.array_equal(emb, hs[i, q])]
        assert len(rows) == 1
        res[rows[0]] = (int(out.track_query_match_ids[i, s]),
                        bool(out.track_query_fp_mask[i, s]))
    return res


def test_deterministic_part_matches_jax():
    a = _setup()
    a["q4t"][0, 3] = -1  # 3 matched prev targets in each image: all kept
    ref = jax.tree_util.tree_map(np.asarray, jax_add_track_queries(
        jax.random.PRNGKey(0), *_jax_inputs(a), false_positive_prob=0.0,
        false_negative_prob=0.0))
    out = add_track_queries_to_targets(
        torch.Generator().manual_seed(0), *_port_inputs(a),
        false_positive_prob=0.0, false_negative_prob=0.0)
    assert out.track_query_mask.sum(1).tolist() == [3, 3]
    for i in range(B):
        assert _slots(out, a["hs"], i) == _slots(ref, a["hs"], i)
    # vanished tracks are flagged; kept ones point at their current index
    assert _slots(out, a["hs"], 0) == {0: (-1, True), 3: (0, False), 5: (-1, True)}
    assert _slots(out, a["hs"], 1) == {2: (2, False), 4: (-1, True), 9: (0, False)}
    # an active slot carries its row's prev box; inactive slots are empty
    act = out.track_query_mask
    for i, s in act.nonzero().tolist():
        (q,) = [q for q in range(Q) if np.array_equal(
            out.track_query_embeds[i, s].numpy(), a["hs"][i, q])]
        assert np.array_equal(out.track_query_boxes[i, s].numpy(), a["boxes"][i, q])
    assert (out.track_query_embeds[~act] == 0).all()
    assert (out.track_query_boxes[~act] == 0).all()
    assert (out.track_query_match_ids[~act] == -1).all()
    assert not out.track_query_fp_mask[~act].any()


def test_random_draws_keep_their_invariants():
    a = _setup(1)
    cur, prev, q4t, prev_out = _port_inputs(a)
    matched = [set(np.array(Q4T[i])[np.array(Q4T[i]) >= 0]) for i in range(B)]
    gen = torch.Generator().manual_seed(0)
    kept_counts, fp_counts = set(), set()
    for _ in range(200):
        out = add_track_queries_to_targets(gen, cur, prev, q4t, prev_out,
                                           false_positive_prob=1.0,
                                           false_negative_prob=0.4)
        n_active = out.track_query_mask.sum(1).tolist()
        assert n_active[0] == n_active[1]  # counts shared by the batch
        assert out.track_query_mask[:, :n_active[0]].all()
        for i in range(B):
            slots = _slots(out, a["hs"], i)
            kept = [q for q in slots if q in matched[i]]
            fps = [q for q in slots if q not in matched[i]]
            assert len(kept) + len(fps) == len(slots) == n_active[i]
            assert len(kept) <= 3 and len(fps) <= len(kept)  # ceil(1.0 * kept)
            for q in kept:  # a kept track: matched, or flagged as vanished
                tid = PREV_IDS[i][Q4T[i].index(q)]
                mid, fp = slots[q]
                assert fp == (tid not in CUR_IDS[i])
                assert mid == (CUR_IDS[i].index(tid) if not fp else -1)
            for q in fps:  # an injected false positive: never matched
                assert slots[q] == (-1, True)
            if i == 0:
                kept_counts.add(len(kept))
                fp_counts.add(len(fps))
    assert kept_counts == {0, 1, 2, 3} and fp_counts == {0, 1, 2, 3}


def test_false_positives_are_drawn_by_distance():
    """One kept track at (0.5, 0.5); the only unmatched queries sit 0.1 and
    0.4 away: draws in proportion to distance pick the far one 4 times in
    5."""
    a = _setup()
    a["q4t"][:] = -1
    a["q4t"][:, 0] = 0
    a["prev_ids"][:] = -1
    a["prev_ids"][:, 0] = 11
    a["prev_valid"] = a["prev_ids"] >= 0
    a["boxes"] = np.zeros((B, Q, 4), np.float32)
    a["boxes"][:, :, :2] = 0.5
    a["boxes"][:, 1, 0] = 0.6
    a["boxes"][:, 2, 0] = 0.9
    # queries 3.. sit on the kept track's centre: weight ~1e-8
    cur, prev, q4t, prev_out = _port_inputs(a)
    gen = torch.Generator().manual_seed(1)
    picks = []
    for _ in range(400):
        out = add_track_queries_to_targets(gen, cur, prev, q4t, prev_out,
                                           false_positive_prob=1.0,
                                           false_negative_prob=0.0)
        picks += [q for q, (_, fp) in _slots(out, a["hs"], 0).items()
                  if q != 0 and fp]
    far = picks.count(2) / len(picks)
    assert len(picks) > 100 and set(picks) <= {1, 2}
    assert 0.72 < far < 0.88


class _FakeModel(torch.nn.Module):
    """Returns outputs that depend on one parameter, and records what the
    current-frame call received."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.calls = []

    def forward(self, batch, targets, **kw):
        self.calls.append((targets, kw))
        hs = batch * self.w
        return {"hs_embed": hs, "pred_boxes": torch.full((B, Q, 4), 0.5),
                "frame_features": (hs, None), "frame_memory": (hs * 2, None)}


class _FakeCriterion:
    def match(self, out, targets):
        return torch.tensor(Q4T)


def test_prev_chain_has_no_gradient_unless_asked():
    a = _setup()
    cur, prev, _, _ = _port_inputs(a)
    frame = torch.from_numpy(a["hs"])
    for backprop in (False, True):
        model = _FakeModel()
        out, aug = tracking_train_forward(
            model, torch.Generator().manual_seed(0), frame, cur, frame, prev,
            _FakeCriterion(), false_positive_prob=0.5,
            false_negative_prob=0.0, backprop_prev_frame=backprop)
        targets, kw = model.calls[-1]
        assert targets is aug and "prev_memory" in kw  # the cached memory
        assert aug.track_query_embeds.requires_grad == backprop
        assert kw["prev_memory"][0].requires_grad == backprop
        assert out["hs_embed"].requires_grad
