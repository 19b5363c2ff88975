"""Train-time track-query simulation (port of
``kinet_tpu/tracking/train_augment.py``; reference
src/trackformer/models/detr_tracking.py:16-283).

The model runs on the previous frame, the matcher assigns its queries to
the previous frame's targets, and T fixed track slots are filled per image:

- slot s < num_kept          : a kept previous-frame track (the false-
                               negative simulation drops the rest),
- num_kept <= s < kept + fps : an injected false positive,
- the rest                   : inactive (masked everywhere).

Semantics kept from the JAX package:
- num_kept ~ U{0..min_b(#matched prev targets)}, shared by the batch
  (fixed at the minimum when false_negative_prob is 0),
- num_fps ~ U{0..ceil(fp_prob * num_kept)}, shared by the batch,
- the kept tracks are a random permutation of the matched prev targets,
- a kept track whose id is absent from the current frame is flagged like
  a false positive,
- false positives are unmatched prev queries drawn without replacement
  with probability proportional to their centre distance (dx^2 + dy^2)^0.5
  to a randomly chosen kept track's box.

The slot choice is host code: the random draws come from a CPU
``torch.Generator`` (so a run draws the same on the card and on the CPU),
and the chosen query rows are gathered on the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..structs import Targets


def _match_current_ids(prev_tid: int, cur_track_ids, cur_valid) -> int:
    """Index of the current-frame target with this track id, or -1."""
    if prev_tid < 0:
        return -1
    hits = np.flatnonzero((cur_track_ids == prev_tid) & cur_valid)
    return int(hits[0]) if hits.size else -1


def _randint(gen, high: int) -> int:
    """U{0..high-1}."""
    return int(torch.randint(high, (1,), generator=gen))


def _augment_one(gen, q4t_prev, prev_valid, prev_track_ids, prev_centres,
                 cur_track_ids, cur_valid, num_kept: int, num_fps: int,
                 num_slots: int, add_false_pos: bool):
    """Slot choices of one image: (query per slot, active, fp flag, match
    id), numpy arrays of length num_slots."""
    q = prev_centres.shape[0]
    matched = prev_valid & (q4t_prev >= 0)
    # random permutation of the matched prev targets (unmatched at the end)
    scores = torch.rand(len(q4t_prev), generator=gen).numpy()
    perm = np.argsort(np.where(matched, scores, 2.0), kind="stable")
    available = np.ones(q, bool)
    available[q4t_prev[matched]] = False  # queries of matched targets

    q_sel = np.zeros(num_slots, np.int64)
    active = np.zeros(num_slots, bool)
    fp_flag = np.zeros(num_slots, bool)
    match_ids = np.full(num_slots, -1, np.int64)
    for s in range(num_kept):
        tgt = perm[s]
        q_sel[s] = q4t_prev[tgt]
        match_ids[s] = _match_current_ids(int(prev_track_ids[tgt]),
                                          cur_track_ids, cur_valid)
        active[s] = True
        fp_flag[s] = match_ids[s] < 0  # vanished tracks count as FPs
    if add_false_pos:
        for s in range(num_kept, num_kept + num_fps):
            anchor = prev_centres[q4t_prev[perm[_randint(gen, max(num_kept, 1))]]]
            d = prev_centres - anchor[None]
            w = np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2) + 1e-8
            w = np.where(available, w, 0.0)
            fp_q = int(torch.multinomial(torch.from_numpy(w), 1, generator=gen))
            available[fp_q] = False
            q_sel[s] = fp_q
            active[s] = fp_flag[s] = True
    return q_sel, active, fp_flag, match_ids


def add_track_queries_to_targets(gen: torch.Generator, targets: Targets,
                                 prev_targets: Targets, q4t_prev: torch.Tensor,
                                 prev_out: dict, false_positive_prob: float,
                                 false_negative_prob: float,
                                 add_false_pos: bool = True) -> Targets:
    """Returns ``targets`` with the track_query_* fields filled from the
    previous frame's outputs: ``hs_embed`` rows (with their gradient, if
    any) and detached ``pred_boxes``. ``gen`` is a CPU generator."""
    t = targets.num_track_slots
    q4t = q4t_prev.cpu().numpy()
    pv = prev_targets.valid.cpu().numpy()
    ptid = prev_targets.track_ids.cpu().numpy()
    ctid = targets.track_ids.cpu().numpy()
    cv = targets.valid.cpu().numpy()
    centres = prev_out["pred_boxes"][..., :2].float().cpu().numpy()
    b = q4t.shape[0]

    min_matched = int((pv & (q4t >= 0)).sum(1).min())
    if false_negative_prob > 0:
        num_kept = _randint(gen, min_matched + 1)
    else:
        num_kept = min_matched
    num_kept = min(num_kept, t)
    max_fps = math.ceil(false_positive_prob * num_kept)
    num_fps = min(_randint(gen, max_fps + 1), t - num_kept)

    slots = [
        _augment_one(gen, q4t[i], pv[i], ptid[i], centres[i], ctid[i], cv[i],
                     num_kept, num_fps, t, add_false_pos)
        for i in range(b)
    ]
    dev = prev_out["hs_embed"].device
    q_sel, active, fp_flag, match_ids = (
        torch.from_numpy(np.stack(x)).to(dev) for x in zip(*slots)
    )
    gather = q_sel[..., None]
    hs = prev_out["hs_embed"]
    embeds = torch.gather(hs, 1, gather.expand(-1, -1, hs.shape[-1]))
    boxes = torch.gather(prev_out["pred_boxes"].detach(), 1,
                         gather.expand(-1, -1, 4))
    act = active[..., None]
    return targets.replace(
        track_query_embeds=torch.where(act, embeds, 0).float(),
        track_query_boxes=torch.where(act, boxes, 0).float(),
        track_query_mask=active,
        track_query_fp_mask=fp_flag,
        track_query_match_ids=match_ids,
    )


def tracking_train_forward(model, gen: torch.Generator, batch, targets,
                           prev_batch, prev_targets, criterion,
                           prev_prev_batch=None, prev_prev_targets=None,
                           false_positive_prob: float = 0.1,
                           false_negative_prob: float = 0.4,
                           backprop_prev_frame: bool = False):
    """One tracking training forward (reference detr_tracking.py:220-283):
    the prev(-prev) forwards build the track queries, the current forward
    consumes them. ``model`` is a callable with the model's signature (the
    module, or a functional call of it). Returns (outputs, targets with
    track queries).

    Without ``backprop_prev_frame`` the previous frames run without
    gradient; their encoded memory (``cache_prev_encoder``) or features are
    reused by the current forward, detached."""

    def prev_chain():
        pt = prev_targets
        if prev_prev_batch is not None:
            pp_out = model(prev_prev_batch, None)
            q4t_pp = criterion.match(pp_out, prev_prev_targets)
            pt = add_track_queries_to_targets(
                gen, pt, prev_prev_targets, q4t_pp, pp_out,
                false_positive_prob, false_negative_prob, add_false_pos=False,
            )
            prev_out = model(prev_batch, pt,
                             prev_features=pp_out["frame_features"])
        else:
            prev_out = model(prev_batch, None)
        q4t_prev = criterion.match(prev_out, pt)
        aug = add_track_queries_to_targets(
            gen, targets, pt, q4t_prev, prev_out, false_positive_prob,
            false_negative_prob,
        )
        return aug, prev_out["frame_features"], prev_out.get("frame_memory")

    if backprop_prev_frame:
        aug_targets, prev_features, prev_memory = prev_chain()
    else:
        with torch.no_grad():
            aug_targets, prev_features, prev_memory = prev_chain()
    kw = ({"prev_memory": prev_memory} if prev_memory is not None
          else {"prev_features": prev_features})
    out = model(batch, aug_targets, **kw)
    return out, aug_targets
