"""Set matchers (port of ``kinet_tpu/models/matcher.py``): the DETR
Hungarian matcher with track-query constraints, and the KineT family's
detection <-> GT box matcher and ordered matchers.

The cost is a [B, N_targets, Q_queries] tensor (targets are rows, as in the
JAX package) built on the device; ``ops.lap.solve_lsap_masked`` solves it on
the host. Track-query constraints (reference matcher.py:179-196):
- false-positive track-query columns get BIG cost,
- a matched track query q with match id m is pinned: row m and column q get
  BIG everywhere except cell (m, q) = -1,
- inactive (padded) track slots also get BIG columns.

Returns query4target [B, N] int64: the query matched to each valid target
slot, -1 for padded slots.

KineT (reference matcher.py:13-81, 205-682):
- ``box_match``: detections <-> GT by box L1 + GIoU alone, invalid
  detections at BIG cost; returns det4gt [B, N];
- ``ordered_match_from_track_ids`` (encoder-only model): a target owned by
  a track slot is predicted there; any other falls back to the row of its
  detection (matched within the reference's ``max_cost``);
- ``ordered_match_transformer`` (dual-stream model with ordered queries):
  a target's prediction is the first query of its detection's positional
  group, unless a track slot owns it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.boxes import (
    box_cxcywh_to_xyxy,
    elementwise_box_iou,
    generalized_box_iou,
)
from ..ops.lap import solve_lsap_masked

BIG = 1e5


def classification_cost(logits, labels, focal_loss: bool, focal_alpha: float,
                        focal_gamma: float) -> torch.Tensor:
    """[B, Q, C(+1)] logits x [B, N] labels -> [B, N, Q] class cost."""
    logits = logits.float()
    if focal_loss:
        prob = torch.sigmoid(logits)
        neg = (1 - focal_alpha) * prob ** focal_gamma * (-torch.log1p(-prob + 1e-8))
        pos = focal_alpha * (1 - prob) ** focal_gamma * (-torch.log(prob + 1e-8))
        cost = pos - neg
    else:
        cost = -logits.softmax(-1)
    return torch.gather(cost.transpose(1, 2), 1,
                        labels.long()[:, :, None].expand(-1, -1, cost.shape[1]))


def build_cost_matrix(pred_logits, pred_boxes, targets, cost_class: float,
                      cost_bbox: float, cost_giou: float,
                      focal_loss: bool = False, focal_alpha: float = 0.25,
                      focal_gamma: float = 2.0) -> torch.Tensor:
    """Matching cost [B, N, Q] with the track-query constraints applied."""
    b, q, _ = pred_logits.shape
    n = targets.labels.shape[1]
    pred_boxes = pred_boxes.float()
    c_class = classification_cost(pred_logits, targets.labels, focal_loss,
                                  focal_alpha, focal_gamma)
    c_bbox = (targets.boxes[:, :, None, :] - pred_boxes[:, None, :, :]).abs().sum(-1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(targets.boxes),
                                  box_cxcywh_to_xyxy(pred_boxes))
    cost = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou

    t = targets.num_track_slots
    if t > 0:
        active = targets.track_query_mask
        fp = targets.track_query_fp_mask
        pinned = active & ~fp & (targets.track_query_match_ids >= 0)
        col_blocked = torch.zeros(b, q, dtype=torch.bool, device=cost.device)
        col_blocked[:, :t] = fp | ~active | pinned
        m_ids = torch.where(pinned, targets.track_query_match_ids, n)  # [B, T]
        pin = F.one_hot(m_ids.long(), n + 1)[..., :n].bool()  # [B, T, N]
        row_pinned = pin.any(1)  # [B, N]
        cost = torch.where(row_pinned[:, :, None] | col_blocked[:, None, :],
                           torch.full_like(cost, BIG), cost)
        pin_cells = F.pad(pin.transpose(1, 2), (0, q - t))  # [B, N, Q]
        cost = torch.where(pin_cells, torch.full_like(cost, -1.0), cost)
    return cost


@torch.no_grad()
def hungarian_match(pred_logits, pred_boxes, targets, cost_class: float = 1.0,
                    cost_bbox: float = 5.0, cost_giou: float = 2.0,
                    focal_loss: bool = False, focal_alpha: float = 0.25,
                    focal_gamma: float = 2.0) -> torch.Tensor:
    """Match predictions to targets; returns query4target [B, N] (or -1)."""
    cost = build_cost_matrix(pred_logits, pred_boxes, targets, cost_class,
                             cost_bbox, cost_giou, focal_loss, focal_alpha,
                             focal_gamma)
    return solve_lsap_masked(cost, targets.valid)


@torch.no_grad()
def box_match(det_boxes, det_valid, gt_boxes, gt_valid, cost_bbox: float = 1.0,
              cost_giou: float = 1.0, giou_threshold=None) -> torch.Tensor:
    """Detection <-> GT assignment by box cost; det4gt [B, Ngt] (the
    detection of each GT slot, -1 for padded slots and for GT whose only
    assignment is an infeasible (BIG) cell)."""
    det_boxes, gt_boxes = det_boxes.float(), gt_boxes.float()
    c_bbox = (gt_boxes[:, :, None, :] - det_boxes[:, None, :, :]).abs().sum(-1)
    giou = generalized_box_iou(box_cxcywh_to_xyxy(gt_boxes),
                               box_cxcywh_to_xyxy(det_boxes))
    cost = cost_bbox * c_bbox - cost_giou * giou
    big = torch.full_like(cost, BIG)
    cost = torch.where(det_valid[:, None, :], cost, big)
    if giou_threshold is not None:
        cost = torch.where(giou < giou_threshold, big, cost)
    det4gt = solve_lsap_masked(cost, gt_valid)
    chosen = torch.gather(cost, 2, det4gt.clamp(min=0)[..., None])[..., 0]
    return torch.where((det4gt >= 0) & (chosen < BIG / 2), det4gt,
                       torch.full_like(det4gt, -1))


def _det4gt_thresholded(targets, detections, det_valid, cost_bbox: float,
                        cost_giou: float) -> torch.Tensor:
    """``box_match`` + the reference's gate on the matched pair's cost,
    L1 - IoU below ``max_cost = 0.6 * cost_bbox - 0.1 * cost_giou``."""
    det4gt = box_match(detections, det_valid, targets.boxes, targets.valid,
                       cost_bbox=cost_bbox, cost_giou=cost_giou)
    d = torch.gather(detections.float(), 1,
                     det4gt.clamp(min=0)[..., None].expand(-1, -1, 4))
    l1 = (d - targets.boxes).abs().sum(-1)
    iou = elementwise_box_iou(box_cxcywh_to_xyxy(d),
                              box_cxcywh_to_xyxy(targets.boxes))
    cost = cost_bbox * l1 - cost_giou * iou
    max_cost = -cost_giou * 0.1 + cost_bbox * 0.6
    return torch.where((det4gt >= 0) & (cost < max_cost), det4gt,
                       torch.full_like(det4gt, -1))


def _slot_of_target(targets) -> torch.Tensor:
    """[B, N]: the track slot that owns each target (an active, not
    false-positive slot with that match id), else -1."""
    n = targets.labels.shape[1]
    mids = torch.where(
        targets.track_query_mask & ~targets.track_query_fp_mask,
        targets.track_query_match_ids.long(), n,
    )  # [B, T]; n = owns nothing (dropped below)
    b, t = mids.shape
    out = torch.full((b, n + 1), -1, dtype=torch.long, device=mids.device)
    slots = torch.arange(t, device=mids.device).expand(b, t)
    out.scatter_(1, mids, slots)
    return out[:, :n]


@torch.no_grad()
def ordered_match_from_track_ids(targets, detections=None, det_valid=None,
                                 cost_bbox: float = 5.0,
                                 cost_giou: float = 2.0) -> torch.Tensor:
    """Ordered matcher of the encoder-only KineT: query4target [B, N]."""
    q4t = _slot_of_target(targets)
    if detections is not None:
        t = targets.track_query_mask.shape[1]
        det4gt = _det4gt_thresholded(targets, detections, det_valid,
                                     cost_bbox, cost_giou)
        fallback = torch.where(det4gt >= 0, t + det4gt,
                               torch.full_like(det4gt, -1))
        q4t = torch.where(q4t >= 0, q4t, fallback)
    return torch.where(targets.valid, q4t, torch.full_like(q4t, -1))


@torch.no_grad()
def ordered_match_transformer(targets, detections, det_valid,
                              num_track_slots: int, n_assign: int = 1,
                              cost_bbox: float = 5.0,
                              cost_giou: float = 2.0) -> torch.Tensor:
    """Positional matcher of the dual-stream KineT with ordered queries:
    query4target [B, N]."""
    det4gt = _det4gt_thresholded(targets, detections, det_valid, cost_bbox,
                                 cost_giou)
    q4t = torch.where(det4gt >= 0, num_track_slots + det4gt * n_assign,
                      torch.full_like(det4gt, -1))
    if targets.num_track_slots > 0:
        override = _slot_of_target(targets)
        q4t = torch.where(override >= 0, override, q4t)
    return torch.where(targets.valid, q4t, torch.full_like(q4t, -1))
