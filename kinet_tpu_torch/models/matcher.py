"""Hungarian set matcher (port of ``kinet_tpu/models/matcher.py``, the
DETR matcher with track-query constraints).

The cost is a [B, N_targets, Q_queries] tensor (targets are rows, as in the
JAX package) built on the device; ``ops.lap.solve_lsap_masked`` solves it on
the host. Track-query constraints (reference matcher.py:179-196):
- false-positive track-query columns get BIG cost,
- a matched track query q with match id m is pinned: row m and column q get
  BIG everywhere except cell (m, q) = -1,
- inactive (padded) track slots also get BIG columns.

Returns query4target [B, N] int64: the query matched to each valid target
slot, -1 for padded slots.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou
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
