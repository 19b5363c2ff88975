"""Set-prediction losses (port of ``kinet_tpu/models/criterion.py``: the
labels / boxes / cardinality losses of the DETR, Deformable DETR and KineT
models, and the mask losses of ``SegmWrapper``).

- the match is query4target [B, N] from ``matcher.hungarian_match``, or for
  the KineT models with ordered queries from the ordered matchers
  (``matcher_kind`` "ordered_encoder" / "ordered_transformer"), which read
  the input detections from the model outputs;
- per-query target classes are a masked scatter of the target labels;
- ``num_boxes`` is the count of valid targets in the batch; over several
  processes the mean of that count over them (reference detr.py:844-846),
  so that the mean of the processes' gradients is the gradient of the
  loss over their whole batch;
- padded query slots (inactive track slots) are left out of every loss via
  the model's ``query_valid``.

Losses: softmax CE with eos down-weighting and the false-positive
track-query reweighting, sigmoid focal, cardinality (log only), boxes L1 +
GIoU, masks (sigmoid focal + dice on the matched queries' mask logits,
resized bilinearly to the ground-truth masks' size; the last decoder
layer only); each auxiliary decoder layer adds the same keys, but the
masks', with the suffix ``_{i}``, and a two-stage model's encoder
proposals (``enc_outputs``) add them with the suffix ``_enc``, against the
targets relabelled to class 0 and matched over all S proposals. The losses
are computed in float32 whatever the type of the model's outputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou
from ..utils.dist import mean_over_processes
from .matcher import (
    hungarian_match,
    ordered_match_from_track_ids,
    ordered_match_transformer,
)


def sigmoid_ce(logits, labels):
    """Numerically stable binary cross-entropy with logits."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(
        torch.exp(-logits.abs())
    )


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Elementwise sigmoid focal loss on logits."""
    prob = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def dice_loss(logits, targets, num_boxes, valid):
    """Mask dice loss over [N, H, W] logits and targets, summed over the
    ``valid`` rows and divided by ``num_boxes``."""
    prob = torch.sigmoid(logits).flatten(1)
    targets = targets.flatten(1)
    numerator = 2 * (prob * targets).sum(1)
    denominator = prob.sum(1) + targets.sum(1)
    loss = 1 - (numerator + 1) / (denominator + 1)
    return (loss * valid).sum() / num_boxes


class SetCriterion:
    """``criterion(outputs, targets)`` -> dict of losses.

    ``outputs`` is the model dict: pred_logits [B, Q, C(+1)], pred_boxes
    [B, Q, 4], query_valid [B, Q] and, with aux_loss, aux_outputs."""

    def __init__(self, num_classes: int, weight_dict: dict, eos_coef: float = 0.1,
                 losses=("labels", "boxes", "cardinality"),
                 focal_loss: bool = False, focal_alpha: float = 0.25,
                 focal_gamma: float = 2.0, tracking: bool = False,
                 track_query_false_positive_eos_weight: bool = True,
                 cost_class: float = 1.0, cost_bbox: float = 5.0,
                 cost_giou: float = 2.0, matcher_kind: str = "hungarian",
                 ordered_n_assign: int = 1, ordered_num_track_slots: int = 0):
        self.num_classes = num_classes
        self.weight_dict = weight_dict
        self.eos_coef = eos_coef
        self.losses = tuple(losses)
        self.focal_loss = focal_loss
        self.focal_alpha = focal_alpha
        self.focal_gamma = focal_gamma
        self.tracking = tracking
        self.track_fp_eos_weight = track_query_false_positive_eos_weight
        self.cost_class = cost_class
        self.cost_bbox = cost_bbox
        self.cost_giou = cost_giou
        self.matcher_kind = matcher_kind
        self.ordered_n_assign = ordered_n_assign
        self.ordered_num_track_slots = ordered_num_track_slots

    def match(self, outputs, targets) -> torch.Tensor:
        if self.matcher_kind == "ordered_encoder":
            return ordered_match_from_track_ids(
                targets, outputs.get("detections"), outputs.get("det_valid"),
                cost_bbox=self.cost_bbox, cost_giou=self.cost_giou,
            )
        if self.matcher_kind == "ordered_transformer":
            return ordered_match_transformer(
                targets, outputs["detections"], outputs["det_valid"],
                num_track_slots=self.ordered_num_track_slots,
                n_assign=self.ordered_n_assign, cost_bbox=self.cost_bbox,
                cost_giou=self.cost_giou,
            )
        return hungarian_match(
            outputs["pred_logits"], outputs["pred_boxes"], targets,
            self.cost_class, self.cost_bbox, self.cost_giou, self.focal_loss,
            self.focal_alpha, self.focal_gamma,
        )

    @staticmethod
    def _query_valid(outputs, b, q, device):
        qv = outputs.get("query_valid")
        return qv if qv is not None else torch.ones(b, q, dtype=torch.bool,
                                                    device=device)

    def _target_classes(self, q4t, targets, num_queries):
        """[B, Q] class per query: the matched target's label, else the
        no-object class ``num_classes``."""
        b = q4t.shape[0]
        tc = torch.full((b, num_queries + 1), self.num_classes,
                        dtype=torch.long, device=q4t.device)
        q = torch.where(targets.valid & (q4t >= 0), q4t, num_queries)
        tc.scatter_(1, q.long(), targets.labels.long())
        return tc[:, :num_queries]

    def loss_labels(self, outputs, targets, q4t, num_boxes):
        logits = outputs["pred_logits"].float()  # [B, Q, C+1]
        b, q, _ = logits.shape
        qv = self._query_valid(outputs, b, q, logits.device)
        tc = self._target_classes(q4t, targets, q)
        empty_weight = torch.ones(self.num_classes + 1, device=logits.device)
        empty_weight[-1] = self.eos_coef
        nll = -torch.gather(logits.log_softmax(-1), -1, tc[..., None])[..., 0]
        w = empty_weight[tc]
        loss_ce = nll * w
        if self.tracking and self.track_fp_eos_weight:
            # FP track queries: drop the eos down-weighting
            t = targets.num_track_slots
            fp = torch.zeros(b, q, dtype=torch.bool, device=logits.device)
            fp[:, :t] = targets.track_query_fp_mask
            loss_ce = torch.where(fp, loss_ce / self.eos_coef, loss_ce)
            w = torch.where(fp, torch.ones_like(w), w)
        loss_ce = torch.where(qv, loss_ce, torch.zeros_like(loss_ce))
        w = torch.where(qv, w, torch.zeros_like(w))
        losses = {"loss_ce": loss_ce.sum() / w.sum().clamp(min=1e-6)}
        losses["class_error"] = self._class_error(logits[..., :-1], tc, qv)
        return losses

    def loss_labels_focal(self, outputs, targets, q4t, num_boxes):
        logits = outputs["pred_logits"].float()  # [B, Q, C], no eos column
        b, q, c = logits.shape
        qv = self._query_valid(outputs, b, q, logits.device)
        tc = self._target_classes(q4t, targets, q)
        onehot = F.one_hot(tc, c + 1)[..., :c].float()  # eos -> all-zero row
        loss = sigmoid_focal_loss(logits, onehot, self.focal_alpha,
                                  self.focal_gamma)
        loss = torch.where(qv[..., None], loss, torch.zeros_like(loss))
        return {
            "loss_ce": loss.sum() / num_boxes,
            "class_error": self._class_error(logits, tc, qv),
        }

    def _class_error(self, logits, tc, qv):
        """Log only: 100 - accuracy (%) over the matched queries."""
        with torch.no_grad():
            matched = (tc != self.num_classes) & qv
            correct = ((logits.argmax(-1) == tc) & matched).sum()
            return 100.0 * (1.0 - correct / matched.sum().clamp(min=1))

    def loss_cardinality(self, outputs, targets, q4t, num_boxes):
        """Log only. Counts argmax != last class as non-empty in both modes,
        as the reference does (under focal loss the last class is a real
        class)."""
        with torch.no_grad():
            logits = outputs["pred_logits"]
            qv = self._query_valid(outputs, *logits.shape[:2], logits.device)
            non_empty = logits.argmax(-1) != logits.shape[-1] - 1
            card = (non_empty & qv).sum(1).float()
            err = (card - targets.valid.sum(1).float()).abs().mean()
        return {"cardinality_error": err}

    def loss_boxes(self, outputs, targets, q4t, num_boxes):
        pred = outputs["pred_boxes"].float()  # [B, Q, 4]
        valid = targets.valid & (q4t >= 0)
        idx = q4t.clamp(min=0).long()
        src = torch.gather(pred, 1, idx[..., None].expand(-1, -1, 4))
        l1 = (src - targets.boxes).abs().sum(-1)
        l1 = torch.where(valid, l1, torch.zeros_like(l1))
        giou = torch.diagonal(
            generalized_box_iou(box_cxcywh_to_xyxy(src),
                                box_cxcywh_to_xyxy(targets.boxes)),
            dim1=1, dim2=2,
        )
        loss_giou = torch.where(valid, 1.0 - giou, torch.zeros_like(giou))
        return {"loss_bbox": l1.sum() / num_boxes,
                "loss_giou": loss_giou.sum() / num_boxes}

    def loss_masks(self, outputs, targets, q4t, num_boxes):
        """Focal + dice on the matched queries' masks; targets without
        ``masks`` give no loss."""
        if targets.masks is None:
            return {}
        pred = outputs["pred_masks"].float()  # [B, Q, Hm, Wm]
        tgt = targets.masks.float()  # [B, N, H, W]
        valid = targets.valid & (q4t >= 0)
        idx = q4t.clamp(min=0).long()
        src = torch.gather(pred, 1, idx[..., None, None].expand(
            -1, -1, *pred.shape[-2:]))
        if src.shape[-2:] != tgt.shape[-2:]:
            src = F.interpolate(src, size=tgt.shape[-2:], mode="bilinear",
                                align_corners=False)
        src, tgt = src.flatten(0, 1), tgt.flatten(0, 1)
        v = valid.reshape(-1).float()
        focal = sigmoid_focal_loss(src, tgt).flatten(1).mean(1)
        return {"loss_mask": (focal * v).sum() / num_boxes,
                "loss_dice": dice_loss(src, tgt, num_boxes, v)}

    def get_loss(self, name, outputs, targets, q4t, num_boxes):
        fns = {
            "labels": self.loss_labels_focal if self.focal_loss else self.loss_labels,
            "cardinality": self.loss_cardinality,
            "boxes": self.loss_boxes,
            "masks": self.loss_masks,
        }
        return fns[name](outputs, targets, q4t, num_boxes)

    def __call__(self, outputs, targets) -> dict:
        num_boxes = mean_over_processes(
            targets.valid.float().sum()).clamp(min=1.0)
        q4t = self.match(outputs, targets)
        losses = {}
        for name in self.losses:
            losses.update(self.get_loss(name, outputs, targets, q4t, num_boxes))
        for i, aux in enumerate(outputs.get("aux_outputs", [])):
            aux = dict(aux)
            aux.setdefault("query_valid", outputs.get("query_valid"))
            q4t_i = self.match(aux, targets)
            for name in self.losses:
                if name == "masks":
                    continue
                for k, v in self.get_loss(name, aux, targets, q4t_i,
                                          num_boxes).items():
                    if k != "class_error":
                        losses[f"{k}_{i}"] = v
        if "enc_outputs" in outputs:
            # two-stage: binary (class-0) targets for the proposals
            bin_targets = targets.replace(
                labels=torch.zeros_like(targets.labels))
            enc = dict(outputs["enc_outputs"])
            q4t_e = self.match(enc, bin_targets)
            for name in self.losses:
                if name == "masks":
                    continue
                for k, v in self.get_loss(name, enc, bin_targets, q4t_e,
                                          num_boxes).items():
                    if k != "class_error":
                        losses[f"{k}_enc"] = v
        return losses

    def total_loss(self, losses: dict) -> torch.Tensor:
        """Weighted sum over the keys present in ``weight_dict``."""
        return sum(w * losses[k] for k, w in self.weight_dict.items()
                   if k in losses)
