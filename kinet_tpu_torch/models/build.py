"""Model assembly (port of ``kinet_tpu/models/build.py``).

``build_model(cfg, device=None)`` -> (model, postprocessors). The model is
``DeformableDETR`` (``deformable``), vanilla ``DETR`` (the default), or
with ``kine`` the dual-stream ``KinematicDetectorTransformer`` (every kine
config without ``use_encoder_only``, as in the JAX package) or the
``KinematicDetectorEncoder`` (whose track slots default to
``max_number_detection``). With ``masks`` (and no ``kine``) the detector
is wrapped in ``SegmWrapper`` with the mask head. It is built on
``device``, which defaults to CUDA and raises without a card (pass
``device="cpu"`` for the CPU). Its
weights are random, drawn from ``seed`` with an explicit generator;
``tools/from_jax.py`` loads trained ones. Its dropout generator
(``model.dropout_rng``) is seeded from ``seed`` too.

``build_criterion(cfg)`` -> the training criterion, with the loss weights
of ``build_weight_dict(cfg)`` and the matcher of the JAX package's
dispatch: the ordered matchers for kine configs with
``used_ordered_queries``, else Hungarian; with ``masks`` it adds the mask
losses.
"""
from __future__ import annotations

import math
import warnings

import torch
from torch import nn

from ..tracking.kine_augment import kine_track_embed_dims
from .backbone import FrozenBatchNorm
from .criterion import SetCriterion
from .deformable_detr import DeformableDETR
from .deformable_transformer import MSDeformAttn, offset_grid_init
from .detr import DETR, KinematicDetectorEncoder, KinematicDetectorTransformer
from .postprocess import build_postprocessors
from .segmentation import SegmWrapper


def num_classes_for(dataset: str) -> int:
    if dataset == "coco":
        return 91
    if dataset == "coco_panoptic":
        return 250
    # mot, crowdhuman, coco_person, ...: the reference's 20-class setting
    return 20


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: CUDA, or an error when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: kinet_tpu_torch runs on the GPU unless the "
                "caller asks for the CPU (device='cpu')"
            )
        device = "cuda"
    return torch.device(device)


def kine_dims(cfg) -> tuple[int, int, int]:
    """(trail length, trail sine-encoding width (0: raw 4-number trails,
    the default of ``use_encoding_tracklets: false``), metadata width) of
    a kine config."""
    enc = (int(cfg.encoding_dim_tracklets)
           if cfg.get("use_encoding_tracklets", False) else 0)
    return (max(int(cfg.track_prev_frame_range), 1), enc,
            2 if cfg.use_class else 1)


def build_model(cfg, device=None, seed: int = 0):
    device = resolve_device(device)
    if cfg.activation != "relu":  # the only activation the configs use
        raise ValueError(f"activation {cfg.activation!r}: only relu is supported")
    tracking = bool(cfg.get("tracking", False))
    num_track_slots = int(cfg.get("max_track_queries", 100)) if tracking else 0
    common = dict(
        num_classes=num_classes_for(cfg.get("dataset", "coco")),
        hidden_dim=cfg.hidden_dim, nheads=cfg.nheads,
        enc_layers=cfg.enc_layers, dim_feedforward=cfg.dim_feedforward,
        dropout=float(cfg.dropout), pre_norm=bool(cfg.pre_norm),
        focal_loss=cfg.focal_loss,
    )
    with torch.device("meta"):
        if cfg.get("kine", False):
            model = _build_kine(cfg, common, num_track_slots)
        elif cfg.get("deformable", False):
            model = _build_deformable(cfg, num_track_slots)
        else:
            model = DETR(
                **common, num_queries=cfg.num_queries,
                dec_layers=cfg.dec_layers, aux_loss=bool(cfg.aux_loss),
                backbone_name=cfg.backbone, dilation=cfg.dilation,
                num_track_slots=num_track_slots,
                track_attention=bool(cfg.track_attention),
                masks=bool(cfg.masks),
            )
        if cfg.masks and not cfg.get("kine", False):
            model = SegmWrapper(model, cfg.hidden_dim, cfg.nheads)
    model.to_empty(device=device)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.dropout_rng.generator = torch.Generator(device=device).manual_seed(
        seed + 1
    )
    model.eval()
    return model, build_postprocessors(cfg)


def _build_kine(cfg, common, num_track_slots):
    trail_len, enc, meta_dim = kine_dims(cfg)
    max_det = int(cfg.max_number_detection)
    if cfg.get("use_encoder_only", False):
        return KinematicDetectorEncoder(
            **common, num_track_slots=num_track_slots or max_det,
            max_detections=max_det, meta_dim=meta_dim,
            trail_dim=sum(kine_track_embed_dims(trail_len, enc, meta_dim)),
        )
    # every other kine config builds the dual-stream model, as the JAX
    # package (and the reference) do; used_ordered_queries only selects
    # the matcher
    trail_w, meta_w = kine_track_embed_dims(trail_len, enc, meta_dim)
    return KinematicDetectorTransformer(
        **common, num_queries=cfg.num_queries, dec_layers=cfg.dec_layers,
        aux_loss=bool(cfg.aux_loss), num_track_slots=num_track_slots,
        max_detections=max_det, meta_dim=meta_dim, trail_enc_dim=trail_w,
        meta_hist_dim=meta_w,
    )


def _build_deformable(cfg, num_track_slots):
    # accuracy-UNSAFE perf knobs of the JAX package: refused unless the
    # config opts in explicitly, and then warned about, as there
    lossy = [
        k for k in ("enc_msda_topk", "enc_msda_int8", "dec_msda_int8")
        if cfg.get(k, 0)
    ]
    if lossy and not cfg.get("allow_lossy", False):
        raise ValueError(
            f"{lossy} change model predictions (measured accuracy loss in the "
            "JAX package); set allow_lossy=true to enable them anyway"
        )
    if lossy:
        warnings.warn(
            f"accuracy-unsafe MSDA variants enabled: {lossy} "
            "(allow_lossy=true); predictions will differ from the exact model",
            stacklevel=3,
        )
    return DeformableDETR(
        num_classes=num_classes_for(cfg.get("dataset", "coco")),
        hidden_dim=cfg.hidden_dim,
        num_queries=cfg.num_queries,
        nheads=cfg.nheads,
        enc_layers=cfg.enc_layers,
        dec_layers=cfg.dec_layers,
        dim_feedforward=cfg.dim_feedforward,
        backbone_name=cfg.backbone,
        dilation=cfg.dilation,
        num_feature_levels=cfg.num_feature_levels,
        dec_n_points=cfg.dec_n_points,
        enc_n_points=cfg.enc_n_points,
        with_box_refine=cfg.with_box_refine,
        multi_frame_attention=cfg.multi_frame_attention,
        multi_frame_encoding=cfg.multi_frame_encoding,
        cache_prev_encoder=bool(cfg.get("cache_prev_encoder", False)),
        two_stage=bool(cfg.two_stage),
        merge_frame_features=bool(cfg.merge_frame_features),
        enc_msda_shared_locs=bool(cfg.get("enc_msda_shared_locs", False)),
        enc_msda_topk=int(cfg.get("enc_msda_topk", 0)),
        enc_msda_int8=bool(cfg.get("enc_msda_int8", False)),
        enc_lite=bool(cfg.get("enc_lite", False)),
        enc_lite_klevels=int(cfg.get("enc_lite_klevels", 0)),
        enc_lite_high_klevels=int(cfg.get("enc_lite_high_klevels", 0)),
        dec_gather_raw=bool(cfg.get("dec_gather_raw", False)),
        dec_klevels=int(cfg.get("dec_klevels", 0)),
        dec_msda_int8=bool(cfg.get("dec_msda_int8", False)),
        msda_ref_normalizer=bool(cfg.get("msda_ref_normalizer", False)),
        num_track_slots=num_track_slots,
        focal_loss=cfg.focal_loss,
        dropout=float(cfg.dropout),
        aux_loss=bool(cfg.aux_loss),
        remat=bool(cfg.get("remat", False)),
        masks=bool(cfg.masks),
    )


def build_weight_dict(cfg) -> dict:
    """Loss weights; with ``aux_loss`` every key is repeated with the
    suffixes ``_0`` .. ``_{dec_layers - 2}`` of the auxiliary decoder layers
    and ``_enc`` (the two-stage encoder proposals' losses), as the JAX
    package does, so ``total_loss`` is an exact-key weighted sum."""
    wd = {
        "loss_ce": cfg.cls_loss_coef,
        "loss_bbox": cfg.bbox_loss_coef,
        "loss_giou": cfg.giou_loss_coef,
    }
    if cfg.masks:
        wd["loss_mask"] = cfg.mask_loss_coef
        wd["loss_dice"] = cfg.dice_loss_coef
    if cfg.aux_loss:
        aux = {}
        for i in range(cfg.dec_layers - 1):
            aux.update({f"{k}_{i}": v for k, v in wd.items()})
        aux.update({f"{k}_enc": v for k, v in wd.items()})
        wd.update(aux)
    return wd


def build_criterion(cfg) -> SetCriterion:
    """The set criterion (labels, boxes, cardinality, and masks with
    ``masks``) with the JAX package's matcher dispatch."""
    kine = bool(cfg.get("kine", False))
    tracking = bool(cfg.get("tracking", False))
    matcher_kind, n_assign = "hungarian", 1
    if kine and cfg.get("used_ordered_queries", False):
        if cfg.get("use_encoder_only", False):
            matcher_kind = "ordered_encoder"
        else:
            matcher_kind = "ordered_transformer"
            n_assign = max(int(cfg.num_queries)
                           // int(cfg.max_number_detection), 1)
    return SetCriterion(
        num_classes=num_classes_for(cfg.get("dataset", "coco")),
        weight_dict=build_weight_dict(cfg),
        eos_coef=cfg.eos_coef,
        losses=("labels", "boxes", "cardinality")
        + (("masks",) if cfg.masks else ()),
        focal_loss=cfg.focal_loss,
        focal_alpha=cfg.focal_alpha,
        focal_gamma=cfg.focal_gamma,
        tracking=tracking,
        track_query_false_positive_eos_weight=(
            cfg.track_query_false_positive_eos_weight
        ),
        cost_class=cfg.set_cost_class,
        cost_bbox=cfg.set_cost_bbox,
        cost_giou=cfg.set_cost_giou,
        matcher_kind=matcher_kind,
        ordered_n_assign=n_assign,
        ordered_num_track_slots=(
            int(cfg.get("max_track_queries", 100)) if tracking else 0
        ),
    )


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator):
    """Seeded random weights in the JAX package's init scheme (LeCun-normal
    kernels, zero biases, unit norms, identity FrozenBatchNorm, N(0, 1)
    query embeddings; for Deformable DETR N(0, 1) level embeddings and the
    focal prior on the class bias), except that the MSDA offset and
    attention kernels get N(0, 0.02^2) instead of zeros, so the sampling
    locations depend on the query."""

    def fill(t: torch.Tensor, sample: torch.Tensor):
        t.copy_(sample.to(t.dtype))

    def normal(t: torch.Tensor, std: float):
        fill(t, torch.randn(t.shape, generator=generator) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            normal(mod.weight, 1.0 / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, FrozenBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    model = getattr(model, "detector", model)  # a SegmWrapper's detector
    deformable = isinstance(model, DeformableDETR)
    if deformable:
        for mod in model.modules():
            if isinstance(mod, MSDeformAttn):
                normal(mod.sampling_offsets.weight, 0.02)
                fill(mod.sampling_offsets.bias, offset_grid_init(
                    mod.n_loc_heads, mod.n_levels, mod.n_points
                ))
                normal(mod.attention_weights.weight, 0.02)
    for name, p in model.named_parameters(recurse=False):
        if name.startswith("query_embed"):
            normal(p, 1.0)
    if deformable:
        normal(model.transformer.level_embed, 1.0)
        for i in range(model.num_heads):
            model.class_head(i).bias.fill_(model.class_bias_init)
