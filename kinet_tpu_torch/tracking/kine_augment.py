"""KineT train-time track-query construction (port of
``kinet_tpu/tracking/kine_augment.py``; reference:
src/trackformer/models/detr_tracking.py:524-872, KinetTrackingBase2).

Per batch:
1. external detections are matched to the GT boxes (``box_match``);
2. ``ratio_add_detections`` of the matched targets get their trail's tail
   replaced by their detection; every target gets a metadata history
   ~ N(0.9, 0.1) whose tail is its detection's confidence where the tail
   was replaced;
3. ``num_slots = min(ceil(ratio_add_tracklets * max_b #targets), T)``
   (with ``random_count`` a U{0..num_slots} draw shared by the batch) slots
   are filled per image: a random permutation of its real targets first,
   then synthetic moving tracklets with confidences <= ``max_confidence_
   false_positives``, flagged as false positives; the rest are inactive;
4. trails are sine-encoded (``trail_enc_dim`` > 0) or kept raw, and packed
   as ``[trail | metadata history]`` into ``track_query_embeds``.

The random draws come from a CPU ``torch.Generator`` (a run draws the same
on the card and on the CPU), in a fixed order; the JAX package draws from
``jax.random``, so only the deterministic part and the invariants of the
random part can be held against it.
"""
from __future__ import annotations

import math

import torch

from ..models.matcher import box_match
from ..structs import Targets


def sine_encode_trail(x: torch.Tensor, num_pos_feats: int,
                      temperature: float = 10000.0) -> torch.Tensor:
    """[..., K] -> [..., K * num_pos_feats]: freq = x * 2 pi / dim_t,
    concat(cos(even freqs), sin(odd freqs)) per input number."""
    t = torch.arange(num_pos_feats, dtype=torch.float32, device=x.device)
    dim_t = temperature ** (2 * torch.floor(t / 2) / num_pos_feats)
    freq = (x[..., None] * 2 * math.pi) / dim_t
    emb = torch.cat([freq[..., 0::2].cos(), freq[..., 1::2].sin()], dim=-1)
    return emb.flatten(-2)


def generate_pseudo_trail(gen: torch.Generator, n: int, trail_len: int,
                          wh_max: float = 0.3) -> torch.Tensor:
    """[n, trail_len, 4] random tracklets moving at a constant speed."""
    wh = torch.rand(n, 2, generator=gen) * wh_max + 0.05
    cxcy = torch.rand(n, 2, generator=gen) * (1 - wh) + wh / 2
    final = torch.cat([cxcy, wh], dim=1)
    move = (torch.rand(n, 2, generator=gen) * wh_max / 5).repeat(1, 2)
    steps = torch.arange(trail_len, dtype=torch.float32)[None, :, None]
    return final[:, None, :] + move[:, None, :] * steps


@torch.no_grad()
def add_kine_track_queries(
    gen: torch.Generator,
    targets: Targets,
    trails: torch.Tensor,  # [B, N, L, 4] normalized cxcywh
    detections: torch.Tensor,  # [B, Nd, 4]
    det_metadata: torch.Tensor,  # [B, Nd, M]
    det_valid: torch.Tensor,  # [B, Nd]
    trail_enc_dim: int,
    ratio_add_tracklets: float = 1.0,
    max_confidence_false_positives: float = 0.5,
    random_count: bool = False,
    ratio_add_detections: float = 0.5,
) -> Targets:
    """``targets`` with the track-query slots filled (``gen`` is a CPU
    generator; everything else stays on the targets' device)."""
    b, n, l, _ = trails.shape
    m = det_metadata.shape[-1]
    t = targets.num_track_slots
    dev = trails.device

    det4gt = box_match(detections, det_valid, targets.boxes, targets.valid)
    n_targets = targets.valid.sum(1)
    num_slots = min(math.ceil(ratio_add_tracklets * int(n_targets.max())), t)
    if random_count:
        num_slots = int(torch.randint(num_slots + 1, (1,), generator=gen))

    # tail replacement + metadata history
    matched = det4gt >= 0
    if ratio_add_detections < 1.0:
        picked = torch.rand(b, n, generator=gen) < ratio_add_detections
        matched = matched & picked.to(dev)
    det_idx = det4gt.clamp(min=0)
    det_boxes = torch.gather(detections.float(), 1,
                             det_idx[..., None].expand(-1, -1, 4))
    trails = trails.float().clone()
    trails[:, :, -1] = torch.where(matched[..., None], det_boxes,
                                   trails[:, :, -1])
    meta_hist = (torch.randn(b, n, l, m, generator=gen) * 0.1 + 0.9).to(dev)
    det_meta = torch.gather(det_metadata.float(), 1,
                            det_idx[..., None].expand(-1, -1, m))
    meta_hist[:, :, -1] = torch.where(matched[..., None], det_meta,
                                      meta_hist[:, :, -1])

    # slot filling per image: valid targets first, in random order
    score = torch.where(targets.valid.cpu(), torch.rand(b, n, generator=gen),
                        torch.tensor(2.0))
    perm = score.argsort(dim=1, stable=True).to(dev)  # [B, N]
    slots = torch.arange(t, device=dev)
    take = n_targets.clamp(max=num_slots)[:, None]  # [B, 1]
    is_real = slots[None] < take
    is_fp = (slots[None] >= take) & (slots[None] < num_slots)
    src = torch.gather(perm, 1, slots.clamp(max=n - 1)[None].expand(b, t))
    bidx = torch.arange(b, device=dev)[:, None]
    trail_slots = trails[bidx, src]  # [B, T, L, 4]
    meta_slots = meta_hist[bidx, src]  # [B, T, L, M]
    pseudo = torch.stack([generate_pseudo_trail(gen, t, l)
                          for _ in range(b)]).to(dev)
    fp_meta = torch.zeros(b, t, l, m)
    fp_meta[..., 0] = torch.rand(b, t, l, generator=gen) \
        * max_confidence_false_positives
    trail_slots = torch.where(is_fp[..., None, None], pseudo, trail_slots)
    meta_slots = torch.where(is_fp[..., None, None], fp_meta.to(dev),
                             meta_slots)
    match_ids = torch.where(is_real, src, torch.full_like(src, -1))

    flat = trail_slots.reshape(b, t, l * 4)
    trail_enc = sine_encode_trail(flat, trail_enc_dim) if trail_enc_dim else flat
    embeds = torch.cat([trail_enc, meta_slots.reshape(b, t, l * m)], dim=-1)
    return targets.replace(
        track_query_embeds=embeds.float(),
        track_query_boxes=trail_slots[:, :, -1, :],
        track_query_mask=is_real | is_fp,
        track_query_fp_mask=is_fp,
        track_query_match_ids=match_ids,
    )


def kine_track_embed_dims(trail_len: int, trail_enc_dim: int, meta_dim: int):
    """(trail feature width, metadata history width) of a kine track-query
    embedding; ``trail_enc_dim`` 0 means raw trails (4 numbers a frame)."""
    per_frame = 4 * trail_enc_dim if trail_enc_dim else 4
    return trail_len * per_frame, trail_len * meta_dim
