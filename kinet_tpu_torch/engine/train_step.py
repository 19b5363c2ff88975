"""The train step (port of ``kinet_tpu/engine/train_step.py``).

One call: the previous frame's forward (and the one before it, with
``track_prev_prev_frame``), the track-query simulation, the current
forward, the criterion, the backward pass and the optimizer update.

Mixed precision follows the JAX package's recipe, not ``torch.autocast``:
the master parameters stay float32, and with ``compute_dtype: bfloat16``
every floating parameter and the images are cast to bfloat16 inside the
differentiated function (``torch.func.functional_call`` over the casts), so
the whole forward runs in bfloat16 and the gradients come back to the
float32 masters through the casts. autocast's per-op policy would keep
some ops in float32 and is a different numeric recipe.

Over several processes (``utils/dist.py``) each process steps on its own
part of the batch: the criterion normalises by the mean target count over
the processes, and once the backward pass has run the gradients are
all-reduced to their mean over the processes (``all_reduce_grads``)
before the optimizer clips them, so every process applies the same
update, the one of the whole batch, as the JAX package's data-parallel
step does. Under a tensor-parallel mesh (``parallel/``) the mean is over
the optimizer's data group only: the ranks of a model group step the
same samples and hold different shards; the replicated parameters'
gradients are then averaged over the model group as well.
``DistributedDataParallel`` would not see this step: the forward runs
through ``functional_call`` on cast copies of the parameters, which
bypasses ``DistributedDataParallel.forward``, so its reducer would never
be prepared. In a run of one process nothing is reduced.

``make_kine_train_step``: the KineT step (reference KinetTrackingBase2):
trail augmentation (``tracking/kine_augment.py``, no previous-frame
forward), the forward, the criterion and the update, in float32 as the JAX
package's KineT step runs whatever ``compute_dtype`` says.
"""
from __future__ import annotations

import functools

import torch
from torch.func import functional_call

from ..data.kinematic import collate_kine
from ..models.build import kine_dims
from ..structs import ImageBatch, KineBatch, Targets
from ..tracking.kine_augment import add_kine_track_queries, kine_track_embed_dims
from ..tracking.train_augment import tracking_train_forward
from ..utils.dist import all_reduce_grads


def _reduce_grads(optimizer):
    """The gradients' mean over the optimizer's data group (every process
    for an optimizer without a mesh). Under tensor parallelism the
    replicated parameters' gradients are then averaged over the model
    group too: its ranks compute them from the same samples, but each on
    its own card (cuDNN's choices, reduction orders), and one copy per
    model group must take one update, or its copies drift apart."""
    mesh = getattr(optimizer, "mesh", None)
    if mesh is None:
        all_reduce_grads(optimizer.params)
        return
    all_reduce_grads(optimizer.params, group=mesh.data_group)
    all_reduce_grads([p for p in optimizer.params
                      if id(p) not in optimizer.shard_dims],
                     group=mesh.model_group)


def make_train_step(model, criterion, optimizer, cfg, generator=None):
    """Returns ``step(batch, targets, prev_batch=None, prev_targets=None,
    prev_prev_batch=None, prev_prev_targets=None) -> losses``: a dict of
    detached scalar tensors on the model's device, with the weighted total
    as "loss" and the global gradient norm before clipping as "grad_norm".

    ``model`` must be in ``train()`` mode for dropout; ``generator`` (a CPU
    ``torch.Generator``, seeded from ``cfg.seed`` by default) draws the
    track-query simulation."""
    tracking = bool(cfg.get("tracking", False))
    fp_prob = float(cfg.get("track_query_false_positive_prob", 0.1))
    fn_prob = float(cfg.get("track_query_false_negative_prob", 0.4))
    backprop_prev = bool(cfg.get("track_backprop_prev_frame", False))
    bf16 = cfg.get("compute_dtype", "float32") == "bfloat16"
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))

    def cast(x):
        return x.to(torch.bfloat16) if bf16 and x.is_floating_point() else x

    def cast_batch(batch):
        if batch is None or not bf16:
            return batch
        return ImageBatch(batch.images.to(torch.bfloat16), batch.pad_mask)

    def step(batch, targets, prev_batch=None, prev_targets=None,
             prev_prev_batch=None, prev_prev_targets=None):
        optimizer.zero_grad()
        params = {k: cast(v) for k, v in model.named_parameters()}

        def forward(b, t, **kw):
            return functional_call(model, params, (b, t), kw)

        batch, prev_batch, prev_prev_batch = map(
            cast_batch, (batch, prev_batch, prev_prev_batch)
        )
        if tracking and prev_batch is not None:
            out, aug_targets = tracking_train_forward(
                forward, generator, batch, targets, prev_batch, prev_targets,
                criterion, prev_prev_batch=prev_prev_batch,
                prev_prev_targets=prev_prev_targets,
                false_positive_prob=fp_prob, false_negative_prob=fn_prob,
                backprop_prev_frame=backprop_prev,
            )
        else:
            out, aug_targets = forward(batch, targets), targets
        losses = criterion(out, aug_targets)
        total = criterion.total_loss(losses)
        total.backward()
        _reduce_grads(optimizer)
        grad_norm = optimizer.step()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss"] = total.detach()
        losses["grad_norm"] = grad_norm
        return losses

    return step


def kine_collate(cfg):
    """``collate_kine`` at the config's static shapes, or None for a config
    that is not KineT's."""
    if not cfg.get("kine", False):
        return None
    trail_len, _, meta_dim = kine_dims(cfg)
    return functools.partial(
        collate_kine, max_detections=int(cfg.max_number_detection),
        max_objects=int(cfg.max_objects), trail_len=trail_len,
        meta_dim=meta_dim, empty_start=bool(cfg.use_empty_start),
    )


def kine_batch(batch: dict, device) -> KineBatch:
    """The ``KineBatch`` of a ``collate_kine`` batch (numpy arrays)."""
    def put(k):
        return torch.from_numpy(batch[k]).to(device)
    return KineBatch(put("detections"), put("metadata"), put("det_pad_mask"))


def kine_targets(batch: dict, cfg, device, num_track_queries: int) -> Targets:
    """The GT ``Targets`` of a ``collate_kine`` batch, with
    ``num_track_queries`` empty track slots of the config's embedding
    width."""
    trail_len, enc, meta_dim = kine_dims(cfg)
    return Targets.create(
        torch.from_numpy(batch["boxes"]), torch.from_numpy(batch["labels"]),
        torch.from_numpy(batch["valid"]), torch.from_numpy(batch["track_ids"]),
        num_track_queries=num_track_queries,
        hidden_dim=sum(kine_track_embed_dims(trail_len, enc, meta_dim)),
        device=device,
    )


def make_kine_train_step(model, criterion, optimizer, cfg, generator=None):
    """Returns ``step(batch) -> losses`` over one ``collate_kine`` batch (a
    dict of numpy arrays), with the losses as ``make_train_step``'s. The
    trail augmentation draws from ``generator`` (a CPU ``torch.Generator``,
    seeded from ``cfg.seed`` by default)."""
    _, trail_enc, _ = kine_dims(cfg)
    ratio = float(cfg.get("ratio_add_tracklets", 1.0))
    rand_count = bool(cfg.get("kine_random_tracklet_count", False))
    ratio_dets = float(cfg.get("ratio_add_detections", 0.5))
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    device = next(model.parameters()).device

    def step(batch: dict):
        optimizer.zero_grad()
        kb = kine_batch(batch, device)
        aug = add_kine_track_queries(
            generator, kine_targets(batch, cfg, device,
                                    int(cfg.max_track_queries)),
            torch.from_numpy(batch["trails"]).to(device), kb.detections,
            kb.metadata, ~kb.pad_mask, trail_enc_dim=trail_enc,
            ratio_add_tracklets=ratio, random_count=rand_count,
            ratio_add_detections=ratio_dets,
        )
        out = model(kb, aug)
        losses = criterion(out, aug)
        total = criterion.total_loss(losses)
        total.backward()
        _reduce_grads(optimizer)
        grad_norm = optimizer.step()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss"] = total.detach()
        losses["grad_norm"] = grad_norm
        return losses

    return step
