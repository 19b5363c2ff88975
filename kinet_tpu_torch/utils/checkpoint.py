"""Checkpoints and shape-adapting resume (port of
``kinet_tpu/utils/checkpoint.py``; reference src/train.py:167-282,
312-357), with ``torch.save`` in place of orbax.

A checkpoint is one file holding {"params": the model's state dict,
"opt_state": the optimizer's state dict, "step", "epoch"}:
``checkpoint.pth`` every epoch, ``checkpoint_epoch_{e}.pth`` every
``save_model_interval`` epochs and ``checkpoint_best_{metric}.pth`` each
time an evaluation improves AP, AP50, mota or idf1.

On resume a tensor whose shape differs from the model's is adapted as the
reference does: the class head keeps its first rows (optionally the
checkpoint's last, eos, row: ``resume_shift_neuron``), query embeddings are
tiled or cut, anything else copies the overlapping region. Shapes are in
the port's layout (a linear weight is [out, in]).

Under tensor parallelism (``parallel/tp.py``) the checkpoint holds the
whole tensors, gathered over the model group, and the whole AdamW
moments: every rank calls the save methods (the gathers are collective)
and rank 0 alone writes. A resume cuts each tensor to the rank's shard, so
a checkpoint saved on any number of model shards resumes on any other, and
``engine/track.py`` loads it unchanged.

``load_mask_head_from_model`` (with ``masks``) then overwrites the mask
head (``bbox_attention`` / ``mask_head``) with a second checkpoint's,
where the shapes match (reference train.py:245-254; as in the JAX package
it also applies without ``resume``, to a freshly built detector).
"""
from __future__ import annotations

import math
from pathlib import Path

import torch

from ..parallel.tp import full_state_dict, local_state_dict
from .dist import is_main_process


def _adapt_tensor(name: str, ckpt: torch.Tensor, model: torch.Tensor,
                  resume_shift_neuron: bool = False) -> torch.Tensor:
    if ckpt.shape == model.shape:
        return ckpt
    out = model.detach().clone()
    if "class_embed" in name:
        n = min(ckpt.shape[0], model.shape[0])
        out[:n] = ckpt[:n]
        if (ckpt.dim() == 1 and resume_shift_neuron
                and ckpt.shape[0] > model.shape[0]):
            out[-1] = ckpt[-1]  # the eos neuron from the checkpoint's last
        return out
    if "query_embed" in name:
        n_model, n_ckpt = model.shape[0], ckpt.shape[0]
        if n_ckpt >= n_model:
            return ckpt[:n_model]
        reps = -(-n_model // n_ckpt)
        return ckpt.repeat(reps, *([1] * (ckpt.dim() - 1)))[:n_model]
    region = tuple(slice(0, min(a, b)) for a, b in zip(ckpt.shape, model.shape))
    out[region] = ckpt[region]
    return out


@torch.no_grad()
def adapt_params(model: torch.nn.Module, state: dict,
                 resume_shift_neuron: bool = False) -> None:
    """Loads ``state`` into ``model``, adapting shapes per tensor; tensors
    missing from the checkpoint keep the model's values."""
    for name, t in model.state_dict().items():
        if name in state:
            t.copy_(_adapt_tensor(name, state[name].to(t.device), t,
                                  resume_shift_neuron))


class CheckpointManager:
    """Epoch checkpoints + best-metric bookkeeping (reference
    train.py:312-357)."""

    def __init__(self, output_dir: str, save_model_interval: int = 5):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_model_interval = save_model_interval
        self.best = {}

    def _save(self, path: Path, payload):
        if not is_main_process():
            return
        tmp = path.with_suffix(".tmp")
        torch.save(payload, tmp)
        tmp.replace(path)

    def save_preempt(self, model, optimizer, step: int, epoch: int):
        """The mid-epoch checkpoint of a preempted run: only
        ``checkpoint.pth``, recorded as epoch ``epoch - 1``, so the resumed
        run (which starts at the recorded epoch + 1) runs the interrupted
        epoch again instead of skipping its remaining steps."""
        self._save(self.dir / "checkpoint.pth",
                   {"params": full_state_dict(model),
                    "opt_state": optimizer.state_dict(),
                    "step": int(step), "epoch": int(epoch) - 1})

    def save_epoch(self, model, optimizer, step: int, epoch: int,
                   eval_stats: dict | None = None):
        """``eval_stats``: {metric: value or None} of this epoch's
        evaluation; a value above the best so far saves
        ``checkpoint_best_{metric}.pth``."""
        payload = {"params": full_state_dict(model),
                   "opt_state": optimizer.state_dict(),
                   "step": int(step), "epoch": int(epoch)}
        self._save(self.dir / "checkpoint.pth", payload)
        if self.save_model_interval and epoch % self.save_model_interval == 0:
            self._save(self.dir / f"checkpoint_epoch_{epoch}.pth", payload)
        for metric, value in (eval_stats or {}).items():
            if value is not None and value > self.best.get(metric, -math.inf):
                self.best[metric] = value
                self._save(self.dir / f"checkpoint_best_{metric}.pth", payload)

    def restore(self):
        """The payload of the latest checkpoint (``checkpoint.pth``), on the
        CPU, or None if there is none."""
        p = self.dir / "checkpoint.pth"
        return load_checkpoint(p) if p.exists() else None


def load_checkpoint(path) -> dict:
    return torch.load(Path(path), map_location="cpu", weights_only=True)


def splice_mask_head(state: dict, mask_state: dict) -> dict:
    """``state`` with every tensor under a ``bbox_attention`` or
    ``mask_head`` module taken from ``mask_state`` where it has the same
    name and shape."""
    out = dict(state)
    for name, t in state.items():
        segs = name.split(".")
        ck = mask_state.get(name)
        if (("bbox_attention" in segs or "mask_head" in segs)
                and ck is not None and ck.shape == t.shape):
            out[name] = ck
    return out


@torch.no_grad()
def load_mask_head_from_model(model: torch.nn.Module, path) -> None:
    """Splices the mask head of the checkpoint at ``path`` (a checkpoint
    file, or a run directory holding ``checkpoint.pth``) into ``model``."""
    path = Path(path)
    if path.is_dir():
        path = path / "checkpoint.pth"
    own = model.state_dict()
    spliced = splice_mask_head(
        own, local_state_dict(model, load_checkpoint(path)["params"]))
    for name, t in own.items():
        if spliced[name] is not t:
            t.copy_(spliced[name])


def load_for_resume(cfg, model, optimizer) -> tuple[int, int]:
    """Resume or transfer from ``cfg.resume`` (reference train.py:167-282):
    the weights always, the optimizer state, step and epoch with
    ``resume_optim``; then, with ``masks``, the mask head of
    ``load_mask_head_from_model``. Returns (start_epoch, step)."""
    start_epoch, step = int(cfg.start_epoch), 0
    restored = None
    if cfg.resume:
        restored = load_checkpoint(cfg.resume)
        adapt_params(model, local_state_dict(model, restored["params"]),
                     bool(cfg.resume_shift_neuron))
    if cfg.get("masks") and cfg.get("load_mask_head_from_model"):
        load_mask_head_from_model(model, cfg.load_mask_head_from_model)
    if restored is None:
        return start_epoch, step
    if cfg.resume_optim and "opt_state" in restored:
        optimizer.load_state_dict(restored["opt_state"])
        start_epoch = int(restored.get("epoch", 0)) + 1
        step = int(restored.get("step", 0))
    return start_epoch, step
