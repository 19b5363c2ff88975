"""The MOTS cell at a tiny size on the CPU (``tiny_mots.py``: added as new
files): it runs through ``harness.run_cell`` with ``correct`` true, the
faults its check has to catch (and a run that lost the traffic's load)
make it incorrect, the fp8 control reads
far above bfloat16, and ``counts/segm.py`` agrees with PyTorch's FLOP
counter."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmarks import control_mots, harness
from benchmarks.counts import segm
from benchmarks.reference.detr_segm import DetrSegm
from benchmarks.tests import tiny_mots
from benchmarks.tests.test_bench_harness import fault_half_batch

SEED = 2**31 + 7


def run(tmp_path, precision="float32", seed=SEED, trace=False):
    root, bench = tiny_mots.make_root(tmp_path, tiny_mots.tiny_config(
        precision=precision))
    return harness.run_cell("tiny.mots", seed, 1.0, trace, "cpu", bench, root)


def test_the_tiny_cell_is_correct(tmp_path):
    res, _, record, _ = run(tmp_path, trace=True)
    nums = record["check"]
    assert res["correct"], res["checks"]
    assert nums["state_mismatches"] == 0 and nums["stage_mismatches"] == 0
    assert record["live_tracks"] > 1.0 and record["frames"] > 0
    # the window times a whole second of steps, the keeping left out
    assert record["window_s"] >= 1.0 and record["kept_s"] > 0
    assert nums["live_tracks_gap"] <= 0.2
    assert len(record["check_samples"]) == 3
    # the traced run's program spans are read (the device's are not: CPU)
    assert set(res["metrics"]) >= {"mask_fetch_ms", "mask_resolve_ms"}
    assert record["program"]["counters"]["mask_rows"] > 0


def fault_moved_logit(monkeypatch):
    """One mask logit of every row moved where the mask head returns."""
    from kinet_tpu_torch.models import segmentation

    forward = segmentation.MaskHeadSmallConv.forward

    def moved(self, *args):
        out = forward(self, *args)
        out[..., 2, 3] += 4.0
        return out

    monkeypatch.setattr(segmentation.MaskHeadSmallConv, "forward", moved)


def fault_flipped_pixel(monkeypatch):
    """One pixel of the first live track's resolved mask flipped."""
    from kinet_tpu_torch.tracking import tracker

    resolve = tracker.Tracker._resolve_masks

    def flipped(self, hw):
        resolve(self, hw)
        self.tracks[0].mask[5, 7] = ~self.tracks[0].mask[5, 7]

    monkeypatch.setattr(tracker.Tracker, "_resolve_masks", flipped)


def fault_lost_load(monkeypatch):
    """The keep threshold steered to 1 from the window on: the run serves
    almost no live track instead of the traffic's."""
    from benchmarks.loops import batched_mots

    def lost(self, births, expired, live):
        for tr in self.bt.trackers:
            tr.track_obj_score_thresh = tr.reid_score_thresh = 1.0

    monkeypatch.setattr(batched_mots.Steer, "steer", lost)


@pytest.mark.parametrize("fault", [fault_moved_logit, fault_flipped_pixel,
                                   fault_half_batch, fault_lost_load])
def test_faults_make_the_cell_incorrect(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    res, _, _, _ = run(tmp_path)
    assert not res["correct"], res["checks"]


def test_fp8_control_reads_far_above_bfloat16(tmp_path):
    _, _, record, ctx = run(tmp_path, precision="bfloat16", seed=11)
    prog = record["check"]
    ctrl = control_mots.control_numbers(ctx, "cpu")
    for k in ("feature_gap", "memory_gap", "mask_gap"):
        assert ctrl[k] > 3 * prog[k], (k, prog, ctrl)


@pytest.mark.parametrize("hw", [(64, 96), (100, 164)])
def test_counts_agree_with_the_flop_counter(hw):
    cfg = dict(tiny_mots.TINY, num_classes=20, focal_loss=False, masks=True)
    model = DetrSegm(cfg).eval()
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    t = cfg["max_track_queries"]
    images = torch.randn(1, *hw, 3)
    pad = torch.zeros(1, *hw, dtype=torch.bool)
    with torch.inference_mode():
        with FlopCounterMode(display=False) as whole:
            model(images, pad, torch.zeros(1, t, cfg["hidden_dim"]),
                  torch.ones(1, t, dtype=torch.bool),
                  torch.tensor([[float(hw[0]), float(hw[1])]]))
        feats = model.features(images)
        enc = model.encode(feats[-1], pad)
        hs = torch.randn(t + cfg["num_queries"], cfg["hidden_dim"])
        b, d, h, w = enc["src_proj"].shape
        with FlopCounterMode(display=False) as head:
            model.mask_logits(hs, enc["memory"].view(h, w, d), enc["pad"][0],
                              enc["src_proj"][0],
                              [f[0] for f in feats[-2::-1]])
    want = segm.frame_flops(cfg, *hw, t)
    assert want["total"] == whole.get_total_flops()
    assert segm.mask_head(cfg, *hw, t + cfg["num_queries"])["flops"] \
        == head.get_total_flops()
    assert [lv[:2] for lv in segm.levels(cfg, *hw)] == \
        [tuple(f.shape[-2:]) for f in feats]
    # each op's least bytes: more than the head's tensors of the C2 level
    q, n2 = t + cfg["num_queries"], np.prod(feats[0].shape[-2:])
    assert segm.mask_head(cfg, *hw, q)["bytes"] > 2 * q * n2 * d // 8 * 2
