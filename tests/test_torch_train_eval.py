"""kinet_tpu_torch's trainer with evaluation, on the CPU:

- ``train(cfg, device="cpu")`` with ``val_interval`` 1 for two epochs on a
  synthetic MOT dataset (the layout of tests/test_train_e2e.py) whose val
  root also holds a MOT17 sequence for the tracking eval: two lines in
  ``metrics.jsonl`` with the JAX trainer's keys, ``checkpoint_best_AP.pth``
  and the other best files, the metrics sink's lines, and the model back
  in train mode for its second epoch;
- the port counterpart of tests/test_overfit.py: a tiny detector overfits
  one image in 40 steps, held to that test's own loss criteria. Its first
  case is vanilla DETR (held through the port from the JAX weights in
  tests/test_torch_detr.py) and its second enables ``enc_msda_topk``,
  which the port has not yet (ROADMAP: MSDA variants off the flagship), so
  the counterparts here are the same recipes on the deformable model
  without those flags; the input image is JAX's, drawn the same way.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.engine import evaluate as port_eval
from kinet_tpu_torch.engine.state import Optimizer
from kinet_tpu_torch.engine.train import train
from kinet_tpu_torch.engine.train_step import make_train_step
from kinet_tpu_torch.models.build import build_criterion, build_model
from kinet_tpu_torch.structs import ImageBatch, Targets

from test_track_e2e import _write_sequence

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLAGSHIP = ["train_deformable", "train_tracking", "train_multi_frame"]
SEQ = "MOT17-02-FRCNN"
TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=32, nheads=2,
    enc_layers=1, dec_layers=2, dim_feedforward=32, num_queries=8,
    max_objects=6, max_track_queries=6, dropout=0.1, batch_size=2,
    epochs=2, val_interval=1, num_workers=1, log_interval=1,
    tracking_eval=True, tracking_eval_dataset=SEQ, metrics_sink="jsonl",
    **{"img_transform.max_size": 128, "img_transform.val_width": 64,
       "size_buckets": [[64, 96], [96, 128]]},
)


@pytest.fixture(scope="module")
def mot_root(tmp_path_factory):
    """Six 64x96 frames with two moving boxes as train and val json, and a
    MOT17 sequence for the tracking eval under the same root."""
    root = tmp_path_factory.mktemp("motdata")
    (root / "train").mkdir()
    (root / "annotations").mkdir()
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for f in range(6):
        name = f"SEQ-01_{f + 1:06d}.jpg"
        arr = rng.integers(0, 120, (64, 96, 3)).astype(np.uint8)
        for tid in (1, 2):
            x = 10 + 4 * f + 20 * tid
            arr[12:42, x:x + 18] = 230
            annotations.append({
                "id": len(annotations), "image_id": f, "category_id": 1,
                "bbox": [x, 12, 18, 30], "area": 540, "iscrowd": 0,
                "track_id": tid})
        Image.fromarray(arr).save(root / "train" / name)
        images.append({"id": f, "file_name": name, "height": 64, "width": 96,
                       "frame_id": f, "first_frame_image_id": 0,
                       "seq_length": 6, "seq": "SEQ-01"})
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "person"}],
            "sequences": ["SEQ-01"]}
    for split in ("train", "val"):
        (root / "annotations" / f"{split}.json").write_text(json.dumps(coco))
    (root / "MOT17" / "test").mkdir(parents=True)
    _write_sequence(root, SEQ, n_frames=4, seed=0)
    return root


def test_train_evaluates_writes_metrics_and_best_checkpoints(
        mot_root, tmp_path, monkeypatch):
    out = tmp_path / "out"
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(
        mot_path_train=str(mot_root), mot_path_val=str(mot_root),
        output_dir=str(out), **TINY)
    modes = []
    evaluate = port_eval.evaluate

    def spy(model, *args, **kw):
        stats = evaluate(model, *args, **kw)
        modes.append(model.training)
        return stats

    monkeypatch.setattr("kinet_tpu_torch.engine.train.evaluate", spy)
    model, _, steps = train(cfg, device="cpu")
    assert steps == 6 and modes == [True, True] and model.training

    lines = [json.loads(ln) for ln in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [ln["epoch"] for ln in lines] == [1, 2]
    for ln in lines:
        assert list(ln) == ["epoch", "AP", "AP50", "mota", "idf1"]
        assert all(np.isfinite(ln[k]) for k in ("AP", "AP50", "mota", "idf1"))
    for name in ("checkpoint.pth", "checkpoint_best_AP.pth",
                 "checkpoint_best_AP50.pth", "checkpoint_best_mota.pth",
                 "checkpoint_best_idf1.pth"):
        assert (out / name).exists(), name
    sink = [json.loads(ln) for ln in
            (out / "vis" / "metrics.jsonl").read_text().splitlines()]
    series = {(p["series"], p["name"]) for p in sink}
    assert ("train iter metrics", "loss") in series
    assert ("train epoch metrics", "AP") in series
    assert sum(p["series"] == "train iter metrics" for p in sink) == 4 * steps
    assert sum(p["series"] == "train epoch metrics" for p in sink) == 4 * 2


def test_missing_val_data_skips_the_evaluation(mot_root, tmp_path, capsys):
    out = tmp_path / "out"
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(
        mot_path_train=str(mot_root), mot_path_val=str(tmp_path / "none"),
        output_dir=str(out), **{**TINY, "epochs": 1, "metrics_sink": None})
    train(cfg, device="cpu")
    assert "eval skipped (no val data)" in capsys.readouterr().out
    assert not (out / "metrics.jsonl").exists()
    assert (out / "checkpoint.pth").exists()
    assert not list(out.glob("checkpoint_best_*"))


def _jax_image():
    import jax

    return np.array(jax.random.normal(jax.random.PRNGKey(0), (1, 64, 64, 3)))


OVERFIT = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=32, nheads=2,
    dim_feedforward=64, num_queries=8, dropout=0.0, aux_loss=False,
    lr=1e-3, lr_backbone=1e-4, clip_max_norm=0.1, weight_decay=0.0,
)


@pytest.mark.parametrize("over, bbox_below", [
    # tests/test_overfit.py::test_detr_overfits_single_image's recipe and
    # criteria
    (dict(enc_layers=1, dec_layers=1), 0.35),
    # ::test_deformable_variants_overfit_single_image's; that test holds
    # the total loss only
    (dict(enc_layers=2, dec_layers=1, num_feature_levels=4, dec_n_points=2,
          enc_n_points=4, with_box_refine=False, enc_lite=True,
          enc_lite_klevels=2, enc_msda_topk=4, allow_lossy=True), None),
], ids=["detr-recipe", "deformable-variants"])
def test_overfits_single_image(over, bbox_below):
    cfg = load_config("train.yaml", named=["train_deformable"]).replace(
        **OVERFIT, **over)
    model, _ = build_model(cfg, device="cpu", seed=1)
    model.train()
    criterion = build_criterion(cfg)
    step = make_train_step(model, criterion, Optimizer(model, cfg, 10_000), cfg)
    batch = ImageBatch(torch.from_numpy(_jax_image()),
                       torch.zeros(1, 64, 64, dtype=torch.bool))
    targets = Targets.create(
        torch.tensor([[[0.3, 0.3, 0.2, 0.2], [0.7, 0.6, 0.15, 0.25]]]),
        torch.zeros(1, 2), torch.ones(1, 2), num_track_queries=0,
        hidden_dim=32)
    trace = [step(batch, targets) for _ in range(40)]
    first, last = float(trace[0]["loss"]), float(trace[-1]["loss"])
    # test_overfit.py's criteria: the loss falls below 0.55 of its start
    # and, in the first case, the box loss below 0.35
    assert last < first * 0.55, (first, last)
    if bbox_below is not None:
        assert float(trace[-1]["loss_bbox"]) < bbox_below, trace[-1]
