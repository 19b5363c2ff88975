"""kinet_tpu_torch's evaluation (``engine/evaluate.py``) against the JAX
package's ``evaluate`` on the CPU, on the same val set and bridged weights
(a tiny flagship-flag model, every class but 0 pushed down by 20 so each
query's label is 0):

- a synthetic MOT val set (the layout of tests/test_train_e2e.py) of five
  96x128 frames, evaluated at 64x85 (``val_width`` 64): an odd count, so
  the batch of 2 leaves a partial last batch that must be evaluated, and
  a resize, so boxes must be scaled to each image's original size. The
  ground truth is the model's own two best boxes a frame, shifted by one
  pixel, so the AP is high and a box scaled to the wrong size scores ~0;
- every image's boxes, scores and labels within rtol 1e-4 / atol 1e-4,
  the logged losses within 1e-4, the 12 COCO stats within 1e-3, and MOTA /
  IDF1 of the tracking eval equal;
- the model comes back in the mode and on the device it had (F3), and the
  tracking eval runs on the evaluation's device, not on a card it would
  pick itself (F4).
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.data.builder import build_dataset
from kinet_tpu_torch.engine import evaluate as port_eval
from kinet_tpu_torch.models.build import build_criterion
from kinet_tpu_torch.models.postprocess import build_postprocessors
from kinet_tpu_torch.utils import dist as port_dist

from test_torch_port_model import FLAGSHIP, TINY, port_model, tiny_params

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_track_e2e import _write_sequence

SEQ = "MOT17-02-FRCNN"
N_VAL, H, W = 5, 96, 128
VAL = dict(
    val_split="val", batch_size=2, num_workers=1, log_interval=1,
    max_objects=6, tracking_eval=True, tracking_eval_dataset=SEQ,
    **{"img_transform.max_size": 128, "img_transform.val_width": 64,
       "size_buckets": [[64, 96], [96, 128]]},
)


def _push_classes(params):
    import jax

    def push(path, x):
        key = jax.tree_util.keystr(path)
        if "class_embed" in key and "bias" in key:
            x = np.array(x)
            x[1:] -= 20.0
        return x

    return jax.tree_util.tree_map_with_path(push, params)


@pytest.fixture(scope="module")
def models():
    jmodel, params = tiny_params(seed=0)
    params = _push_classes(params)
    return jmodel, params, port_model(params)


def _cfgs(root, **over):
    over = dict(TINY, mot_path_train=str(root), mot_path_val=str(root),
                **VAL, **over)
    return (jax_load_config("train.yaml", named=FLAGSHIP).replace(**over),
            load_config("train.yaml", named=FLAGSHIP).replace(**over))


def _write_val_set(root, annotations):
    images = [{"id": f, "file_name": f"SEQ-01_{f + 1:06d}.jpg", "height": H,
               "width": W, "frame_id": f, "first_frame_image_id": 0,
               "seq_length": N_VAL, "seq": "SEQ-01"} for f in range(N_VAL)]
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "person"}],
            "sequences": ["SEQ-01"]}
    (root / "annotations").mkdir(exist_ok=True)
    for split in ("train", "val"):
        (root / "annotations" / f"{split}.json").write_text(json.dumps(coco))


@pytest.fixture(scope="module")
def val_root(tmp_path_factory, models):
    """Frames of noise with two bright boxes, a placeholder json to build
    the dataset, then the ground truth from the model's own predictions;
    the tracking eval's sequence under MOT17/train."""
    root = tmp_path_factory.mktemp("val")
    (root / "train").mkdir()
    rng = np.random.default_rng(0)
    for f in range(N_VAL):
        arr = rng.integers(0, 120, (H, W, 3)).astype(np.uint8)
        arr[10:50, 8 + 6 * f:38 + 6 * f] = 230
        arr[40:90, 70 - 4 * f:100 - 4 * f] = 200
        Image.fromarray(arr).save(root / "train" / f"SEQ-01_{f + 1:06d}.jpg")
    _write_val_set(root, [])
    (root / "MOT17" / "test").mkdir(parents=True)
    _write_sequence(root, SEQ, n_frames=4, seed=0)

    _, cfg = _cfgs(root)
    preds = _run_port(models[2], cfg)[0]
    annotations = []
    for img_id, p in sorted(preds.items()):
        for box in p["boxes"][np.argsort(-p["scores"])[:2]]:
            x0, y0, x1, y1 = (float(v) + 1.0 for v in box)
            annotations.append({
                "id": len(annotations), "image_id": img_id, "category_id": 1,
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "area": (x1 - x0) * (y1 - y0), "iscrowd": 0, "track_id": 1})
    _write_val_set(root, annotations)
    return root


class _Recorder:
    """Records what an evaluate call hands its CocoEvaluator and its
    MetricLogger."""

    def __init__(self, monkeypatch, module):
        self.preds, self.losses = {}, []
        rec = self

        class Evaluator(module.CocoEvaluator):
            def update(self, predictions):
                for k, v in predictions.items():
                    rec.preds[k] = {f: np.asarray(a) for f, a in v.items()}
                super().update(predictions)

        class Logger(module.MetricLogger):
            def update(self, **kw):
                rec.losses.append(kw)
                super().update(**kw)

        monkeypatch.setattr(module, "CocoEvaluator", Evaluator)
        monkeypatch.setattr(module, "MetricLogger", Logger)


def _run_port(model, cfg):
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp, port_eval)
        np.random.seed(0)
        stats = port_eval.evaluate(
            model, build_criterion(cfg), build_postprocessors(cfg),
            build_dataset("val", cfg), cfg, device="cpu")
    return rec.preds, rec.losses, stats


def test_evaluate_matches_jax(models, val_root, monkeypatch):
    from kinet_tpu.data.builder import build_dataset as jax_build_dataset
    from kinet_tpu.engine import evaluate as jax_eval
    from kinet_tpu.models.build import build_model as jax_build_model

    jmodel, params, model = models
    jcfg, cfg = _cfgs(val_root)
    _, jcriterion, jpost = jax_build_model(jcfg)
    jrec = _Recorder(monkeypatch, jax_eval)
    np.random.seed(0)
    ref = jax_eval.evaluate(jmodel, jcriterion, jpost, params,
                            jax_build_dataset("val", jcfg), jcfg)
    rec = _Recorder(monkeypatch, port_eval)
    np.random.seed(0)
    got = port_eval.evaluate(model, build_criterion(cfg),
                             build_postprocessors(cfg),
                             build_dataset("val", cfg), cfg, device="cpu")

    # every val image, the partial last batch's included
    assert sorted(rec.preds) == sorted(jrec.preds) == list(range(N_VAL))
    for img_id, p in jrec.preds.items():
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(rec.preds[img_id][k], p[k], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{img_id} {k}")
        np.testing.assert_array_equal(rec.preds[img_id]["labels"], p["labels"])
    assert len(rec.losses) == len(jrec.losses) == 3
    for a, b in zip(rec.losses, jrec.losses):
        assert a.keys() == b.keys() and "loss_ce_0" in a
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4, k
    assert len(got["coco_eval_bbox"]) == len(ref["coco_eval_bbox"]) == 12
    np.testing.assert_allclose(got["coco_eval_bbox"], ref["coco_eval_bbox"],
                               rtol=0, atol=1e-3)
    # the model's own boxes, shifted by a pixel: a high AP, which a box
    # scaled to the 64x85 input instead of the 96x128 original would lose
    assert got["coco_eval_bbox"][0] > 0.5
    assert got["mota"] == ref["mota"] and got["idf1"] == ref["idf1"]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_evaluate_restores_mode_and_runs_on_its_device(
        models, val_root, monkeypatch, training):
    """F3: the model leaves evaluate, and the in-process tracking eval, in
    the mode it came in; F4: with no card, the tracking eval of
    ``evaluate(..., device="cpu")`` runs on the CPU instead of raising."""
    from kinet_tpu_torch.engine import track

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = []
    main_track = track.main_track

    def spy(track_cfg, obj_detector_model=None):
        model = obj_detector_model[0]
        seen.append((track_cfg.device, model.training))
        out = main_track(track_cfg, obj_detector_model)
        seen.append(model.training)
        return out

    monkeypatch.setattr(track, "main_track", spy)
    _, _, model = models
    _, cfg = _cfgs(val_root)
    model.train(training)
    stats = _run_port(model, cfg)[2]
    # evaluate hands the tracking eval its device and an eval-mode model
    assert seen == [("cpu", False), False]
    assert model.training is training
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert "mota" in stats and "idf1" in stats

    # main_track with a live model restores the mode it was given
    track_cfg = load_config("track.yaml").replace(
        data_root_dir=str(val_root), dataset_name=SEQ, output_dir="",
        device="cpu")
    summary = main_track(track_cfg, obj_detector_model=(
        model, build_postprocessors(cfg), cfg))
    assert summary[SEQ]["mota"] == stats["mota"]
    assert model.training is training
    model.eval()


def test_evaluate_defaults_to_the_card(models, val_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs(val_root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.evaluate(models[2], build_criterion(cfg),
                           build_postprocessors(cfg),
                           build_dataset("val", cfg), cfg)


def test_kine_evaluation_raises(models, val_root, monkeypatch):
    """KineT evaluation is ported (tests/test_torch_kine.py), and so is
    evaluation over several processes (tests/test_torch_dist.py): the val
    loader's sampler is the process's shard, by the process group's rank
    and size (WORLD_SIZE in the environment alone shards nothing). The
    loader is stopped with an exception once its sampler is seen."""
    _, cfg = _cfgs(val_root)
    seen = []

    class Stop(Exception):
        pass

    def loader(dataset, sampler, **kw):
        seen.append((sampler.rank, sampler.world_size))
        raise Stop

    monkeypatch.setattr(port_eval, "DataLoader", loader)
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = (models[2], build_criterion(cfg), build_postprocessors(cfg),
            build_dataset("val", cfg), cfg.replace(kine=True))
    with pytest.raises(Stop):
        port_eval.evaluate(*args, device="cpu")
    # the sampler takes the model's data shard (parallel/mesh.py), which
    # without tensor parallelism is the process's
    monkeypatch.setattr(port_dist, "get_rank", lambda: 1)
    monkeypatch.setattr(port_dist, "get_world_size", lambda: 2)
    with pytest.raises(Stop):
        port_eval.evaluate(*args, device="cpu")
    assert seen == [(0, 1), (1, 2)]
