"""kinet_tpu_torch's panoptic parts against the JAX package's, on the CPU:

- ``rgb2id`` / ``id2rgb`` (panopticapi's segment-id colour code);
- ``CocoPanoptic`` built by ``build_dataset`` (``coco_panoptic``) on a tiny
  panoptic tree, on the ``val`` split, whose transform draws nothing (the
  ``train`` split draws from an unseeded generator in both packages):
  images and targets, per-segment masks included, bit for bit;
- ``postprocess_panoptic`` (thing and stuff queries, a merged stuff class,
  a segment under 4 pixels dropped, nothing above the threshold) and
  ``panoptic_quality`` / ``PanopticEvaluator``: the same segment maps,
  segment lists and PQ / SQ / RQ counts;
- the masked model for the panoptic dataset's 250 classes builds.
"""
import json

import numpy as np
import pytest
from PIL import Image

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.data import coco_panoptic as jax_cp
from kinet_tpu.data.builder import build_dataset as jax_build_dataset
from kinet_tpu.models import panoptic as jax_panoptic
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.data import coco_panoptic as cp
from kinet_tpu_torch.data.builder import build_dataset
from kinet_tpu_torch.models import panoptic
from kinet_tpu_torch.models.build import build_criterion, build_model

SHAPES = [(40, 56), (48, 40), (36, 60)]
IMG = {"img_transform.max_size": 64, "img_transform.val_width": 32}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """coco_path/val2017 JPEGs, coco_panoptic_path/annotations/
    panoptic_val2017.json and panoptic_val2017/ PNG id maps: rectangles of
    things and stuff on a void background, one segment listed but absent."""
    base = tmp_path_factory.mktemp("panoptic")
    rng = np.random.default_rng(0)
    coco, pan = base / "coco", base / "panoptic"
    for split in ("train2017", "val2017"):
        (coco / split).mkdir(parents=True)
        (pan / f"panoptic_{split}").mkdir(parents=True)
        images, anns = [], []
        for i, (h, w) in enumerate(SHAPES):
            name = f"{i:012d}"
            Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(
                coco / split / f"{name}.jpg")
            ids = np.zeros((h, w), np.int64)
            segs = []
            for k in range(3 + i):
                sid = int(rng.integers(1, 2 ** 24))
                y0, x0 = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
                ids[y0:y0 + int(rng.integers(4, 16)),
                    x0:x0 + int(rng.integers(4, 16))] = sid
                segs.append({"id": sid, "category_id": int(rng.integers(1, 200)),
                             "iscrowd": 0})
            segs.append({"id": 77, "category_id": 3, "iscrowd": 0})  # absent
            Image.fromarray(cp.id2rgb(ids)).save(
                pan / f"panoptic_{split}" / f"{name}.png")
            images.append({"id": 300 - i, "file_name": f"{name}.jpg",
                           "height": h, "width": w})
            anns.append({"image_id": 300 - i, "file_name": f"{name}.png",
                         "segments_info": segs})
        (pan / "annotations").mkdir(exist_ok=True)
        (pan / "annotations" / f"panoptic_{split}.json").write_text(json.dumps(
            {"images": images, "annotations": anns, "categories": []}))
    return dict(coco_path=str(coco), coco_panoptic_path=str(pan))


def test_rgb_id_code_matches_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 2 ** 24, (7, 9))
    rgb = cp.id2rgb(ids)
    np.testing.assert_array_equal(rgb, jax_cp.id2rgb(ids))
    np.testing.assert_array_equal(cp.rgb2id(rgb), ids)
    np.testing.assert_array_equal(cp.rgb2id(rgb), jax_cp.rgb2id(rgb))


def test_coco_panoptic_val_samples_match_jax(roots):
    over = dict(dataset="coco_panoptic", masks=True, **roots, **IMG)
    ds = build_dataset("val", load_config("train.yaml").replace(**over))
    jds = jax_build_dataset("val", jax_load_config("train.yaml").replace(**over))
    assert type(ds).__name__ == "CocoPanoptic" and len(ds) == len(jds) == 3
    for i in range(len(ds)):
        got, ref = ds[i], jds[i]
        np.testing.assert_array_equal(got["image"], ref["image"])
        assert got["target"].keys() == ref["target"].keys()
        for k, v in ref["target"].items():
            assert np.asarray(got["target"][k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got["target"][k], v, err_msg=f"{i} {k}")
        masks = got["target"]["masks"]
        assert masks.dtype == bool and masks.shape[1:] == got["image"].shape[:2]
        assert len(masks) == len(got["target"]["labels"]) > 0
    # images sorted by id; image 300 is the first written
    assert [im["id"] for im in ds.coco["images"]] == [298, 299, 300]


def _outputs(seed, q=7, c=6, h=10, w=12):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (q, c + 1)).astype(np.float32)
    logits[np.arange(q), rng.integers(0, c, q)] += 6.0  # confident queries
    logits[5, -1] += 12.0  # a no-object query
    masks = rng.normal(0, 1, (q, h, w)).astype(np.float32)
    masks[6] -= 4.0  # a query that wins no pixel
    masks[4, 0, 0] += 20.0  # a query that wins one pixel only
    return logits, masks


IS_THING = {0: True, 1: False, 2: True, 3: False, 4: True, 5: False}


@pytest.mark.parametrize("threshold", [0.85, 0.999999])
def test_postprocess_panoptic_matches_jax(threshold):
    logits, masks = _outputs(2)
    got = panoptic.postprocess_panoptic(logits, masks, IS_THING, threshold)
    ref = jax_panoptic.postprocess_panoptic(logits, masks, IS_THING, threshold)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].dtype == ref[0].dtype
    assert got[1] == ref[1]
    if threshold < 0.9:
        assert got[1] and any(not s["isthing"] for s in got[1])


def test_panoptic_quality_and_evaluator_match_jax():
    pairs = []
    for seed in (3, 4, 5):
        logits, masks = _outputs(seed)
        pred = panoptic.postprocess_panoptic(logits, masks, IS_THING)
        gt_logits = logits + np.random.default_rng(seed).normal(0, 0.1, logits.shape)
        gt_masks = masks + np.random.default_rng(seed + 10).normal(0, 1.0, masks.shape)
        gt = panoptic.postprocess_panoptic(gt_logits.astype(np.float32),
                                           gt_masks.astype(np.float32), IS_THING)
        pairs.append((gt, pred))
    gts, preds = [g for g, _ in pairs], [p for _, p in pairs]
    got = panoptic.panoptic_quality(gts, preds)
    assert got == jax_panoptic.panoptic_quality(gts, preds)
    assert got["tp"] > 0 and (got["fp"] + got["fn"]) > 0 and 0 < got["pq"] < 1
    ev = panoptic.PanopticEvaluator(gts)
    ev.update(preds[:2])
    ev.update(preds[2:])
    ev.synchronize_between_processes()
    assert ev.summarize() == got
    assert panoptic.PanopticEvaluator().summarize() is None


def test_masked_model_for_coco_panoptic_builds(roots):
    cfg = load_config("train.yaml").replace(
        dataset="coco_panoptic", masks=True, backbone="resnet_test",
        hidden_dim=32, nheads=2, enc_layers=1, dec_layers=1,
        dim_feedforward=32, num_queries=4, **roots)
    model, _ = build_model(cfg, device="cpu")
    assert model.class_embed.out_features == 251  # 250 classes + no-object
    crit = build_criterion(cfg)
    assert "masks" in crit.losses and crit.weight_dict["loss_dice"] == 1.0
