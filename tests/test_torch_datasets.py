"""kinet_tpu_torch's datasets (``data/builder.py`` and what it builds)
against the JAX package's, on tiny synthetic COCO, CrowdHuman and MOT
trees: with numpy seeded alike before each build (the datasets draw their
augmentation base seed from it), both give the same image arrays and the
same targets, bit for bit, for every index over two epochs, the previous
and the one-before-previous frames included (COCO's and CrowdHuman's
are the same image, re-augmented and cropped by a seeded jitter; MOT's are
real frames). The samplers draw the same sequences, and a dataset name
that ``build_dataset`` does not know raises."""
import json

import numpy as np
import pytest
from PIL import Image

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.data.builder import build_dataset as jax_build_dataset
from kinet_tpu.data.loader import RandomSampler as JaxRandomSampler
from kinet_tpu.data.loader import WeightedRandomSampler as JaxWeightedSampler
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.data.builder import build_dataset
from kinet_tpu_torch.data.loader import RandomSampler, WeightedRandomSampler

FLAGSHIP = ["train_deformable", "train_tracking", "train_multi_frame"]
SMALL = dict(
    track_prev_prev_frame=True, coco_min_num_objects=1,
    **{"img_transform.max_size": 96, "img_transform.val_width": 48},
)


def _images(folder, names, rng, shapes):
    folder.mkdir(parents=True, exist_ok=True)
    for name, (h, w) in zip(names, shapes):
        arr = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        Image.fromarray(arr).save(folder / name)


def _boxes(rng, h, w, n):
    out = []
    for _ in range(n):
        bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
        out.append([float(rng.uniform(0, w - bw)), float(rng.uniform(0, h - bh)),
                    float(bw), float(bh)])
    return out


def _coco_json(names, shapes, rng, cats=(1,), extra=None, empty=()):
    images, anns = [], []
    for i, (name, (h, w)) in enumerate(zip(names, shapes)):
        images.append({"id": 100 + i, "file_name": name, "height": h,
                       "width": w, **(extra(i) if extra else {})})
        if i in empty:
            continue
        for k, box in enumerate(_boxes(rng, h, w, 2 + i % 3)):
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": int(cats[k % len(cats)]), "bbox": box,
                         "area": box[2] * box[3], "iscrowd": int(k == 3),
                         "ignore": int(k == 2 and i % 2 == 1),
                         "track_id": k + 1})
    return {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": str(c)} for c in cats]}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    rng = np.random.default_rng(0)
    base = tmp_path_factory.mktemp("datasets")
    shapes = [(60, 90), (80, 64), (72, 100), (64, 64), (90, 70)]
    # COCO: two halves, two annotation modes, categories with a gap; one
    # image without objects (min_num_objects drops it)
    coco = base / "coco"
    (coco / "annotations").mkdir(parents=True)
    for half in ("train2017", "val2017"):
        names = [f"{half}_{i}.jpg" for i in range(len(shapes))]
        _images(coco / half, names, rng, shapes)
        for mode, cats in (("instances", (1, 3, 18)), ("person_keypoints", (1,))):
            (coco / "annotations" / f"{mode}_{half}.json").write_text(json.dumps(
                _coco_json(names, shapes, rng, cats, empty=(3,))))
    # CrowdHuman: train_val and val, ignore regions
    ch = base / "crowdhuman"
    (ch / "annotations").mkdir(parents=True)
    for split in ("train_val", "val"):
        names = [f"{split}_{i}.jpg" for i in range(4)]
        _images(ch / split, names, rng, shapes[:4])
        (ch / "annotations" / f"{split}.json").write_text(json.dumps(
            _coco_json(names, shapes[:4], rng)))
    # MOT: one sequence of six frames in the MOT-to-COCO layout
    mot = base / "mot"
    (mot / "annotations").mkdir(parents=True)
    names = [f"SEQ-01_{f + 1:06d}.jpg" for f in range(6)]
    _images(mot / "train", names, rng, [(64, 96)] * 6)
    seq = _coco_json(names, [(64, 96)] * 6, rng, extra=lambda f: {
        "frame_id": f, "first_frame_image_id": 100, "seq_length": 6,
        "seq": "SEQ-01"})
    for split in ("train", "val"):
        (mot / "annotations" / f"{split}.json").write_text(json.dumps(seq))
    return dict(coco_path=str(coco), crowdhuman_path=str(ch),
                mot_path_train=str(mot), mot_path_val=str(mot))


CASES = {
    "coco": ([], {"dataset": "coco"}),
    "coco_person": ([], {"dataset": "coco_person"}),
    "crowdhuman": (["train_crowdhuman"], {"crowdhuman_train_split": "train_val"}),
    "mot_crowdhuman": (["train_mot17_crowdhuman"], {}),
    "mot_crowdhuman-crowdhuman_only": (["train_mot17_crowdhuman"],
                                       {"train_split": None}),
    "mot_coco_person": (["train_mot_coco_person"], {"train_split": "train"}),
    "mot_coco_person-coco_only": (["train_mot_coco_person"], {}),
}


def _build(case, roots, split, seed=5):
    named, over = CASES[case]
    over = {**SMALL, **roots, **over}
    cfg = load_config("train.yaml", named=FLAGSHIP + named).replace(**over)
    jcfg = jax_load_config("train.yaml", named=FLAGSHIP + named).replace(**over)
    np.random.seed(seed)
    jds = jax_build_dataset(split, jcfg)
    np.random.seed(seed)
    return build_dataset(split, cfg), jds


def _assert_same_sample(got, ref, where):
    assert got.keys() == ref.keys(), where
    for key, v in ref.items():
        if isinstance(v, dict):
            assert got[key].keys() == v.keys(), (where, key)
            for f, a in v.items():
                np.testing.assert_array_equal(np.asarray(got[key][f]),
                                              np.asarray(a),
                                              err_msg=f"{where} {key}.{f}")
        else:
            assert got[key].dtype == v.dtype, (where, key)
            np.testing.assert_array_equal(got[key], v, err_msg=f"{where} {key}")


@pytest.mark.parametrize("case", list(CASES))
def test_train_samples_equal_jax(case, roots):
    ds, jds = _build(case, roots, "train")
    assert type(ds).__name__ == type(jds).__name__
    assert len(ds) == len(jds) > 0
    assert hasattr(ds, "set_epoch") == hasattr(jds, "set_epoch")
    jittered = 0
    for epoch in (1, 2):
        for d in (ds, jds):
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)
        for i in range(len(ds)):
            got, ref = ds[i], jds[i]
            assert "prev_prev_image" in got
            _assert_same_sample(got, ref, f"epoch {epoch} item {i}")
            if got["prev_image"].shape != got["image"].shape:
                jittered += 1
    if case.startswith(("coco", "crowdhuman")):
        assert jittered > 0  # the previous frame's jitter crop shows


@pytest.mark.parametrize("case", ["coco", "coco_person", "crowdhuman",
                                  "mot_crowdhuman"])
def test_val_samples_equal_jax(case, roots):
    ds, jds = _build(case, roots, "val")
    assert len(ds) == len(jds) > 0
    for i in range(len(ds)):
        _assert_same_sample(ds[i], jds[i], f"val item {i}")


@pytest.mark.parametrize("case", ["mot_crowdhuman", "mot_coco_person", "coco"])
def test_samplers_equal_jax(case, roots):
    ds, jds = _build(case, roots, "train")
    weighted = hasattr(jds, "sample_weight")
    assert hasattr(ds, "sample_weight") == weighted
    if weighted:
        np.testing.assert_array_equal(
            [ds.sample_weight(i) for i in range(len(ds))],
            [jds.sample_weight(i) for i in range(len(jds))])
    pairs = [(WeightedRandomSampler, JaxWeightedSampler),
             (RandomSampler, JaxRandomSampler)]
    for sampler, jax_sampler in pairs[0 if weighted else 1:]:
        for rank, world in ((0, 1), (1, 2)):
            a = sampler(ds, rank=rank, world_size=world, seed=7)
            b = jax_sampler(jds, rank=rank, world_size=world, seed=7)
            for epoch in (1, 2):
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                assert list(a) == list(b) and len(a) == len(b)


@pytest.mark.parametrize("name, error, item", [
    # coco_panoptic is ported (tests/test_torch_panoptic.py): a root
    # without its annotations raises as the JAX package's does
    ("coco_panoptic", FileNotFoundError, "panoptic_train2017.json"),
    # mot_kine is ported (tests/test_torch_kine.py); a name no builder
    # knows raises as in the JAX package
    ("no_such_dataset", ValueError, "unknown dataset"),
])
def test_unported_datasets_raise(name, error, item, roots):
    cfg = load_config("train.yaml").replace(
        dataset=name, coco_panoptic_path=roots["coco_path"], **roots)
    with pytest.raises(error, match=item):
        build_dataset("train", cfg)
