"""kinet_tpu_torch's trainer entry point on the CPU: ``train(cfg)`` over a
synthetic MOT-format COCO dataset on disk (the layout of
tests/test_train_e2e.py) with the flagship's flags at a tiny width: the
loader, the weighted sampler, the tracking train step and the checkpoint;
then ``main(argv)``, the command line, resumes from that checkpoint. What
the trainer does not port yet raises NotImplementedError naming its
ROADMAP item."""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from kinet_tpu_torch.config import load_config, load_saved_config
from kinet_tpu_torch.engine.train import main, train
from kinet_tpu_torch.utils.checkpoint import load_checkpoint

FLAGSHIP = ["train_deformable", "train_tracking", "train_multi_frame"]
TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=32, nheads=2,
    enc_layers=2, dec_layers=2, dim_feedforward=32, num_queries=8,
    max_objects=6, max_track_queries=6, dropout=0.1, batch_size=2,
    epochs=1, num_workers=1, debug=True, val_interval=0, log_interval=1,
    **{"img_transform.max_size": 128, "img_transform.val_width": 64,
       "size_buckets": [[64, 96], [96, 128]]},
)


@pytest.fixture(scope="module")
def mot_root(tmp_path_factory):
    """Six 64x96 frames of one sequence with two moving boxes."""
    root = tmp_path_factory.mktemp("motdata")
    (root / "train").mkdir()
    (root / "annotations").mkdir()
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for f in range(6):
        name = f"SEQ-01_{f + 1:06d}.jpg"
        Image.fromarray(rng.integers(0, 255, (64, 96, 3)).astype(np.uint8)).save(
            root / "train" / name)
        images.append({"id": f, "file_name": name, "height": 64, "width": 96,
                       "frame_id": f, "first_frame_image_id": 0,
                       "seq_length": 6, "seq": "SEQ-01"})
        for tid in (1, 2):
            annotations.append({
                "id": len(annotations), "image_id": f, "category_id": 1,
                "bbox": [10 + 4 * f + 20 * tid, 12, 18, 30], "area": 540,
                "iscrowd": 0, "track_id": tid,
            })
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "person"}],
            "sequences": ["SEQ-01"]}
    (root / "annotations" / "train.json").write_text(json.dumps(coco))
    return root


def _cfg(mot_root, out_dir, **over):
    return load_config("train.yaml", named=FLAGSHIP).replace(
        mot_path_train=str(mot_root), mot_path_val=str(mot_root),
        output_dir=str(out_dir), **{**TINY, **over})


def test_train_writes_a_checkpoint_and_resumes(mot_root, tmp_path):
    out = tmp_path / "out"
    model, optimizer, steps = train(_cfg(mot_root, out), device="cpu")
    assert steps >= 1 and optimizer.num_updates == steps
    assert load_saved_config(out).hidden_dim == 32
    ckpt = load_checkpoint(out / "checkpoint.pth")
    assert ckpt["epoch"] == 1 and ckpt["step"] == steps
    for name, p in model.state_dict().items():
        torch.testing.assert_close(ckpt["params"][name], p, rtol=0, atol=0)

    # the command line: resume weights, optimizer, step and epoch
    argv = ["--config", "train.yaml", "--named", *FLAGSHIP, "--",
            f"mot_path_train={mot_root}", f"mot_path_val={mot_root}",
            f"output_dir={tmp_path / 'resumed'}",
            f"resume={out / 'checkpoint.pth'}", "resume_optim=true", "epochs=2",
            *[f"{k}={json.dumps(v)}" for k, v in TINY.items() if k != "epochs"]]
    _, opt2, steps2 = main(["--device", "cpu", *argv])
    assert steps2 == 2 * steps and opt2.num_updates == 2 * steps
    assert (tmp_path / "resumed" / "checkpoint.pth").exists()


@pytest.mark.parametrize("over, item", [
    ({"mesh.model": 2}, "mesh.data -1 x mesh.model 2"),
    # KineT, vanilla DETR and masks train (tests/test_torch_kine.py,
    # tests/test_torch_detr.py, tests/test_torch_mots.py), and two-stage
    # (tests/test_torch_two_stage.py) with masks or without; data-parallel
    # and tensor-parallel processes do too (tests/test_torch_ddp.py,
    # tests/test_torch_parallel.py), on as many processes as the mesh has
    ({"masks": True, "two_stage": True}, "two-stage"),
    ({"two_stage": True}, "two-stage"),
    ({"mesh.data": 2, "mesh.model": 2, "batch_size": 2},
     "mesh.data 2 x mesh.model 2"),
])
def test_unported_parts_raise(mot_root, tmp_path, over, item):
    """A mesh of more processes than the group has raises; two-stage,
    which an earlier slice refused, trains an epoch with its encoder
    proposals' ``_enc`` losses and writes its checkpoint."""
    cfg = _cfg(mot_root, tmp_path / "out", **over)
    if item.startswith("mesh"):
        with pytest.raises(ValueError, match=item):
            train(cfg, device="cpu")
        return
    model, optimizer, steps = train(cfg, device="cpu")
    assert steps >= 1 and optimizer.num_updates == steps
    assert model.two_stage and (tmp_path / "out" / "checkpoint.pth").exists()
    ckpt = load_checkpoint(tmp_path / "out" / "checkpoint.pth")
    assert any("transformer.enc_output" in k for k in ckpt["params"])


def test_train_defaults_to_the_card(mot_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(_cfg(mot_root, tmp_path / "out"))


def test_dataset_and_collate_match_jax(mot_root, tmp_path):
    """The port's MOT dataset, samplers and collate against the JAX
    package's on the same files and seeds: identical arrays."""
    from kinet_tpu.config import load_config as jax_load_config
    from kinet_tpu.data.builder import build_dataset as jax_build_dataset
    from kinet_tpu.data.loader import WeightedRandomSampler as JaxSampler
    from kinet_tpu.data.loader import collate_tracking as jax_collate
    from kinet_tpu_torch.data.builder import build_dataset
    from kinet_tpu_torch.data.loader import WeightedRandomSampler, collate_tracking

    over = dict(mot_path_train=str(mot_root), mot_path_val=str(mot_root), **TINY)
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**over)
    jcfg = jax_load_config("train.yaml", named=FLAGSHIP).replace(**over)
    np.random.seed(3)
    ds = build_dataset("train", cfg)
    np.random.seed(3)
    jds = jax_build_dataset("train", jcfg)
    for d in (ds, jds):
        d.set_epoch(2)
    order = list(WeightedRandomSampler(ds, seed=4))
    assert order == list(JaxSampler(jds, seed=4))
    args = (cfg.size_buckets, cfg.max_objects, cfg.max_track_queries, cfg.hidden_dim)
    got = collate_tracking([ds[i] for i in order[:2]], *args)
    ref = jax_collate([jds[i] for i in order[:2]], *args)
    for key in ("image", "prev_image"):
        np.testing.assert_array_equal(got[key].images.numpy(), np.asarray(ref[key].images))
        np.testing.assert_array_equal(got[key].pad_mask.numpy(), np.asarray(ref[key].pad_mask))
    for key in ("target", "prev_target"):
        for field in ("boxes", "labels", "valid", "track_ids"):
            np.testing.assert_array_equal(
                getattr(got[key], field).numpy(), np.asarray(getattr(ref[key], field)),
                err_msg=f"{key}.{field}")
    assert got["target"].valid.any()
