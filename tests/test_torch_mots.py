"""kinet_tpu_torch's MOTS path against the JAX package's, on the CPU:

- the RLE wire format (``utils/rle.py``): the same strings and counts as
  the JAX package's for empty, full, noisy and large masks, and round trips;
- ``load_mots_gt`` on a MOTS20 ``gt.txt`` (an ignore region, an empty
  mask);
- MOT samples with ``segmentation`` RLEs (masks through the crop, flip and
  nearest resize) bit for bit over two epochs, and their collate (masks f32
  [b, max_objects, H, W] at the padded size);
- the tracker over a synthetic MOTS20 sequence (the published
  ``train_tracking`` + ``train_mots20`` model at a tiny width on bridged
  weights): ``main_track`` of both packages writes byte-identical MOTS
  result files and the same metrics, after the same mask probabilities
  (within 1e-5) every frame, with every result mask boolean, disjoint and
  of the padded input size (no score the tracker compares lies within 1e-3
  of its threshold; no track mask probability within 1e-4 of 0.5, and no
  pixel's winning track within 1e-4 of the runner-up);
- the tracker's host state machine with masks (track, re-identified and
  new-detection masks, masks kept from earlier frames, the per-pixel
  overlap resolution with its ties) on the same forward outputs as the
  JAX tracker's: the same results, masks bit for bit;
- the training CLI on the ``train_mots20`` recipe with its evaluation and
  the tracking eval over the MOTS20 sequence.
"""
import configparser
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.data import mots20_sequence as jax_mots
from kinet_tpu.data.builder import build_dataset as jax_build_dataset
from kinet_tpu.data.loader import collate_tracking as jax_collate
from kinet_tpu.engine import track as jax_track
from kinet_tpu.models.build import build_model as jax_build_model
from kinet_tpu.tracking import tracker as jax_tracker
from kinet_tpu.utils import rle as jax_rle
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.data import mots20_sequence as mots
from kinet_tpu_torch.data.builder import build_dataset
from kinet_tpu_torch.data.loader import collate_tracking
from kinet_tpu_torch.data.sequences import TrackDatasetFactory
from kinet_tpu_torch.engine import track
from kinet_tpu_torch.models.build import build_model
from kinet_tpu_torch.models.segmentation import SegmWrapper
from kinet_tpu_torch.tools.from_jax import load_jax_params
from kinet_tpu_torch.tracking import tracker as port_tracker
from kinet_tpu_torch.utils import rle

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MOTS = ["train_tracking", "train_mots20"]
TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=32, nheads=2,
    enc_layers=1, dec_layers=1, dim_feedforward=48, num_queries=8,
    max_track_queries=6, max_objects=6, dropout=0.0,
    compute_dtype="float32",
)
SEQ, N_FRAMES, H, W = "MOTS20-02", 5, 48, 64
IMG = {"img_transform.max_size": 64, "img_transform.val_width": 48}
THRESH = dict(detection_obj_score_thresh=0.7, track_obj_score_thresh=0.6,
              reid_score_thresh=0.6)


def _objects(frame):
    """(track id, y0, x0, h, w) of the sequence's three walkers."""
    return [(1, 6, 4 + 3 * frame, 20, 10), (2, 20, 40 - 2 * frame, 24, 12),
            (3, 2, 30, 10, 8)]


def _mask(y0, x0, h, w):
    m = np.zeros((H, W), bool)
    m[y0:y0 + h, x0:x0 + w] = True
    return m


def write_mots_sequence(root):
    """A MOTS20 sequence: JPEG frames with bright walkers on noise and a
    ``gt.txt`` of RLE lines (class 2, ids 2000 + n; one ignore region
    10000; frame 3 has an empty mask line)."""
    seq = root / "MOTS20" / "train" / SEQ
    (seq / "img1").mkdir(parents=True)
    (seq / "gt").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for f in range(N_FRAMES):
        img = rng.integers(0, 90, (H, W, 3)).astype(np.uint8)
        for tid, y0, x0, h, w in _objects(f):
            img[y0:y0 + h, x0:x0 + w] = 60 + 60 * tid
            enc = rle.mask_to_rle(_mask(y0, x0, h, w))
            lines.append(f"{f + 1} {2000 + tid} 2 {H} {W} {enc['counts']}")
        Image.fromarray(img).save(seq / "img1" / f"{f + 1:06d}.jpg")
        ignore = rle.mask_to_rle(_mask(40, 56, 6, 6))["counts"]
        lines.append(f"{f + 1} 10000 10 {H} {W} {ignore}")
    empty = rle.mask_to_rle(np.zeros((H, W), bool))["counts"]
    lines.append(f"3 2009 2 {H} {W} {empty}")
    (seq / "gt" / "gt.txt").write_text("\n".join(lines) + "\n")
    cfgp = configparser.ConfigParser()
    cfgp["Sequence"] = {"name": SEQ, "imDir": "img1", "frameRate": "30",
                        "seqLength": str(N_FRAMES), "imWidth": str(W),
                        "imHeight": str(H), "imExt": ".jpg"}
    with open(seq / "seqinfo.ini", "w") as fh:
        cfgp.write(fh)
    return seq


def write_mot_json_tree(root):
    """The MOT-to-COCO layout of the same frames, with ``segmentation``
    RLEs (one annotation an ignore region)."""
    (root / "annotations").mkdir(parents=True)
    (root / "train").mkdir()
    rng = np.random.default_rng(1)
    images, anns = [], []
    for f in range(N_FRAMES):
        name = f"{SEQ}_{f + 1:06d}.jpg"
        Image.fromarray(rng.integers(0, 255, (H, W, 3)).astype(np.uint8)).save(
            root / "train" / name)
        images.append({"id": f, "file_name": name, "height": H, "width": W,
                       "frame_id": f, "first_frame_image_id": 0,
                       "seq_length": N_FRAMES, "seq": SEQ})
        for tid, y0, x0, h, w in _objects(f):
            anns.append({"id": len(anns), "image_id": f, "category_id": 1,
                         "bbox": [x0, y0, w, h], "area": h * w, "iscrowd": 0,
                         "track_id": tid, "ignore": int(tid == 3 and f % 2),
                         "segmentation": rle.mask_to_rle(_mask(y0, x0, h, w))})
    doc = {"images": images, "annotations": anns, "sequences": [SEQ],
           "categories": [{"id": 1, "name": "person"}]}
    for split in ("train", "val"):
        (root / "annotations" / f"{split}.json").write_text(json.dumps(doc))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mots")
    write_mots_sequence(root)
    write_mot_json_tree(root)
    return root


@pytest.mark.parametrize("case", ["noise", "empty", "full", "first-pixel",
                                  "large"])
def test_rle_matches_jax(case):
    rng = np.random.default_rng(5)
    mask = {
        "noise": rng.uniform(size=(13, 17)) > 0.5,
        "empty": np.zeros((8, 5), bool),
        "full": np.ones((8, 5), bool),
        "first-pixel": np.eye(6, 9, dtype=bool),
        "large": np.pad(np.ones((700, 40), bool), ((300, 80), (1000, 880))),
    }[case]
    got, ref = rle.mask_to_rle(mask), jax_rle.mask_to_rle(mask)
    assert got == ref
    counts = rle.rle_decode_counts(got["counts"])
    assert counts == jax_rle.rle_decode_counts(ref["counts"])
    assert rle.rle_encode_counts(counts) == got["counts"]
    np.testing.assert_array_equal(rle.rle_to_mask(got["counts"], mask.shape),
                                  mask)
    np.testing.assert_array_equal(rle.rle_to_mask(counts, mask.shape), mask)


def test_load_mots_gt_matches_jax(data_root):
    gt = data_root / "MOTS20" / "train" / SEQ / "gt" / "gt.txt"
    got, ref = mots.load_mots_gt(str(gt)), jax_mots.load_mots_gt(str(gt))
    assert got.keys() == ref.keys() == set(range(1, N_FRAMES + 1))
    for f in ref:
        assert len(got[f]) == len(ref[f])
        for a, b in zip(got[f], ref[f]):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f} {k}")
    assert any(o["ignore"] for o in got[1])
    assert not got[3][-1]["mask"].any()


def _datasets(data_root, split, seed=4):
    over = dict(TINY, mot_path_train=str(data_root),
                mot_path_val=str(data_root), **IMG)
    cfg = load_config("train.yaml", named=MOTS).replace(**over)
    jcfg = jax_load_config("train.yaml", named=MOTS).replace(**over)
    np.random.seed(seed)
    ds = build_dataset(split, cfg)
    np.random.seed(seed)
    return ds, jax_build_dataset(split, jcfg)


@pytest.mark.parametrize("split", ["train", "val"])
def test_mot_samples_with_masks_match_jax(data_root, split):
    ds, jds = _datasets(data_root, split)
    assert len(ds) == len(jds) == N_FRAMES
    for epoch in (1, 2):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        samples = []
        for i in range(len(ds)):
            got, ref = ds[i], jds[i]
            assert got.keys() == ref.keys()
            for key in ("image", "prev_image"):
                np.testing.assert_array_equal(got[key], ref[key])
            for key in ("target", "prev_target"):
                assert got[key].keys() == ref[key].keys()
                assert "masks" in got[key]
                for k, v in ref[key].items():
                    assert np.asarray(got[key][k]).dtype == np.asarray(v).dtype
                    np.testing.assert_array_equal(got[key][k], v,
                                                  err_msg=f"{i} {key}.{k}")
            assert got["target"]["masks"].shape[1:] == got["image"].shape[:2]
            samples.append((got, ref))
        batch = collate_tracking([s[0] for s in samples[:2]], [[48, 64]], 6,
                                 6, 32)
        jbatch = jax_collate([s[1] for s in samples[:2]], [[48, 64]], 6, 6, 32)
        for key in ("target", "prev_target"):
            masks = batch[key].masks
            assert masks.dtype == torch.float32 and masks.shape[1] == 6
            assert masks.shape[2:] == batch["image"].images.shape[1:3]
            np.testing.assert_array_equal(masks.numpy(),
                                          np.asarray(jbatch[key].masks))


def _models():
    """The JAX MOTS model with its params and the port model on the same
    weights; the class heads' biases of every real class but 0 (person)
    pushed down by 20, so every query's label is 0. The mask head reads
    its queries: the attention maps' input channels of ``lay1`` scaled by
    2000 (a map's values are ~1 / (heads * h * w)) and ``q_linear`` by 5,
    so each query's mask is its own; ``out_lay`` doubled with its bias
    lowered by 2, so masks are small blobs. With random weights and no
    such scaling every query's mask probabilities agree to ~1e-6, and the
    per-pixel winner between tracks is decided by rounding."""
    jcfg = jax_load_config("train.yaml", named=MOTS).replace(**TINY, **IMG)
    cfg = load_config("train.yaml", named=MOTS).replace(**TINY, **IMG)
    jmodel, _, _ = jax_build_model(jcfg)
    from kinet_tpu.structs import ImageBatch as JaxImageBatch
    from kinet_tpu.structs import Targets as JaxTargets

    t = int(TINY["max_track_queries"])
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(2),
        JaxImageBatch(images=jnp.zeros((1, H, W, 3)),
                      pad_mask=jnp.zeros((1, H, W), bool)),
        JaxTargets.create(jnp.zeros((1, 1, 4)), jnp.zeros((1, 1), jnp.int32),
                          jnp.zeros((1, 1), bool), num_track_queries=t,
                          hidden_dim=32)))

    def push(path, x):
        key = jax.tree_util.keystr(path)
        x = np.array(x)
        if "class_embed" in key and "bias" in key:
            x[1:-1] -= 20.0
        if "mask_head" in key and "lay1" in key and "kernel" in key:
            x[:, :, -2:, :] *= 2000.0  # the 2 heads' attention maps
        if "bbox_attention" in key and "q_linear" in key and "kernel" in key:
            x *= 5.0
        if "out_lay" in key:
            x = x * 2.0 - 2.0 * ("bias" in key)
        return x

    params = jax.tree_util.tree_map_with_path(push, params)
    model, _ = build_model(cfg, device="cpu")
    assert type(model) is SegmWrapper
    load_jax_params(model, params)
    return jcfg, jmodel, params, cfg, model


def _track_cfg(load, root, out, **over):
    return load("track.yaml").replace(
        data_root_dir=str(root), dataset_name=SEQ, output_dir=str(out),
        **{f"tracker_cfg.{k}": v for k, v in THRESH.items()}, **over)


def test_main_track_mots20_matches_jax(data_root, tmp_path, monkeypatch):
    jcfg, jmodel, params, cfg, model = _models()
    probs, scores = {"jax": [], "port": []}, []

    def recording(cls, key):
        consume = cls._consume

        def wrapped(self, out, blob):
            probs[key].append(np.array(out["mask_probs"]))
            if key == "port":
                scores.append(out["scores"])
            consume(self, out, blob)
            masks = [r[self.frame_index - 1]["mask"]
                     for r in self.results.values()
                     if self.frame_index - 1 in r]
            if key == "port" and masks:
                stack = np.stack(masks)
                assert stack.dtype == bool and stack.shape[1:] == (H, W)
                assert stack.sum(0).max() <= 1  # disjoint

        monkeypatch.setattr(cls, "_consume", wrapped)

    recording(jax_tracker.Tracker, "jax")
    recording(port_tracker.Tracker, "port")
    resolved = []
    resolve = port_tracker.Tracker._resolve_masks

    def recording_resolve(self, hw):
        resolved.append(np.stack([t.mask for t in self.tracks
                                  if t.mask is not None]))
        resolve(self, hw)

    monkeypatch.setattr(port_tracker.Tracker, "_resolve_masks",
                        recording_resolve)
    ref = jax_track.main_track(
        _track_cfg(jax_load_config, data_root, tmp_path / "jax"),
        obj_detector_model=(jmodel, params, None, jcfg))
    got = track.main_track(
        _track_cfg(load_config, data_root, tmp_path / "port", device="cpu"),
        obj_detector_model=(model, None, cfg))

    assert len(probs["port"]) == len(probs["jax"]) == N_FRAMES
    for a, b in zip(probs["port"], probs["jax"]):
        assert a.shape == (6 + 8, H, W)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    # every score the tracker compares is 1e-3 from its threshold
    flat = np.concatenate(scores)
    for k in THRESH.values():
        assert np.abs(flat - k).min() > 1e-3, k
    # every track mask probability the overlap resolution reads is 1e-4
    # from 0.5, and where a pixel's winner is above 0.5 it leads the
    # runner-up by 1e-4: ten times the 1e-5 agreement asserted above, so
    # both packages resolve every pixel alike
    assert len(resolved) == N_FRAMES
    n_on = 0
    for stack in resolved:
        assert np.abs(stack - 0.5).min() > 1e-4
        top = np.sort(stack, axis=0)
        on = top[-1] > 0.5
        if len(stack) > 1:
            assert (top[-1] - top[-2])[on].min(initial=1.0) > 1e-4
        n_on += int(on.sum())
    assert n_on >= 20

    name = f"{SEQ}.txt"
    text = (tmp_path / "port" / SEQ / name).read_bytes()
    assert text == (tmp_path / "jax" / SEQ / name).read_bytes()
    lines = text.decode().splitlines()
    assert len(lines) >= N_FRAMES and len({ln.split()[1] for ln in lines}) >= 2
    for ln in lines:
        frame, tid, cls, h, w, counts = ln.split(" ")
        assert cls == "2" and (int(h), int(w)) == (H, W)
        assert rle.rle_to_mask(counts, (H, W)).shape == (H, W)
    assert got.keys() == ref.keys()
    for k, v in ref[SEQ].items():
        if k in ("motp", "loc_a"):
            assert abs(got[SEQ][k] - v) < 1e-6, k
        else:
            assert got[SEQ][k] == v, k
    assert np.isfinite(got[SEQ]["mota"]) and np.isfinite(got[SEQ]["idf1"])

    seqs = TrackDatasetFactory("MOTS20-02", root_dir=str(data_root))
    assert [type(s).__name__ for s in seqs] == ["MOTS20Sequence"]


def test_tracker_state_machine_with_masks_matches_jax():
    """Both trackers' host state machines on the same forward outputs, 8
    frames of 4 track slots + 6 object rows: persistent, terminated,
    re-identified (through track rows and through new detections, which
    keep their earlier mask) and new tracks; exact ties and values of
    exactly 0.5 in the probabilities. The results are the same, masks bit
    for bit."""
    t_slots, n_obj, d, hw = 4, 6, 8, (12, 16)
    tracker_cfg = dict(
        detection_obj_score_thresh=0.5, track_obj_score_thresh=0.4,
        detection_nms_thresh=0.9, track_nms_thresh=0.9,
        public_detections=False, inactive_patience=3, reid_sim_threshold=4.0,
        reid_sim_only=False, reid_score_thresh=0.45,
        reid_greedy_matching=False, prev_frame_dist=1, steps_termination=1)
    jcfg = jax_load_config("train.yaml", named=MOTS).replace(**TINY)
    jt = jax_tracker.Tracker(jax_build_model(jcfg)[0], None, None,
                             tracker_cfg, n_obj, t_slots, d)
    pt = port_tracker.Tracker(torch.nn.Linear(1, 1), None, tracker_cfg, n_obj,
                              t_slots, d)
    rng = np.random.default_rng(7)
    centres = rng.uniform(2, 14, (t_slots + n_obj, 2))
    blob = {"images": np.zeros((1, *hw, 3), np.float32),
            "pad_mask": np.zeros((1, *hw), bool), "orig_size": hw}
    for _ in range(8):
        n = t_slots + n_obj
        probs = rng.uniform(size=(n, *hw)).astype(np.float32)
        probs[1] = probs[0]  # an exact tie between two rows
        probs[:, 0, :4] = 0.5  # exactly at the threshold
        boxes = np.concatenate([centres - 1.5, centres + 1.5], 1)
        centres += rng.normal(0, 0.3, centres.shape)
        out = {"scores": rng.uniform(0.2, 1.0, n).astype(np.float32),
               "labels": np.zeros(n, np.int64),
               "boxes": boxes.astype(np.float32),
               "hs_embed": rng.normal(0, 0.5, (n, d)).astype(np.float32),
               "mask_probs": probs}
        for tracker in (jt, pt):
            tracker._build_inputs(blob)
            tracker._consume({k: v.copy() for k, v in out.items()}, blob)
    ref, got = jt.get_results(), pt.get_results()
    assert got.keys() == ref.keys() and len(got) >= 6
    assert pt.num_reids == jt.num_reids > 0
    for tid in ref:
        assert got[tid].keys() == ref[tid].keys(), tid
        for f, r in ref[tid].items():
            assert got[tid][f].keys() == r.keys()
            np.testing.assert_array_equal(got[tid][f]["bbox"], r["bbox"])
            assert got[tid][f]["score"] == r["score"]
            assert got[tid][f]["mask"].dtype == bool
            np.testing.assert_array_equal(got[tid][f]["mask"], r["mask"])


def test_train_mots20_recipe_trains_and_evaluates(data_root, tmp_path):
    """The training CLI (``python -m kinet_tpu_torch.engine.train --device
    cpu``) on ``train_tracking`` + ``train_mots20`` (freeze_detr) over the
    MOT json tree: the mask losses are finite, only the mask head moves,
    and the epoch's evaluation runs the tracking eval over the MOTS20
    sequence."""
    from kinet_tpu_torch.engine.train import main

    over = dict(TINY, **IMG, mot_path_train=str(data_root),
                mot_path_val=str(data_root), output_dir=str(tmp_path / "out"),
                batch_size=2, epochs=1, num_workers=1, val_interval=1,
                log_interval=1, tracking_eval_dataset=SEQ,
                size_buckets=[[48, 64]])
    cfg = load_config("train.yaml", named=MOTS).replace(**over)
    model0, _ = build_model(cfg, device="cpu", seed=int(cfg.seed))
    before = {k: v.clone() for k, v in model0.state_dict().items()}
    model, optimizer, steps = main(
        ["--device", "cpu", "--config", "train.yaml", "--named", *MOTS, "--"]
        + [f"{k}={json.dumps(v)}" for k, v in over.items()])
    assert type(model) is SegmWrapper and steps == 2
    changed = {k for k, v in model.state_dict().items()
               if not torch.equal(v, before[k])}
    assert changed and all(k.startswith(("bbox_attention.", "mask_head."))
                           for k in changed)
    rows = [json.loads(ln) for ln in
            (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert rows and np.isfinite(rows[-1]["mota"]) and np.isfinite(rows[-1]["AP"])
