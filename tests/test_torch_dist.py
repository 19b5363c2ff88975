"""kinet_tpu_torch's runs over several processes (``utils/dist.py``) on
the CPU, with the gloo backend; each multi-process case starts its
processes (spawned, torch on one thread each) on a ``file://`` rendezvous
under the test's tmp_path and gives every join a timeout:

- without a group (and in a group of one) every helper is the
  one-process identity;
- ``all_gather_objects`` over 2 processes: uneven payloads come back in
  rank order, after a gather of the lengths and one of the payloads padded
  only to the longest (the reference's two phases);
- ``reduce_dict`` and ``mean_over_processes``: means over the processes;
- ``all_reduce_grads``: every gradient (a missing one as zeros) becomes
  its mean, in buckets;
- the ``CocoEvaluator`` and ``PanopticEvaluator`` merges: 2 processes,
  each with a shard of the predictions, score what one process scores
  with all of them;
- ``evaluate()`` in 2 processes (each over its shard of the val images,
  the shards merged) scores every image and gives one process's stats;
- ``main_track`` over 4 sequences in 2 processes (each tracks every other
  sequence, the accumulators gathered) returns the summary of one process
  tracking all 4, on both processes, and writes the same result files.
"""
import configparser
import json
import multiprocessing as mp
import pickle
import tempfile
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as tdist
from PIL import Image

from kinet_tpu_torch.utils import dist

TIMEOUT = 240


def _worker(fn, rank, world, work, tmp, args, group=True):
    torch.set_num_threads(1)
    try:
        if group:
            tdist.init_process_group("gloo", init_method=f"file://{work}/rdv",
                                     world_size=world, rank=rank)
        try:
            out = fn(rank, world, tmp, *args)
        finally:
            if group:
                tdist.destroy_process_group()
        with open(f"{work}/out{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(f"{work}/err{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_processes(fn, world, tmp_path, *args, group=True, timeout=TIMEOUT):
    """fn(rank, world, tmp_path, *args) in ``world`` spawned processes
    joined in a gloo group (a rendezvous file of its own under tmp_path),
    or with ``group=False`` in one process without a group; returns their
    results in rank order. ``fn`` is a top-level function of an importable
    module."""
    assert group or world == 1
    tmp_path.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=tmp_path))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(fn, r, world, str(work),
                                               str(tmp_path), args, group))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = [work / f"err{r}.txt" for r in range(world)]
    text = "\n".join(e.read_text() for e in errors if e.exists())
    assert not hung, f"{len(hung)} processes hung\n{text}"
    assert all(p.exitcode == 0 for p in procs), text
    out = []
    for r in range(world):
        with open(work / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))  # written by this test's processes
    return out


# ---------------------------------------------------------------------------


def test_world1_short_circuit():
    assert not dist.is_dist_avail_and_initialized()
    assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
    assert dist.is_main_process()
    obj = {"only": "me"}
    assert dist.all_gather_objects(obj) == [obj]
    d = {"loss": torch.tensor(2.0), "n": 3.0}
    assert dist.reduce_dict(d) is d
    t = torch.tensor([1.0, 2.0])
    assert dist.mean_over_processes(t) is t
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 0.5)
    g = p.grad
    dist.all_reduce_grads([p])
    assert p.grad is g and torch.equal(g, torch.full((3,), 0.5))
    assert dist._gather_buf_bytes([0, 0]) == 1
    assert dist._gather_buf_bytes([3, 7, 5]) == 7


def test_world1_group_short_circuits(tmp_path):
    (out,) = run_processes(_group_of_one, 1, tmp_path)
    assert out == ([{"a": 1}], True, True)


def _group_of_one(rank, world, tmp):
    t = torch.tensor([3.0])
    d = {"x": 1.0}
    return (dist.all_gather_objects({"a": 1}),
            dist.mean_over_processes(t) is t, dist.reduce_dict(d) is d)


PAYLOADS = [{"a": 1}, {"b": list(range(500)), "c": "x" * 3000}]


def _gather(rank, world, tmp):
    sizes = []
    gather = tdist.all_gather

    def recording(tensors, tensor, *a, **kw):
        sizes.append((tensor.dtype, tensor.numel()))
        return gather(tensors, tensor, *a, **kw)

    tdist.all_gather = recording
    try:
        got = dist.all_gather_objects(PAYLOADS[rank])
    finally:
        tdist.all_gather = gather
    return got, sizes


def test_all_gather_objects_two_processes(tmp_path):
    outs = run_processes(_gather, 2, tmp_path)
    longest = max(len(pickle.dumps(p)) for p in PAYLOADS)
    for got, sizes in outs:
        assert got == PAYLOADS
        # the lengths (one int64 each), then the payloads padded only to
        # the longest: traffic proportional to the payloads
        assert sizes == [(torch.int64, 1), (torch.uint8, longest)]


def _reduce(rank, world, tmp):
    d = dist.reduce_dict({"loss": torch.tensor(float(rank + 1)),
                          "n": 2.0 * rank})
    m = dist.mean_over_processes(torch.tensor([rank, 10.0 * rank]))
    ps = [torch.nn.Parameter(torch.zeros(n)) for n in (3, 5, 2)]
    ps[0].grad = torch.full((3,), float(rank))
    ps[1].grad = None if rank == 0 else torch.arange(5.0)
    ps[2].grad = torch.full((2,), 4.0 * rank)
    dist.all_reduce_grads(ps, bucket_elems=4)
    return d, m.tolist(), [p.grad.tolist() for p in ps]


def test_reduce_dict_and_gradients_two_processes(tmp_path):
    outs = run_processes(_reduce, 2, tmp_path)
    for d, m, grads in outs:
        assert d == {"loss": 1.5, "n": 1.0}
        assert m == [0.5, 5.0]
        assert grads == [[0.5] * 3, [0.0, 0.5, 1.0, 1.5, 2.0], [2.0, 2.0]]


# ---------------------------------------------------------------------------
# the evaluators' merges


def _coco_case(tmp):
    rng = np.random.default_rng(0)
    images, anns, preds = [], [], {}
    for i in range(1, 9):
        images.append({"id": i, "height": 400, "width": 400,
                       "file_name": f"{i}.jpg"})
        boxes, scores = [], []
        for _ in range(int(rng.integers(1, 6))):
            w, h = rng.uniform(10, 150, 2)
            x, y = rng.uniform(0, 400 - w), rng.uniform(0, 400 - h)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1,
                         "bbox": [float(x), float(y), float(w), float(h)],
                         "area": float(w * h), "iscrowd": 0})
            if rng.uniform() < 0.8:
                boxes.append(np.array([x, y, x + w, y + h]) + rng.normal(0, 5, 4))
                scores.append(rng.uniform(0.1, 1.0))
        for _ in range(int(rng.integers(0, 3))):
            x, y = rng.uniform(0, 300, 2)
            boxes.append([x, y, x + 50, y + 60])
            scores.append(rng.uniform(0.1, 1.0))
        preds[i] = {"boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
                    "scores": np.asarray(scores), "labels":
                    np.zeros(len(scores), np.int64)}
    path = f"{tmp}/val.json"
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return path, preds


def _segments(seed, h=10, w=12):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 4, (h, w)).astype(np.int32)
    info = [{"id": int(i), "category_id": int(i % 2), "isthing": bool(i % 2)}
            for i in np.unique(seg) if i]
    return seg, info


def _panoptic_case():
    gts = [_segments(s) for s in range(6)]
    preds = [_segments(s + 100) if s % 3 else gts[s] for s in range(6)]
    return gts, preds


def _evaluate(rank, world, tmp):
    from kinet_tpu_torch.data.coco import CocoIndex
    from kinet_tpu_torch.models.panoptic import PanopticEvaluator
    from kinet_tpu_torch.utils.coco_eval import CocoEvaluator

    path, preds = _coco_case(tmp)
    ev = CocoEvaluator(CocoIndex(path))
    ids = sorted(preds)[rank::world]
    ev.update({i: preds[i] for i in ids})
    ev.synchronize_between_processes()
    ev.accumulate()
    gts, ppreds = _panoptic_case()
    pev = PanopticEvaluator(gts)
    pev.update(ppreds[rank * 3:(rank + 1) * 3])
    pev.synchronize_between_processes()
    return ev.summarize(), pev.summarize()


def test_coco_and_panoptic_merges_two_processes(tmp_path):
    from kinet_tpu_torch.data.coco import CocoIndex
    from kinet_tpu_torch.models.panoptic import PanopticEvaluator
    from kinet_tpu_torch.utils.coco_eval import CocoEvaluator

    outs = run_processes(_evaluate, 2, tmp_path / "two")
    (tmp_path / "one").mkdir()
    path, preds = _coco_case(tmp_path / "one")
    ev = CocoEvaluator(CocoIndex(path))
    ev.update(preds)
    ev.synchronize_between_processes()
    ev.accumulate()
    ref = ev.summarize()
    gts, ppreds = _panoptic_case()
    pev = PanopticEvaluator(gts)
    pev.update(ppreds)
    pref = pev.summarize()
    assert 0.1 < ref[0] < 0.9 and pref["tp"] > 0
    for stats, pq in outs:
        assert list(stats) == list(ref)
        assert pq == pref


# ---------------------------------------------------------------------------
# main_track over two processes

SEQS = [f"MOT17-{n:02d}-FRCNN" for n in (2, 4, 5, 9)]
TRACK_TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=36, nheads=2,
    enc_layers=1, dec_layers=1, dim_feedforward=64, num_queries=12,
    max_track_queries=4, dropout=0.0,
    **{"img_transform.max_size": 160, "img_transform.val_width": 96})


def write_sequence(root, name, n_frames=4, h=96, w=128, seed=0):
    """A MOT17 sequence: noise frames with one ground-truth track."""
    seq = root / "MOT17" / "train" / name
    for d in ("img1", "gt", "det"):
        (seq / d).mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for f in range(1, n_frames + 1):
        Image.fromarray(rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)).save(
            seq / "img1" / f"{f:06d}.jpg")
    info = configparser.ConfigParser()
    info["Sequence"] = {"name": name, "imDir": "img1", "frameRate": "30",
                        "seqLength": str(n_frames), "imWidth": str(w),
                        "imHeight": str(h), "imExt": ".jpg"}
    with open(seq / "seqinfo.ini", "w") as f:
        info.write(f)
    rows = [f"{f},1,{10 + 5 * f},20,30,40,1,1,1.0" for f in range(1, n_frames + 1)]
    (seq / "gt" / "gt.txt").write_text("\n".join(rows) + "\n")
    (seq / "det" / "det.txt").write_text("")


def _track(rank, world, tmp, out):
    from kinet_tpu_torch.config import load_config
    from kinet_tpu_torch.engine.track import main_track
    from kinet_tpu_torch.models.build import build_model

    cfg = load_config("train.yaml", named=[
        "train_deformable", "train_tracking", "train_multi_frame"]).replace(
        **TRACK_TINY)
    model, _ = build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "class_embed" in name and name.endswith("bias"):
                p.fill_(-4.0)
                p[0] = -1.0
    track_cfg = load_config("track.yaml").replace(
        data_root_dir=f"{tmp}/data", dataset_name=",".join(SEQS),
        output_dir=f"{tmp}/{out}", device="cpu",
        **{"tracker_cfg.detection_obj_score_thresh": 0.25,
           "tracker_cfg.track_obj_score_thresh": 0.2})
    return main_track(track_cfg, obj_detector_model=(model, None, cfg))


def test_main_track_two_processes(tmp_path):
    """The summary on both processes equals one process's, and the result
    files the processes wrote, each for its sequences, are that process's
    byte for byte."""
    for i, name in enumerate(SEQS):
        write_sequence(tmp_path / "data", name, seed=i)
    (ref,) = run_processes(_track, 1, tmp_path, "one")
    outs = run_processes(_track, 2, tmp_path, "two")
    assert set(ref) == set(SEQS) | {"OVERALL"}
    assert ref["OVERALL"]["num_false_positives"] > 0
    for got in outs:
        assert got.keys() == ref.keys()
        for seq, row in ref.items():
            assert got[seq].keys() == row.keys()
            for k, v in row.items():
                # means over all matches, summed in another order
                tol = 1e-9 if k in ("motp", "loc_a") else 0
                assert abs(got[seq][k] - v) <= tol, (seq, k)
    sub = ",".join(SEQS)
    for name in SEQS:
        got = (tmp_path / "two" / sub / f"{name}.txt").read_bytes()
        assert got == (tmp_path / "one" / sub / f"{name}.txt").read_bytes()


# ---------------------------------------------------------------------------
# evaluate() over two processes


def write_mot_tree(root, n_frames=4, h=64, w=96):
    """The MOT-to-COCO layout of ``n_frames`` frames with two moving boxes
    (annotations/{train,val}.json)."""
    (root / "train").mkdir(parents=True)
    (root / "annotations").mkdir()
    rng = np.random.default_rng(0)
    images, anns = [], []
    for f in range(n_frames):
        name = f"SEQ-01_{f + 1:06d}.jpg"
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(
            root / "train" / name)
        images.append({"id": f, "file_name": name, "height": h, "width": w,
                       "frame_id": f, "first_frame_image_id": 0,
                       "seq_length": n_frames, "seq": "SEQ-01"})
        for tid in (1, 2):
            anns.append({"id": len(anns), "image_id": f, "category_id": 1,
                         "bbox": [10 + 4 * f + 20 * tid, 12, 18, 30],
                         "area": 540, "iscrowd": 0, "track_id": tid})
    doc = {"images": images, "annotations": anns, "sequences": ["SEQ-01"],
           "categories": [{"id": 1, "name": "person"}]}
    for split in ("train", "val"):
        (root / "annotations" / f"{split}.json").write_text(json.dumps(doc))


def _evaluate_model(rank, world, tmp):
    from kinet_tpu_torch.config import load_config
    from kinet_tpu_torch.data.builder import build_dataset
    from kinet_tpu_torch.engine import evaluate as ev
    from kinet_tpu_torch.models.build import build_criterion, build_model

    merged = []

    class Recording(ev.CocoEvaluator):
        def accumulate(self):
            merged.append(sorted(self.preds))
            return super().accumulate()

    ev.CocoEvaluator = Recording
    cfg = load_config("train.yaml", named=[
        "train_deformable", "train_tracking", "train_multi_frame"]).replace(
        **{**TRACK_TINY, "img_transform.max_size": 96,
           "img_transform.val_width": 64},
        mot_path_train=f"{tmp}/mot", mot_path_val=f"{tmp}/mot", batch_size=1,
        max_objects=6,
        num_workers=1, tracking_eval=False, size_buckets=[[64, 96]])
    model, post = build_model(cfg, device="cpu", seed=0)
    stats = ev.evaluate(model, build_criterion(cfg), post,
                        build_dataset("val", cfg), cfg, device="cpu")
    return stats, merged


def test_evaluate_two_processes(tmp_path):
    """evaluate() in 2 processes, each over its shard of the 4 val images
    (batch 1: every image's forward is the same in either run), scores
    all 4 on both processes and gives one process's 12 COCO stats."""
    write_mot_tree(tmp_path / "mot")
    ((ref, ref_ids),) = run_processes(_evaluate_model, 1, tmp_path)
    assert ref_ids == [[0, 1, 2, 3]]
    for stats, ids in run_processes(_evaluate_model, 2, tmp_path):
        assert ids == ref_ids
        assert list(stats["coco_eval_bbox"]) == list(ref["coco_eval_bbox"])
