"""kinet_tpu_torch's host tools against the JAX package's, on the CPU:
the dataset converters (MOT17 / MOT15 / MOTS -> COCO json, public
detections -> COCO json, cross-validation splits, CrowdHuman odgt -> COCO
json), ``compute_best_epoch``, ``parse_mot_results_to_tex``,
``combine_frames``, ``utils/vis.py``'s ``plot_sequence`` and
``vis_results``, ``track_param_search`` (stubbed, then a real search on a
saved run against JAX's search on the same weights) and
``utils/plot_utils.py``. Every output equals JAX's: the dicts, the
strings, the written images byte for byte, the search's MOTA and IDF1.
"""
import configparser
import json
import os
import sys
import types

import numpy as np
import pytest
from PIL import Image

from kinet_tpu.tools import combine_frames as jax_combine
from kinet_tpu.tools import compute_best_epoch as jax_best
from kinet_tpu.tools import generate_coco_from_crowdhuman as jax_ch
from kinet_tpu.tools import generate_coco_from_mot as jax_mot
from kinet_tpu.tools import parse_mot_results_to_tex as jax_tex
from kinet_tpu.utils import vis as jax_vis
from kinet_tpu_torch.tools import combine_frames, compute_best_epoch
from kinet_tpu_torch.tools import generate_coco_from_crowdhuman as ch
from kinet_tpu_torch.tools import generate_coco_from_mot as mot
from kinet_tpu_torch.tools import parse_mot_results_to_tex as tex
from kinet_tpu_torch.utils import vis

from test_crowdhuman import _make_crowdhuman
from test_mots_converter import synthetic_mots  # noqa: F401 (fixture)


def _write_mot_seq(root, name, n_frames, seed, h=48, w=64):
    """MOT17/train/<name> with seqinfo.ini, gt.txt rows of every class and
    visibility rule (pedestrians, distractors, conf 0, low visibility, a
    car) and det.txt with confidences."""
    seq = root / "train" / name
    for d in ("img1", "gt", "det"):
        (seq / d).mkdir(parents=True)
    info = configparser.ConfigParser()
    info["Sequence"] = {"name": name, "imDir": "img1", "frameRate": "30",
                        "seqLength": str(n_frames), "imWidth": str(w),
                        "imHeight": str(h), "imExt": ".jpg"}
    with open(seq / "seqinfo.ini", "w") as f:
        info.write(f)
    rng = np.random.default_rng(seed)
    gt, det = [], []
    for f in range(1, n_frames + 1):
        for tid, cls in ((1, 1), (2, 2), (3, 7), (4, 3), (5, 1), (6, 12)):
            x, y = rng.uniform(1, 40, 2).round(2)
            conf = 0 if tid == 5 and f % 2 else 1
            vis_ = round(float(rng.uniform(0.0, 1.0)), 3)
            gt.append(f"{f},{tid},{x},{y},10.5,20,{conf},{cls},{vis_}")
        det.append(f"{f},-1,{rng.uniform(1, 40):.2f},5,11,21,"
                   f"{rng.uniform():.4f},-1,-1,-1")
    (seq / "gt" / "gt.txt").write_text("\n".join(gt) + "\n")
    (seq / "det" / "det.txt").write_text("\n".join(det) + "\n")


@pytest.fixture(scope="module")
def mot_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mot")
    _write_mot_seq(root, "MOT17-02-FRCNN", 6, seed=0)
    _write_mot_seq(root, "MOT17-04-FRCNN", 5, seed=1)
    # MOT15: no seqinfo.ini, no class or visibility columns (the table of
    # test_tools.py's MOT15 test)
    seq = root / "train" / "TUD-Campus"
    (seq / "gt").mkdir(parents=True)
    (seq / "gt" / "gt.txt").write_text(
        "1,1,10,20,30,60,1\n1,2,50,20,30,60,0\n2,1,12,20,30,60,1\n"
        "70,3,5,5,8,9,1\n")
    return root


@pytest.mark.parametrize("seqs,frame_range", [
    (None, (0.0, 1.0)),
    (["MOT17-04-FRCNN", "MOT17-02-FRCNN"], (0.5, 1.0)),
    (["TUD-Campus"], (0.0, 1.0)),
    (["TUD-Campus", "MOT17-02-FRCNN"], (0.0, 0.5)),
])
def test_generate_coco_from_mot_matches_jax(mot_root, seqs, frame_range):
    got = mot.generate_coco_from_mot(str(mot_root), seqs=seqs,
                                     frame_range=frame_range)
    ref = jax_mot.generate_coco_from_mot(str(mot_root), seqs=seqs,
                                         frame_range=frame_range)
    assert got == ref
    assert got["annotations"] and any(a["ignore"] for a in got["annotations"])


def test_det_json_and_splits_match_jax(mot_root):
    seqs = ["MOT17-02-FRCNN", "MOT17-04-FRCNN"]
    gt = mot.generate_coco_from_mot(str(mot_root), seqs=seqs,
                                    frame_range=(0.25, 1.0))
    got = mot.generate_det_json_from_mot(str(mot_root), seqs, gt)
    assert got == jax_mot.generate_det_json_from_mot(str(mot_root), seqs, gt)
    assert len(got["annotations"]) == len(gt["images"])
    names = [f"MOT17-{i:02d}" for i in (2, 4, 5, 9, 10, 11, 13)]
    for folds in (2, 3, 7):
        assert mot.cross_val_splits(names, folds) == \
            jax_mot.cross_val_splits(names, folds)


def test_generate_coco_from_mots_matches_jax(synthetic_mots):  # noqa: F811
    root, seq, _ = synthetic_mots
    for frame_range in ((0.0, 1.0), (0.34, 1.0)):
        got = mot.generate_coco_from_mots(root, frame_range=frame_range)
        assert got == jax_mot.generate_coco_from_mots(
            root, frame_range=frame_range)
    assert len(got["annotations"]) == 6  # two frames, 2 people + 1 ignore


def test_mot_converter_cli_matches_jax(mot_root, tmp_path):
    args = ["--mot-dir", str(mot_root), "--frame-range", "0.0", "0.5",
            "--dets"]
    mot.main(args + ["--out", str(tmp_path / "port")])
    jax_mot.main(args + ["--out", str(tmp_path / "jax")])
    for name in ("train.json", "det_train.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


def test_generate_coco_from_crowdhuman_matches_jax(tmp_path):
    odgt, img_dir, _ = _make_crowdhuman(tmp_path)
    with open(odgt, "a") as f:  # an image that is not on disk: size 0 x 0
        f.write(json.dumps({"ID": "gone", "gtboxes": [
            {"tag": "person", "fbox": [1, 2, 3, 4], "extra": {"ignore": 0}}]})
            + "\n")
    got = ch.generate_coco_from_crowdhuman(str(odgt), str(img_dir))
    assert got == jax_ch.generate_coco_from_crowdhuman(str(odgt), str(img_dir))
    assert [a["ignore"] for a in got["annotations"][:3]] == [0, 1, 1]
    ch.main(["--odgt", str(odgt), "--img-dir", str(img_dir),
             "--out", str(tmp_path / "port" / "train.json")])
    jax_ch.main(["--odgt", str(odgt), "--img-dir", str(img_dir),
                 "--out", str(tmp_path / "jax" / "train.json")])
    assert (tmp_path / "port" / "train.json").read_bytes() == \
        (tmp_path / "jax" / "train.json").read_bytes()


def test_compute_best_epoch_matches_jax(tmp_path, capsys):
    dirs = []
    for i, motas in enumerate([[0.3, 0.5, 0.4, 0.1], [0.2, 0.6, 0.5]]):
        d = tmp_path / f"split{i}"
        d.mkdir()
        with open(d / "metrics.jsonl", "w") as f:
            for e, m in enumerate(motas):
                f.write(json.dumps({"epoch": e, "mota": m, "idf1": 1 - m})
                        + "\n")
        dirs.append(str(d))
    dirs.append(str(tmp_path / "no-metrics"))
    for metric in ("mota", "idf1"):
        got = compute_best_epoch.best_mean_epoch(dirs[:2], metric)
        assert got == jax_best.best_mean_epoch(dirs[:2], metric)
    assert got[0] == 0
    assert compute_best_epoch.best_mean_epoch(dirs) == \
        jax_best.best_mean_epoch(dirs) == (None, {})
    compute_best_epoch.main(dirs[:2])
    port_out = capsys.readouterr().out
    jax_best.main(dirs[:2])
    assert port_out == capsys.readouterr().out
    assert "BEST epoch: 1" in port_out


def test_parse_mot_results_to_tex_matches_jax(tmp_path, capsys):
    row = {"mota": 0.623, "idf1": 0.5758, "motp": 0.21, "recall": 0.66,
           "precision": 0.95, "num_false_positives": 16591,
           "num_misses": 192123, "num_switches": 4018}
    summaries = [{"MOT17-02": row},
                 {"MOT17-02": {**row, "hota": 0.5467}, "OVERALL": row}]
    for summary in summaries:
        for caption in ("Results", "MOT17 test"):
            assert tex.to_tex(summary, caption) == \
                jax_tex.to_tex(summary, caption)
    path = tmp_path / "summary.json"
    path.write_text(json.dumps(summaries[1]))
    tex.main([str(path), "--caption", "MOT20"])
    port_out = capsys.readouterr().out
    jax_tex.main([str(path), "--caption", "MOT20"])
    assert port_out == capsys.readouterr().out and "54.67" in port_out


def _frames(root, n, h=40, w=60, seed=0):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        p = root / f"{i:06d}.jpg"
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(p)
        paths.append(str(p))
    return paths


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("axis", [0, 1])
def test_combine_frames_matches_jax(tmp_path, axis):
    a = _frames(tmp_path / "a", 3, seed=0)
    _frames(tmp_path / "b", 2, h=36, w=70, seed=1)
    os.remove(a[2])
    _frames(tmp_path / "a2", 0)
    n = combine_frames.combine(str(tmp_path / "a"), str(tmp_path / "b"),
                               str(tmp_path / "port"), axis)
    assert n == jax_combine.combine(str(tmp_path / "a"), str(tmp_path / "b"),
                                    str(tmp_path / "jax"), axis) == 2
    _same_files(tmp_path / "port", tmp_path / "jax")
    h, w = np.asarray(Image.open(tmp_path / "port" / "000000.jpg")).shape[:2]
    assert (h, w) == ((72, 60) if axis == 0 else (36, 120))


class _Seq:
    """What plot_sequence reads of a sequence: len() and data[i]["im_path"]."""

    def __init__(self, paths):
        self.data = [{"im_path": p} for p in paths]

    def __len__(self):
        return len(self.data)


def _track_results(seed=0, n_frames=4, n_tracks=10):
    """Tracks with float boxes, some partly outside the frame, over the
    palette's 8 colours and beyond."""
    rng = np.random.default_rng(seed)
    out = {}
    for tid in range(n_tracks):
        frames = sorted(rng.choice(n_frames, size=2, replace=False).tolist())
        out[tid] = {}
        for f in frames:
            x0, y0 = rng.uniform(-5, 50, 2)
            out[tid][f] = {"bbox": np.array([x0, y0, x0 + 12.3, y0 + 9.6],
                                            np.float32),
                           "score": 0.5, "obj_ind": tid}
    return out


def test_plot_sequence_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")  # without it JAX's writes nothing
    paths = _frames(tmp_path / "src", 4)
    results = _track_results()
    vis.plot_sequence(results, _Seq(paths), str(tmp_path / "port"))
    jax_vis.plot_sequence(results, _Seq(paths), str(tmp_path / "jax"))
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port")) == 4
    # draw_boxes itself, before the JPEG: every colour of the palette
    img = np.zeros((40, 60, 3), np.uint8)
    for c in vis.PALETTE:
        box = [np.random.default_rng(int(c.sum())).uniform(0, 50, 4)]
        np.testing.assert_array_equal(
            vis.draw_boxes(img, box, tuple(int(v) for v in c)),
            jax_vis.draw_boxes(img, box, tuple(int(v) for v in c)))


def test_plot_sequence_needs_no_matplotlib(tmp_path, monkeypatch):
    """JAX's plot_sequence returns silently without matplotlib; the port's
    draws with numpy and PIL alone and writes every frame."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    paths = _frames(tmp_path / "src", 3)
    vis.plot_sequence(_track_results(n_frames=3), _Seq(paths),
                      str(tmp_path / "out"))
    assert sorted(os.listdir(tmp_path / "out")) == \
        ["000000.jpg", "000001.jpg", "000002.jpg"]
    with pytest.raises(FileNotFoundError):
        vis.plot_sequence({}, _Seq([str(tmp_path / "missing.jpg")]),
                          str(tmp_path / "out2"))


@pytest.mark.parametrize("floats", [False, True])
def test_vis_results_matches_jax(tmp_path, floats):
    pytest.importorskip("matplotlib")  # ImgVis draws with it
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (32, 48, 3)).astype(np.uint8)
    if floats:  # an ImageNet-normalized frame
        img = ((img / 255.0 - [0.485, 0.456, 0.406])
               / [0.229, 0.224, 0.225]).astype(np.float32)
    result = {"boxes": np.array([[2.0, 2.0, 10.0, 10.0], [5, 6, 30, 20]]),
              "track_query_boxes": np.array([[12.0, 12.0, 20.0, 20.0]]),
              "track_query_fp_boxes": np.array([[22.0, 22.0, 30.0, 30.0]])}
    for pkg, out in ((vis, "port"), (jax_vis, "jax")):
        iv = pkg.ImgVis({"title": "res"}, str(tmp_path / out))
        pkg.vis_results(iv, img, result, None, tracking=True)
        pkg.vis_results(iv, img, result, None, tracking=False)
        pkg.vis_results(None, img, result, None, tracking=True)
        assert iv.count == 2
    _same_files(tmp_path / "port" / "vis", tmp_path / "jax" / "vis")


def test_track_param_search_grid(monkeypatch, tmp_path, capsys):
    """search() over a tracker_cfg grid through a stubbed main_track,
    against JAX's search (test_tools.py's stub)."""
    import kinet_tpu.tools.track_param_search as jax_tps
    from kinet_tpu.config import load_config as jax_load_config
    from kinet_tpu_torch.config import load_config
    from kinet_tpu_torch.tools import track_param_search as tps

    def fake_main_track(run_cfg):
        good = (float(run_cfg.tracker_cfg.detection_obj_score_thresh) == 0.4
                and float(run_cfg.tracker_cfg.track_obj_score_thresh) == 0.5)
        mota = 0.9 if good else 0.1
        return {"MOT17-02": {"mota": mota, "idf1": mota / 2}}

    grid = {"detection_obj_score_thresh": [0.3, 0.4],
            "track_obj_score_thresh": [0.4, 0.5]}
    outs = []
    for module, load in ((tps, load_config), (jax_tps, jax_load_config)):
        monkeypatch.setattr(module, "main_track", fake_main_track)
        cfg = load("track.yaml").replace(output_dir=str(tmp_path))
        outs.append((module.search(cfg, grid), capsys.readouterr().out))
    assert outs[0] == outs[1]
    results = outs[0][0]
    assert len(results) == 4 and max(r["mota"] for r in results) == 0.9
    best = max(results, key=lambda r: r["mota"])
    assert (best["detection_obj_score_thresh"],
            best["track_obj_score_thresh"]) == (0.4, 0.5)
    assert tps.DEFAULT_GRID == jax_tps.DEFAULT_GRID
    # without ground truth: None, as in the JAX package
    monkeypatch.setattr(tps, "main_track", lambda run_cfg: None)
    assert tps.search(load_config("track.yaml")) is None


def test_track_param_search_on_a_saved_run(tmp_path, monkeypatch):
    """A real 2 x 1 search over test_torch_track.py's sequence and tiny
    flagship, each package restoring its own saved run of the same
    weights: equal MOTA and IDF1 for every combination."""
    import kinet_tpu.tools.track_param_search as jax_tps
    from kinet_tpu.config import load_config as jax_load_config
    from kinet_tpu.config import save_config as jax_save_config
    from kinet_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
    from kinet_tpu_torch.config import load_config, save_config
    from kinet_tpu_torch.tools import track_param_search as tps
    from kinet_tpu_torch.utils.checkpoint import CheckpointManager

    import torch
    from test_torch_port_model import FLAGSHIP, TINY
    from test_torch_track import IMG, SEQ, THRESH, _models
    from test_track_e2e import _write_sequence

    root = tmp_path / "data"
    _write_sequence(root, SEQ, n_frames=6, seed=0)
    _, params, model = _models({})
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **IMG)
    save_config(cfg, tmp_path / "port_run")
    CheckpointManager(str(tmp_path / "port_run")).save_epoch(
        model, torch.optim.SGD(model.parameters(), lr=0.0), 0, 0)
    jax_save_config(jax_load_config("train.yaml", named=FLAGSHIP).replace(
        **TINY, **IMG), tmp_path / "jax_run")
    JaxCkpt(str(tmp_path / "jax_run")).save_epoch(
        types.SimpleNamespace(params=params, opt_state={}, step=0), 0)

    grid = {"detection_obj_score_thresh": [0.07, 0.09],
            "track_obj_score_thresh": [THRESH["track_obj_score_thresh"]]}
    runs = []
    for module, load, run, extra in (
            (tps, load_config, "port_run", {"device": "cpu"}),
            (jax_tps, jax_load_config, "jax_run", {})):
        track_cfg = load("track.yaml").replace(
            data_root_dir=str(root), dataset_name=SEQ,
            obj_detect_checkpoint_dir=str(tmp_path / run),
            output_dir=str(tmp_path / f"out_{run}"),
            **{"tracker_cfg.reid_score_thresh": THRESH["reid_score_thresh"]},
            **extra)
        runs.append(module.search(track_cfg, grid))
    assert runs[0] == runs[1]
    assert len({(r["mota"], r["idf1"]) for r in runs[0]}) == 2


def _metrics_runs(tmp_path):
    dirs = []
    for i in range(2):
        d = tmp_path / f"run{i}"
        d.mkdir()
        with open(d / "metrics.jsonl", "w") as f:
            for e in range(3):
                rec = {"epoch": e, "AP": 0.1 * e + i, "mota": 0.2 * e}
                if e != 1:
                    rec["idf1"] = 0.3
                f.write(json.dumps(rec) + "\n")
        dirs.append(str(d))
    return dirs


def test_plot_utils_write_their_figures(tmp_path, mot_root):
    pytest.importorskip("matplotlib")
    from kinet_tpu.utils import plot_utils as jax_plot
    from kinet_tpu_torch.data.coco import CocoIndex
    from kinet_tpu_torch.utils import plot_utils
    from kinet_tpu_torch.utils.coco_eval import CocoEvaluator

    dirs = _metrics_runs(tmp_path)
    assert plot_utils.load_log(dirs[0]) == jax_plot.load_log(dirs[0])
    assert plot_utils.load_log(str(tmp_path / "none")) == []
    plot_utils.plot_logs(dirs + [str(tmp_path / "none")],
                         output_path=str(tmp_path / "logs.png"))
    fig = plot_utils.plot_logs(dirs, fields=("AP",))
    assert len(fig.axes) == 1 and len(fig.axes[0].lines) == 2

    coco = mot.generate_coco_from_mot(str(mot_root), seqs=["MOT17-02-FRCNN"])
    (tmp_path / "val.json").write_text(json.dumps(coco))
    evaluator = CocoEvaluator(CocoIndex(str(tmp_path / "val.json")))
    assert plot_utils.plot_precision_recall(evaluator) is None
    rng = np.random.default_rng(0)
    preds = {}
    for im in coco["images"]:
        boxes = [[x, y, x + w, y + h] for a in coco["annotations"]
                 if a["image_id"] == im["id"]
                 for x, y, w, h in [a["bbox"]]]
        preds[im["id"]] = {"boxes": np.array(boxes) + rng.normal(0, 1, (len(boxes), 4)),
                           "scores": rng.uniform(size=len(boxes)),
                           "labels": np.zeros(len(boxes), int)}
    evaluator.update(preds)
    evaluator.accumulate()
    fig = plot_utils.plot_precision_recall(evaluator)
    assert [line.get_label() for line in fig.axes[0].lines] == \
        ["IoU=0.50", "IoU=0.75"]
    plot_utils.plot_precision_recall(evaluator, str(tmp_path / "pr.png"))
    for name in ("logs.png", "pr.png"):
        assert (tmp_path / name).stat().st_size > 1000


def test_plot_utils_name_matplotlib_when_it_is_missing(tmp_path, monkeypatch):
    from kinet_tpu_torch.utils import plot_utils

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    dirs = _metrics_runs(tmp_path)
    for call in (lambda: plot_utils.plot_logs(dirs),
                 lambda: plot_utils.plot_precision_recall(None)):
        with pytest.raises(ImportError, match="matplotlib"):
            call()
    assert len(plot_utils.load_log(dirs[0])) == 3  # reading needs none
