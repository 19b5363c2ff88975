"""kinet_tpu_torch's tracking CLI (``engine/track.py``) against the JAX
package's, on the CPU:

- ``main_track`` of both on one synthetic MOT17 sequence (written as
  tests/test_track_e2e.py::_write_sequence writes it), with a tiny
  flagship-flag model on bridged weights, with ``dec_msda_int8`` off and
  on: the result files agree within 1e-3 px and the CLEAR-MOT / IDF1 /
  HOTA summaries are identical, but for the two means of IoU distances
  (MOTP and HOTA's LocA), which follow the boxes' last bits (within
  1e-6). The ground truth is written from a first JAX run's tracks,
  shifted, cut, with two identities swapped and one object no track
  follows, so the metrics are not trivial; the test asserts that at least 3 tracks
  appear and that no score the tracker compares lies within 1e-3 of a
  threshold, so no decision rests on rounding;
- the sequence loader's blobs (image, dets, gt, vis) against JAX's;
- ``interpolate_tracks`` against JAX's, and the result files' round trip;
- the configurations the JAX package refuses raise; without a card the
  CLI refuses to run unless asked for the CPU;
- ``write_images`` writes one JPEG a frame of the sequence under
  output_dir/<dataset dir>/<sequence>/, byte-equal to JAX's;
- ``batch_sequences: 2`` writes the same result files, byte for byte, as
  ``batch_sequences: 1`` over two sequences, in both ``batch_exec`` forms.
"""
import numpy as np
import pytest
import torch

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.data.sequences import MOT17Sequence as JaxMOT17Sequence
from kinet_tpu.engine import track as jax_track
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.data.sequences import MOT17Sequence, TrackDatasetFactory
from kinet_tpu_torch.engine import track
from kinet_tpu_torch.tracking import tracker as port_tracker

from test_torch_port_model import FLAGSHIP, TINY, port_model, tiny_params
from test_track_e2e import _write_sequence

SEQ = "MOT17-02-FRCNN"
N_FRAMES = 6
IMG = {"img_transform.max_size": 160, "img_transform.val_width": 96}
# random heads score about 0.03-0.10 (the focal prior's 0.01 at the bias);
# these thresholds keep 3-6 new tracks a frame and let tracks live on
THRESH = dict(detection_obj_score_thresh=0.07, track_obj_score_thresh=0.008,
              reid_score_thresh=0.008)
INT8 = dict(dec_msda_int8=True, allow_lossy=True)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    (root / "MOT17" / "test").mkdir(parents=True)
    _write_sequence(root, SEQ, n_frames=N_FRAMES, seed=0)
    return root


def _models(over):
    """The JAX model with its params and the port model on the same
    weights; the class heads' biases of every class but 0 (person) pushed
    down by 20, so every query's label is 0."""
    import jax

    jmodel, params = tiny_params(seed=0, **over)

    def push(path, x):
        if "class_embed" in jax.tree_util.keystr(path) and "bias" in \
                jax.tree_util.keystr(path):
            x = np.array(x)
            x[1:] -= 20.0
        return x

    params = jax.tree_util.tree_map_with_path(push, params)
    return jmodel, params, port_model(params, **over)


def _track_cfg(load, root, out, **over):
    return load("track.yaml").replace(
        data_root_dir=str(root), dataset_name=SEQ, output_dir=str(out),
        **{f"tracker_cfg.{k}": v for k, v in THRESH.items()}, **over,
    )


def _results(out):
    return np.loadtxt(out / SEQ / f"{SEQ}.txt", delimiter=",", ndmin=2)


def _write_gt(root, rows):
    """gt.txt from result rows (frame, id, x, y, w, h): the boxes rounded to
    whole pixels and shifted by 2 px; the two longest tracks' identities
    swapped halfway through the frames they share; the other tracks' last
    frame dropped (false positives); and one object in a corner that no
    track follows (misses)."""
    ids = sorted(set(rows[:, 1]), key=lambda t: -int((rows[:, 1] == t).sum()))
    t1, t2 = ids[:2]
    shared = sorted(set(rows[rows[:, 1] == t1, 0]) & set(rows[rows[:, 1] == t2, 0]))
    assert len(shared) >= 3
    swap_from = shared[len(shared) // 2]
    last = {tid: rows[rows[:, 1] == tid, 0].max() for tid in ids}
    with open(root / "MOT17" / "train" / SEQ / "gt" / "gt.txt", "w") as f:
        for frame, tid, x, y, w, h in rows[:, :6]:
            if tid in (t1, t2):
                if frame >= swap_from:
                    tid = t1 + t2 - tid
            elif frame == last[tid]:
                continue
            f.write(f"{int(frame)},{int(tid)},{round(x) + 2},{round(y)},"
                    f"{round(w)},{round(h)},1,1,1.0\n")
        for frame in range(1, N_FRAMES + 1):
            f.write(f"{frame},999,2,2,6,6,1,1,1.0\n")


@pytest.mark.parametrize("over", [{}, INT8], ids=["bf16-table", "int8-table"])
def test_main_track_matches_jax(over, data_root, tmp_path, monkeypatch):
    jmodel, params, model = _models(over)
    jax_cfg = jax_load_config("train.yaml", named=FLAGSHIP).replace(
        **TINY, **over, **IMG)
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **over, **IMG)

    def run_jax(out):
        return jax_track.main_track(
            _track_cfg(jax_load_config, data_root, out),
            obj_detector_model=(jmodel, params, None, jax_cfg))

    run_jax(tmp_path / "first")
    _write_gt(data_root, _results(tmp_path / "first"))

    scores = []
    consume = port_tracker.Tracker._consume

    def recording(self, out, blob):
        scores.append((out["scores"][:self.num_track_slots],
                       out["scores"][self.num_track_slots:]))
        return consume(self, out, blob)

    monkeypatch.setattr(port_tracker.Tracker, "_consume", recording)
    ref = run_jax(tmp_path / "jax")
    got = track.main_track(
        _track_cfg(load_config, data_root, tmp_path / "port", device="cpu"),
        obj_detector_model=(model, None, cfg))

    assert len(scores) == N_FRAMES
    tracks = np.concatenate([s[0] for s in scores])
    dets = np.concatenate([s[1] for s in scores])
    assert np.abs(dets - THRESH["detection_obj_score_thresh"]).min() > 1e-3
    assert np.abs(tracks - THRESH["track_obj_score_thresh"]).min() > 1e-3

    a, b = _results(tmp_path / "jax"), _results(tmp_path / "port")
    assert len(set(b[:, 1])) >= 3 and len(b) > len(set(b[:, 1]))
    assert a.shape == b.shape
    np.testing.assert_array_equal(a[:, :2], b[:, :2])
    np.testing.assert_allclose(b[:, 2:], a[:, 2:], rtol=0, atol=1e-3)
    # every count and every metric made of counts is equal; the two means
    # of IoU distances (motp, HOTA's loc_a) follow the boxes' last bits
    assert got.keys() == ref.keys() and got[SEQ].keys() == ref[SEQ].keys()
    for k, v in ref[SEQ].items():
        if k in ("motp", "loc_a"):
            assert abs(got[SEQ][k] - v) < 1e-6, k
        else:
            assert got[SEQ][k] == v, k
    m = got[SEQ]
    assert m["num_matches"] > 0 and m["num_misses"] > 0
    assert m["num_false_positives"] > 0
    for k in ("mota", "idf1", "hota", "ass_a"):
        assert 0.0 < m[k] < 1.0, k


def test_sequence_blobs_match_jax(data_root):
    cfg = load_config("train.yaml").replace(**IMG)
    jseq = JaxMOT17Sequence(root_dir=str(data_root), seq_name="MOT17-02",
                            dets="FRCNN", img_transform=cfg.img_transform)
    seq = MOT17Sequence(root_dir=str(data_root), seq_name="MOT17-02",
                        dets="FRCNN", img_transform=cfg.img_transform)
    assert len(seq) == len(jseq) == N_FRAMES and not seq.no_gt
    assert str(seq) == str(jseq) == SEQ
    for i in range(N_FRAMES):
        a, b = jseq[i], seq[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                assert a[k].keys() == b[k].keys()
                for key in a[k]:
                    np.testing.assert_array_equal(b[k][key], a[k][key])
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    datasets = TrackDatasetFactory("MOT17-02-FRCNN", root_dir=str(data_root),
                                   img_transform=cfg.img_transform)
    assert [str(s) for s in datasets] == [SEQ]


def _tracks():
    rng = np.random.default_rng(3)
    out = {}
    for tid in range(4):
        frames = sorted(rng.choice(20, size=6, replace=False).tolist())
        out[tid] = {f: {"bbox": rng.uniform(0, 100, 4).astype(np.float32),
                        "score": float(rng.uniform()), "obj_ind": tid}
                    for f in frames}
    return out


def test_interpolate_tracks_matches_jax():
    tracks = _tracks()
    ref, got = jax_track.interpolate_tracks(tracks), track.interpolate_tracks(tracks)
    assert ref.keys() == got.keys()
    for tid in ref:
        assert ref[tid].keys() == got[tid].keys()
        assert len(got[tid]) > len(tracks[tid])  # the gaps were filled
        for f in ref[tid]:
            np.testing.assert_array_equal(got[tid][f]["bbox"], ref[tid][f]["bbox"])
            assert got[tid][f]["score"] == ref[tid][f]["score"]


def test_results_round_trip(data_root, tmp_path):
    cfg = load_config("train.yaml").replace(**IMG)
    seq = MOT17Sequence(root_dir=str(data_root), seq_name="MOT17-02",
                        dets="FRCNN", img_transform=cfg.img_transform)
    tracks = _tracks()
    seq.write_results(tracks, str(tmp_path))
    jseq = JaxMOT17Sequence(root_dir=str(data_root), seq_name="MOT17-02",
                            dets="FRCNN", img_transform=cfg.img_transform)
    jseq.write_results(tracks, str(tmp_path / "jax"))
    assert (tmp_path / f"{SEQ}.txt").read_text() == \
        (tmp_path / "jax" / f"{SEQ}.txt").read_text()
    back = seq.load_results(str(tmp_path))
    assert back == jseq.load_results(str(tmp_path))
    assert back.keys() == tracks.keys()
    for tid in tracks:
        assert back[tid].keys() == tracks[tid].keys()
        for f, r in tracks[tid].items():
            np.testing.assert_allclose(back[tid][f]["bbox"], r["bbox"], atol=1e-4)


@pytest.mark.parametrize("over,error,item", [
    # the kinematic tracker and the batched trackers are ported
    # (tests/test_torch_batched_tracker.py), and spatial parallelism
    # (tests/test_torch_spatial.py), which needs as many processes as it
    # splits a frame over: one process refuses it, whatever else is asked
    (dict(kinet=True, spatial_parallel=2), ValueError,
     "spatial_parallel 2 needs 2"),
    # attention maps are ported for vanilla DETR; a deformable model has
    # none, as the JAX package asserts
    (dict(generate_attention_maps=True), ValueError, "deformable"),
    (dict(batch_sequences=2, spatial_parallel=2), ValueError,
     "spatial_parallel 2 needs 2"),
    (dict(spatial_parallel=2), ValueError, "spatial_parallel 2 needs 2"),
])
def test_configs_outside_the_slice_raise(over, error, item, data_root,
                                         tmp_path):
    if "generate_attention_maps" in over:  # the saved run's config decides
        from kinet_tpu_torch.config import save_config
        save_config(load_config("train.yaml", named=FLAGSHIP).replace(**TINY),
                    tmp_path)
        over = {**over, "obj_detect_checkpoint_dir": str(tmp_path)}
    cfg = _track_cfg(load_config, data_root, "", device="cpu", **over)
    with pytest.raises(error, match=item):
        track.main_track(cfg)


@pytest.mark.parametrize("batch", [1, 2], ids=["tracker", "batched"])
def test_main_track_writes_images_as_jax(batch, tmp_path):
    """main_track with write_images: one JPEG a frame of each sequence
    under output_dir/<dataset dir>/<sequence>/, byte-equal to JAX's (whose
    plot_sequence writes nothing without matplotlib); with
    ``batch_sequences: 2`` each batched sequence's own tracks."""
    pytest.importorskip("matplotlib")
    root = tmp_path / "data"
    names = [SEQ, "MOT17-04-FRCNN"][:batch]
    for i, name in enumerate(names):
        _write_sequence(root, name, n_frames=5, seed=2 + i)
    jmodel, params, model = _models({})
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **IMG)
    jcfg = jax_load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **IMG)

    def track_cfg(load, out, **extra):
        return load("track.yaml").replace(
            data_root_dir=str(root), dataset_name=",".join(names),
            output_dir=str(out), write_images="pretty",
            batch_sequences=batch, batch_exec="interleaved",
            **{f"tracker_cfg.{k}": v for k, v in THRESH.items()}, **extra)

    track.main_track(track_cfg(load_config, tmp_path / "port", device="cpu"),
                     obj_detector_model=(model, None, cfg))
    jax_track.main_track(track_cfg(jax_load_config, tmp_path / "jax"),
                         obj_detector_model=(jmodel, params, None, jcfg))
    sub = ",".join(names)
    for name in names:
        out = tmp_path / "port" / sub / name
        files = sorted(p.name for p in out.iterdir())
        assert files == [f"{i:06d}.jpg" for i in range(5)]
        rows = np.loadtxt(tmp_path / "port" / sub / f"{name}.txt",
                          delimiter=",", ndmin=2)
        assert len(rows) > 0  # boxes were drawn
        for f in files:
            assert (out / f).read_bytes() == \
                (tmp_path / "jax" / sub / name / f).read_bytes(), (name, f)


def test_mots20_and_many_processes_raise(data_root, monkeypatch):
    # MOTS20 is ported (tests/test_torch_mots.py): a sequence the root
    # does not hold raises as in the JAX package
    with pytest.raises(AssertionError, match="MOTS20-02"):
        TrackDatasetFactory("MOTS20-02", root_dir=str(data_root))
    # tracking over several processes is ported (tests/test_torch_dist.py):
    # the process group, not the environment, makes a run of several
    # processes, so WORLD_SIZE alone splits nothing
    from kinet_tpu_torch.utils import dist

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert (dist.get_world_size(), dist.get_rank()) == (1, 0)


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(data_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        track.main(["dataset_name=" + SEQ, f"data_root_dir={data_root}"])


def test_cli_restores_a_saved_model(data_root, tmp_path, capsys):
    """``python -m kinet_tpu_torch.engine.track`` on a saved run: config and
    checkpoint written as the trainer writes them (bf16 weights, so the
    model runs in bf16), MOTChallenge results and the summary lines."""
    from kinet_tpu_torch.config import save_config
    from kinet_tpu_torch.utils.checkpoint import CheckpointManager

    _, params, model = _models({})
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **IMG)
    model.to(torch.bfloat16)
    save_config(cfg, tmp_path / "run")
    CheckpointManager(str(tmp_path / "run")).save_epoch(
        model, torch.optim.SGD(model.parameters(), lr=0.0), 0, 0)
    track.main([f"obj_detect_checkpoint_dir={tmp_path / 'run'}",
                f"data_root_dir={data_root}", f"dataset_name={SEQ}",
                f"output_dir={tmp_path / 'out'}", "device=cpu"]
               + [f"tracker_cfg.{k}={v}" for k, v in THRESH.items()])
    text = capsys.readouterr().out
    assert f"TRACK SEQ: {SEQ}" in text and "NUM TRACKS:" in text
    assert f"for {N_FRAMES} frames" in text
    rows = _results(tmp_path / "out")
    assert rows.shape[1] == 10 and len(rows) > 0


@pytest.mark.parametrize("form", ["stacked", "interleaved"])
def test_main_track_batched_writes_the_same_files(form, tmp_path):
    """``batch_sequences: 2`` over two sequences of one frame size (one
    batch) against ``batch_sequences: 1``. Interleaved runs each sequence's
    own batch-1 forward: byte-identical result files and summaries.
    Stacked runs one forward of batch 2, whose sums run in another order:
    the same tracks and frames, boxes within 1e-3 px, and the same
    summary but for the means of IoU distances (within 1e-6)."""
    names = [SEQ, "MOT17-04-FRCNN"]
    root = tmp_path / "data"
    for i, name in enumerate(names):
        _write_sequence(root, name, n_frames=N_FRAMES, seed=i)
    _, _, model = _models({})
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(**TINY, **IMG)

    def run(out, **over):
        track_cfg = load_config("track.yaml").replace(
            data_root_dir=str(root), dataset_name=",".join(names),
            output_dir=str(out), device="cpu",
            **{f"tracker_cfg.{k}": v for k, v in THRESH.items()}, **over)
        return track.main_track(track_cfg, obj_detector_model=(model, None, cfg))

    ref = run(tmp_path / "single")
    got = run(tmp_path / "batched", batch_sequences=2, batch_exec=form)
    sub = ",".join(names)
    for name in names:
        text = (tmp_path / "batched" / sub / f"{name}.txt").read_bytes()
        want = (tmp_path / "single" / sub / f"{name}.txt").read_bytes()
        if form == "interleaved":
            assert text == want, name
            continue
        a = np.loadtxt(tmp_path / "batched" / sub / f"{name}.txt",
                       delimiter=",", ndmin=2)
        b = np.loadtxt(tmp_path / "single" / sub / f"{name}.txt",
                       delimiter=",", ndmin=2)
        assert len(b) >= N_FRAMES
        np.testing.assert_array_equal(a[:, :2], b[:, :2])
        np.testing.assert_allclose(a[:, 2:], b[:, 2:], atol=1e-3)
    assert got.keys() == ref.keys()
    for seq, row in ref.items():
        for k, v in row.items():
            if form == "stacked" and k in ("motp", "loc_a"):
                assert abs(got[seq][k] - v) < 1e-6, (seq, k)
            else:
                assert got[seq][k] == v, (seq, k)
