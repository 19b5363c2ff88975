"""kinet_tpu_torch's kinematic tracker and the tracking paths of this
slice against the JAX package, on the CPU:

- ``TrackerKinematic`` on the stub script of tests/test_kine_tracker.py
  (spawn, persist, terminate, trails, two tracks) and on scripts with an
  inactive track revived by its own row (its ``count_inactive`` kept) and
  with ``snap_to_detections``: the same results, trails and counters as
  JAX's tracker on the same stub;
- ``TrackerKinematic`` driving the real dual-stream model on bridged
  weights: the same results as JAX's;
- the encoder-only KineT gate (tests/test_synthetic_mota_kine.py's recipe,
  ``tools/mota_gates.py``) trained through the port on the CPU and held to
  the JAX gate's thresholds; then ``main_track`` with ``track_kinet.yaml``
  over the gate's sequence in both packages on the trained weights (JAX's
  filled from the port's): the same result rows, ids equal, boxes within
  1e-3 px, with and without boxes snapped to the public detections;
- ``main_track`` with ``generate_attention_maps`` on a vanilla DETR: the
  per-query maps [Hf, Wf] of every result against JAX's (atol 1e-5).

The dual-stream gate runs on the card only
(tests/test_torch_synthetic_mota.py).

Tolerances: boxes within 1e-3 px, scores within 1e-5 (float32).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from torch import nn

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.engine import track as jax_track
from kinet_tpu.models.build import build_model as jax_build_model
from kinet_tpu.models.postprocess import postprocess as jax_postprocess
from kinet_tpu.structs import KineBatch as JaxKineBatch
from kinet_tpu.structs import Targets as JaxTargets
from kinet_tpu.tracking.kine_tracker import TrackerKinematic as JaxTracker
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.engine import track
from kinet_tpu_torch.models.build import build_model
from kinet_tpu_torch.models.postprocess import postprocess
from kinet_tpu_torch.tools import mota_gates
from kinet_tpu_torch.tools.from_jax import flax_path, load_jax_params, to_flax_layout
from kinet_tpu_torch.tracking.kine_tracker import TrackerKinematic

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_track_e2e import _write_sequence

T_SLOTS, N_DET = 6, 8
TRACKER = dict(
    detection_obj_score_thresh=0.4, track_obj_score_thresh=0.4,
    detection_nms_thresh=0.9, track_nms_thresh=0.9, public_detections=False,
    inactive_patience=-1, reid_sim_threshold=0.0, reid_sim_only=False,
    reid_score_thresh=0.4, reid_greedy_matching=False, prev_frame_dist=1,
    steps_termination=1,
)


def _stub_outputs(script, frame):
    nq = T_SLOTS + N_DET
    logits = np.full((1, nq, 21), -10.0, np.float32)
    logits[..., 20] = 10.0
    boxes = np.full((1, nq, 4), 0.5, np.float32)
    for kind, idx, score, box in script.get(frame, []):
        row = idx if kind == "track" else T_SLOTS + idx
        logits[0, row, 20] = 0.0
        logits[0, row, 0] = np.log(score / (1 - score + 1e-8))
        logits[0, row, 1:20] = -30.0
        boxes[0, row] = box
    return logits, boxes


class JaxStub:
    """tests/test_kine_tracker.py's stub: script[frame] = [(kind, index,
    score, relative cxcywh box)]; it also records the track queries."""

    def __init__(self, script):
        self.script, self.frame, self.seen = script, 0, []

    def apply(self, params, kb, targets, **kw):
        self.seen.append(np.array(targets.track_query_embeds))
        logits, boxes = _stub_outputs(self.script, self.frame)
        self.frame += 1
        return {"pred_logits": jnp.asarray(logits),
                "pred_boxes": jnp.asarray(boxes)}


class PortStub(nn.Module):
    def __init__(self, script):
        super().__init__()
        self.dummy = nn.Parameter(torch.zeros(1))
        self.script, self.frame, self.seen = script, 0, []

    def forward(self, kb, targets):
        self.seen.append(targets.track_query_embeds.numpy().copy())
        logits, boxes = _stub_outputs(self.script, self.frame)
        self.frame += 1
        return {"pred_logits": torch.from_numpy(logits),
                "pred_boxes": torch.from_numpy(boxes)}


def _jax_tracker(model, params, cfg, **kw):
    t = JaxTracker(model, params, jax_postprocess, cfg, **kw)
    if isinstance(model, JaxStub):
        def fwd(p, kb, targets, orig_size):
            out = model.apply(p, kb, targets)
            res = jax_postprocess(out, orig_size)
            return {"scores": res["scores"], "labels": res["labels"],
                    "boxes": res["boxes"], "rel_boxes": out["pred_boxes"]}
        t._fwd_kine = fwd
    return t


def _blob(k=2, seed=0):
    rng = np.random.default_rng(seed)
    dets = rng.uniform(0.2, 0.8, (k, 4)).astype(np.float32)
    dets[:, 2:] = rng.uniform(0.05, 0.2, (k, 2))
    return {"detections": dets,
            "metadata": np.full((k, 1), 0.9, np.float32),
            "orig_size": (100, 200), "max_detections": N_DET}


def _assert_same_results(got, ref, box_atol=1e-3):
    assert got.keys() == ref.keys()
    for tid in ref:
        assert got[tid].keys() == ref[tid].keys(), tid
        for f, r in ref[tid].items():
            g = got[tid][f]
            np.testing.assert_allclose(g["bbox"], r["bbox"], atol=box_atol)
            assert abs(g["score"] - r["score"]) < 1e-5
            assert g["obj_ind"] == r["obj_ind"]


B1 = np.array([0.25, 0.5, 0.1, 0.2], np.float32)
B2 = np.array([0.7, 0.5, 0.1, 0.2], np.float32)
SCRIPTS = {
    "spawn-persist-terminate": ({
        0: [("det", 0, 0.9, B1)],
        1: [("track", 0, 0.9, B1 + [0.02, 0, 0, 0])],
        2: [],
    }, {}),
    "trail": ({0: [("det", 0, 0.9, B1)], **{
        f: [("track", 0, 0.9, B1 + [0.02 * f, 0, 0, 0])] for f in range(1, 5)}},
        {}),
    "two-tracks": ({
        0: [("det", 0, 0.9, B1)],
        1: [("track", 0, 0.9, B1), ("det", 1, 0.8, B2)],
        2: [("track", 0, 0.9, B1), ("track", 1, 0.8, B2)],
    }, {}),
    # track 0 goes inactive at frame 1, is aged, and comes back on its own
    # row at frame 3 (its count_inactive kept, not reset)
    "inactive-revival": ({
        0: [("det", 0, 0.9, B1), ("det", 1, 0.8, B2)],
        1: [("track", 1, 0.8, B2)],
        2: [("track", 0, 0.8, B2)],
        3: [("track", 0, 0.85, B2), ("track", 1, 0.7, B1)],
        4: [("track", 0, 0.85, B2), ("track", 1, 0.7, B1)],
    }, dict(inactive_patience=5)),
    "snap-to-detections": ({
        0: [("det", 0, 0.9, B1 + 0.01), ("det", 1, 0.8, B2)],
        1: [("track", 0, 0.9, B1 + 0.02), ("track", 1, 0.7, B2 - 0.01)],
    }, dict(snap_to_detections=True)),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_tracker_on_stub_scripts_matches_jax(name):
    script, over = SCRIPTS[name]
    cfg = {**TRACKER, **over}
    kw = dict(num_object_queries=N_DET, num_track_slots=T_SLOTS, trail_len=3,
              trail_enc_dim=4, meta_dim=1)
    jstub, pstub = JaxStub(script), PortStub(script)
    jt = _jax_tracker(jstub, {}, cfg, **kw)
    pt = TrackerKinematic(pstub, postprocess, cfg, **kw)
    blob = _blob()
    if name == "snap-to-detections":
        blob["detections"] = np.stack([B1, B2]).astype(np.float32)
    for _ in range(max(script) + 1):
        jt.step(dict(blob))
        pt.step(dict(blob))
    _assert_same_results(pt.get_results(), jt.get_results())
    assert pt.track_num == jt.track_num and pt.num_reids == jt.num_reids
    for got, ref in zip(pstub.seen, jstub.seen):  # the trail encodings
        np.testing.assert_allclose(got, ref, atol=1e-5)
    for tracks, jtracks in ((pt.tracks, jt.tracks),
                            (pt.inactive_tracks, jt.inactive_tracks)):
        assert [t.id for t in tracks] == [t.id for t in jtracks]
        for t, j in zip(tracks, jtracks):
            assert (t.count_inactive, t.count_termination) == \
                (j.count_inactive, j.count_termination)
            np.testing.assert_allclose(np.stack(t.trail), np.stack(j.trail),
                                       atol=1e-6)
    if name == "inactive-revival":
        assert pt.num_reids == 1 and pt.tracks[-1].count_inactive == 2


def test_tracker_with_the_dual_stream_model_matches_jax():
    over = dict(dataset="mot_kine", hidden_dim=32, nheads=2,
                dim_feedforward=32, num_queries=N_DET, dropout=0.0,
                max_number_detection=N_DET, max_track_queries=T_SLOTS,
                track_prev_frame_range=3, tracking=True)
    jcfg = jax_load_config("train.yaml", named=["train_kinet"]).replace(**over)
    cfg = load_config("train.yaml", named=["train_kinet"]).replace(**over)
    jmodel, _, _ = jax_build_model(jcfg)
    e_dim = 3 * 4 + 3
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0),
        JaxKineBatch(detections=jnp.zeros((1, N_DET, 4)),
                     metadata=jnp.zeros((1, N_DET, 1)),
                     pad_mask=jnp.zeros((1, N_DET), bool)),
        JaxTargets.create(jnp.zeros((1, 1, 4)), jnp.zeros((1, 1), jnp.int32),
                          jnp.zeros((1, 1), bool), num_track_queries=T_SLOTS,
                          hidden_dim=e_dim)))
    flat = flatten_dict(params, sep="/")
    for k in flat:
        if k.endswith("class_embed/bias"):  # confident person detections
            b = np.array(flat[k])
            b[:] = -8.0
            b[0] = 1.5
            flat[k] = b
    params = unflatten_dict(flat, sep="/")
    model, _ = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    tcfg = {**TRACKER, "detection_obj_score_thresh": 0.5,
            "track_obj_score_thresh": 0.5, "reid_score_thresh": 0.5}
    kw = dict(num_object_queries=N_DET, num_track_slots=T_SLOTS, trail_len=3,
              trail_enc_dim=0, meta_dim=1)
    jt = _jax_tracker(jmodel, params, tcfg, **kw)
    pt = TrackerKinematic(model, postprocess, tcfg, **kw)
    for f in range(4):
        blob = _blob(k=3, seed=f)
        jt.step(dict(blob))
        pt.step(dict(blob))
    ref = jt.get_results()
    assert len(ref) >= 2
    _assert_same_results(pt.get_results(), ref)


@pytest.fixture(scope="module")
def kine_gate(tmp_path_factory):
    """The encoder-only gate trained through the port on the CPU, saved as
    a run; its tracking summary from ``main_track``."""
    root = tmp_path_factory.mktemp("kinegate")
    mota_gates.write_kine_scene(root / "data")
    model, optimizer, cfg, loss, _ = mota_gates.train_kine(
        "kine", root / "data", torch.device("cpu"))
    from kinet_tpu_torch.config import save_config
    from kinet_tpu_torch.utils.checkpoint import CheckpointManager
    save_config(cfg, root / "model")
    CheckpointManager(str(root / "model")).save_epoch(
        model, optimizer, mota_gates.KINE_STEPS["kine"], 0)
    summary = track.main_track(mota_gates.kine_track_cfg(
        root / "data", root / "model", root / "results", "cpu"))
    return root, model, cfg, loss, summary[mota_gates.KINE_SEQ]


def test_encoder_kine_gate_on_the_cpu(kine_gate):
    *_, loss, m = kine_gate
    print("KINE GATE:", json.dumps({k: float(m[k]) for k in m}))
    assert np.isfinite(loss)
    assert m["mota"] > 0.75, m
    assert m["idf1"] > 0.85, m
    assert m["num_switches"] <= 2, m


def _jax_params_of(model, jmodel, example):
    """The JAX parameter tree of ``jmodel`` filled from the port model."""
    shapes = flatten_dict(jax.device_get(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0), *example))["params"])
    state = dict(model.named_parameters())
    flat = {}
    for name, p in state.items():
        path = flax_path(model, name)
        flat[path] = to_flax_layout(model, name, p.detach().numpy(),
                                    shapes[path].shape)
    assert set(flat) == set(shapes)
    return {"params": unflatten_dict(flat)}


@pytest.mark.parametrize("snap", [True, False], ids=["snapped", "raw-boxes"])
def test_main_track_kinet_matches_jax(kine_gate, tmp_path, snap):
    root, model, cfg, _, _ = kine_gate
    jcfg = jax_load_config("train.yaml", named=["train_kinet2"]).replace(
        **{k: v for k, v in cfg.to_dict().items() if not isinstance(v, dict)})
    jmodel, _, _ = jax_build_model(jcfg)
    e_dim = 3 * 16 + 3
    example = (
        JaxKineBatch(detections=jnp.zeros((1, 8, 4)),
                     metadata=jnp.zeros((1, 8, 1)),
                     pad_mask=jnp.zeros((1, 8), bool)),
        JaxTargets.create(jnp.zeros((1, 1, 4)), jnp.zeros((1, 1), jnp.int32),
                          jnp.zeros((1, 1), bool), num_track_queries=8,
                          hidden_dim=e_dim))
    params = _jax_params_of(model, jmodel, example)
    over = {"tracker_cfg.snap_to_detections": snap}
    jax_out, out = tmp_path / "jax", tmp_path / "port"
    jsum = jax_track.main_track(
        _jax_track_cfg(root / "data", jax_out, over),
        obj_detector_model=(jmodel, params, None, jcfg))
    psum = track.main_track(
        mota_gates.kine_track_cfg(root / "data", "", out, "cpu", **over),
        obj_detector_model=(model, None, cfg))
    seq = mota_gates.KINE_SEQ
    ref = np.loadtxt(jax_out / seq / f"{seq}.txt", delimiter=",", ndmin=2)
    got = np.loadtxt(out / seq / f"{seq}.txt", delimiter=",", ndmin=2)
    assert len(ref) >= 60 and got.shape == ref.shape
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])  # frames, ids
    np.testing.assert_allclose(got[:, 2:6], ref[:, 2:6], atol=1e-3)
    for k in ("mota", "idf1", "num_switches"):
        assert psum[seq][k] == jsum[seq][k], k


def _jax_track_cfg(data, out, over):
    return jax_load_config("track_kinet.yaml").replace(
        data_root_dir=str(data), dataset_name=mota_gates.KINE_SEQ,
        output_dir=str(out),
        **{"tracker_cfg.detection_obj_score_thresh": 0.3,
           "tracker_cfg.track_obj_score_thresh": 0.3,
           "tracker_cfg.detection_nms_thresh": 0.5, **over})


def test_attention_maps_match_jax(tmp_path):
    """``generate_attention_maps`` with a vanilla DETR on a 4-frame
    sequence: every result's map [Hf, Wf] is JAX's."""
    from test_torch_detr import configs
    from kinet_tpu.structs import ImageBatch as JaxImageBatch

    seq = "MOT17-02-FRCNN"
    (tmp_path / "MOT17" / "test").mkdir(parents=True)
    _write_sequence(tmp_path, seq, n_frames=4, seed=0)
    img = {"img_transform.max_size": 160, "img_transform.val_width": 96}
    jcfg, cfg = configs(**img)
    jmodel, _, _ = jax_build_model(jcfg)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0),
        JaxImageBatch(images=jnp.zeros((1, 96, 128, 3)),
                      pad_mask=jnp.zeros((1, 96, 128), bool)),
        JaxTargets.create(jnp.zeros((1, 1, 4)), jnp.zeros((1, 1), jnp.int32),
                          jnp.zeros((1, 1), bool), num_track_queries=4,
                          hidden_dim=32)))
    flat = flatten_dict(params, sep="/")
    for k in flat:
        if k.endswith("class_embed/bias"):
            b = np.array(flat[k])
            b[1:] -= 20.0
            flat[k] = b
    params = unflatten_dict(flat, sep="/")
    model, _ = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    thresh = {"tracker_cfg.detection_obj_score_thresh": 0.4,
              "tracker_cfg.track_obj_score_thresh": 0.3,
              "tracker_cfg.reid_score_thresh": 0.3}
    captured = {}

    def capture(module, key):
        orig = module.Tracker.get_results

        def get_results(self):
            captured[key] = orig(self)
            return captured[key]
        return orig, get_results

    from kinet_tpu.tracking import tracker as jax_tracker_mod
    from kinet_tpu_torch.tracking import tracker as port_tracker_mod
    origs = []
    for mod, key in ((jax_tracker_mod, "jax"), (port_tracker_mod, "port")):
        orig, patched = capture(mod, key)
        origs.append((mod, orig))
        mod.Tracker.get_results = patched
    try:
        jax_track.main_track(
            jax_load_config("track.yaml").replace(
                data_root_dir=str(tmp_path), dataset_name=seq, output_dir="",
                generate_attention_maps=True, **thresh),
            obj_detector_model=(jmodel, params, None, jcfg))
        track.main_track(
            load_config("track.yaml").replace(
                data_root_dir=str(tmp_path), dataset_name=seq, output_dir="",
                generate_attention_maps=True, device="cpu", **thresh),
            obj_detector_model=(model, None, cfg))
    finally:
        for mod, orig in origs:
            mod.Tracker.get_results = orig
    ref, got = captured["jax"], captured["port"]
    assert len(ref) >= 2
    _assert_same_results(got, ref)
    n_maps = 0
    for tid in ref:
        for f, r in ref[tid].items():
            m = got[tid][f]["attention_map"]
            assert m.shape == r["attention_map"].shape and m.ndim == 2
            np.testing.assert_allclose(m, r["attention_map"], atol=1e-5)
            n_maps += 1
    assert n_maps >= 4

