"""kinet_tpu_torch's batched tracking (``tracking/batched.py``) on the CPU:
N sequences stepped through one forward a step give each sequence the
results of its own single ``Tracker`` (batching moves where the forward
runs, never a decision), in the cases of tests/test_batched_tracker.py:

- vanilla DETR, stacked;
- the flagship family (deformable, multi-frame, ``cache_prev_encoder``,
  whose stacked memory and position caches round-trip through the
  batched forward), stacked: within 1e-3 px and 1e-4 in score of the
  single trackers (a batch of 2 sums in another order), and held to the
  JAX package's ``BatchedTracker`` on the same weights
  (``tools/from_jax.py``): the same track ids and frames every step,
  boxes within 1e-3 px; no score the trackers compare lies within 1e-3 of
  a threshold;
- interleaved (batch-1 forwards on row slices of the inputs and caches):
  bit for bit the single trackers' results;
- stacked, the flagship family over 4 sequences in reverse order: each
  sequence's results as in forward order, bit for bit (a row's results
  depend on its own inputs and caches alone; chip_smoke.py's phase B
  makes this check at full width in bf16);
- uneven lengths (a finished slot rides on its last inputs), a zero-frame
  slot riding on a donor's inputs, every slot empty;
- the kinematic tracker (``BatchedTrackerKinematic``).

``main_track`` with ``batch_sequences: 2`` writes the same result files as
with ``batch_sequences: 1``: tests/test_torch_track.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kinet_tpu.config import load_config as jax_load_config
from kinet_tpu.models.build import build_model as jax_build_model
from kinet_tpu.models.postprocess import postprocess_focal as jax_postprocess
from kinet_tpu.structs import ImageBatch as JaxImageBatch
from kinet_tpu.structs import Targets as JaxTargets
from kinet_tpu.tracking.batched import BatchedTracker as JaxBatchedTracker
from kinet_tpu.tracking.batched import run_batched as jax_run_batched
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.models.build import build_model
from kinet_tpu_torch.models.postprocess import postprocess_focal
from kinet_tpu_torch.tools.from_jax import load_jax_params
from kinet_tpu_torch.tracking.batched import (
    BatchedTracker,
    BatchedTrackerKinematic,
    run_batched,
)
from kinet_tpu_torch.tracking.kine_tracker import TrackerKinematic
from kinet_tpu_torch.tracking.tracker import Tracker

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_tracker import FLAGSHIP, TINY, TRACKER_CFG, moving_boxes

N_SEQ, N_FRAMES = 2, 4
KW = dict(num_object_queries=12, num_track_slots=4, hidden_dim=36)


def _sequences(n_seq=N_SEQ, n_frames=N_FRAMES):
    return [list(moving_boxes(n_frames, seed=10 + s)) for s in range(n_seq)]


def _bias_heads(model, person: float, other: float):
    """Every class head's bias: ``person`` for class 0, ``other`` for the
    rest (so that random weights give confident person detections)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "class_embed" in name and name.endswith("bias"):
                p.fill_(other)
                p[0] = person


@pytest.fixture(scope="module")
def flagship():
    """The tiny flagship-family JAX model with perturbed params (as
    tests/test_torch_port_tracker.py's) and the port model on the same
    weights."""
    cfg = jax_load_config("train.yaml", named=FLAGSHIP).replace(**TINY)
    jmodel, _, _ = jax_build_model(cfg)
    h, w = 64, 96
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3),
        JaxImageBatch(jnp.zeros((1, h, w, 3)), jnp.zeros((1, h, w), bool)),
        JaxTargets.create(jnp.zeros((1, 1, 4)), jnp.zeros((1, 1), jnp.int32),
                          jnp.zeros((1, 1), bool), num_track_queries=4,
                          hidden_dim=36)))
    rng = np.random.default_rng(3)

    def perturb(path, x):
        key = jax.tree_util.keystr(path)
        if ("sampling_offsets" in key or "attention_weights" in key) \
                and "kernel" in key:
            return (x + rng.normal(0, 0.05, x.shape)).astype(x.dtype)
        if "class_embed" in key and "bias" in key:
            return np.where(np.arange(x.shape[0]) == 0, 0.3,
                            -4.0).astype(x.dtype)
        return np.asarray(x)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    model, _ = build_model(
        load_config("train.yaml", named=FLAGSHIP).replace(**TINY),
        device="cpu")
    load_jax_params(model, params)
    return jmodel, params, model


def _singles(model, post, seqs, tracker_cfg=TRACKER_CFG, **kw):
    out = []
    for frames in seqs:
        tr = Tracker(model, post, tracker_cfg, **{**KW, **kw})
        for blob in frames:
            tr.step(blob)
        out.append(tr.get_results())
        assert out[-1], "no track spawned: the fixture is broken"
    return out


def _batched(model, post, seqs, tracker_cfg=TRACKER_CFG, **kw):
    bt = BatchedTracker(model, post, tracker_cfg, n_sequences=len(seqs),
                        **{**KW, **kw})
    run_batched(bt, [iter(s) for s in seqs])
    return bt


def _results_equal(got, ref, atol=1e-3, exact=False):
    assert got.keys() == ref.keys(), (sorted(got), sorted(ref))
    for tid in ref:
        assert got[tid].keys() == ref[tid].keys(), tid
        for f, r in ref[tid].items():
            if exact:
                np.testing.assert_array_equal(got[tid][f]["bbox"], r["bbox"])
                assert got[tid][f]["score"] == r["score"]
            else:
                np.testing.assert_allclose(got[tid][f]["bbox"], r["bbox"],
                                           atol=atol, err_msg=f"{tid} {f}")
                assert abs(got[tid][f]["score"] - r["score"]) < 1e-4


def _vanilla_model():
    cfg = load_config("train.yaml").replace(
        dataset="mot", backbone="resnet_test", hidden_dim=36, nheads=2,
        enc_layers=1, dec_layers=2, dim_feedforward=64, num_queries=12,
        max_objects=5, tracking=True, max_track_queries=4, dropout=0.0)
    model, post = build_model(cfg, device="cpu", seed=1)
    _bias_heads(model, 4.0, -4.0)
    return model.eval(), post["bbox"]


def test_batched_equals_single_vanilla_detr():
    model, post = _vanilla_model()
    seqs = _sequences()
    singles = _singles(model, post, seqs)
    bt = _batched(model, post, seqs, tracker_cfg={**TRACKER_CFG,
                                                  "batch_exec": "stacked"})
    for s in range(N_SEQ):
        _results_equal(bt.get_results(s), singles[s])


def test_batched_interleaved_equals_single(flagship):
    """Interleaved: each sequence's forward is the single tracker's own, so
    the results are the same bits, the stacked caches sliced by row."""
    _, _, model = flagship
    seqs = _sequences()
    singles = _singles(model, postprocess_focal, seqs)
    bt = _batched(model, postprocess_focal, seqs,
                  tracker_cfg={**TRACKER_CFG, "batch_exec": "interleaved"})
    assert bt.exec_form() == "interleaved"
    for s in range(N_SEQ):
        _results_equal(bt.get_results(s), singles[s], exact=True)


def test_batched_equals_single_flagship_family(flagship):
    """Stacked, with cache_prev_encoder: the port's batched tracker against
    the port's single trackers and JAX's BatchedTracker on the same
    weights, step by step."""
    jmodel, params, model = flagship
    assert model.cache_prev_encoder
    seqs = _sequences()
    singles = _singles(model, postprocess_focal, seqs)
    cfg = {**TRACKER_CFG, "batch_exec": "stacked"}
    bt = BatchedTracker(model, postprocess_focal, cfg, n_sequences=N_SEQ, **KW)
    jt = JaxBatchedTracker(jmodel, params, jax_postprocess, cfg,
                           n_sequences=N_SEQ, **KW)
    scores = []
    consume = Tracker._consume

    def recording(self, out, blob):
        scores.append(out["scores"])
        consume(self, out, blob)

    Tracker._consume = recording
    try:
        for f in range(N_FRAMES):
            blobs = [s[f] for s in seqs]
            bt.step(blobs)
            jt.step(blobs)
            for p, j in zip(bt.trackers, jt.trackers):
                assert (sorted(t.id for t in p.tracks)
                        == sorted(t.id for t in j.tracks)), f
                assert (sorted(t.id for t in p.inactive_tracks)
                        == sorted(t.id for t in j.inactive_tracks)), f
    finally:
        Tracker._consume = consume
    flat = np.concatenate(scores)
    for k in ("detection_obj_score_thresh", "track_obj_score_thresh",
              "reid_score_thresh"):
        assert np.abs(flat - TRACKER_CFG[k]).min() > 1e-3, k
    for s in range(N_SEQ):
        got = bt.get_results(s)
        assert sum(len(v) for v in got.values()) >= 4
        _results_equal(got, singles[s])
        _results_equal(got, jt.get_results(s))


def test_batched_stacked_rows_are_independent(flagship):
    _, _, model = flagship
    seqs = _sequences(n_seq=4)
    runs = []
    for order in (seqs, seqs[::-1]):
        bt = _batched(model, postprocess_focal, order,
                      tracker_cfg={**TRACKER_CFG, "batch_exec": "stacked"})
        runs.append([bt.get_results(s) for s in range(len(order))])
    for got, ref in zip(runs[1][::-1], runs[0]):
        assert sum(len(v) for v in ref.values()) >= 4
        _results_equal(got, ref, exact=True)


def test_batched_uneven_lengths():
    """A finished sequence's slot rides along; its results stop growing and
    equal its single tracker's."""
    model, post = _vanilla_model()
    seqs = _sequences(n_frames=4)
    seqs[1] = seqs[1][:2]
    singles = _singles(model, post, seqs)
    bt = _batched(model, post, seqs)
    r0, r1 = bt.get_results(0), bt.get_results(1)
    assert max(f for t in r0.values() for f in t) == 3
    assert max(f for t in r1.values() for f in t) == 1
    _results_equal(r0, singles[0])
    _results_equal(r1, singles[1])


def test_batched_zero_frame_slot_rides_on_donor():
    """A sequence with no frame rides on a live slot's inputs and gets no
    result; with every slot empty, run_batched ends without a forward."""
    model, post = _vanilla_model()
    seqs = _sequences()
    seqs[1] = []
    single = _singles(model, post, seqs[:1])[0]
    bt = _batched(model, post, seqs)
    _results_equal(bt.get_results(0), single)
    assert bt.get_results(1) == {}
    bt.reset()
    run_batched(bt, [iter([]), iter([])])
    assert bt.get_results(0) == {} and bt.get_results(1) == {}


def test_batched_kinematic_equals_single():
    """BatchedTrackerKinematic: two detection sequences of different
    detection counts through the dual-stream KineT model, one forward a
    step, equal two TrackerKinematic runs."""
    cfg = load_config("train.yaml", named=["train_kinet"]).replace(
        dataset="mot_kine", hidden_dim=32, nheads=2, dim_feedforward=32,
        num_queries=8, dropout=0.0, max_number_detection=8,
        max_track_queries=6, track_prev_frame_range=3,
        encoding_dim_tracklets=4, use_encoding_tracklets=True, tracking=True)
    model, post = build_model(cfg, device="cpu", seed=0)
    _bias_heads(model, 8.0, -8.0)
    model.eval()
    tcfg = dict(detection_obj_score_thresh=0.0, track_obj_score_thresh=0.0,
                detection_nms_thresh=0.9, track_nms_thresh=0.9,
                public_detections=False, inactive_patience=-1,
                reid_sim_threshold=0.0, reid_sim_only=False,
                reid_score_thresh=0.0, reid_greedy_matching=False,
                prev_frame_dist=1, steps_termination=1)
    kw = dict(num_object_queries=8, num_track_slots=6, trail_len=3,
              trail_enc_dim=4, meta_dim=1)
    rng = np.random.default_rng(3)
    seqs = [[{"detections": rng.uniform(0.2, 0.7, (3 + s, 4)).astype(
                  np.float32),
              "metadata": np.full((3 + s, 1), 0.9, np.float32),
              "orig_size": (100, 200), "max_detections": 8}
             for _ in range(3)] for s in range(2)]
    singles = []
    for frames in seqs:
        tr = TrackerKinematic(model, post["bbox"], tcfg, **kw)
        for blob in frames:
            tr.step(dict(blob))
        singles.append(tr.get_results())
        assert singles[-1], "no kine track spawned: the fixture is broken"
    bt = BatchedTrackerKinematic(model, post["bbox"], tcfg, n_sequences=2,
                                 **kw)
    run_batched(bt, [iter([dict(b) for b in s]) for s in seqs])
    for s in range(2):
        _results_equal(bt.get_results(s), singles[s])


def test_batch_exec_is_checked():
    model, post = _vanilla_model()
    with pytest.raises(ValueError, match="batch_exec"):
        BatchedTracker(model, post, {**TRACKER_CFG, "batch_exec": "fused"},
                       n_sequences=2, **KW)
    bt = BatchedTracker(model, post, TRACKER_CFG, n_sequences=2, **KW)
    assert bt.exec_form() == "stacked"  # auto
    with pytest.raises(ValueError, match="3 blobs for 2"):
        bt.step([None, None, None])


def test_jax_batched_runs_the_same_sequences(flagship):
    """The JAX package's BatchedTracker over uneven sequences against the
    port's: the same results per sequence (the finished slot's rows are
    discarded in both)."""
    jmodel, params, model = flagship
    seqs = _sequences()
    seqs[1] = seqs[1][:2]
    bt = _batched(model, postprocess_focal, seqs,
                  tracker_cfg={**TRACKER_CFG, "batch_exec": "stacked"})
    jt = JaxBatchedTracker(jmodel, params, jax_postprocess,
                           {**TRACKER_CFG, "batch_exec": "stacked"},
                           n_sequences=N_SEQ, **KW)
    jax_run_batched(jt, [iter(s) for s in seqs])
    for s in range(N_SEQ):
        _results_equal(bt.get_results(s), jt.get_results(s))
