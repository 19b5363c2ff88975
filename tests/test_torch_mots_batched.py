"""kinet_tpu_torch's MOTS20 model (vanilla DETR with DETR's mask head)
against the benchmark's plain float32 reference, on the CPU at a tiny
width, on the seeded weights of ``benchmarks/weights_segm.py``:

- ``SegmWrapper(DETR)``'s forward with track slots against
  ``benchmarks/reference/detr_segm.py``: scores, labels, boxes, the track
  embeddings and the mask logits, at a frame whose levels double and at
  one where no level doubles the next (the mask head's half-pixel resize);
- ``BatchedTracker`` (stacked, B = 2) against two single ``Tracker``s:
  the same tracks every frame, boxes within 1e-2 px, scores within 1e-4,
  and the same resolved masks but for a pixel in a thousand (a batch of 2
  sums in another order, which the decoder's sharpened attention and the
  track embeddings fed back over 4 frames grow to 1e-3 px; about 1e-6 in
  a probability, which moves a pixel that lies that close to 0.5 or to its
  runner-up);
- ``benchmarks/reference/mots_tracker.py`` against ``Tracker._consume`` on
  synthetic rows with masks (kept, missed, re-identified by slot and by
  embedding, new, clipped and suppressed tracks, tied probabilities): the
  same state, masks and results, bit for bit, every frame; and
  ``Tracker._resolve_masks`` against the reference's resolution over
  float, boolean and missing masks with ties, in one band of rows and in
  several;
- the tracer's mask spans and counters in a batched step (``mask_head``,
  ``mask_upsample`` under ``forward``; ``mask_fetch`` under ``fetch``;
  ``mask_resolve`` under each stream's ``state_machine``; ``mask_rows``,
  ``mask_d2h_bytes``, ``masks_resolved``), and nothing recorded off.
"""
import numpy as np
import pytest
import torch

from benchmarks import check_mots, weights_segm
from benchmarks.reference import mots_tracker as rm
from benchmarks.reference.detr_segm import DetrSegm
from benchmarks.traffic.generator import stream_frames
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.models.build import build_model
from kinet_tpu_torch.structs import ImageBatch, Targets
from kinet_tpu_torch.tracking.batched import BatchedTracker
from kinet_tpu_torch.tracking import tracker as tracker_mod
from kinet_tpu_torch.tracking.tracker import Track, Tracker
from kinet_tpu_torch.utils import trace

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(dataset="mot", backbone="resnet_test", hidden_dim=32, nheads=4,
            enc_layers=1, dec_layers=2, dim_feedforward=48, num_queries=8,
            max_track_queries=6, dropout=0.0)
REF_CFG = dict(TINY, num_classes=20, focal_loss=False, masks=True)
KW = dict(num_object_queries=8, num_track_slots=6, hidden_dim=32)
TRACKER_CFG = dict(detection_obj_score_thresh=0.5, track_obj_score_thresh=0.4,
                   detection_nms_thresh=0.9, track_nms_thresh=0.9,
                   reid_score_thresh=0.4, inactive_patience=2,
                   reid_sim_threshold=0.0, steps_termination=1)
SEED = 5


def _frames(h, w, n, stream=0):
    traffic = dict(streams=1, height=h, width=w, pad_bottom=8, pad_right=16,
                   cycle_frames=n, boxes=3, box_height=[0.2, 0.4],
                   box_width=[0.1, 0.2], max_speed=0.03, background_std=0.5,
                   box_gain=2.0)
    return stream_frames(traffic, 40 + stream, stream)


@pytest.fixture(scope="module")
def models():
    """(the port's model and postprocess, the reference) on one state dict,
    its input projection centred on a 64 x 96 frame by the reference's own
    backbone."""
    cfg = load_config("train.yaml", named=["train_tracking", "train_mots20"])
    model, post = build_model(cfg.replace(**TINY), device="cpu")
    ref = DetrSegm(REF_CFG)
    ref.load_state_dict(weights_segm.state_dict(ref, SEED, "cpu",
                                                torch.float32))
    blob = _frames(64, 96, 1)[0]
    with torch.inference_mode():
        c5 = ref.features(torch.from_numpy(blob["images"]))[-1]
    sd = weights_segm.state_dict(ref, SEED, "cpu", torch.float32,
                                 weights_segm.c5_mean(c5))
    model.load_state_dict(sd)
    ref.load_state_dict(sd)
    return model.eval(), post["bbox"], ref.eval()


@pytest.mark.parametrize("hw", [(64, 96), (100, 164)])
def test_reference_matches_the_port(models, hw):
    model, post, ref = models
    blob = _frames(*hw, 1)[0]
    images = torch.from_numpy(blob["images"])
    pad = torch.from_numpy(blob["pad_mask"])
    rng = np.random.default_rng(0)
    t, d = KW["num_track_slots"], KW["hidden_dim"]
    tq = torch.from_numpy(rng.normal(size=(1, t, d)).astype(np.float32))
    tq_mask = torch.tensor([[True, True, True, False, False, False]])
    size = torch.tensor([[float(hw[0]), float(hw[1])]])
    targets = Targets.create(
        torch.zeros(1, 1, 4), torch.zeros(1, 1, dtype=torch.int64),
        torch.zeros(1, 1, dtype=torch.bool), num_track_queries=t,
        hidden_dim=d).replace(track_query_embeds=tq,
                              track_query_boxes=torch.full((1, t, 4), 0.5),
                              track_query_mask=tq_mask)
    with torch.inference_mode():
        out = model(ImageBatch(images, pad), targets)
        got = post(out, size)
        want = ref(images, pad, tq, tq_mask, size)
    feats = [f.shape[-2:] for f in want["feats"]]
    if hw == (100, 164):  # 25x41, 13x21, 7x11, 4x6: nothing doubles
        assert all(2 * b[0] != a[0] and 2 * b[1] != a[1]
                   for a, b in zip(feats, feats[1:])), feats
    torch.testing.assert_close(got["scores"], want["scores"], rtol=0,
                               atol=1e-5)
    assert torch.equal(got["labels"], want["labels"])
    torch.testing.assert_close(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    torch.testing.assert_close(out["hs_embed"], want["hs_embed"], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out["pred_masks"], want["pred_masks"],
                               rtol=1e-4, atol=1e-4)


def test_batched_mask_tracker_equals_single_trackers(models):
    model, post, _ = models
    seqs = [_frames(64, 96, 4, stream=s) for s in range(2)]
    singles = []
    for frames in seqs:
        tr = Tracker(model, post, TRACKER_CFG, **KW)
        for blob in frames:
            tr.step(blob)
        singles.append(tr.get_results())
    bt = BatchedTracker(model, post, dict(TRACKER_CFG, batch_exec="stacked"),
                        n_sequences=2, **KW)
    for f in range(4):
        bt.step([s[f] for s in seqs])
    pixels = flipped = 0
    for i, want in enumerate(singles):
        got = bt.get_results(i)
        assert want and got.keys() == want.keys()
        for tid, frames in want.items():
            assert got[tid].keys() == frames.keys(), tid
            for f, r in frames.items():
                g = got[tid][f]
                np.testing.assert_allclose(g["bbox"], r["bbox"], atol=1e-2)
                assert abs(g["score"] - r["score"]) < 1e-4
                assert g["mask"].dtype == bool and g["mask"].shape == (64, 96)
                pixels += r["mask"].size
                flipped += int((g["mask"] != r["mask"]).sum())
    assert flipped <= pixels // 1000, (flipped, pixels)


def _rows(rng, st, n_slots, n_queries, hw):
    """A frame's synthetic rows: track-slot scores around the keep
    threshold, a few confident new detections (one with the embedding of
    an inactive track, so the embedding assignment re-identifies it), boxes
    partly outside the frame, and probabilities with a tie."""
    n = n_slots + n_queries
    h, w = hw
    scores = rng.uniform(0.2, 0.7, n).astype(np.float32)
    scores[n_slots:] = rng.uniform(0.0, 0.45, n_queries)
    new = rng.choice(n_queries, 3, replace=False) + n_slots
    scores[new] = rng.uniform(0.55, 0.9, 3)
    labels = np.where(rng.uniform(size=n) < 0.9, 0, 3)
    xy = rng.uniform([-10, -10], [w, h], (n, 2))
    wh = rng.uniform([8, 8], [w / 2, h / 2], (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    hs = rng.normal(size=(n, KW["hidden_dim"])).astype(np.float32)
    if st.inactive:
        hs[new[0]] = st.inactive[0].hs_embed
    probs = rng.uniform(0, 1, (n, h, w)).astype(np.float32)
    probs[new[1]] = probs[new[2]]  # a tie: the first such track wins
    return dict(scores=scores, labels=labels, boxes=boxes, hs_embed=hs,
                mask_probs=probs)


def test_reference_state_machine_with_masks_matches_consume(models):
    model, post, _ = models
    tr = Tracker(model, post, TRACKER_CFG, **KW)
    st = rm.State([], [], 0, 0, 0)
    frames = _frames(64, 96, 8)
    rng = np.random.default_rng(1)
    n_slots = KW["num_track_slots"]
    seen = dict(kept=0, inactive=0, reid=0, results=0)
    for blob in frames:
        inputs = tr._build_inputs(blob)
        staged = rm.stage(st, blob["orig_size"], n_slots, KW["hidden_dim"],
                          TRACKER_CFG["inactive_patience"])
        for k, v in staged.items():
            np.testing.assert_array_equal(inputs[k], v)
        out = _rows(rng, st, n_slots, KW["num_object_queries"],
                    blob["images"].shape[1:3])
        reids = tr.num_reids
        tr._consume(out, blob)
        rm.consume(st, out, TRACKER_CFG, n_slots, clip_hw=blob["orig_size"])
        assert check_mots.state_diff(st, check_mots.snapshot(tr),
                                     check_mots.frame_results(tr)) == 0
        seen["kept"] += len(tr.tracks)
        seen["inactive"] += len(tr.inactive_tracks)
        seen["reid"] += tr.num_reids - reids
        seen["results"] += len(check_mots.frame_results(tr))
    assert all(seen.values()), seen


def test_resolve_masks_matches_the_reference(models):
    """The per-pixel resolution over float, boolean and missing masks, with
    ties (the first track of the highest probability wins) and pixels at
    exactly 0.5 (no track's)."""
    model, post, _ = models
    rng = np.random.default_rng(2)
    hw = (16, 24)
    probs = rng.choice([0.2, 0.5, 0.7, 0.9], size=(4, *hw)).astype(np.float32)
    masks = [probs[0], probs[1] > 0.6, None, probs[0], probs[3]]
    tr = Tracker(model, post, TRACKER_CFG, **KW)
    ref = []
    for i, m in enumerate(masks):
        tr.tracks.append(Track(i, np.zeros(4), 1.0, np.zeros(2), i, mask=m))
        ref.append(rm.Track(i, np.zeros(4), 1.0, np.zeros(2), i, mask=m))
    tr._resolve_masks(hw)
    rm.resolve(ref, hw)
    claimed = np.zeros(hw, int)
    for t, r in zip(tr.tracks, ref):
        assert t.mask.dtype == bool
        np.testing.assert_array_equal(t.mask, r.mask)
        claimed += t.mask
    assert claimed.max() == 1 and not tr.tracks[3].mask.any()



def test_resolve_masks_in_bands_matches_the_reference(models):
    """A frame wide enough to be resolved in several bands of rows, the
    last one short: the same masks as the reference's whole-frame
    resolution, ties and pixels at 0.5 included."""
    model, post, _ = models
    rng = np.random.default_rng(3)
    hw = (21, 4096)  # bands of 8, 8 and 5 rows
    assert tracker_mod.RESOLVE_BAND_BYTES // (4 * hw[1]) == 8
    probs = rng.choice([0.2, 0.5, 0.7, 0.9], size=(4, *hw)).astype(np.float32)
    masks = [probs[0], probs[1] > 0.6, None, probs[0], probs[2], probs[3]]
    tr = Tracker(model, post, TRACKER_CFG, **KW)
    ref = []
    for i, m in enumerate(masks):
        tr.tracks.append(Track(i, np.zeros(4), 1.0, np.zeros(2), i, mask=m))
        ref.append(rm.Track(i, np.zeros(4), 1.0, np.zeros(2), i,
                            mask=None if m is None else m.copy()))
    rm.resolve(ref, hw)
    tr._resolve_masks(hw)
    claimed = np.zeros(hw, int)
    for t, r in zip(tr.tracks, ref):
        assert t.mask.dtype == bool and t.mask.shape == hw
        np.testing.assert_array_equal(t.mask, r.mask)
        claimed += t.mask
    assert claimed.max() == 1 and claimed.any()

def test_mask_spans_and_counters(models):
    model, post, _ = models
    seqs = [_frames(64, 96, 2, stream=s) for s in range(2)]
    bt = BatchedTracker(model, post, dict(TRACKER_CFG, batch_exec="stacked"),
                        n_sequences=2, **KW)
    trace.disable()
    try:
        bt.step([s[0] for s in seqs])
        assert trace.drain() == {"spans": [], "counters": {}}
        assert trace.span("mask_head") is trace.span("mask_resolve", 1)
        trace.enable()
        bt.step([s[1] for s in seqs])
        rec = trace.drain()
    finally:
        trace.disable()
    spans = rec["spans"]
    names = {s["name"]: s for s in spans}
    parent = lambda s: spans[s["parent"]]["name"]
    for name in ("backbone", "encoder", "decoder", "mask_head",
                 "mask_upsample"):
        assert parent(names[name]) == "forward", name
    assert parent(names["mask_fetch"]) == "fetch"
    resolve = [s for s in spans if s["name"] == "mask_resolve"]
    assert resolve and all(parent(s) == "state_machine" for s in resolve)
    assert {s["stream"] for s in resolve} <= {0, 1}
    rows = 2 * (KW["num_track_slots"] + KW["num_object_queries"])
    c = rec["counters"]
    assert c["mask_rows"] == rows
    assert c["mask_d2h_bytes"] == rows * 64 * 96 * 4
    assert c["masks_resolved"] == sum(len(t.tracks) for t in bt.trackers)
