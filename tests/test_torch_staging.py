"""The copy of a step's staged inputs to the device
(``kinet_tpu_torch/tracking/staging.py``), on the CPU and, in the
``gpu``-marked cases, on the card:

- ``FrameStager`` gives the bits of ``torch.from_numpy(x).to(dtype)`` for
  float32 and bf16 images, one part or several, on random values, ties of
  bf16's rounding, subnormals and signed zeros, and bf16 follows a plain
  numpy model of round-to-nearest-even; so does every split of the frames'
  rows into pieces, from one piece to a piece a row;
- its buffers are reused step after step (same pointers, no allocation),
  and a new frame shape allocates once;
- ``h2d_pinned_bytes`` is 0 on a CPU device;
- ``BatchedTracker`` (stacked, interleaved) and ``Tracker.step`` on a tiny
  model give the results of the copy made as before (each array through
  ``torch.from_numpy(...).to(device)``, rows concatenated) bit for bit;
- ``Tracker._build_inputs`` returns float32 images equal to the blob's,
  while the device's images are in the model's ``image_dtype``, which
  ``DeformableDETR``, ``DETR`` and ``SegmWrapper`` give;
- on the card: the buffers are page-locked, the host's bf16 equals the
  card's cast bit for bit, and a buffer whose copy is still pending (the
  stream held back by ``torch.cuda._sleep``) is not written over.

This file imports no JAX, so that its ``gpu`` cases collect on the card.
"""
import numpy as np
import pytest
import torch

from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.models.build import build_model
from kinet_tpu_torch.models.postprocess import postprocess_focal
from kinet_tpu_torch.models.segmentation import SegmWrapper
from kinet_tpu_torch.tracking.batched import BatchedTracker
from kinet_tpu_torch.tracking import staging
from kinet_tpu_torch.tracking.staging import FrameStager
from kinet_tpu_torch.tracking.tracker import Tracker
from kinet_tpu_torch.utils import trace

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLAGSHIP = ["train_deformable", "train_tracking", "train_multi_frame"]
TINY = dict(
    dataset="mot", backbone="resnet_test", hidden_dim=36, nheads=2,
    enc_layers=2, dec_layers=2, dim_feedforward=64, num_queries=12,
    max_track_queries=4, dropout=0.0,
)
KW = dict(num_object_queries=12, num_track_slots=4, hidden_dim=36)
TRACKER_CFG = dict(
    detection_obj_score_thresh=0.5, track_obj_score_thresh=0.5,
    detection_nms_thresh=0.9, track_nms_thresh=0.9, public_detections=False,
    inactive_patience=2, reid_sim_threshold=6.0, reid_sim_only=False,
    reid_score_thresh=0.5, reid_greedy_matching=False, prev_frame_dist=1,
    steps_termination=1,
)
N_SEQ, N_FRAMES = 2, 4

# float32 bit patterns at bf16's edges: signed zeros, subnormals (ties
# among them), ties to even of both parities, either side of a tie, the
# largest finite (which rounds to infinity) and the smallest normal
EDGES = np.array([
    0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x00008000, 0x00018000,
    0x80018000, 0x00007FFF, 0x00008001, 0x007FFFFF, 0x00800000, 0x3F808000,
    0x3F818000, 0x3F807FFF, 0x3F808001, 0xBF808000, 0xBF818000, 0x7F7FFFFF,
    0x7F7F8000, 0x7F7F7FFF, 0x4B7F8000,
], np.uint32)


def edge_values(shape, seed):
    """float32 [*shape]: normal draws, with random finite bit patterns
    (their low half set to bf16's tie in a third of them) and ``EDGES``
    spread through."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    flat = x.reshape(-1).view(np.uint32)
    n = flat.size // 2
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    bits[(bits & 0x7F800000) == 0x7F800000] ^= np.uint32(0x00800000)  # finite
    bits[::3] = (bits[::3] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    at = rng.choice(flat.size, n + len(EDGES), replace=False)
    flat[at[:n]] = bits
    flat[at[n:]] = EDGES
    assert np.isfinite(x).all()
    return x


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """The bf16 bits of finite float32 values rounded to nearest, ties to
    even: a plain model of the conversion."""
    b = x.view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def parts_of(x: np.ndarray, n_parts: int) -> list:
    """``x`` [B, ...] as ``n_parts`` parts of rows, each with a mask and a
    small slot array beside the images."""
    rows = np.array_split(np.arange(len(x)), n_parts)
    return [{"images": np.ascontiguousarray(x[r]),
             "pad_mask": np.ascontiguousarray(x[r, ..., 0] > 0),
             "tq_boxes": np.full((len(r), 4, 4), 0.5, np.float32)}
            for r in rows]


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    yield
    trace.disable()


@pytest.mark.parametrize("n_parts", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stager_gives_the_casts_bits(dtype, n_parts):
    x = edge_values((3, 24, 40, 3), seed=n_parts)
    out = FrameStager("cpu").stage(parts_of(x, n_parts), dtype)
    want = torch.from_numpy(x).to(dtype)
    assert out["images"].dtype == dtype
    assert torch.equal(out["images"].view(torch.int16 if dtype == torch.bfloat16
                                          else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
    if dtype == torch.bfloat16:
        assert np.array_equal(out["images"].view(torch.int16).numpy()
                              .view(np.uint16), bf16_bits(x))
    assert torch.equal(out["pad_mask"], torch.from_numpy(x[..., 0] > 0))
    assert torch.equal(out["tq_boxes"], torch.full((3, 4, 4), 0.5))


@pytest.mark.parametrize("torch_threads", [1, 3])
@pytest.mark.parametrize("n_parts", [1, 2, 3])
@pytest.mark.parametrize("n_workers", [1, 2, 5, 16, 200])
def test_pieces_of_rows_cover_every_part(monkeypatch, n_workers, n_parts,
                                         torch_threads):
    # one piece, two that meet inside a frame and a part, a piece a row of
    # the batch, and more workers than rows; filled by the pool, or as one
    # piece where torch has threads of its own
    monkeypatch.setattr(staging, "workers", lambda: n_workers)
    monkeypatch.setattr(torch, "get_num_threads", lambda: torch_threads)
    x = edge_values((3, 24, 40, 3), seed=10 + n_parts)
    stager = FrameStager("cpu")
    for step in range(2):
        out = stager.stage(parts_of(x + step, n_parts), torch.bfloat16)
        assert torch.equal(out["images"],
                           torch.from_numpy(x + step).to(torch.bfloat16))
        assert torch.equal(out["pad_mask"],
                           torch.from_numpy(x[..., 0] + step > 0))
        assert torch.equal(out["tq_boxes"], torch.full((3, 4, 4), 0.5))
    assert (stager._pool is None) == (n_workers == 1 or torch_threads > 1)


def _frames(n_frames, seed, h=64, w=96):
    """Blobs of a padded scene of three bright boxes moving over noise."""
    rng = np.random.default_rng(seed)
    vh, vw = h - 16, w - 8
    starts = rng.uniform([4, 4], [vh - 16, vw - 20], size=(3, 2))
    vel = rng.uniform(-3, 3, size=(3, 2))
    for f in range(n_frames):
        img = rng.normal(0, 0.3, size=(1, h, w, 3)).astype(np.float32)
        for (y, x), (vy, vx) in zip(starts, vel):
            y0 = int(np.clip(y + vy * f, 0, vh - 12))
            x0 = int(np.clip(x + vx * f, 0, vw - 10))
            img[0, y0:y0 + 12, x0:x0 + 10] += 2.0
        pad = np.zeros((1, h, w), bool)
        pad[:, vh:] = True
        pad[:, :, vw:] = True
        img[pad] = 0.0
        yield {"images": img, "pad_mask": pad, "orig_size": (vh, vw),
               "dets": np.zeros((0, 4), np.float32)}


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m, _ = build_model(load_config("train.yaml", named=FLAGSHIP)
                       .replace(**TINY), device="cpu")
    with torch.no_grad():  # confident person detections from random weights
        for name, p in m.named_parameters():
            if "class_embed" in name and name.endswith("bias"):
                p.fill_(-4.0)
                p[0] = 0.3
    return m.eval()


def _copy_as_before(tracker):
    """Routes ``tracker.make_device_inputs`` through the copy made before
    the stager: each array to the device as it is, rows concatenated."""
    make = tracker.make_device_inputs

    def before(inputs):
        rows = inputs if isinstance(inputs, list) else [inputs]
        return make({k: torch.cat([torch.from_numpy(r[k]).to(tracker.device)
                                   for r in rows]) for k in rows[0]})
    tracker.make_device_inputs = before


def _run(model, form, as_before):
    seqs = [list(_frames(N_FRAMES, seed=30 + s)) for s in range(N_SEQ)]
    if form == "single":
        tr = Tracker(model, postprocess_focal, TRACKER_CFG, **KW)
        if as_before:
            _copy_as_before(tr)
        for blob in seqs[0]:
            tr.step(blob)
        return [tr.get_results()]
    bt = BatchedTracker(model, postprocess_focal,
                        dict(TRACKER_CFG, batch_exec=form),
                        n_sequences=N_SEQ, **KW)
    if as_before:
        _copy_as_before(bt.trackers[0])
    for f in range(N_FRAMES):
        bt.step([s[f] for s in seqs])
    return [bt.get_results(i) for i in range(N_SEQ)]


@pytest.mark.parametrize("form", ["stacked", "interleaved", "single"])
def test_results_equal_the_copy_made_before(model, form):
    got, want = _run(model, form, False), _run(model, form, True)
    assert all(want), "no track spawned: the fixture is broken"
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for tid in w:
            assert sorted(g[tid]) == sorted(w[tid])
            for f in w[tid]:
                assert np.array_equal(g[tid][f]["bbox"], w[tid][f]["bbox"])
                assert g[tid][f]["score"] == w[tid][f]["score"]


@pytest.mark.parametrize("form", ["stacked", "single"])
def test_buffers_are_reused_and_a_new_shape_allocates_once(model, form):
    small = [list(_frames(2, seed=40 + s)) for s in range(N_SEQ)]
    large = [list(_frames(2, seed=50 + s, h=80, w=112)) for s in range(N_SEQ)]
    if form == "single":
        tr = Tracker(model, postprocess_focal, TRACKER_CFG, **KW)
        step = lambda seqs, f: tr.step(seqs[0][f])  # noqa: E731
    else:
        bt = BatchedTracker(model, postprocess_focal,
                            dict(TRACKER_CFG, batch_exec=form),
                            n_sequences=N_SEQ, **KW)
        tr = bt.trackers[0]
        step = lambda seqs, f: bt.step([s[f] for s in seqs])  # noqa: E731
    trace.enable()
    allocs, ptrs = [], []
    for seqs in (small, large):
        (tr if form == "single" else bt).reset()  # a new sequence
        for f in range(2):
            step(seqs, f)
            allocs.append(trace.drain()["counters"].get("h2d_stage_allocs", 0))
            ptrs.append({k: b.data_ptr() for k, b in tr._stager._bufs.items()})
    # six arrays at the first step; the frame's two (images, pad mask) at
    # the new shape; none at a step of a shape seen before
    assert allocs == [6, 0, 2, 0]
    assert ptrs[0] == ptrs[1] and ptrs[2] == ptrs[3]
    assert ptrs[2]["tq_embeds"] == ptrs[0]["tq_embeds"]
    assert tr._stager._bufs["images"].shape[1:] == (80, 112, 3)


def test_nothing_is_pinned_on_a_cpu_device(model):
    seqs = [list(_frames(2, seed=60 + s)) for s in range(N_SEQ)]
    bt = BatchedTracker(model, postprocess_focal,
                        dict(TRACKER_CFG, batch_exec="stacked"),
                        n_sequences=N_SEQ, **KW)
    trace.enable()
    for f in range(2):
        bt.step([s[f] for s in seqs])
    counters = trace.drain()["counters"]
    assert counters["h2d_bytes"] > 0
    assert counters.get("h2d_pinned_bytes", 0) == 0
    assert not any(b.is_pinned() for b in bt.trackers[0]._stager._bufs.values())


class _Bf16Images(torch.nn.Module):
    """A stand-in model whose forward would cast its images to bf16."""

    image_dtype = torch.bfloat16

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))


def test_build_inputs_keep_float32_and_the_device_gets_image_dtype():
    blob = next(_frames(1, seed=70))
    blob["images"].reshape(-1)[:len(EDGES)] = EDGES.view(np.float32)
    tr = Tracker(_Bf16Images(), postprocess_focal, TRACKER_CFG, **KW)
    inputs = tr._build_inputs(blob)
    assert inputs["images"].dtype == np.float32
    assert np.array_equal(inputs["images"], blob["images"])
    batch, targets, size = tr.make_device_inputs(inputs)
    assert batch.images.dtype == torch.bfloat16
    assert torch.equal(batch.images,
                       torch.from_numpy(blob["images"]).to(torch.bfloat16))
    assert np.array_equal(inputs["images"], blob["images"])  # left as it was
    assert torch.equal(batch.pad_mask, torch.from_numpy(blob["pad_mask"]))
    assert torch.equal(size, torch.tensor([[48.0, 88.0]]))
    assert targets.track_query_embeds.dtype == torch.float32


@pytest.mark.parametrize("kind", ["deformable", "detr", "segm"])
def test_models_give_the_dtype_their_forward_casts_to(kind):
    named = FLAGSHIP if kind == "deformable" else ["train_tracking"]
    m, _ = build_model(load_config("train.yaml", named=named).replace(**TINY),
                       device="cpu")
    if kind == "segm":
        m = SegmWrapper(m, 36, 2)
    assert m.image_dtype == torch.float32
    assert m.to(torch.bfloat16).image_dtype == torch.bfloat16


# ---------------------------------------------------------------- the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked staging runs only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_parts", [1, 4])
def test_card_buffers_are_page_locked(n_parts):
    dev = _cuda()
    x = edge_values((4, 32, 48, 3), seed=2)
    stager = FrameStager(dev)
    trace.enable()
    out = stager.stage(parts_of(x, n_parts), torch.bfloat16)
    torch.cuda.synchronize()
    counters = trace.drain()["counters"]
    assert all(b.is_pinned() for b in stager._bufs.values())
    assert counters["h2d_pinned_bytes"] == sum(
        t.numel() * t.element_size() for t in out.values())
    assert counters["h2d_stage_allocs"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("n_parts", [1, 4])
def test_card_gets_the_bits_of_its_own_cast(n_parts):
    dev = _cuda()
    x = edge_values((4, 64, 96, 3), seed=3)
    out = FrameStager(dev).stage(parts_of(x, n_parts), torch.bfloat16)
    want = torch.from_numpy(x).to(dev).to(torch.bfloat16)
    assert torch.equal(out["images"].view(torch.int16),
                       want.view(torch.int16))
    assert np.array_equal(out["images"].view(torch.int16).cpu().numpy()
                          .view(np.uint16), bf16_bits(x))


@pytest.mark.gpu
@pytest.mark.parametrize("n_parts", [1, 4])
def test_a_pending_copy_is_not_written_over(n_parts):
    dev = _cuda()
    stager = FrameStager(dev)
    a = edge_values((4, 128, 192, 3), seed=4)
    b = -a
    stager.stage(parts_of(a, n_parts), torch.bfloat16)  # allocates
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s: the copies below wait
    first = stager.stage(parts_of(a, n_parts), torch.bfloat16)
    second = stager.stage(parts_of(b, n_parts), torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(first["images"], torch.from_numpy(a).to(dev)
                       .to(torch.bfloat16))
    assert torch.equal(second["images"], torch.from_numpy(b).to(dev)
                       .to(torch.bfloat16))
    assert torch.equal(first["pad_mask"].cpu(), torch.from_numpy(a[..., 0] > 0))
