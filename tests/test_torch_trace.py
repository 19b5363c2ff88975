"""kinet_tpu_torch's tracer (``utils/trace.py``) on the CPU, over the tiny
flagship-family model of tests/test_torch_batched_tracker.py:

- a ``BatchedTracker`` step (stacked and interleaved) and a
  ``Tracker.step`` give the span tree of the served step: ``step`` >
  ``stage`` (a stream), ``h2d``, ``forward`` > ``backbone``, ``encoder``,
  ``decoder``, ``postprocess``; ``fetch``; ``state_machine`` (a stream),
  every span of the step with its number and each child inside its parent;
- ``h2d_bytes`` is the staged arrays' bytes;
- the track counters follow ``track_num``, ``num_reids`` and the track
  lists over a few frames, and each step's span keeps its own counts;
- off, ``span`` returns one shared object and nothing is recorded;
- under ``torch.profiler``, every drained span but the first lies within
  50 us of its ``kinet.*`` range at both ends: the spans are on the
  profile's clock;
- the CLI's ``trace`` key prints a line a span and the counters.
"""
import numpy as np
import pytest
import torch

from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.engine import track
from kinet_tpu_torch.models.build import build_model
from kinet_tpu_torch.models.postprocess import postprocess_focal
from kinet_tpu_torch.tracking.batched import BatchedTracker
from kinet_tpu_torch.tracking.tracker import Tracker
from kinet_tpu_torch.utils import trace

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_batched_tracker import KW, _bias_heads
from test_torch_port_tracker import FLAGSHIP, TINY, TRACKER_CFG, moving_boxes

N_SEQ = 2
MODEL_SPANS = ("backbone", "encoder", "decoder", "postprocess")


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m, _ = build_model(load_config("train.yaml", named=FLAGSHIP)
                       .replace(**TINY), device="cpu")
    _bias_heads(m, 0.3, -4.0)
    return m.eval()


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    yield
    trace.disable()


def _frames(n_frames, n_seq=N_SEQ):
    return [list(moving_boxes(n_frames, seed=20 + s)) for s in range(n_seq)]


def _stepper(model, form):
    """(a function stepping frame f of every stream, the trackers)."""
    seqs = _frames(3)
    if form == "single":
        tr = Tracker(model, postprocess_focal, TRACKER_CFG, **KW)
        return (lambda f: tr.step(seqs[0][f])), [tr]
    bt = BatchedTracker(model, postprocess_focal,
                        dict(TRACKER_CFG, batch_exec=form),
                        n_sequences=N_SEQ, **KW)
    return (lambda f: bt.step([s[f] for s in seqs])), bt.trackers


def _children(spans, i):
    return [s for s in spans if s["parent"] == i]


@pytest.mark.parametrize("form", ["stacked", "interleaved", "single"])
def test_a_step_gives_the_span_tree(model, form):
    step, trackers = _stepper(model, form)
    step(0)
    trace.enable()
    step(1)
    spans = trace.drain()["spans"]
    roots = [i for i, s in enumerate(spans) if s["parent"] is None]
    assert [spans[i]["name"] for i in roots] == ["step"]
    root = roots[0]
    n = len(trackers)
    streams = list(range(n)) if form != "single" else [None]
    forwards = n if form == "interleaved" else 1
    top = [s["name"] for s in _children(spans, root)]
    assert sorted(top) == sorted(["stage"] * n + ["h2d"] * forwards
                                 + ["forward"] * forwards + ["fetch"]
                                 + ["state_machine"] * n), top
    for name in ("stage", "state_machine"):
        assert [s["stream"] for s in spans if s["name"] == name] == streams
    h2d = [s["stream"] for s in spans if s["name"] == "h2d"]
    assert h2d == (list(range(n)) if form == "interleaved" else [None])
    for i, s in enumerate(spans):
        if s["name"] == "forward":
            assert [c["name"] for c in _children(spans, i)] == \
                list(MODEL_SPANS)
    assert {s["step"] for s in spans} == {spans[root]["step"]}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            up = spans[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= up["end_ns"], (s, up)
    trace.enable()  # a second step takes the next number
    step(2)
    assert {s["step"] for s in trace.drain()["spans"]} == \
        {spans[root]["step"] + 1}


@pytest.mark.parametrize("form", ["stacked", "interleaved", "single"])
def test_h2d_bytes_are_the_staged_arrays(model, form):
    step, trackers = _stepper(model, form)
    staged = []
    for tr in trackers:
        def build(blob, orig=tr._build_inputs):
            staged.append(orig(blob))
            return staged[-1]
        tr._build_inputs = build
    step(0)
    staged.clear()
    trace.enable()
    step(1)
    counters = trace.drain()["counters"]
    assert len(staged) == len(trackers)
    assert counters["h2d_bytes"] == sum(a.nbytes for inp in staged
                                        for a in inp.values())


def test_track_counters_follow_the_trackers_state(model):
    seqs = _frames(8)
    cfg = dict(TRACKER_CFG, batch_exec="stacked", inactive_patience=1)
    bt = BatchedTracker(model, postprocess_focal, cfg, n_sequences=N_SEQ,
                        **KW)
    trace.enable()
    live = 0
    for f in range(len(seqs[0])):
        bt.step([s[f] for s in seqs])
        live += sum(len(tr.tracks) for tr in bt.trackers)
    rec = trace.drain()
    counters = rec["counters"]
    # the same counts, each kept with the step it was made in
    steps = [s for s in rec["spans"] if s["name"] == "step"]
    assert len(steps) == len(seqs[0])
    for name, total in counters.items():
        assert sum(s["counters"].get(name, 0) for s in steps) == total, name
    assert all(s["counters"]["frames"] == N_SEQ for s in steps)
    born = sum(tr.track_num for tr in bt.trackers)
    left = sum(len(tr.tracks) + len(tr.inactive_tracks) for tr in bt.trackers)
    assert born > 0 and counters["tracks_born"] == born
    assert counters["tracks_reidentified"] == sum(tr.num_reids
                                                  for tr in bt.trackers)
    assert counters["tracks_ended"] == born - left
    assert counters["tracks_live"] == live
    assert counters["frames"] == N_SEQ * len(seqs[0])


def test_off_records_nothing(model):
    step, _ = _stepper(model, "stacked")
    assert not trace.enabled()
    assert trace.span("step") is trace.span("forward", 1)
    trace.count("frames", 3)
    step(0)
    trace.enable()
    assert trace.drain() == {"spans": [], "counters": {}}
    trace.disable()
    step(1)
    assert trace.drain() == {"spans": [], "counters": {}}


def test_spans_are_on_the_profiles_clock(model):
    step, _ = _stepper(model, "stacked")
    step(0)
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(1)
        step(2)
    spans = trace.drain()["spans"]
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("kinet."):
            ranges.setdefault(e.name()[6:], []).append(e)
    for name in ranges:
        ranges[name].sort(key=lambda e: e.start_ns())
    seen = {}
    assert len(spans) == sum(len(v) for v in ranges.values())
    for k, s in enumerate(spans):
        twin = ranges[s["name"]][seen.get(s["name"], 0)]
        seen[s["name"]] = seen.get(s["name"], 0) + 1
        if k == 0:
            continue
        for ours, theirs in ((s["start_ns"], twin.start_ns()),
                             (s["end_ns"], twin.end_ns())):
            assert abs(ours - theirs) < 50_000, (s["name"], ours - theirs)


@pytest.mark.parametrize("batch", [1, 2], ids=["tracker", "batched"])
def test_cli_prints_the_spans_and_counters(model, batch, tmp_path, capsys):
    from test_track_e2e import _write_sequence

    names = ["MOT17-02-FRCNN", "MOT17-04-FRCNN"]
    for i, name in enumerate(names):
        _write_sequence(tmp_path, name, n_frames=3, seed=i)
    cfg = load_config("train.yaml", named=FLAGSHIP).replace(
        **TINY, **{"img_transform.max_size": 160,
                   "img_transform.val_width": 96})
    track_cfg = load_config("track.yaml").replace(
        data_root_dir=str(tmp_path), dataset_name=",".join(names),
        output_dir=str(tmp_path / "out"), device="cpu", trace=True,
        batch_sequences=batch)
    track.main_track(track_cfg, obj_detector_model=(model, None, cfg))
    text = capsys.readouterr().out
    lines = text[text.index("RUNTIME"):].splitlines()[1:]
    names = ["step", "stage", "h2d", "forward", "backbone", "encoder",
             "decoder", "postprocess", "fetch", "state_machine"]
    for name in names:
        assert any(line.startswith(f"SPAN {name}: ") for line in lines), name
    counters = next(line for line in lines if line.startswith("COUNTERS: "))
    assert counters.startswith("COUNTERS: 6 frames, ")
    assert not trace.enabled()
