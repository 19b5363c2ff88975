"""The program's tracer in a run of the benchmark (``run_traced.py``,
``program_trace.py``), at the tiny cell's size on the CPU: the host metrics
of the program's spans and counters read, the device's read None without a
card, the record keeps what a run without the tracer has, the window's
steps are kept, the harness's checks run first, and the gaps and kernels
are named by the innermost span."""
import sys
import types
import warnings

import pytest
import torch

from benchmarks import harness, program_trace, run_traced
from benchmarks.loops import batched_tracking
from benchmarks.tests import tiny
from benchmarks.traffic.generator import make_streams

warnings.filterwarnings("ignore", message="accuracy-unsafe")

SEED = 2**31 + 7
HOST = ("h2d_ms", "h2d_mb_per_frame", "enqueue_ms", "fetch_ms")
DEVICE = ("enqueue_idle_pct", "backbone_ms", "encoder_ms", "decoder_ms")


def cell(tmp_path):
    conf = tiny.tiny_config("tiny_cfg", "trackformer_mot17")
    return tiny.make_root(tmp_path, {"tiny.s4": (conf, None)})


@pytest.mark.parametrize("trace", [True, False], ids=["traced", "untraced"])
def test_a_run_reads_the_programs_metrics(tmp_path, trace):
    root, bench = cell(tmp_path)
    res, _, record, ctx = run_traced.run_cell(
        "tiny.s4", SEED, 1.0, trace, "cpu", bench, root)
    assert res["correct"], res["checks"]
    for name in HOST:
        assert res["metrics"][name]["value"] > 0, name
    for name in DEVICE:  # no card, no profile of its work
        assert name not in res["metrics"]
    program = record["program"]
    assert program["counters"]["frames"] == record["frames"]
    steps = {s["step"] for s in program["spans"]}
    assert len(steps) == record["steps"]
    # the bytes of a frame: its image, its pad mask and the staged slots
    frame = make_streams(ctx.traffic, SEED)[0][0]
    slots, hidden = tiny.TINY["max_track_queries"], tiny.TINY["hidden_dim"]
    per_frame = frame["images"].nbytes + frame["pad_mask"].nbytes \
        + slots * (hidden * 4 + 4 * 4 + 1) + 2 * 4
    assert res["metrics"]["h2d_mb_per_frame"]["value"] == \
        pytest.approx(per_frame / 1e6, rel=1e-12)
    # the window's steps alone, each with its spans and counts
    assert sum(s["counters"]["frames"] for s in program["spans"]
               if s["name"] == "step") == record["frames"]
    assert all(program["spans"][s["parent"]]["step"] == s["step"]
               for s in program["spans"] if s["parent"] is not None)
    # the harness and the loop as they were, the tracer off
    from kinet_tpu_torch.utils import trace as program_tracer

    assert not program_tracer.enabled()
    assert harness.run_cell is run_traced._plain_run_cell
    assert batched_tracking.read_profile.__module__ == batched_tracking.__name__


@pytest.mark.parametrize("loaded,code", [(None, 3), ("jax", 4)],
                         ids=["no_card", "forbidden_module"])
def test_main_runs_the_harnesss_checks_first(monkeypatch, loaded, code):
    # no card: refused as run.py refuses; with one, a forbidden module
    # loaded refuses the run before its set-up
    if loaded is not None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran, plain = [], harness.run_cell
    monkeypatch.setattr(run_traced, "_plain_run_cell",
                        lambda *a, **k: ran.append(a))
    argv = ["--workload", "lite.s4", "--seed", "1", "--seconds", "1"]
    assert run_traced.main(argv, 0.0) == code
    assert not ran and harness.run_cell is plain


def test_the_window_keeps_its_steps_and_their_counts():
    spans = [
        {"name": "step", "start_ns": 0, "end_ns": 10, "parent": None,
         "step": 0, "stream": None, "counters": {"frames": 2}},
        {"name": "h2d", "start_ns": 1, "end_ns": 2, "parent": 0, "step": 0,
         "stream": None},
        {"name": "step", "start_ns": 20, "end_ns": 30, "parent": None,
         "step": 1, "stream": None, "counters": {"frames": 2, "h2d_bytes": 5}},
        {"name": "fetch", "start_ns": 28, "end_ns": 29, "parent": 2,
         "step": 1, "stream": None},
        {"name": "step", "start_ns": 40, "end_ns": 50, "parent": None,
         "step": 2, "stream": None, "counters": {"frames": 1}},
    ]
    out = program_trace.window({"spans": spans, "counters": {}}, 12, 38)
    assert [s["name"] for s in out["spans"]] == ["step", "fetch"]
    assert [s["parent"] for s in out["spans"]] == [None, 0]
    assert out["counters"] == {"frames": 2, "h2d_bytes": 5}


def test_the_record_keeps_what_a_run_without_the_tracer_has(tmp_path):
    root, bench = cell(tmp_path)
    plain, _, plain_rec, _ = harness.run_cell("tiny.s4", SEED, 1.0, True,
                                              "cpu", bench, root)
    res, rows, record, _ = run_traced.run_cell(
        "tiny.s4", SEED, 1.0, True, "cpu", bench, root)
    assert "program" not in plain_rec
    assert set(record) == set(plain_rec) | {"program"}
    assert list(res) == list(plain)
    assert set(res["metrics"]) == set(plain["metrics"]) | set(HOST)
    assert res["correct"] and plain["correct"]
    for k in ("missing_answers", "stage_mismatches", "state_mismatches"):
        assert record["check"][k] == plain_rec["check"][k] == 0
    assert set(record["spans"]) == set(plain_rec["spans"])
    assert len(record["spans"]["forward"]) == record["steps"]


SPANS = [(10, 100, "step"), (12, 20, "stage"), (21, 30, "h2d"),
         (31, 80, "forward"), (32, 50, "backbone"), (51, 70, "encoder"),
         (81, 90, "fetch"), (110, 200, "step"), (111, 190, "forward")]


@pytest.mark.parametrize("t,name", [
    (5, "outside"), (11, "step"), (25, "h2d"), (40, "backbone"),
    (75, "forward"), (85, "fetch"), (95, "step"), (105, "outside"),
    (150, "forward"), (195, "step")])
def test_the_innermost_span_names_a_time(t, name):
    assert program_trace.Innermost(SPANS)(t) == name


def test_gaps_and_kernels_go_to_the_innermost_span():
    owner = program_trace.Innermost(SPANS)
    dev = [(0, 25, "k"), (45, 60, "k"), (74, 76, "k"), (86, 120, "k")]
    gaps = program_trace.name_gaps(dev, 0, 200, owner)
    # 25-45 (mid 35, backbone), 60-74 (67, encoder), 76-86 (81, fetch),
    # 120-200 (160, forward)
    assert gaps == pytest.approx({"backbone": 20e-6, "encoder": 14e-6,
                                  "fetch": 10e-6, "forward": 80e-6})
    assert sum(gaps.values()) == pytest.approx(
        200e-6 - sum(z - a for a, z, _ in dev) * 1e-6)
    kernels = [(1, 0.5), (2, 0.25), (3, 0.125), (4, 1.0)]
    launches = {1: 40, 2: 60, 3: 105}
    assert program_trace.device_by_span(kernels, launches, owner) == {
        "backbone": 0.5, "encoder": 0.25, "outside": 0.125, "unlinked": 1.0}
