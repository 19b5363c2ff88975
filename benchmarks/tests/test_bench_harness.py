"""The harness at a tiny size on the CPU: the reference against the port,
cells, configurations and metrics found as new files, and the faults that
``correct`` has to catch."""
import json
import warnings

import numpy as np
import pytest

from benchmarks import harness
from benchmarks.tests import tiny

warnings.filterwarnings("ignore", message="accuracy-unsafe")

EXACT = {"missing_answers": 0, "frames_untracked": 0, "stage_mismatches": 0,
         "state_mismatches": 0}


def run(tmp_path, base="trackformer_mot17", precision="float32", seed=2**31 + 7,
        seconds=1.0, trace=False, limits=None, **kw):
    conf = tiny.tiny_config("tiny_cfg", base, precision=precision)
    root, bench = tiny.make_root(tmp_path, {"tiny.s4": (conf, limits)}, **kw)
    return harness.run_cell("tiny.s4", seed, seconds, trace, "cpu", bench, root)


# (score, embedding, box px) gaps in float32: the order of sums alone; with
# the int8 decoder table also a value that float32 rounding puts on the
# other side of a half step (one step of the table's scale: gaps up to
# 3.5e-5, 2.5e-4 and 0.017 px over six seeds), far under bfloat16's
# (1e-3, 1e-2, 0.5 px at this size)
F32_GAPS = {"trackformer_mot17": (1e-5, 1e-4, 1e-2),
            "trackformer_mot17_lite_int8": (2e-4, 2e-3, 0.1)}


@pytest.mark.parametrize("base", sorted(F32_GAPS))
def test_reference_agrees_with_the_port_in_float32(tmp_path, base):
    """In float32 on the CPU the port's MSDA entries run their plain
    versions: the port and the reference differ by the order of sums."""
    res, rows, record, _ = run(tmp_path, base)
    nums = record["check"]
    assert res["correct"] and record["frames"] > 0
    for k in ("missing_answers", "stage_mismatches", "state_mismatches"):
        assert nums[k] == 0, nums
    score, embed, box = F32_GAPS[base]
    assert nums["score_gap"] < score and nums["decoder_gap"] < embed, nums
    assert nums["memory_gap"] < 1e-4, nums
    assert nums["box_gap_px"] < box, nums
    assert len(record["check_samples"]) == 3 and record["check_samples"][0] == 0
    assert record["live_tracks"] > 1.0
    assert record["events"]["kept"] > 0 and record["events"]["born"] > 0


@pytest.mark.parametrize("seconds", [0.05, 1.0])
def test_every_kept_step_is_checked(tmp_path, seconds):
    """The steps drawn for the check are all compared: one that a short
    window does not reach is stepped after the window closes."""
    res, _, record, ctx = run(tmp_path, seconds=seconds)
    assert len(record["check_samples"]) == ctx.workload["check_steps"] + 1
    assert record["check"]["missing_answers"] == 0 and res["correct"]
    if seconds < 0.1:
        assert record["late_samples"] > 0


def test_a_step_drawn_and_never_kept_is_a_missing_answer():
    from benchmarks import check

    cell = {"tracker_cfg": {"inactive_patience": 5}, "n_slots": 8,
            "hidden_dim": 48}
    nums = check.run_check(cell, [], [[{}]] * 4, 1, None, expected=[0, 9])
    assert nums["missing_answers"] == 8


def test_a_cell_configuration_and_metric_added_as_files(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files (and entries), no file edited: the harness finds each and
    the traced run reports the new metric."""
    src = ('"""Steps in the window."""\n\n\n'
           'def read(run):\n    return float(run["steps"])\n')
    entry = {"name": "window_steps", "unit": "steps", "better": "higher",
             "source": "host_clock", "layer": "batched tracker",
             "moves": "frames_per_s", "workloads": ["tiny.s4"]}
    res, _, record, ctx = run(tmp_path, trace=True,
                              metric_files={"window_steps": src},
                              per_layer=[entry])
    assert ctx.config["name"] == "tiny_cfg" and ctx.traffic["height"] == 96
    assert res["metrics"]["window_steps"]["value"] == record["steps"]
    assert set(res["metrics"]) == {"window_steps"}  # the others list theirs
    # the spans of the traced run are there for the cells that list them
    assert len(record["spans"]["forward"]) == record["steps"]
    assert len(record["spans"]["state_machine"]) == record["frames"]
    assert res["checks"] and list(res)[-1] == "checks"


def test_the_result_line_is_the_contracts(tmp_path):
    res, rows, _, _ = run(tmp_path)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    assert res["metrics"]["setup_s"]["unit"] == "s"
    assert {k for k, _, _ in rows} >= set(EXACT)
    json.dumps(res)


def fault_state_unchanged(monkeypatch):
    """Each tracker's step leaves its state as it was."""
    from kinet_tpu_torch.tracking import tracker

    monkeypatch.setattr(tracker.Tracker, "_consume",
                        lambda self, out, blob: None)


def fault_half_batch(monkeypatch):
    """Half of the streams are left out of each step (they ride along on
    their last inputs, as finished sequences do)."""
    from kinet_tpu_torch.tracking import batched

    step = batched.BatchedTracker.step

    def half(self, blobs):
        n = len(blobs) // 2
        return step(self, list(blobs[:n]) + [None] * (len(blobs) - n))

    monkeypatch.setattr(batched.BatchedTracker, "step", half)


def fault_altered_answer(monkeypatch):
    """One detection's box is moved where the forward's rows are fetched."""
    from kinet_tpu_torch.tracking import batched

    fetch = batched.fetch_rows

    def altered(res, rows):
        outs = fetch(res, rows)
        o = outs[rows[0]]
        top = int(np.argmax(o["scores"]))
        o["boxes"][top] += 40.0
        return outs

    monkeypatch.setattr(batched, "fetch_rows", altered)


def fault_altered_result(monkeypatch):
    """One track's result box is altered where the state machine writes it."""
    from kinet_tpu_torch.tracking import tracker

    consume = tracker.Tracker._consume

    def altered(self, out, blob):
        consume(self, out, blob)
        if self.tracks:
            self.tracks[0].pos = self.tracks[0].pos + 1.0

    monkeypatch.setattr(tracker.Tracker, "_consume", altered)


LIMITS = {"score_gap": 0.05, "box_gap_px": 8.0, "memory_gap": 0.05,
          "decoder_gap": 0.05}


@pytest.mark.parametrize("fault", [fault_state_unchanged, fault_half_batch,
                                   fault_altered_answer, fault_altered_result])
def test_faults_make_the_run_incorrect(tmp_path, monkeypatch, fault):
    res, _, _, _ = run(tmp_path, limits=LIMITS)
    assert res["correct"], res["checks"]
    fault(monkeypatch)
    res, _, record, _ = run(tmp_path / "fault", limits=LIMITS)
    assert not res["correct"], res["checks"]
