"""The synthetic-MOT accuracy gates through kinet_tpu_torch's trainer and
tracker (``kinet_tpu_torch/tools/mota_gates.py``), held to the thresholds
of the JAX package's gates:

- the simple gate (tests/test_synthetic_mota.py's recipe: 350 steps, then
  ``main_track`` from a saved run) on the CPU and on the card: MOTA > 0.5,
  IDF1 > 0.5, ID switches <= 2;
- the hard gate (tests/test_synthetic_mota_hard.py's recipe: 780 steps
  on the crossing / occlusion / noisy-detection scene, then the Tracker with
  public detections) on the card only: its 780 steps are too slow for the
  CPU suite (``gpu``-marked, skipped without a card): MOTA > 0.6, IDF1 > 0.55, ID
  switches <= 4, at least one re-identification, and the occluded
  object's identity kept across its occlusion;
- the dual-stream KineT gate (tests/test_synthetic_mota_kine.py's
  ``train_kinet`` recipe: 3600 steps, then ``main_track`` with
  ``track_kinet.yaml``) on the card only (``gpu``-marked: its 3600 steps take
  minutes on a CPU): MOTA > 0.6, IDF1 > 0.8, ID switches <= 2. The encoder-only KineT
  gate runs on the CPU in tests/test_torch_kine_track.py.

The models train from the port's own seeded initialisation, not the JAX
gates' weights, so only the thresholds are shared.
"""
import json

import pytest
import torch

from kinet_tpu_torch.tools import mota_gates

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _assert_simple(s):
    assert s["mota"] > 0.5, s
    assert s["idf1"] > 0.5, s
    assert s["num_switches"] <= 2, s


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")


def test_simple_gate_on_the_cpu():
    _assert_simple(mota_gates.run_simple(device="cpu"))


@pytest.mark.gpu
def test_simple_gate_on_the_card():
    _needs_card()
    s = mota_gates.run_simple()
    print(json.dumps({"gate": "simple", **s}))
    _assert_simple(s)


@pytest.mark.gpu
def test_hard_gate_on_the_card():
    _needs_card()
    s = mota_gates.run_hard()
    print(json.dumps({"gate": "hard", **s}))
    assert s["num_reids"] >= 1, s
    assert s["identity_kept"], s
    assert s["mota"] > 0.6, s
    assert s["idf1"] > 0.55, s
    assert s["num_switches"] <= 4, s


def test_gate_thresholds_are_the_jax_gates():
    assert mota_gates.THRESHOLDS == {
        "simple": {"mota": 0.5, "idf1": 0.5, "num_switches": 2},
        "hard": {"mota": 0.6, "idf1": 0.55, "num_switches": 4, "num_reids": 1},
        # tests/test_synthetic_mota_kine.py's two gates
        "kine": {"mota": 0.75, "idf1": 0.85, "num_switches": 2},
        "kine_dual": {"mota": 0.6, "idf1": 0.8, "num_switches": 2},
    }
    scores = {"mota": 0.5, "idf1": 0.9, "num_switches": 3, "num_reids": 0,
              "identity_kept": False}
    assert len(mota_gates.misses("simple", scores)) == 2
    assert len(mota_gates.misses("hard", scores)) == 3


@pytest.mark.gpu
def test_dual_stream_kine_gate_on_the_card():
    _needs_card()
    s = mota_gates.run_kine("kine_dual")
    print(json.dumps({"gate": "kine_dual", **s}))
    assert s["mota"] > 0.6, s
    assert s["idf1"] > 0.8, s
    assert s["num_switches"] <= 2, s
