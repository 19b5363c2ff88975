"""kinet_tpu_torch's MOTChallenge metrics and det-file parser against the
JAX package's, on the CPU:

- every scenario of tests/test_mot_metrics.py runs twice, once through
  ``kinet_tpu.utils.mot_metrics`` and once with the port's module in its
  place: the scenario's own assertions hold for the port, and every
  metric dict it computes (CLEAR-MOT, ID measures, HOTA, summaries) is
  equal, number for number;
- ``parse_mot_csv`` against the csv reader of
  ``kinet_tpu.native.parse_mot_csv`` (its fallback without the C++
  library) on rows of 6, 7 and 10 fields, short rows and an empty file:
  equal arrays.
"""
import inspect

import numpy as np
import pytest

import kinet_tpu.native as native
import kinet_tpu.utils.mot_metrics as jax_mm
import test_mot_metrics as scenarios
from kinet_tpu_torch.data.mot_csv import parse_mot_csv
from kinet_tpu_torch.utils import mot_metrics as port_mm

SCENARIOS = sorted(
    name for name, fn in inspect.getmembers(scenarios, inspect.isfunction)
    if name.startswith("test_")
)


def _run_scenario(name, module, monkeypatch):
    """Runs scenario ``name`` with ``module``'s metrics in place of the JAX
    package's; returns every metric dict the scenario computed, in order
    (summaries' inner accumulators included)."""
    seen = []
    base, evaluate_orig = module.MOTAccumulator, module.evaluate_mot_accums

    class Recording(base):
        pass

    for method in ("clear_mot", "id_measures", "hota", "metrics"):
        def recorded(self, *a, _orig=getattr(base, method), _name=method, **kw):
            out = _orig(self, *a, **kw)
            seen.append((_name, out))
            return out
        setattr(Recording, method, recorded)

    def evaluate(*a, **kw):
        out = evaluate_orig(*a, **kw)
        seen.append(("evaluate_mot_accums", out))
        return out

    names = {"MOTAccumulator": Recording, "evaluate_mot_accums": evaluate,
             "iou_distance": module.iou_distance,
             "iou_matrix": module.iou_matrix,
             "get_mot_accum": module.get_mot_accum,
             "format_summary": module.format_summary}
    with monkeypatch.context() as m:
        for attr, value in names.items():
            for target in {jax_mm, module, scenarios}:
                if hasattr(target, attr):
                    m.setattr(target, attr, value)
        getattr(scenarios, name)()
    return seen


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenarios_match_jax(name, monkeypatch):
    ref = _run_scenario(name, jax_mm, monkeypatch)
    got = _run_scenario(name, port_mm, monkeypatch)
    assert ref, f"{name} computed no metric"
    assert got == ref


def test_all_scenarios_are_covered():
    assert len(SCENARIOS) >= 16


ROWS = {
    "six": "1,-1,10,20,30,40\n2,-1,11.5,21,30,40\n",
    "seven": "1,-1,10,20,30,40,0.9\n3,2,1,2,3,4,0.25\n",
    "ten": "1,-1,10,20,30,40,0.9,-1,-1,-1\n2,7,5,6,7,8,1,1,0.5,3\n",
    "short": "1,2,3\n\n4,-1,10,20,30,40,0.5\n1,2,3,4,5\n",
    "mixed": "1,-1,10,20,30,40\n2,-1,10,20,30,40,0.75,-1,-1,-1\n3,1,1,1,1,1,0.5\n",
    "empty": "",
}


@pytest.mark.parametrize("case", sorted(ROWS))
def test_parse_mot_csv_matches_jax_csv_reader(case, tmp_path, monkeypatch):
    path = tmp_path / "det.txt"
    path.write_text(ROWS[case])
    monkeypatch.setattr(native, "_load", lambda: None)  # the csv reader
    ref = native.parse_mot_csv(str(path))
    got = parse_mot_csv(str(path))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert got.shape[1] == 7
    np.testing.assert_array_equal(got, ref)
