"""The control: the reference in fp8 in the program's place must come out
as not correct. At a tiny size on the CPU here; at the cells' own size on
the card (``gpu``; ``control.py`` gives the readings the limits are set
from)."""
import warnings

import pytest
import torch

from benchmarks import control, harness
from benchmarks.tests import tiny

warnings.filterwarnings("ignore", message="accuracy-unsafe")


@pytest.mark.parametrize("base", ["trackformer_mot17",
                                  "trackformer_mot17_lite_int8"])
def test_fp8_control_reads_far_above_bfloat16(tmp_path, base):
    conf = tiny.tiny_config("tiny_cfg", base, precision="bfloat16")
    root, bench = tiny.make_root(tmp_path, {"tiny.s4": (conf, None)})
    _, _, record, ctx = harness.run_cell("tiny.s4", 11, 1.0, False, "cpu",
                                         bench, root)
    prog = record["check"]
    ctrl = control.control_numbers(ctx, "cpu")
    # at this size bfloat16 reads about a tenth of fp8 on these numbers
    assert ctrl["memory_gap"] > 3 * prog["memory_gap"], (prog, ctrl)
    assert ctrl["decoder_gap"] > 3 * prog["decoder_gap"], (prog, ctrl)
    assert ctrl["box_gap_px"] > 3 * prog["box_gap_px"], (prog, ctrl)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["mot17.s4", "lite.s4"])
def test_fp8_control_fails_the_cells_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    bench = harness.load_json(harness.ROOT.parent / "BENCHMARK.json")
    res, _, _, ctx = harness.run_cell(cell, 20260418, 4.0, False, "cuda", bench)
    assert res["correct"], res["checks"]
    nums = control.control_numbers(ctx, "cuda")
    limits = ctx.workload["limits"]
    assert any(nums[k] > lim for k, lim in limits.items() if k in nums), nums
