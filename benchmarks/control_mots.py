"""The readings that the MOTS cell's limits are set from, at its own size:
``control.py`` with ``check_mots.py`` in the place of ``check.py``.

    python3 benchmarks/control_mots.py --workload mots20.s4 --seeds <n,n,...>
        [--control-seeds <n,n,...>] [--seconds <s>] [--out <file.jsonl>]

For each of ``--seeds`` it runs the cell and prints the program's compared
numbers (their largest over the seeds: each number's lower reading); for
each of ``--control-seeds`` it then puts the reference, computed in fp8
(``reference/lowp.py``), in the program's place on the same kept steps
(their smallest: each number's upper reading). It needs the card.
"""
from __future__ import annotations

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmarks import check_mots, control  # noqa: E402
from benchmarks.loops.batched_tracking import DTYPES  # noqa: E402


def control_numbers(ctx, device, detail=None):
    """The compared numbers of the fp8 reference in the program's place on
    the kept steps of the run ``ctx`` made."""
    conf, kept = ctx.config, ctx.kept
    dtype = DTYPES[conf["precision"]]
    mean = kept["cell"]["c5_mean"]
    ref = check_mots.Reference(conf["model"], ctx.seed, device, dtype, mean)
    low = check_mots.Reference(conf["model"], ctx.seed, device, dtype, mean,
                               fp8=True)
    return check_mots.run_check(kept["cell"], kept["samples"],
                                kept["streams"], kept["cycle"], ref,
                                control=low, detail=detail,
                                expected=kept["expected"])


if __name__ == "__main__":
    control.control_numbers = control_numbers  # what control.main calls
    control.main()
