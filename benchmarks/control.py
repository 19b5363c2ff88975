"""The readings that a cell's limits are set from, at the cell's own size.

    python3 benchmarks/control.py --workload <cell> --seeds <n,n,...>
        [--control-seeds <n,n,...>] [--seconds <s>] [--out <file.jsonl>]

For each of ``--seeds`` it runs the cell (a short window at the cell's own
load and the same kept steps as a run) and prints the program's compared
numbers: their largest over the seeds is each number's lower reading. For
each of ``--control-seeds`` it then puts the reference, computed in fp8
(``reference/lowp.py``), in the program's place on the same kept steps and
prints the numbers it gets: their smallest is each number's upper
reading. The benchmark's own runs never run this; it needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmarks import harness  # noqa: E402

harness.setup_env()

from benchmarks import check  # noqa: E402
from benchmarks.loops.batched_tracking import DTYPES  # noqa: E402


def control_numbers(ctx, device, detail=None):
    """The compared numbers of the fp8 reference in the program's place on
    the kept steps of the run ``ctx`` made."""
    conf, kept = ctx.config, ctx.kept
    dtype = DTYPES[conf["precision"]]
    ref = check.Reference(conf["model"], ctx.seed, device, dtype)
    low = check.Reference(conf["model"], ctx.seed, device, dtype, fp8=True)
    return check.run_check(kept["cell"], kept["samples"], kept["streams"],
                           kept["cycle"], ref, control=low, detail=detail,
                           expected=kept["expected"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.ROOT.parent / "BENCHMARK.json")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    lower, upper = {}, {}
    for seed in seeds + sorted(ctrl - set(seeds)):
        t0 = time.perf_counter()
        res, rows, record, ctx = harness.run_cell(
            args.workload, seed, args.seconds, False, "cuda", bench)
        line = {"workload": args.workload, "seed": seed, "side": "program",
                "numbers": dict(record["check"],
                                frames_untracked=record["failed"]),
                "live_tracks": record["live_tracks"],
                "frames_per_s": res["metrics"].get("frames_per_s"),
                "setup_s": record["setup_s"], "check_s": record["check_s"],
                "detail": record["check_detail"]}
        lines = [line] if seed in seeds else []
        if seed in ctrl:
            detail = []
            lines.append({"workload": args.workload, "seed": seed,
                          "side": "control_fp8",
                          "numbers": control_numbers(ctx, "cuda", detail),
                          "detail": detail})
        for ln in lines:
            ln["seconds"] = time.perf_counter() - t0
            print(json.dumps(ln), flush=True)
            if out:
                out.write(json.dumps(ln) + "\n")
                out.flush()
            agg = lower if ln["side"] == "program" else upper
            for k, v in ln["numbers"].items():
                agg[k] = max(agg.get(k, v), v) if agg is lower \
                    else min(agg.get(k, v), v)
        del ctx
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}), flush=True)


if __name__ == "__main__":
    main()
