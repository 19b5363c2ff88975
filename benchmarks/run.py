"""Runs one cell of the benchmark of ``kinet_tpu_torch`` once.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for (it exits with another code than 0, printing no result, without
them). The last line of standard output is the result (JSON); the lines
before it on standard error hold the card's clocks and power beside the
window, the parts of the set-up and each compared number beside its limit.
Build and kernel caches stay inside the checkout, under ``build/``.
"""
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])  # the checkout's root

from benchmarks import harness  # noqa: E402

if __name__ == "__main__":
    t_start = time.perf_counter() - harness.process_age()
    harness.setup_env()
    sys.exit(harness.main(sys.argv[1:], t_start))
