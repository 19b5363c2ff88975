"""Row-gather throughput probe: ``python -m kinet_tpu_torch.tools.gather_probe``.

The counterpart of ``scripts/pallas_gather_probe.py``: ``gather_rows``
(``out[i, j] = tbl[idx[i, j], j]``) on a [8192, 128] float32 table with
random int32 indices, timed over K = 32 back-to-back launches, reported as
microseconds per launch and GB/s with R * C * 4 * 2 bytes counted per
launch (the index read and the output write, as the TPU probe counts).

Runs on the card; ``--device cpu`` runs the plain version on the CPU, whose
time says nothing about the card.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..models.build import resolve_device
from ..ops.gather_probe import gather_rows

R, C, K = 8192, 128, 32


def probe_inputs(device, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    tbl = torch.randn(R, C, generator=gen)
    idx = torch.randint(0, R, (R, C), generator=gen, dtype=torch.int32)
    return tbl.to(device), idx.to(device)


def run_probe(device=None, seed: int = 0) -> dict:
    """Times K launches of ``gather_rows`` after one warm-up launch."""
    device = resolve_device(device)
    tbl, idx = probe_inputs(device, seed)
    out_sum = float(gather_rows(tbl, idx).sum())  # warm-up (and build)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(K):
            gather_rows(tbl, idx)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3 / K
    else:
        t0 = time.perf_counter()
        for _ in range(K):
            gather_rows(tbl, idx)
        seconds = (time.perf_counter() - t0) / K
    bytes_moved = R * C * 4 * 2
    return {
        "device": str(device), "out_sum": out_sum, "us_per_op": seconds * 1e6,
        "gb_per_s": bytes_moved / seconds / 1e9,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain version)")
    args = p.parse_args(argv)
    res = run_probe(args.device)
    print(f"out sum: {res['out_sum']:.4f}")
    print(f"gather_rows {R}x{C} on {res['device']}: {res['us_per_op']:.1f} "
          f"us/op -> {res['gb_per_s']:.1f} GB/s")
    return res


if __name__ == "__main__":
    main()
