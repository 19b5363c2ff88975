"""Row-gather throughput probe: ``python -m kinet_tpu_torch.tools.gather_probe``.

The counterpart of ``scripts/pallas_gather_probe.py``: ``gather_rows``
(``out[i, j] = tbl[idx[i, j], j]``) on a [8192, 128] float32 table with
random int32 indices, timed over K = 32 back-to-back launches, reported as
microseconds per launch and GB/s with R * C * 4 * 2 bytes counted per
launch (the index read and the output write, as the TPU probe counts).

On the card the time is device time, as the TPU probe's one ``jit`` of a
``lax.scan`` over K calls is: the K launches are queued behind a spin
kernel that holds the stream until the host has enqueued them all, and
CUDA events around them measure the card's work alone (the host's
per-launch cost, the wrapper's checks and the ctypes call, is larger than
the kernel's).

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
# torch.cuda._sleep counts SM clock cycles; at the H100's highest clock
# (1.98 GHz) a spin lasts at least the time asked for, at lower clocks longer
SPIN_CYCLES_PER_S = 1.98e9


def probe_inputs(device, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    tbl = torch.randn(R, C, generator=gen)
    idx = torch.randint(0, R, (R, C), generator=gen, dtype=torch.int32)
    return tbl.to(device), idx.to(device)


def device_seconds(fn, n: int) -> tuple[float, int]:
    """Device seconds per call of fn over n back-to-back calls, and the
    number of timed windows of n calls it took. The calls are queued behind
    a spin kernel sized for 1 ms of host time a call (about 16 times what a
    ``gather_rows`` call takes), so that the interval between the CUDA
    events holds the calls' device work and none of the host's. If the
    first event has fired by the time the last call is enqueued, the spin
    was too short: the window is timed again with a spin twice as long."""
    host_s = 1e-3
    for window in range(1, 7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((2.0 * n * host_s + 2e-3) * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        covered = not start.query()
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / 1e3 / n, window
        host_s *= 2.0
    raise RuntimeError("gather probe: the host never got ahead of the card")


def run_probe(device=None, seed: int = 0) -> dict:
    """Times K launches of ``gather_rows`` after one warm-up launch (on the
    card, by device time)."""
    device = resolve_device(device)
    tbl, idx = probe_inputs(device, seed)
    out_sum = float(gather_rows(tbl, idx).sum())  # warm-up (and build)
    windows = 1
    if device.type == "cuda":
        with torch.cuda.device(device):
            seconds, windows = device_seconds(lambda: gather_rows(tbl, idx), K)
    else:
        t0 = time.perf_counter()
        for _ in range(K):
            gather_rows(tbl, idx)
        seconds = (time.perf_counter() - t0) / K
    bytes_moved = R * C * 4 * 2
    return {
        "device": str(device), "out_sum": out_sum, "us_per_op": seconds * 1e6,
        "gb_per_s": bytes_moved / seconds / 1e9, "timed_windows": windows,
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
