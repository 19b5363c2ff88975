#!/usr/bin/env python3
"""GPU smoke run of kinet_tpu_torch, the PyTorch/CUDA port, on one card.

    python3 chip_smoke.py

Needs one CUDA device (Hopper: the kernels build for sm_90a) and the CUDA
toolkit's nvcc; imports nothing of JAX or of the JAX package. Phases, each
failing the run on any mismatch:

1. device: the card's name and power limit;
2. build: nvcc builds the five kernels from kinet_tpu_torch/ops/csrc;
3. forward kernels vs their plain PyTorch versions on the card, at the
   flagship's 800x1440 shapes (encoder MSDA high- and low-level Lite
   updates, decoder raw-pool with a bottom/right pad; a random reference
   point per query), f32 (TF32 off) and bf16, with times and what the
   corners read (corners, distinct rows, L2 bytes of the corner reads in
   32-byte sectors, that over the device time);
3b. backward kernels vs the plain versions' autograd gradients at the
   training shapes (672x1184), f32 and bf16, with times and each pass's
   device time;
P2. the row-gather probe kernel exactly against its plain version and
   torch.gather, with its device time warm and with a cold L2
   (``cold_ms``), and torch.gather's, in the same call; then the probe's
   entry point (kinet_tpu_torch.tools.gather_probe), whose device time a
   launch must agree with P2's within 25 %;
4. the full-width flagship model (hidden 288, 8 heads, 6+6 layers, 500
   queries, 100 track slots, seeded random weights) on the card against the
   same model on the CPU, f32, over two chained frames at 256x448;
5. the serving main path: the flagship model in bf16 at 800x1440 driven
   frame by frame through Tracker.step over a synthetic moving-boxes
   sequence, with per-frame times and the kernels' launch counts; then a
   replay: the arguments of one served frame's 12 forward MSDA calls,
   recorded by wrapping the two entry points where the model binds them,
   each call's kernel against its plain version (bf16 and f32) and its
   device time and reads on the main path's own samples (``replay_ms``);
6. one full-width f32 train step (dropout 0) on the card against the CPU
   at 256x448, on the same augmented targets: loss, gradient norm and the
   MSDA linears' gradients;
7. the training main path: make_train_step in bf16 with remat at 672x1184
   (3 warm-up, 10 timed steps), launch counts per step, peak memory and a
   profile (the MSDA kernels' device time per step beside that of the
   earlier f32-atomic backward kernels, each backward kernel's device
   time a call and each forward kernel's a launch); then
   train(cfg), the entry point, on a synthetic MOT dataset,
   writing a checkpoint and resuming from it.

A kernel's time is its device time: CUDA events around 20 back-to-back
calls of its wrapper on the same inputs (so the tables stay in L2 from one
call to the next), queued behind a spin kernel until the host has
enqueued them all, per call (``device_ms``). A wrapper enqueues only its
kernel's own launches, so the interval holds those and the gaps between
them. Phase 3b adds the profiler's device time of each pass of a backward
kernel, and phase 7 each backward kernel's device time a call on the
training path (every MSDA ``__global__`` has ``msda`` in its name); both
are readings, and a profiler that sees nothing fails neither. The
wrapper's time between two CUDA events around one call, which also holds
the argument checks, the allocations and the ctypes call while the card
waits, is reported beside it as ``wrapper_ms``. The plain versions and
``torch.gather`` are timed by ``device_ms`` too.

Then one JSON line listing every kernel with its launches, error and times;
nvidia-smi's name/power line; the result line. ``--phases 3b,P2`` runs a
subset (phases 1 and 2 always run) and prints no result line.

Exits non-zero, printing no result, without a CUDA device or without the
kinet_tpu_torch package beside this file.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# torch.cuda._sleep counts SM clock cycles; at the H100's highest clock
# (1.98 GHz) a spin lasts at least the time asked for, at lower clocks longer
SPIN_CYCLES_PER_S = 1.98e9
FLAGSHIP = ["train_deformable", "train_tracking", "train_multi_frame"]
# flagship level shapes at 800x1440: strides 8, 16, 32, 64
LEVELS = ((100, 180), (50, 90), (25, 45), (13, 23))
N_FRAMES, WARMUP = 14, 2
MAIN_HW = (800, 1440)
# training: bench_train.py's 672x1184, levels at strides 8, 16, 32, 64
TRAIN_LEVELS = ((84, 148), (42, 74), (21, 37), (11, 19))
TRAIN_HW, TRAIN_OBJECTS = (672, 1184), 20
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# launches a train step: msda_fwd 6 for the previous frame, 6 for the
# current one, 6 again under remat; the decoder's 6 + 6; one backward each
TRAIN_LAUNCHES = {"msda_fwd": 18, "msda_bwd": 6, "msda_raw_pool_fwd": 12,
                  "msda_raw_pool_bwd": 6}
# the four MSDA kernels' device ms per step on an H100 (700 W) when the
# backward kernels scattered the table gradient with f32 atomics
ATOMIC_BWD_MSDA_MS_PER_STEP = 3.253
DEVICE = "cuda"  # the card (a rehearsal on the CPU sets "cpu")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def ptxas_entries(text):
    """(mangled entry name, registers, spills) of every kernel instance in
    nvcc's ``-Xptxas -v`` messages."""
    entries, name, spills = [], "?", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            entries.append((name, regs, spills))
    return entries


def median_ms(torch, fn, iters=20, warmup=3):
    """The wrapper's time: CUDA events around one call, median of iters
    calls. Host work inside the call (checks, allocations, the ctypes
    call) counts while the card waits for it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def device_ms(torch, fn, iters=20, warmup=3):
    """Device ms per call of fn: CUDA events around iters back-to-back
    calls, queued behind a spin kernel that holds the stream until the host
    has enqueued them all, so the interval holds the calls' device work
    (and the gaps between their launches) and none of the host's. If the
    first event has fired by the time the last call is enqueued (a call
    waited for the card, or the launch queue filled), the spin did not
    cover the host: the run is repeated with a longer spin and fewer
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0  # host and device: an upper bound
    for _ in range(6):
        spin_s = 2.0 * iters * call_s + 2e-3
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        a.record()
        for _ in range(iters):
            fn()
        z.record()
        covered = not a.query()
        z.synchronize()
        if covered:
            return a.elapsed_time(z) / iters
        log(f"  (the spin did not cover {iters} calls: again, longer, with "
            f"{max(1, iters // 2)})")
        call_s *= 2.0
        iters = max(1, iters // 2)
    raise SmokeFailure("device_ms: the host never got ahead of the card")


def pass_ms(torch, fn, match, iters=20):
    """{short name: device ms per call} of the device operations whose
    name contains ``match`` over iters profiled calls of fn (the passes of
    one kernel's C entry point). Each operation counts at its mean duration
    times its launches per call, so a launch that the profiler drops at the
    window's edge does not shorten it. Empty if the profiler saw none:
    the breakdown is a reading, the kernel's time is ``device_ms``'s."""
    by_name = device_profile(torch, fn, iters)
    parts = {}
    for k, (t, n) in by_name.items():
        if match in k:
            short = k.split("(")[0].replace("void ", "").replace("kinet::", "")
            parts[short] = parts.get(short, 0.0) + \
                t * iters / n * max(1, round(n / iters))
    return parts


def errors(torch, out, ref):
    out, ref = out.float(), ref.float()
    d = (out - ref).abs()
    return d.max().item(), (d / ref.abs().clamp(min=1e-3)).max().item()


def assert_close(torch, name, out, ref, rtol, atol):
    d = (out.float() - ref.float()).abs()
    bad = d > atol + rtol * ref.float().abs()
    check(not bad.any().item(),
          f"{name}: {int(bad.sum())} elements beyond rtol {rtol} atol {atol} "
          f"(max abs err {d.max().item():.3e})")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain


def make_samples(torch, gen, b, lq, m, shapes, p):
    """Sampling locations around each query's reference point (offsets of
    a few cells, some past the border) and softmax attention weights."""
    l = len(shapes)
    dev = gen.device
    ref = torch.rand(b, lq, 1, 1, 1, 2, generator=gen, device=dev)
    off = torch.randn(b, lq, m, l, p, 2, generator=gen, device=dev)
    scale = torch.tensor([[1.0 / w, 1.0 / h] for h, w in shapes], device=dev)
    loc = (ref * 1.1 - 0.05) + off * 3.0 * scale[None, None, None, :, None, :]
    # on a 2^-16 grid, every pixel coordinate (loc * W - 0.5, and
    # grid_sample's ((2 loc - 1) + 1) * W / 2 - 0.5) is exact in f32, so the
    # kernel and the plain version differ only in the order of their sums;
    # off the grid, f32 rounding of coordinates near 180 px alone moves a
    # sample by ~1e-5 px, ~3e-5 in the output at these value scales
    loc = torch.round(loc * 65536.0) / 65536.0
    aw = torch.randn(b, lq, m, l * p, generator=gen, device=dev).softmax(-1)
    return loc.contiguous(), aw.view(b, lq, m, l, p).contiguous()


def corner_rows(torch, loc, shapes, ext):
    """Row of the table (level start + cell) of every bilinear corner of
    every sample, [B, Lq, M, L, P, 2 (dy), 2 (dx)] int64, and -1 where the
    kernels read nothing: the corner rule of csrc/msda_common.cuh::corner_at
    (outside the level, or at or past the valid extent)."""
    from kinet_tpu_torch.ops.msda import level_start_index

    b, lq, m, l, p, _ = loc.shape
    rows = torch.full((b, lq, m, l, p, 2, 2), -1, dtype=torch.long,
                      device=loc.device)
    for lid, ((h, w), start) in enumerate(zip(shapes, level_start_index(shapes))):
        x = loc[:, :, :, lid, :, 0] * w - 0.5
        y = loc[:, :, :, lid, :, 1] * h - 0.5
        x0, y0 = x.floor(), y.floor()
        xmax, ymax = torch.full_like(x, w - 1.0), torch.full_like(y, h - 1.0)
        if ext is not None:
            xmax = torch.minimum(xmax, ext[:, lid, 1].view(b, 1, 1, 1) - 1.0)
            ymax = torch.minimum(ymax, ext[:, lid, 0].view(b, 1, 1, 1) - 1.0)
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                inside = (xi >= 0) & (xi <= xmax) & (yi >= 0) & (yi <= ymax)
                cell = start + yi.clamp(0, h - 1).long() * w + \
                    xi.clamp(0, w - 1).long()
                rows[:, :, :, lid, :, dy, dx] = torch.where(inside, cell, -1)
    return rows


def read_stats(torch, kind, loc, shapes, ext, width, esize, run=16):
    """What one call's corners read. ``corners``: in-bounds corners;
    ``distinct``: distinct rows (head slices for msda), the bound's count;
    ``l2_bytes``: the 32-byte sectors of every corner read, what a kernel
    that reads each corner from L2 fetches. msda: ``run_distinct``, the distinct slices
    summed over blocks of ``run`` consecutive queries (a block's reads of a
    slice it read before can come from L1). Raw pool: ``query_distinct``,
    distinct rows per query summed over queries (what a kernel that fetched
    each row once per query would read)."""
    rows = corner_rows(torch, loc, shapes, ext)
    b, lq, m = loc.shape[:3]
    s = sum(h * w for h, w in shapes)
    dev = loc.device
    bidx = torch.arange(b, device=dev).view(b, 1, 1, 1, 1, 1, 1)
    bq = bidx * lq + torch.arange(lq, device=dev).view(1, lq, 1, 1, 1, 1, 1)
    valid = rows >= 0
    row = bidx * s + rows
    key = row * m + torch.arange(m, device=dev).view(1, 1, m, 1, 1, 1, 1) \
        if kind == "msda" else row
    nbytes = width * esize
    off = key * nbytes
    sectors = (off + nbytes - 1) // 32 - off // 32 + 1
    st = dict(corners=int(valid.sum()),
              distinct=torch.unique(key[valid]).numel(),
              l2_bytes=int(sectors[valid].sum()) * 32)
    if kind == "msda":
        run_key = (bq // run) * (b * s * m) + key
        st["run_distinct"] = torch.unique(run_key[valid]).numel()
    else:
        st["query_distinct"] = torch.unique((bq * (b * s) + row)[valid]).numel()
    return st


def stats_text(st, ms):
    """Log text of read_stats beside the kernel's device ms."""
    c = st["corners"]
    text = (f"corners {c}, distinct rows {st['distinct']} "
            f"({st['distinct'] / max(c, 1):.3f})")
    if "run_distinct" in st:
        text += (f", a run's repeated slice reads "
                 f"{1 - st['run_distinct'] / max(c, 1):.3f}")
    else:
        text += (f", distinct per query {st['query_distinct']} "
                 f"({st['query_distinct'] / max(c, 1):.3f})")
    return (text + f"; corner sectors {st['l2_bytes'] / 1e6:.1f} MB, "
            f"{st['l2_bytes'] / ms / 1e9:.2f} TB/s")


def bound_ms(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_case(torch, msda, gen, name, kind, shapes, lq, p, dtype, extents):
    """One kernel at one shape and dtype: error against the plain version
    and medians of both, plus the bound of this run's inputs."""
    b, m = 1, 8
    s = sum(h * w for h, w in shapes)
    loc, aw = make_samples(torch, gen, b, lq, m, shapes, p)
    l = len(shapes)
    n_samples = b * lq * m * l * p
    sample_bytes = n_samples * 3 * 4  # loc (x, y) + aw, f32
    esize = torch.finfo(dtype).bits // 8
    if kind == "msda":
        d = 36
        value = torch.randn(b, s, m, d, generator=gen, device=gen.device).to(dtype)
        out = msda.ms_deform_attn(value, shapes, loc, aw)
        torch.cuda.synchronize()
        ref = msda.ms_deform_attn_plain(value, shapes, loc, aw)
        tol = dict(rtol=1e-4, atol=1e-5)  # both read the same values in f32
        assert_close(torch, f"{name} {dtype}", out, ref, **tol)
        err = errors(torch, out, ref)
        run_k = lambda: msda.ms_deform_attn(value, shapes, loc, aw)  # noqa: E731
        run_p = lambda: msda.ms_deform_attn_plain(value, shapes, loc, aw)  # noqa: E731
        st = read_stats(torch, "msda", loc, shapes, None, d, esize)
        moved = st["distinct"] * d * esize + sample_bytes + b * lq * m * d * 4
        flops = st["corners"] * d * 2 + n_samples * 20
    else:
        c = 288
        src = torch.randn(b, s, c, generator=gen, device=gen.device).to(dtype)
        out, wsum = msda.ms_deform_attn_raw_pool(src, shapes, loc, aw, extents)
        torch.cuda.synchronize()
        ref, ref_w = msda.ms_deform_attn_raw_pool_plain(src, shapes, loc, aw, extents)
        # bf16: both round the f32 sum to bf16 once; they may land one bf16
        # ulp (at most 2^-7 relative) apart
        tol = dict(rtol=1e-2, atol=1e-5) if dtype == torch.bfloat16 else \
            dict(rtol=1e-4, atol=1e-5)
        assert_close(torch, f"{name} {dtype}", out, ref, **tol)
        assert_close(torch, f"{name} wsum {dtype}", wsum, ref_w, 1e-4, 1e-5)
        err = max(errors(torch, out, ref), errors(torch, wsum, ref_w))
        run_k = lambda: msda.ms_deform_attn_raw_pool(src, shapes, loc, aw, extents)  # noqa: E731
        run_p = lambda: msda.ms_deform_attn_raw_pool_plain(src, shapes, loc, aw, extents)  # noqa: E731
        st = read_stats(torch, "raw", loc, shapes, extents, c, esize)
        moved = st["distinct"] * c * esize + sample_bytes + l * b * 8 + \
            b * lq * m * (c * esize + 4)
        flops = st["corners"] * c * 2 + n_samples * 20
    t_b, by = bound_ms(moved, flops)
    timed = time_kernel(torch, run_k, run_p)
    log(f"  {name:<24} {str(dtype):<15} max abs err {err[0]:.3e} max rel err "
        f"{err[1]:.3e} | {timed_text(timed)} bound {t_b:.4f} ms ({by}: "
        f"{moved / 1e6:.1f} MB, {flops / 1e6:.1f} Mflop)")
    log(f"      {stats_text(st, timed['ms'])}")
    return dict(err=err[0], bound_ms=t_b, bound_by=by, **timed)


def time_kernel(torch, run_k, run_p, passes=None):
    """Device ms of the kernel's wrapper (which enqueues only the kernel's
    own launches) and of the plain version, the wrapper's host-inclusive
    ms and, with ``passes`` (a name fragment), the profiler's device ms of
    each pass."""
    return dict(ms=device_ms(torch, run_k), plain_ms=device_ms(torch, run_p, 5),
                wrapper_ms=median_ms(torch, run_k),
                parts=pass_ms(torch, run_k, passes) if passes else {})


def timed_text(t):
    return (f"kernel {t['ms']:.4f} ms device (wrapper {t['wrapper_ms']:.4f} "
            f"ms)  plain {t['plain_ms']:.4f} ms device ")


def phase_kernels(torch, msda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec_shapes = LEVELS[:2] * 2  # 2 finest levels x 2 frames
    # bottom/right pad: the valid region of every level is smaller
    ext = torch.tensor(
        [[[h - 7, w - 11] for h, w in dec_shapes]], dtype=torch.float32,
        device="cuda",
    )
    cases = [
        # (name, kernel, kind, shapes, Lq, P, launches per frame)
        ("msda_fwd high-lite", "msda_fwd", "msda", LEVELS[:2],
         sum(h * w for h, w in LEVELS[1:]), 2, 5),
        ("msda_fwd low-lite", "msda_fwd", "msda", LEVELS[:1],
         LEVELS[0][0] * LEVELS[0][1], 2, 1),
        ("msda_raw_pool_fwd", "msda_raw_pool_fwd", "raw", dec_shapes,
         600, 2, 6),
    ]
    results = {}
    for name, kernel, kind, shapes, lq, p, per_frame in cases:
        for dtype in (torch.float32, torch.bfloat16):
            r = kernel_case(torch, msda, gen, name, kind, shapes, lq, p,
                            dtype, ext if kind == "raw" else None)
            results.setdefault(kernel, []).append((dtype, per_frame, r))
    return results


def kernel_summary(torch, results):
    """Per kernel: the worst error over every comparison, and the bf16 (the
    main path's type) times averaged per launch over one frame's mix of
    shapes."""
    summary = {}
    for kernel, rows in results.items():
        bf = [(n, r) for dt, n, r in rows if dt == torch.bfloat16]
        total = sum(n for n, _ in bf)
        summary[kernel] = {
            "max_abs_err": max(r["err"] for _, _, r in rows),
            "bound_by": bf[0][1]["bound_by"],
        }
        for key in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                    "pr2_bound_ms"):
            if key in bf[0][1]:
                summary[kernel][key] = sum(n * r[key] for n, r in bf) / total
    return summary


# ---------------------------------------------------------------------------
# phase 3b: backward kernels vs the plain versions' gradients


def grad_errors(torch, name, pairs):
    """pairs: (label, kernel grad, plain grad, rtol, atol); checks each and
    returns the largest max abs error."""
    worst = 0.0
    for label, g, r, rtol, atol in pairs:
        assert_close(torch, f"{name} {label}", g, r, rtol, atol)
        worst = max(worst, (g.float() - r.float()).abs().max().item())
    return worst


def backward_case(torch, msda, gen, name, kind, shapes, lq, p, dtype, extents):
    """One backward kernel at one shape and dtype: its gradients against
    autograd through the plain version, device times of both backward
    passes, and the bound of this run's inputs (and, to compare with PR 2,
    the bound by PR 2's count, which left out the untouched rows of the
    table gradient and counted an f32 write of the touched ones)."""
    b, m = 1, 8
    s = sum(h * w for h, w in shapes)
    dev = gen.device
    loc, aw = make_samples(torch, gen, b, lq, m, shapes, p)
    l = len(shapes)
    n_samples = b * lq * m * l * p
    sample_bytes = n_samples * 3 * 4  # loc (x, y) + aw, f32
    esize = torch.finfo(dtype).bits // 8
    # bf16: both round the f32 dvalue / dsrc sums to bf16 once and may land
    # one bf16 ulp (2^-7 relative) apart; the kernel's segment sums change
    # only the order of the f32 adds
    tol_v = (1e-2, 1e-5) if dtype == torch.bfloat16 else (1e-4, 1e-5)

    # daw sums corner dot products over a head's channels (over all C for
    # the raw pool), and dloc is W_l (H_l) * aw times their signed sum: f32
    # rounding of those dot products in another order gives absolute errors
    # that scale with the largest values, and relative errors without bound
    # where the signed sum cancels. atol is 1e-5 of the largest |reference|
    def scaled(ref, floor):
        return max(floor, 1e-5 * ref.abs().max().item())
    if kind == "msda":
        d = 36
        value = torch.randn(b, s, m, d, generator=gen, device=dev).to(dtype)
        cot = torch.randn(b, lq, m * d, generator=gen, device=dev)
        got = msda._msda_bwd(value, shapes, loc, aw, cot)
        ins = [t.detach().clone().requires_grad_(True) for t in (value, loc, aw)]
        out = msda.ms_deform_attn_plain(ins[0], shapes, ins[1], ins[2])
        ref = torch.autograd.grad(out, ins, cot, retain_graph=True)
        torch.cuda.synchronize()
        err = grad_errors(torch, f"{name} {dtype}", [
            ("dvalue", got[0], ref[0], *tol_v),
            ("dloc", got[1], ref[1], 1e-3, scaled(ref[1], 1e-4)),
            ("daw", got[2], ref[2], 1e-4, scaled(ref[2], 1e-5)),
        ])
        run_k = lambda: msda._msda_bwd(value, shapes, loc, aw, cot)  # noqa: E731
        run_p = lambda: torch.autograd.grad(  # noqa: E731
            out, ins, cot, retain_graph=True)
        st = read_stats(torch, "msda", loc, shapes, None, d, esize)
        rows, corners = st["distinct"], st["corners"]
        # the touched value rows read, all of dvalue written (both in
        # value's type), grad_out read, the samples' loc/aw read and
        # dloc/daw written
        common = b * lq * m * d * 4 + 2 * sample_bytes
        moved = rows * d * esize + b * s * m * d * esize + common
        # PR 2's count, kept to compare with it: the touched rows of an f32
        # dvalue written, the rest of the table not
        moved_pr2 = rows * d * (esize + 4) + common
        flops = corners * d * 4 + n_samples * 30
    else:
        c = 288
        src = torch.randn(b, s, c, generator=gen, device=dev).to(dtype)
        cot_p = torch.randn(b, lq, m, c, generator=gen, device=dev).to(dtype)
        cot_w = torch.randn(b, lq, m, generator=gen, device=dev)
        got = msda._raw_pool_bwd(src, shapes, loc, aw, extents, cot_p, cot_w)
        ins = [t.detach().clone().requires_grad_(True) for t in (src, loc, aw)]
        outs = msda.ms_deform_attn_raw_pool_plain(ins[0], shapes, ins[1],
                                                  ins[2], extents)
        ref = torch.autograd.grad(outs, ins, (cot_p, cot_w), retain_graph=True)
        torch.cuda.synchronize()
        err = grad_errors(torch, f"{name} {dtype}", [
            ("dsrc", got[0], ref[0], *tol_v),
            ("dloc", got[1], ref[1], 1e-3, scaled(ref[1], 1e-4)),
            ("daw", got[2], ref[2], 1e-4, scaled(ref[2], 1e-5)),
        ])
        run_k = lambda: msda._raw_pool_bwd(  # noqa: E731
            src, shapes, loc, aw, extents, cot_p, cot_w)
        run_p = lambda: torch.autograd.grad(  # noqa: E731
            outs, ins, (cot_p, cot_w), retain_graph=True)
        st = read_stats(torch, "raw", loc, shapes, extents, c, esize)
        rows, corners = st["distinct"], st["corners"]
        # the touched src rows read, all of dsrc written (both in src's
        # type), grad_pooled and grad_wsum read, the samples and extents
        common = b * lq * m * (c * esize + 4) + 2 * sample_bytes + l * b * 8
        moved = rows * c * esize + b * s * c * esize + common
        moved_pr2 = rows * c * (esize + 4) + common
        flops = corners * c * 4 + n_samples * 30
    t_b, by = bound_ms(moved, flops)
    t_pr2, _ = bound_ms(moved_pr2, flops)
    timed = time_kernel(torch, run_k, run_p, passes="msda")
    log(f"  {name:<26} {str(dtype):<15} max abs err {err:.3e} | "
        f"{timed_text(timed)} bound {t_b:.4f} ms ({by}: {moved / 1e6:.1f} "
        f"MB, {flops / 1e6:.1f} Mflop; PR 2's count {t_pr2:.4f} ms)")
    if not timed["parts"]:
        log("      (the profiler saw no pass of this kernel)")
    for k, t in sorted(timed["parts"].items(), key=lambda kv: -kv[1]):
        log(f"      {t:.4f} ms  {k[:90]}")
    return dict(err=err, bound_ms=t_b, bound_by=by, pr2_bound_ms=t_pr2,
                **timed)


def phase_backward_kernels(torch, msda):
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    dec_shapes = TRAIN_LEVELS[:2] * 2  # 2 finest levels x 2 frames
    ext = torch.tensor(
        [[[h - 5, w - 9] for h, w in dec_shapes]], dtype=torch.float32,
        device=DEVICE,
    )
    cases = [
        # (name, kernel, kind, shapes, Lq, P, launches per train step)
        ("msda_bwd high-lite", "msda_bwd", "msda", TRAIN_LEVELS[:2],
         sum(h * w for h, w in TRAIN_LEVELS[1:]), 2, 5),
        ("msda_bwd low-lite", "msda_bwd", "msda", TRAIN_LEVELS[:1],
         TRAIN_LEVELS[0][0] * TRAIN_LEVELS[0][1], 2, 1),
        ("msda_raw_pool_bwd", "msda_raw_pool_bwd", "raw", dec_shapes, 600, 2, 6),
    ]
    results = {}
    for name, kernel, kind, shapes, lq, p, per_step in cases:
        for dtype in (torch.float32, torch.bfloat16):
            r = backward_case(torch, msda, gen, name, kind, shapes, lq, p,
                              dtype, ext if kind == "raw" else None)
            results.setdefault(kernel, []).append((dtype, per_step, r))
    return results


# ---------------------------------------------------------------------------
# phase P2: the row-gather probe


def cold_ms(torch, fn, iters=10):
    """Device ms of one call of fn with a cold L2: before each call a buffer
    of twice the L2 is written, and CUDA events around the call alone time
    it (median of iters), all queued behind a spin kernel as in
    ``device_ms``."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0) \
        or 50 * 2 ** 20
    flush = torch.empty(2 * l2 // 4, dtype=torch.float32, device="cuda")
    flush.fill_(0.0)
    fn()
    torch.cuda.synchronize()
    host_s = 1e-3
    for _ in range(6):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(int((2.0 * iters * host_s + 2e-3) * SPIN_CYCLES_PER_S))
        for i, (a, z) in enumerate(pairs):
            flush.fill_(float(i))
            a.record()
            fn()
            z.record()
        covered = not pairs[0][0].query()
        torch.cuda.synchronize()
        if covered:
            return statistics.median(a.elapsed_time(z) for a, z in pairs)
        host_s *= 2.0
    raise SmokeFailure("cold_ms: the host never got ahead of the card")


def phase_gather_probe(torch):
    from kinet_tpu_torch.ops import gather_probe
    from kinet_tpu_torch.tools import gather_probe as probe

    tbl, idx = probe.probe_inputs(DEVICE)
    r, c = tbl.shape
    idx64 = idx.long()
    out = gather_probe.gather_rows(tbl, idx)
    ref = gather_probe.gather_rows_plain(tbl, idx)
    lib = torch.gather(tbl, 0, idx64)
    torch.cuda.synchronize()
    # a gather copies values: exact
    err = max((out - ref).abs().max().item(), (out - lib).abs().max().item())
    check(torch.equal(out, ref) and torch.equal(out, lib),
          f"gather_rows differs from its plain version or torch.gather by {err}")
    run = lambda: gather_probe.gather_rows(tbl, idx)  # noqa: E731
    run_lib = lambda: torch.gather(tbl, 0, idx64)  # noqa: E731
    timed = time_kernel(torch, run, lambda: gather_probe.gather_rows_plain(tbl, idx))
    t_k = timed["ms"]
    t_lib = device_ms(torch, run_lib)
    cold_k, cold_lib = cold_ms(torch, run), cold_ms(torch, run_lib)
    moved = r * c * 4 * 3  # index read, output written, table read once
    t_b, by = bound_ms(moved, 0)
    sectors = r * c * (32 + 8)  # a 32-byte sector per table element
    log(f"  gather_rows [{r}, {c}] f32  max abs err {err:.3e} | "
        f"{timed_text(timed)}; cold L2 {cold_k:.5f} ms | torch.gather "
        f"{t_lib:.5f} ms device, cold L2 {cold_lib:.5f} | bound {t_b:.5f} ms "
        f"({by}: {moved / 1e6:.1f} MB): {100 * t_b / t_k:.1f} % of it, "
        f"{t_lib / t_k:.3f}x torch.gather; {sectors / 1e6:.1f} MB of L2 "
        f"sectors, {sectors / 1e9 / t_k:.2f} TB/s")
    gather_probe.gather_rows.launches = 0
    res = probe.main(["--device", DEVICE])  # the probe's entry point
    launches = gather_probe.gather_rows.launches
    want = 1 + probe.K * res["timed_windows"]
    check(launches == want, f"the probe launched gather_rows {launches} "
          f"times, expected {want}")
    probe_ms = res["us_per_op"] / 1e3
    log(f"  probe entry point: {res['us_per_op']:.3f} us/op device, "
        f"{res['gb_per_s']:.1f} GB/s, {launches} launches; P2's device_ms "
        f"{t_k * 1e3:.3f} us ({probe_ms / t_k:.3f}x)")
    check(abs(probe_ms / t_k - 1.0) <= 0.25,
          f"the probe's {res['us_per_op']:.3f} us/op is not device time "
          f"(device_ms {t_k * 1e3:.3f} us)")
    return dict(max_abs_err=err, ms=t_k, cold_ms=cold_k,
                wrapper_ms=timed["wrapper_ms"], plain_ms=timed["plain_ms"],
                bound_ms=t_b, bound_by=by, library_ms=t_lib,
                library_cold_ms=cold_lib, launches=launches)


# ---------------------------------------------------------------------------
# phases 4 and 5: the model


def flagship_cfg():
    from kinet_tpu_torch.config import load_config

    return load_config("train.yaml", named=FLAGSHIP).replace(
        dataset="mot", dropout=0.0
    )


def model_inputs(torch, rng, h, w, t_slots, hidden, n_active, device):
    import numpy as np

    from kinet_tpu_torch.structs import ImageBatch, Targets

    images = rng.normal(size=(1, h, w, 3)).astype(np.float32)
    pad = np.zeros((1, h, w), bool)
    pad[:, h - 32:] = True
    pad[:, :, w - 32:] = True
    targets = Targets.create(
        torch.zeros(1, 1, 4), torch.zeros(1, 1), torch.zeros(1, 1),
        num_track_queries=t_slots, hidden_dim=hidden, device=device,
    ).replace(
        track_query_embeds=torch.from_numpy(
            rng.normal(size=(1, t_slots, hidden)).astype(np.float32)).to(device),
        track_query_boxes=torch.from_numpy(
            rng.uniform(0.2, 0.6, size=(1, t_slots, 4)).astype(np.float32)).to(device),
        track_query_mask=(torch.arange(t_slots, device=device) < n_active)[None],
    )
    batch = ImageBatch(torch.from_numpy(images).to(device),
                       torch.from_numpy(pad).to(device))
    return batch, targets


def phase_model_vs_cpu(torch):
    import numpy as np

    from kinet_tpu_torch.models.build import build_model

    cfg = flagship_cfg()
    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    outs = {}
    for dev in ("cpu", "cuda"):
        model, _ = build_model(cfg, device=dev, seed=0)
        rng = np.random.default_rng(5)
        frames = [model_inputs(torch, rng, 256, 448, t_slots, hidden, 20, dev)
                  for _ in range(2)]
        with torch.inference_mode():
            o1 = model(*frames[0])
            o2 = model(*frames[1], prev_memory=o1["frame_memory"],
                       pos_cache=o1["pos_cache"])
        outs[dev] = [{k: o[k].float().cpu() for k in
                      ("pred_logits", "pred_boxes", "hs_embed")} for o in (o1, o2)]
        del model, o1, o2
    torch.cuda.empty_cache()
    # f32 on both, TF32 off: convolution algorithms and sums run in another
    # order on the card, and the differences grow through the 50-layer
    # backbone and 12 transformer layers
    tol = {"pred_logits": (1e-3, 2e-3), "pred_boxes": (1e-3, 5e-4),
           "hs_embed": (1e-3, 2e-3)}
    for f in range(2):
        for k, (rtol, atol) in tol.items():
            a, r = outs["cuda"][f][k], outs["cpu"][f][k]
            check(bool(torch.isfinite(a).all()), f"frame {f} {k} not finite")
            err = (a - r).abs().max().item()
            log(f"  frame {f} {k:<12} {tuple(a.shape)} max abs err {err:.3e} "
                f"(rtol {rtol}, atol {atol})")
            assert_close(torch, f"model frame {f} {k}", a, r, rtol, atol)


def moving_boxes(np, h, w, n_frames, seed=0):
    """Synthetic sequence: eight bright boxes moving over a fixed noisy
    background, normalized like an image batch."""
    rng = np.random.default_rng(seed)
    background = rng.normal(0, 0.5, size=(h, w, 3)).astype(np.float32)
    sizes = rng.integers([h // 10, w // 36], [h // 4, w // 12], size=(8, 2))
    starts = rng.uniform([0, 0], [h - h // 4, w - w // 12], size=(8, 2))
    vel = rng.uniform(-0.015, 0.015, size=(8, 2)) * [h, w]
    for f in range(n_frames):
        img = background.copy()
        for (y, x), (vy, vx), (bh, bw) in zip(starts, vel, sizes):
            y0 = int(np.clip(y + vy * f, 0, h - bh))
            x0 = int(np.clip(x + vx * f, 0, w - bw))
            img[y0:y0 + bh, x0:x0 + bw] += 2.0
        yield {
            "images": img[None], "pad_mask": np.zeros((1, h, w), bool),
            "orig_size": (h, w), "dets": np.zeros((0, 4), np.float32),
        }


def phase_main_path(torch, msda):
    import numpy as np

    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.structs import ImageBatch
    from kinet_tpu_torch.tracking.tracker import Tracker, make_forward_fn

    cfg = flagship_cfg()
    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    model, post = build_model(cfg, seed=1)
    # the tracker keeps class 0 (person); random heads rarely rank it first,
    # so the other classes' biases are pushed down
    with torch.no_grad():
        for i in range(model.dec_layers):
            model.class_head(i).bias[1:] -= 20.0
    model.to(torch.bfloat16)
    h, w = MAIN_HW
    frames = list(moving_boxes(np, h, w, N_FRAMES + 3))

    # random weights give low, random scores: set the thresholds from one
    # calibration frame so about 7 detections a frame start tracks, which
    # live 3 frames: about 20 active track slots, as in the JAX bench
    blob, dev = frames[0], next(model.parameters()).device
    batch = ImageBatch(torch.from_numpy(blob["images"]).to(dev),
                       torch.from_numpy(blob["pad_mask"]).to(dev))
    size = torch.tensor([[float(h), float(w)]], device=dev)
    res = make_forward_fn(model, post["bbox"])(batch, None, size, None, None, None)
    scores = res["scores"][0, t_slots:].float()
    cand = scores[res["labels"][0, t_slots:] == 0].sort(descending=True).values
    check(cand.numel() > 0, "no query scores class 0")
    thresh = cand[min(7, cand.numel() - 1)].item()
    tracker_cfg = dict(
        detection_obj_score_thresh=thresh, track_obj_score_thresh=thresh,
        reid_score_thresh=thresh, detection_nms_thresh=0.9,
        track_nms_thresh=0.9, steps_termination=3, inactive_patience=0,
        reid_sim_threshold=0.0, prev_frame_dist=1,
    )
    tracker = Tracker(model, post["bbox"], tracker_cfg, 500, t_slots, hidden,
                      overflow_boxes=bool(cfg.overflow_boxes))
    del res, batch
    log(f"  tracker thresholds {thresh:.5f} (calibrated), steps_termination 3")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    msda.ms_deform_attn.launches = 0
    msda.ms_deform_attn_raw_pool.launches = 0
    times, active = [], []
    for blob in frames[:N_FRAMES]:
        active.append(min(len(tracker.tracks) + len(tracker.inactive_tracks),
                          t_slots))
        t0 = time.perf_counter()
        tracker.step(blob)  # ends in the device-to-host copy of its rows
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {
        "msda_fwd": msda.ms_deform_attn.launches,
        "msda_raw_pool_fwd": msda.ms_deform_attn_raw_pool.launches,
    }
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times[WARMUP:])
    log(f"  per-frame ms: {' '.join(f'{t:.2f}' for t in times)}")
    log(f"  active track slots per frame: {active}")
    log(f"  median {med:.3f} ms/frame after {WARMUP} warm-up frames -> "
        f"{1000.0 / med:.3f} frames/s; peak device memory {peak:.2f} GiB")
    log(f"  launches over {N_FRAMES} frames: {launches}")
    for k, n in launches.items():
        check(n == 6 * N_FRAMES,
              f"{k} launched {n} times, expected 6 per frame x {N_FRAMES}")
    check(max(active[WARMUP:]) > 0, "no track was ever active")

    # results: finite boxes in the tracker's output
    n_boxes = 0
    for per_frame in tracker.get_results().values():
        for r in per_frame.values():
            check(bool(np.isfinite(r["bbox"]).all()), "non-finite result box")
            check(0.0 <= r["score"] <= 1.0, "score outside [0, 1]")
            n_boxes += 1
    check(n_boxes > 0, "the tracker produced no result")
    log(f"  {len(tracker.get_results())} tracks, {n_boxes} result boxes")

    # the forward kernels on one served frame's own samples
    calls = record_forward_calls(torch, lambda: tracker.step(frames[N_FRAMES]))
    kinds = [k for k, _ in calls]
    check(kinds.count("msda_fwd") == 6 and kinds.count("msda_raw_pool_fwd") == 6,
          f"a frame made {len(calls)} forward MSDA calls, expected 6 + 6")
    log("  replay of one frame's 12 forward MSDA calls (bf16; compared on "
        "locations snapped to a 2^-16 grid):")
    replay = phase_replay(torch, msda, calls)
    del calls

    # where the time goes: one profiled window of 3 frames, after the run
    # whose launches were counted; device time = the kernels and copies
    # CUPTI saw on the card (one stream, so their durations do not overlap)
    profiled = itertools.cycle(frames[N_FRAMES:N_FRAMES + 3])
    by_name = device_profile(torch, lambda: tracker.step(next(profiled)), 3)
    busy = sum(t for t, _ in by_name.values())
    if busy <= 0:
        log("  profiler: no device time recorded")
    else:
        msda_ms = sum(t for k, (t, _) in by_name.items() if "msda" in k)
        log(f"  profiler: device busy {busy:.3f} ms/frame = {100 * busy / med:.1f}% "
            f"of the median frame (idle {100 * (1 - busy / med):.1f}%); MSDA "
            f"kernels {msda_ms:.3f} ms/frame = {100 * msda_ms / busy:.1f}% of "
            f"device time; {sum(n for _, n in by_name.values()) // 3} device "
            f"ops/frame")
        for k, (t, n) in sorted(forward_launch_ms(by_name, 3).items()):
            log(f"  {k}: {t:.5f} device ms a launch on this path ({n:.0f} "
                f"a frame)")
        for k, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
            log(f"    {t:8.3f} ms/frame {n // 3:5d}/frame  {k[:100]}")
    del tracker, model
    torch.cuda.empty_cache()
    return launches, med, replay


# ---------------------------------------------------------------------------
# phase 5's replay: the forward kernels on the main path's own samples


def record_forward_calls(torch, fn):
    """Runs fn() with the model's two MSDA entry points wrapped where
    models/deformable_transformer.py binds them, and unwrapped after;
    returns (kernel, arguments) of every call, the tensors cloned."""
    from kinet_tpu_torch.models import deformable_transformer as dt

    calls = []
    orig = (dt.ms_deform_attn, dt.ms_deform_attn_raw_pool)

    def recording(kernel, f):
        def wrapped(*args):
            calls.append((kernel, tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)))
            return f(*args)
        return wrapped

    dt.ms_deform_attn = recording("msda_fwd", orig[0])
    dt.ms_deform_attn_raw_pool = recording("msda_raw_pool_fwd", orig[1])
    try:
        fn()
    finally:
        dt.ms_deform_attn, dt.ms_deform_attn_raw_pool = orig
    return calls


def snapped(torch, loc):
    """The locations on a 2^-16 grid, for the comparisons: there every
    pixel coordinate is exact in f32 (make_samples), so a kernel and its
    plain version differ only in the order of their sums. Off the grid,
    f32 rounding of the main path's coordinates (grid_sample's formula vs
    loc * W - 0.5) alone moves a sample by ~1e-5 px."""
    return torch.round(loc * 65536.0) / 65536.0


def replay_call(torch, msda, kernel, args):
    """One recorded call: the kernel against its plain version on the
    snapped samples, bf16 as recorded and f32; the kernel's device ms on
    the recorded inputs, and what its corners read."""
    table, shapes, loc, aw = args[:4]
    lq, l = loc.shape[1], loc.shape[3]
    esize = torch.finfo(table.dtype).bits // 8
    loc_s = snapped(torch, loc)
    err = 0.0
    if kernel == "msda_fwd":
        for v in (table, table.float()):
            out = msda.ms_deform_attn(v, shapes, loc_s, aw)
            ref = msda.ms_deform_attn_plain(v, shapes, loc_s, aw)
            assert_close(torch, f"replay {kernel} {v.dtype}", out, ref,
                         1e-4, 1e-5)
            err = max(err, errors(torch, out, ref)[0])
        run_k = lambda: msda.ms_deform_attn(table, shapes, loc, aw)  # noqa: E731
        st = read_stats(torch, "msda", loc, shapes, None, table.shape[3], esize)
    else:
        ext = args[4]
        for v in (table, table.float()):
            pooled, wsum = msda.ms_deform_attn_raw_pool(v, shapes, loc_s, aw, ext)
            ref, ref_w = msda.ms_deform_attn_raw_pool_plain(v, shapes, loc_s,
                                                            aw, ext)
            rtol = 1e-2 if v.dtype == torch.bfloat16 else 1e-4
            assert_close(torch, f"replay {kernel} {v.dtype}", pooled, ref,
                         rtol, 1e-5)
            assert_close(torch, f"replay {kernel} wsum {v.dtype}", wsum,
                         ref_w, 1e-4, 1e-5)
            err = max(err, errors(torch, pooled, ref)[0],
                      errors(torch, wsum, ref_w)[0])
        run_k = lambda: msda.ms_deform_attn_raw_pool(  # noqa: E731
            table, shapes, loc, aw, ext)
        st = read_stats(torch, "raw", loc, shapes, ext, table.shape[2], esize)
    ms = device_ms(torch, run_k)
    log(f"  {kernel:<18} Lq {lq:5d} L {l}: {ms:.5f} ms device, max abs err "
        f"{err:.3e}; {stats_text(st, ms)}")
    return ms


def phase_replay(torch, msda, calls):
    """{kernel: mean device ms a launch} over one served frame's recorded
    forward calls."""
    per_kernel = {}
    with torch.inference_mode():
        for kernel, args in calls:
            per_kernel.setdefault(kernel, []).append(
                replay_call(torch, msda, kernel, args))
    for k, t in per_kernel.items():
        log(f"  {k}: {statistics.mean(t):.5f} ms a launch over the frame's "
            f"{len(t)} calls, {sum(t):.5f} ms a frame")
    return {k: statistics.mean(t) for k, t in per_kernel.items()}


def forward_launch_ms(by_name, calls):
    """{forward kernel: (device ms a launch, launches a call of fn)} from a
    profile of ``calls`` calls (device_profile's by_name)."""
    found = {}
    for k, (t, n) in by_name.items():
        kernel = ("msda_raw_pool_fwd" if "raw_pool_fwd" in k else
                  "msda_fwd" if "msda_fwd" in k else None)
        if kernel:
            t0, n0 = found.get(kernel, (0.0, 0))
            found[kernel] = (t0 + t * calls, n0 + n)
    return {k: (t / n, n / calls) for k, (t, n) in found.items()}


# ---------------------------------------------------------------------------
# phases 6 and 7: training


def train_frames(torch, seed, h, w, n_obj, t_slots, hidden, device):
    """(batch, targets, prev_batch, prev_targets): two frames of random
    images with the same n_obj tracks at random boxes, as bench_train.py."""
    from kinet_tpu_torch.structs import ImageBatch, Targets

    gen = torch.Generator().manual_seed(seed)
    frames = []
    for _ in range(2):
        images = torch.randn(1, h, w, 3, generator=gen)
        boxes = 0.2 + 0.4 * torch.rand(1, n_obj, 4, generator=gen)
        targets = Targets.create(
            boxes, torch.zeros(1, n_obj), torch.ones(1, n_obj),
            track_ids=torch.arange(n_obj)[None], num_track_queries=t_slots,
            hidden_dim=hidden,
        )
        frames += [ImageBatch(images, torch.zeros(1, h, w, dtype=torch.bool)),
                   targets]
    return [x.to(device) for x in frames]


def phase_train_vs_cpu(torch):
    """One f32 train step (dropout 0) on the CPU and on the card from the
    same seeded weights, with the augmented targets the CPU made fed to
    both."""
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import make_train_step
    from kinet_tpu_torch.models.build import build_criterion, build_model
    from kinet_tpu_torch.tracking import train_augment

    cfg = flagship_cfg().replace(compute_dtype="float32")
    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    made = []
    augment = train_augment.add_track_queries_to_targets
    res = {}
    for dev in ("cpu", DEVICE):
        model, _ = build_model(cfg, device=dev, seed=3)
        model.train()
        opt = Optimizer(model, cfg, 1000)
        step = make_train_step(model, build_criterion(cfg), opt, cfg)

        def recorded(*a, **kw):
            if dev == "cpu":
                made.append(augment(*a, **kw))
            return made[0].to(dev)

        train_augment.add_track_queries_to_targets = recorded
        try:
            losses = step(*train_frames(torch, 4, 256, 448, TRAIN_OBJECTS,
                                        t_slots, hidden, dev))
        finally:
            train_augment.add_track_queries_to_targets = augment
        # the optimizer has clipped the gradients in place; the clip scale
        # is the reported norm's, so compare the clipped gradients
        grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()
                 if any(k in n for k in ("sampling_offsets",
                                         "attention_weights", "value_proj"))}
        res[dev] = ({k: v.float().cpu() for k, v in losses.items()}, grads)
        del model, opt, step
    torch.cuda.empty_cache()
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res[DEVICE]
    n_active = int(made[0].track_query_mask.sum())
    log(f"  augmented targets: {n_active} track queries "
        f"({int(made[0].track_query_fp_mask.sum())} flagged false positive)")
    # f32 on both, TF32 off; sums run in other orders on the card, through a
    # 50-layer backbone, 12 transformer layers and the segment sums of the
    # MSDA backward kernels
    for key in ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm"):
        a, r = l_gpu[key], l_cpu[key]
        log(f"  {key:<10} card {a.item():.6f}  cpu {r.item():.6f}")
        assert_close(torch, f"train step {key}", a, r, 1e-3, 1e-5)
    worst = (0.0, "")
    for n in g_cpu:
        scale = g_cpu[n].abs().max().item()
        err = (g_gpu[n] - g_cpu[n]).abs().max().item()
        worst = max(worst, (err / max(scale, 1e-12), n))
        assert_close(torch, f"grad {n}", g_gpu[n], g_cpu[n], 1e-2,
                     1e-3 * scale + 1e-9)
    log(f"  {len(g_cpu)} MSDA linear gradients agree; worst max abs err / "
        f"max |grad| {worst[0]:.3e} ({worst[1]}; rtol 1e-2, atol 1e-3 x "
        f"max |grad|)")


def device_profile(torch, fn, n, timeline=None):
    """{device op name: (ms per call of fn, count)} over n calls: the CUDA
    kernels and copies CUPTI saw on the card (one stream, so their
    durations do not overlap). User annotations that the profiler mirrors
    onto the device timeline (``Optimizer.step#AdamW.step``) span other
    ops and are left out. A ``timeline`` list gets (start, name, ms) of
    each op, in order of start. A window in which the profiler saw no
    device op at all is profiled again, up to three times; then it is
    returned empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        if events:
            break
        log("  (the profiler saw no device op: profiling again)")
    by_name = {}
    for e in events:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / (1e3 * n), k + 1)
        if timeline is not None:
            timeline.append((e.time_range.start, e.name,
                             e.time_range.elapsed_us() / 1e3))
    if timeline is not None:
        timeline.sort()
    return by_name


def backward_calls(timeline):
    """{backward kernel: (device ms a call, calls)} from a profiled
    timeline: one call's passes run back to back on the stream, from
    msda_segment_clear to msda_segment_sum, and its dots pass names the
    kernel. A call cut by the profile's edges is left out."""
    calls, run = {}, None
    for _, name, ms in timeline:
        if "msda_segment_clear" in name:
            run = [ms, None]
        elif run is not None and "msda" in name:
            run[0] += ms
            if "_bwd_dots" in name:
                run[1] = ("msda_raw_pool_bwd" if "raw_pool" in name
                          else "msda_bwd")
            if "msda_segment_sum" in name:
                if run[1] is not None:
                    t, k = calls.get(run[1], (0.0, 0))
                    calls[run[1]] = (t + run[0], k + 1)
                run = None
    return {k: (t / n, n) for k, (t, n) in calls.items()}


def phase_train_main_path(torch, msda):
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import make_train_step
    from kinet_tpu_torch.models.build import build_criterion, build_model

    # the flagship as bench_train.py trains it: bf16, remat, dropout 0.1
    cfg = flagship_cfg().replace(compute_dtype="bfloat16", remat=True,
                                 dropout=0.1)
    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    model, _ = build_model(cfg, device=DEVICE, seed=5)
    model.train()
    step = make_train_step(model, build_criterion(cfg), Optimizer(model, cfg),
                           cfg)
    frames = train_frames(torch, 6, *TRAIN_HW, TRAIN_OBJECTS, t_slots, hidden,
                          DEVICE)
    for _ in range(TRAIN_WARMUP):
        loss = float(step(*frames)["loss"])
        check(loss == loss and abs(loss) < 1e6, f"warm-up loss {loss}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {
        "msda_fwd": (msda.ms_deform_attn, "launches"),
        "msda_bwd": (msda.ms_deform_attn, "bwd_launches"),
        "msda_raw_pool_fwd": (msda.ms_deform_attn_raw_pool, "launches"),
        "msda_raw_pool_bwd": (msda.ms_deform_attn_raw_pool, "bwd_launches"),
    }
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = step(*frames)
        losses.append(float(out["loss"]))  # the step ends in this copy
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times)
    check(all(x == x and abs(x) < 1e6 for x in losses), f"losses {losses}")
    log(f"  per-step ms: {' '.join(f'{t:.1f}' for t in times)}")
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  median {med:.3f} ms/step -> {1000.0 / med:.4f} steps/s; peak "
        f"device memory {peak:.2f} GiB")
    log(f"  launches per step: "
        f"{ {k: n / TRAIN_STEPS for k, n in launches.items()} }")
    for k, n in launches.items():
        check(n == TRAIN_LAUNCHES[k] * TRAIN_STEPS,
              f"{k} launched {n} times over {TRAIN_STEPS} steps, expected "
              f"{TRAIN_LAUNCHES[k]} a step")

    timeline = []
    by_name = device_profile(torch, lambda: float(step(*frames)["loss"]), 2,
                             timeline)
    busy = sum(t for t, _ in by_name.values())
    if busy <= 0:
        log("  profiler: no device time recorded")
    else:
        msda_ms = sum(t for k, (t, _) in by_name.items() if "msda" in k)
        log(f"  profiler: device busy {busy:.3f} ms/step = "
            f"{100 * busy / med:.1f}% of the median step (idle "
            f"{100 * (1 - busy / med):.1f}%); MSDA kernels {msda_ms:.3f} "
            f"ms/step = {100 * msda_ms / busy:.1f}% of device time; "
            f"{sum(n for _, n in by_name.values()) // 2} device ops/step")
        log(f"  MSDA device ms/step {msda_ms:.3f} (with the f32-atomic "
            f"backward kernels: {ATOMIC_BWD_MSDA_MS_PER_STEP})")
        for k, (t, n) in sorted(backward_calls(timeline).items()):
            log(f"  {k}: {t:.4f} device ms a call on this path, all its "
                f"passes ({n} calls profiled)")
        for k, (t, n) in sorted(forward_launch_ms(by_name, 2).items()):
            log(f"  {k}: {t:.5f} device ms a launch on this path ({n:.0f} "
                f"a step)")
        for k, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
            if "msda" in k:
                log(f"    {t:8.3f} ms/step {n // 2:5d}/step  {k[:100]}")
        log("  largest device items:")
        for k, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
            log(f"    {t:8.3f} ms/step {n // 2:5d}/step  {k[:100]}")
    del model, step, frames
    torch.cuda.empty_cache()
    return launches, med


def write_mot_dataset(root: Path, n_frames=6, h=360, w=640):
    """A synthetic MOT sequence in the MOT-to-COCO layout the trainer reads
    (root/train/*.jpg, root/annotations/train.json): four boxes moving over
    noise."""
    import numpy as np
    from PIL import Image

    (root / "train").mkdir(parents=True)
    (root / "annotations").mkdir()
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for f in range(n_frames):
        name = f"SEQ-01_{f + 1:06d}.jpg"
        arr = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        for tid in range(1, 5):
            x, y = 40 + 120 * tid + 6 * f, 60 + 20 * tid
            arr[y:y + 120, x:x + 50] = 255
            annotations.append({
                "id": len(annotations), "image_id": f, "category_id": 1,
                "bbox": [x, y, 50, 120], "area": 6000, "iscrowd": 0,
                "track_id": tid,
            })
        Image.fromarray(arr).save(root / "train" / name)
        images.append({"id": f, "file_name": name, "height": h, "width": w,
                       "frame_id": f, "first_frame_image_id": 0,
                       "seq_length": n_frames, "seq": "SEQ-01"})
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "person"}],
            "sequences": ["SEQ-01"]}
    (root / "annotations" / "train.json").write_text(json.dumps(coco))


def phase_train_entry(torch):
    from kinet_tpu_torch.engine.train import train

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_mot_dataset(root / "mot")
        out = root / "out"
        cfg = flagship_cfg().replace(
            mot_path_train=str(root / "mot"), mot_path_val=str(root / "mot"),
            val_interval=0, epochs=2, debug=True, batch_size=1,
            num_workers=2, log_interval=1, dropout=0.1, remat=True,
            compute_dtype="bfloat16", output_dir=str(out),
            **{"img_transform.max_size": 666},
        )
        t0 = time.perf_counter()
        _, _, steps = train(cfg, device=DEVICE)
        first_s = time.perf_counter() - t0
        ckpt = out / "checkpoint.pth"
        check(ckpt.exists() and (out / "config.yaml").exists(),
              "train(cfg) wrote no checkpoint or config")
        t0 = time.perf_counter()
        _, _, resumed = train(cfg.replace(resume=str(ckpt), resume_optim=True),
                              device=DEVICE)
        check(resumed == 2 * steps,
              f"the resumed run ended at step {resumed}, expected {2 * steps}")
        log(f"  train(cfg): {steps} steps in {first_s:.1f} s (model build "
            f"included), checkpoint {ckpt.stat().st_size / 2**20:.1f} MiB; "
            f"resumed at epoch 2, {resumed - steps} more steps in "
            f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------


KERNEL_META = {
    # name: (source, the TPU kernel or XLA formulation it replaces)
    "msda_fwd": ("kinet_tpu_torch/ops/csrc/msda_fwd.cu",
                 "kinet_tpu/ops/pallas_msda.py:91"),
    "msda_raw_pool_fwd": ("kinet_tpu_torch/ops/csrc/msda_raw_pool_fwd.cu",
                          "kinet_tpu/ops/msda.py:691"),
    "msda_bwd": ("kinet_tpu_torch/ops/csrc/msda_bwd.cu",
                 "kinet_tpu/ops/pallas_msda.py:220"),
    "msda_raw_pool_bwd": ("kinet_tpu_torch/ops/csrc/msda_raw_pool_bwd.cu",
                          "kinet_tpu/ops/msda.py:426"),
    "gather_rows": ("kinet_tpu_torch/ops/csrc/gather_rows.cu",
                    "scripts/pallas_gather_probe.py:14"),
}
PHASES = ("3", "3b", "P2", "4", "5", "6", "7")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="GPU smoke run of kinet_tpu_torch")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    root = Path(__file__).resolve().parent
    if not (root / "kinet_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: the kinet_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from kinet_tpu_torch.ops import cuda_build, msda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("== 1. device")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"  {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    log("== 2. build")
    t0 = time.perf_counter()
    messages = cuda_build.build_all(ptxas_info=True)
    log(f"  built {sorted(messages)} in {time.perf_counter() - t0:.1f} s")
    for kernel, text in messages.items():
        for entry, regs, spills in ptxas_entries(text):
            log(f"  {kernel}: {entry[:72]}: {regs}; {spills}")

    summary, launches = {}, {}
    if "3" in phases:
        log("== 3. forward kernels vs plain (800x1440 shapes, B=1)")
        summary.update(kernel_summary(torch, phase_kernels(torch, msda)))
    if "3b" in phases:
        log("== 3b. backward kernels vs plain gradients (672x1184 shapes, B=1)")
        bwd = kernel_summary(torch, phase_backward_kernels(torch, msda))
        for k, r in bwd.items():
            log(f"  {k} over a step's mix: {r['ms']:.5f} ms a launch, "
                f"{100 * r['bound_ms'] / r['ms']:.1f} % of its bound "
                f"{r['bound_ms']:.5f} ms (PR 2's count {r['pr2_bound_ms']:.5f})")
        summary.update(bwd)
    if "P2" in phases:
        log("== P2. row-gather probe [8192, 128]")
        summary["gather_rows"] = phase_gather_probe(torch)
        launches["gather_rows"] = summary["gather_rows"]["launches"]
    if "4" in phases:
        log("== 4. full-width model: card vs CPU, f32, 256x448, two frames")
        phase_model_vs_cpu(torch)
    if "5" in phases:
        log(f"== 5. serving main path: Tracker.step, bf16, 800x1440, "
            f"{N_FRAMES} frames")
        served, frame_ms, replay = phase_main_path(torch, msda)
        launches.update(served)
        for k, t in replay.items():
            summary.setdefault(k, {})["replay_ms"] = t
        log(f"  {1000.0 / frame_ms:.3f} frames/s")
    if "6" in phases:
        log("== 6. train step: card vs CPU, f32, dropout 0, 256x448")
        phase_train_vs_cpu(torch)
    if "7" in phases:
        log(f"== 7. training main path: make_train_step, bf16, remat, "
            f"672x1184, {TRAIN_WARMUP} + {TRAIN_STEPS} steps")
        trained, step_ms = phase_train_main_path(torch, msda)
        # the forward kernels' count is the serving path's; the backward
        # kernels' the training path's
        launches.update({k: v for k, v in trained.items() if "bwd" in k})
        log("== 7b. train(cfg): the entry point on a synthetic MOT dataset")
        phase_train_entry(torch)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    if phases != set(PHASES):
        log("  (a subset of the phases: no result line)")
        return 0

    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[k], "max_abs_err": summary[k]["max_abs_err"],
         "ms": summary[k]["ms"], "wrapper_ms": summary[k]["wrapper_ms"],
         "plain_ms": summary[k]["plain_ms"],
         "bound_ms": summary[k]["bound_ms"],
         "bound_by": summary[k]["bound_by"],
         "library_ms": summary[k].get("library_ms"),
         **{key: summary[k][key]
            for key in ("replay_ms", "cold_ms", "library_cold_ms")
            if key in summary[k]}}
        for k, (src, replaces) in KERNEL_META.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
