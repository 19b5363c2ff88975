#!/usr/bin/env python3
"""GPU smoke run of kinet_tpu_torch, the PyTorch/CUDA port, on one card.

    python3 chip_smoke.py

Needs one CUDA device (Hopper: the kernels build for sm_90a) and the CUDA
toolkit's nvcc; imports nothing of JAX or of the JAX package. Phases, each
failing the run on any mismatch:

1. device: the card's name and power limit;
2. build: nvcc builds the five kernel sources of kinet_tpu_torch/ops/csrc
   (nine kernel entry points: msda_fwd.cu also holds the int8, the
   head-shared and the top-k instances, msda_raw_pool_fwd.cu the int8 one,
   K1); K1's instances ((L, P) = (4, 2) at B = 1 and 4, (2, 2), a generic
   (3, 1); pooled in bf16 and f32) with their registers, spilled bytes,
   threads, shared bytes, resident blocks an SM, pairs a block and blocks,
   beside the direct kernel's int8 instances that K1 ran before
   (msda_raw_pool_fwd_i8_direct, kept as its yardstick);
3. forward kernels vs their plain PyTorch versions on the card, at the
   flagship's 800x1440 shapes (encoder MSDA high- and low-level Lite
   updates, decoder raw-pool with a bottom/right pad; a random reference
   point per query; the int8 raw pool over each frame's half quantized
   on its own, pooled in f32 and bf16), f32 (TF32 off) and bf16, with
   times and what the corners read (corners, distinct rows, L2 bytes of the corner reads in
   32-byte sectors, that over the device time); K1 also against the direct
   kernel on the same inputs, bit for bit, timed in turn (direct, K1, K1,
   direct: ``direct_ms``);
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
   then the same with the served config's int8 decoder table
   (dec_msda_int8): 6 + 6 launches a frame of msda_fwd and the int8 raw
   pool, whose replay also times the bf16 kernel on the same calls
   (``replay_bf16_ms``) and the direct kernel in turn with K1, bit for bit
   (``replay_direct_ms``);
6. one full-width f32 train step (dropout 0) on the card against the CPU
   at 256x448, on the same augmented targets: loss, gradient norm and the
   MSDA linears' gradients;
7. the training main path: make_train_step in bf16 with remat at 672x1184
   (3 warm-up, 10 timed steps), launch counts per step, peak memory and a
   profile (the MSDA kernels' device time per step beside that of the
   earlier f32-atomic backward kernels, each backward kernel's device
   time a call and each forward kernel's a launch); then 7b, train(cfg),
   the entry point, on the published MOT17 recipe as it stands
   (train_deformable train_tracking train_multi_frame
   train_mot17_crowdhuman) over a synthetic MOT tree and a synthetic
   CrowdHuman train_val tree: two epochs, each ending in evaluate() with
   the tracking eval, metrics.jsonl with finite AP / AP50 / MOTA / IDF1,
   checkpoint_best_*, the model back in train mode after each evaluation,
   and a resume that ends at the expected step;
T. the tracking CLI, ``python -m kinet_tpu_torch.engine.track``, as a
   subprocess on a synthetic MOT17-02-FRCNN (1080x1920 JPEGs, 16 frames)
   with a saved full-width bf16 run that has dec_msda_int8: exit 0, 6 + 6
   launches a frame, a result file, finite MOTA / IDF1 / HOTA, and the
   frames/s of its RUNTIME line;
E. evaluation at full width: evaluate() on the flagship in bf16 (class
   heads calibrated as in phase T) over a synthetic MOT val set of 33
   1080x1920 JPEG frames (800x1422 after the val transform; 33 is odd, so
   the batch of 2 leaves a partial last batch), then the tracking eval over
   the same sequence: every image in the evaluator, 12 finite stats, finite
   MOTA / IDF1, 6 + 6 forward launches a batch and a tracked frame; ms per
   val image, the eval's seconds and the device's busy share (profiler);
A. accuracy on the card: the simple synthetic-MOT gate of
   kinet_tpu_torch.tools.mota_gates (350 training steps of a tiny tracking
   model through the MSDA forward and backward kernels, then main_track),
   held to the JAX gate's thresholds (MOTA > 0.5, IDF1 > 0.5, ID switches
   <= 2);
D. vanilla DETR at full width (train.yaml + train_tracking: ResNet-50,
   hidden 256, 8 heads, 6 + 6 layers, 100 queries, 100 track slots): card
   vs CPU in f32 at 256x448 over two chained frames (frame 1's pre-norm
   hs_embed fed back as track queries), then 14 frames in bf16 at 800x1440
   through Tracker.step (ms/frame, device busy share; no NMS, as the
   random queries' boxes coincide), then one frame's
   decoder attention maps [B, Q, Hf, Wf] (finite, each summing to 1);
K. the KineT family at full width (train_kinet, train_kinet2 with
   train_tracking's 100 track slots; hidden 288, 150 queries, 60 detection
   slots, trails of 5, 1 + 1 layers, batch 8): card vs CPU in f32 for both
   models (forward, one train step), train(cfg) of each over a synthetic
   mot_kine tree (24 frames of 1080x1920, 40 objects, 44 public detections
   a frame) with its evaluation and tracking eval (ms a step), the
   tracking CLI with track_kinet.yaml as a subprocess on the dual-stream
   run (steady-state frames/s, the JPEG decode's share), and the
   encoder-only gate on the card at the JAX gate's thresholds.
   Phases D and K check that every MSDA count stays 0: neither path has
   an MSDA kernel.
M. MOTS, the mask head (models/segmentation.py) at full width:
   M1, the published MOTS recipe's model (train.yaml + train_tracking +
   train_mots20: vanilla DETR in SegmWrapper, freeze_detr) on the card vs
   the CPU in f32 at 256x448 over two chained frames (pred_masks, the
   tracker's mask probabilities), then one freeze_detr train step (the
   mask losses, the gradient norm over every parameter, only
   bbox_attention / mask_head updated); M2, that model in bf16 at 800x1440
   through Tracker.step (no NMS; 7 public detections a frame and tracks
   that end 3 frames after their detection hold 20-30 live tracks, see
   ``mots_served``): ms/frame, the
   device's busy share, MB copied to the host a frame, peak memory, every
   frame's resolved masks boolean, disjoint and of the padded input size;
   M3, train(cfg) on train_mots20 as it stands, one epoch, over a
   synthetic MOTS tree (six 1080x1920 frames whose COCO json carries RLE
   masks written by the port's utils/rle.py), with its evaluation and the
   tracking eval over a synthetic MOTS20-02 (ms a step, peak memory, the
   detector unchanged); M4, the tracking CLI as a subprocess on MOTS20-02
   with M3's run, class heads calibrated (every MOTS result line decodes
   to its stated size, finite MOTA / IDF1, steady-state frames/s); M5,
   the flagship with masks: card vs CPU in f32 at 128x224 (forward and a
   train step through the MSDA forward and backward kernels), then 4
   frames in bf16 at 800x1440 through Tracker.step, 6 + 6 forward MSDA
   launches a frame (``mots_launches`` in the kernels line: M5's forward
   launches and its train step's backward ones). Config (a) launches no
   MSDA kernel (checked).
V. the encoder's MSDA variants, two-stage and merge_frame_features:
   V1, the variant kernels (msda_fwd_i8, msda_topk_fwd with k = 3 at
   (L, P) = (2, 2) and k = 8 at (4, 4), msda_shared_fwd) against their
   plain versions at the flagship's encoder shapes and a generic (4, 4),
   f32 and bf16, with device times and bounds (top-k beside msda_fwd's
   time on the same inputs, unpruned, ``fwd_ms``), then the top-k and
   shared-locations gradients (their backward is msda_bwd) against the
   plain versions' autograd; V2, the served flagship with enc_msda_int8,
   enc_msda_topk 3 and enc_msda_shared_locs in turn, 8 frames of
   Tracker.step each at 800x1440 in bf16 with their launch counts a frame
   asserted, and for each a replay of the next frame's encoder calls of
   its kernel (6 int8, 5 top-k, 6 head-shared), as phase 5's (kernel vs
   plain on the snapped samples, device ms and reads on the frame's own
   samples, ``replay_ms``; the int8 calls also time msda_fwd over the same
   values in bf16, ``replay_bf16_ms``, the top-k calls msda_fwd on the
   same weights unpruned, ``replay_fwd_ms``), then one bf16 remat train
   step at 672x1184 with top-k and with shared locations (msda_bwd
   launches, finite gradients); V3,
   two-stage (train.yaml + train_deformable, two_stage, box refine: hidden
   256, 300 proposals): card vs CPU in f32 at 256x448 (the card given the
   CPU's proposal choice, whose scores can tie within the two devices'
   rounding), train(cfg) over a synthetic MOT tree with the encoder
   proposals' _enc losses, evaluate() on 3 frames of 1080x1920, and the
   host match over the ~24k encoder proposals timed; V4,
   merge_frame_features on the flagship (cache_prev_encoder off): card vs
   CPU, then 8 frames of Tracker.step (12 + 6 launches a frame).
B. batched serving (tracking/batched.py) on the served config
   (dec_msda_int8, bf16): 4 synthetic sequences of 8 moving-box frames
   (~20 live tracks each) through BatchedTracker at 800x1440 with B = 1,
   2, 4 in the stacked and the interleaved form, and at 544x960 and
   1088x1920 with B = 4 in both; the results of B = 1 and of the
   interleaved form held to each sequence's single Tracker's (the same
   track ids and frames, boxes within 1e-3 px); the stacked form's bf16
   results held to themselves with the sequences in reverse order, bit
   for bit, and in f32 to the single Trackers' (boxes within
   F32_STACKED_BOX_PX); a frame as a row of a batch of 4 against the frame
   alone, with the kernels and with the plain MSDA versions; the launches
   a step asserted (6 + 6 a forward), aggregate frames/s, ms a step and
   the device's busy share (profiler) of each; then a replay of one stacked
   B = 4 step's 12 MSDA calls as phase 5's (msda_fwd and the int8 raw
   pool, and the raw pool over the same calls' bf16 table: each kernel vs
   its plain version, device ms a launch beside 4 x phase 5's B = 1
   replay, and its bound; K1 in turn with the direct kernel,
   ``batched_replay_direct_ms``); then the tracking CLI with batch_sequences 4
   and batch_exec auto on four synthetic 1080x1920 JPEG sequences of 8
   frames (its RUNTIME line, steady-state aggregate frames/s, the share
   waiting for decoded frames);
S. processes on the one card: (a) main_track in 2 gloo processes (each
   takes half of B's four sequences) against 1: the same summary and
   result files; (b) 3 flagship train steps at 672x1184 through
   tools/launch.py in a world-1 NCCL group (torchrun's environment)
   against the same run without a group: the same losses and parameters,
   bit for bit; then 3 full-width f32 steps in 2 gloo processes sharing
   the card, one image each, against 1 process stepping each image on its
   own with the mean gradient, bit for bit, and against 1 process on both
   images (printed); step 0's gradient of both images against the mean of
   the two images' in f64 with the plain MSDA versions; (c) the launcher with
   --requeue-on-preempt sent SIGUSR1 after its first step: its
   checkpoint, the requeue (a re-exec) and the resume to the end;
P. the parallel package (``kinet_tpu_torch/parallel/``) in 2 gloo
   processes sharing the card: (a) 3 f32 flagship steps at 672x1184 with
   the model tensor parallel (mesh.model 2) against 1 process on the same
   two images (step 0's losses and gradient, the later losses and the
   parameters within the fixed P_* bounds) and step 0 of image 0 in f64
   with the plain MSDA versions: its gradient within 1e-6 (the witness
   that the f32 gap is rounding) and its parameters after the AdamW
   update within P_F64_UPDATE lr (the sharded optimizer state); phase
   7's bf16 step timed at TP=2 and in 1 process; the path's kernels
   counted and each (kernel, query count, levels) of the warm-up step's
   recorded calls held to its plain version, forward (the table as
   recorded, bf16, and in f32) and backward; (b) an f32 Tracker session
   at 800x1440 spatially parallel over the 2 processes against 1 process
   (the same tracks and frames, boxes within P_BOX_PX) and the served
   config's (dec_msda_int8) bf16 ms a frame at SP=2 and in 1 process, its
   launches, and one frame's msda_fwd calls (each process's own encoder
   queries; bf16 as recorded and f32) and int8 decoder calls (bf16 and
   f32 output) held to their plain versions. The
   correctness parts run at once; the timed parts one after another. No
   scaling is claimed: the processes share one card.
H. the host tools: (a) a seeded state dict under a reference
   checkpoint's names for the full-width flagship (tests/_ref_state_dict.py
   writes it from a seeded port model) imported under ``strict`` into
   another port model on the card whose tensors were set to NaN: every
   parameter and buffer filled, bit for bit the source, no reference key
   unmapped; one f32 frame at 256x448 on those weights against the CPU
   (phase 4's tolerances), then phase 5's served frames on them
   (Tracker.step, bf16, 800x1440; 6 msda_fwd and 6 msda_raw_pool_fwd
   launches a frame) and one frame's calls held to the plain versions as
   in phase P; (b) ``tools/track_param_search.py::search`` over a 2 x 2
   grid of detection_obj_score_thresh x track_obj_score_thresh on phase
   T's saved run and sequence (dec_msda_int8, bf16, 16 JPEG frames
   1080x1920), each combination's MOTA, IDF1 and seconds; then the
   tracking CLI with the best combination and ``write_images: pretty``:
   the same MOTA and IDF1 as the search's entry; (c) its 16 frame images
   under output_dir/<dataset dir>/<sequence>/, frame 0 byte-equal to the
   frame drawn again from the CLI's tracks, the largest box's top edge
   in its track's palette colour, and the host ms a frame of the writing
   beside the run's ms a frame.

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

Then one JSON line listing every kernel with its launches, error and times
(for K1 ``instances``, phase 2's facts, and ``direct_ms``,
``replay_direct_ms``, ``batched_replay_direct_ms``: the direct kernel in
turn with it; ``eval_launches``: phase E's detection-eval launches;
``mots_launches``: phase M5's; ``batched_launches``: a stacked batched
step's at B = 1, 2, 4, ``batched_replay_ms`` / ``batched_bound_ms``: phase
B's B = 4 replay; ``tp_launches`` / ``sp_launches``: phase P's a step of a
tensor-parallel process / a frame of a spatially parallel one,
``parallel_max_abs_err``: its kernels against their plain versions on those
paths' calls, and ``parallel_max_abs_err_by_dtype`` the same by the table's
dtype; ``import_launches`` / ``import_max_abs_err``: phase H's served frames
on the imported weights, ``tools_launches``: phase H's search and CLI run);
nvidia-smi's name/power line; the result line. ``--phases 3b,P2`` runs a
subset (phases 1 and 2 always run; ``V1`` and ``V2`` run those parts of
phase V, V2 without its train steps) and prints no result line.

Exits non-zero, printing no result, without a CUDA device or without the
kinet_tpu_torch package beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
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
# the tracking CLI's sequence: MOT17-02's size and name
T_SEQ, T_FRAMES, T_HW = "MOT17-02-FRCNN", 16, (1080, 1920)
# its val transform: 800 rows, at most 1440 columns (1080x1920 -> 800x1422)
T_TRANSFORM = {"img_transform.max_size": 1440, "img_transform.val_width": 800}
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


PHASE_STARTS = []  # (phase label, perf_counter) at each "== " heading


def log(msg: str):
    if msg.startswith("== "):
        PHASE_STARTS.append((msg[3:].split(".")[0], time.perf_counter()))
    print(msg, flush=True)


def phase_seconds() -> str:
    """Each phase's seconds, from one heading to the next."""
    marks = PHASE_STARTS + [("end", time.perf_counter())]
    return ", ".join(f"{a} {t1 - t0:.1f}"
                     for (a, t0), (_, t1) in zip(marks, marks[1:]))


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


def read_stats(torch, kind, loc, shapes, ext, width, esize, run=16,
               keep=None):
    """What one call's corners read. ``corners``: in-bounds corners;
    ``distinct``: distinct rows (head slices for msda), the bound's count;
    ``l2_bytes``: the 32-byte sectors of every corner read, what a kernel
    that reads each corner from L2 fetches. msda: ``run_distinct``, the distinct slices
    summed over blocks of ``run`` consecutive queries (a block's reads of a
    slice it read before can come from L1). Raw pool: ``query_distinct``,
    distinct rows per query summed over queries (what a kernel that fetched
    each row once per query would read). ``keep`` [B, Lq, M, L, P] bool:
    count only those samples' corners (top-k)."""
    rows = corner_rows(torch, loc, shapes, ext)
    if keep is not None:
        rows = torch.where(keep[..., None, None], rows, -1)
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
    and medians of both, plus the bound of this run's inputs; for K1 also
    the direct kernel's time in turn with it (``direct_ms``)."""
    b, m = 1, 8
    extra = {}
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
    elif kind == "raw_i8":
        # the decoder's int8 table: each frame's half (the first and last
        # L / 2 levels) quantized on its own; dtype is pooled's
        c = 288
        src = torch.randn(b, s, c, generator=gen, device=gen.device)
        split = sum(h * w for h, w in shapes[:l // 2])
        (q_cur, s_cur), (q_prev, s_prev) = (msda.quantize_rows(src[:, :split]),
                                            msda.quantize_rows(src[:, split:]))
        q8 = torch.cat([q_cur, q_prev], dim=1)
        scales = torch.cat([s_cur[:, None].expand(b, l // 2),
                            s_prev[:, None].expand(b, l - l // 2)], 1).contiguous()
        args = (q8, shapes, loc, aw, extents, scales, dtype)
        out, wsum = msda.ms_deform_attn_raw_pool(*args)
        torch.cuda.synchronize()
        ref, ref_w = msda.ms_deform_attn_raw_pool_plain(*args)
        tol = dict(rtol=1e-2, atol=1e-5) if dtype == torch.bfloat16 else \
            dict(rtol=1e-4, atol=1e-5)
        assert_close(torch, f"{name} {dtype}", out, ref, **tol)
        assert_close(torch, f"{name} wsum {dtype}", wsum, ref_w, 1e-4, 1e-5)
        err = max(errors(torch, out, ref), errors(torch, wsum, ref_w))
        run_k = lambda: msda.ms_deform_attn_raw_pool(*args)  # noqa: E731
        run_p = lambda: msda.ms_deform_attn_raw_pool_plain(*args)  # noqa: E731
        diff, k_ms, d_ms = k1_against_direct(torch, msda, args)
        extra = dict(direct_ms=d_ms, in_turn_ms=k_ms)
        log(f"      in turn with the direct kernel it replaced: K1 "
            f"{k_ms:.5f} ms, direct {d_ms:.5f} ms ({k_ms / d_ms:.3f}x); "
            f"largest difference {diff:.3e}")
        st = read_stats(torch, "raw", loc, shapes, extents, c, 1)
        # int8 rows, the samples, extents and scales read; pooled (in
        # dtype) and wsum written
        moved = st["distinct"] * c + sample_bytes + l * b * (8 + 4) + \
            b * lq * m * (c * esize + 4)
        flops = st["corners"] * c * 2 + n_samples * 20
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
    return dict(err=err[0], bound_ms=t_b, bound_by=by, **timed, **extra)


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


# K1 (msda_raw_pool_fwd_i8) beside the kernel it replaced: the direct
# kernel's int8 instances, msda_raw_pool_fwd_kernel<int8_t, ..> (C entry
# msda_raw_pool_fwd_i8_direct), on the same arguments.
K1_INSTANCES = ((4, 2), (2, 2), (3, 1))  # the fixed instances, a generic one
K1_FACTS = ("registers", "local_bytes", "threads", "shared_bytes",
            "blocks_per_sm", "pairs_per_block", "blocks")


def k1_facts(msda):
    """{"K1|direct (L, P) B=b dtype": {registers, local (spilled) bytes,
    threads, shared bytes and resident blocks an SM of the kernel, pairs a
    block (0: the direct kernel's blocks are threads, not pairs), blocks}}
    of what a launch at the decoder's Lq 600, M 8, C 288 with aligned
    pointers runs, at B = 1 and for (4, 2) also B = 4, from the runtime
    (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes

    fn = msda._kernel_fn("msda_raw_pool_fwd_i8_facts",
                         [ctypes.c_int] * 8 + [ctypes.c_void_p],
                         "msda_raw_pool_fwd")
    facts = {}
    for dt_name, code in (("bf16", 1), ("f32", 0)):
        for l, p in K1_INSTANCES:
            for b in (1, 4) if (l, p) == (4, 2) else (1,):
                for which, direct in (("K1", 0), ("direct", 1)):
                    out = (ctypes.c_int * len(K1_FACTS))()
                    rc = fn(code, direct, b, 600, 8, 288, l, p,
                            ctypes.addressof(out))
                    check(rc == 0,
                          f"msda_raw_pool_fwd_i8_facts: CUDA error {rc}")
                    facts[f"{which} ({l}, {p}) B={b} {dt_name}"] = dict(
                        zip(K1_FACTS, list(out)))
    return facts


def k1_direct(torch, msda, q8, shapes, loc, aw, ext, scales, out_dtype):
    """(pooled, wsum) of the direct kernel's int8 instance on K1's
    arguments (ms_deform_attn_raw_pool's, in its order; contiguous, on the
    card); not counted in i8_launches."""
    b, s, c = q8.shape
    _, lq, m, l, p, _ = loc.shape
    pooled = torch.empty(b, lq, m, c, dtype=out_dtype, device=q8.device)
    wsum = torch.empty(b, lq, m, dtype=torch.float32, device=q8.device)
    shapes_t, starts_t = msda._level_tables(shapes, q8.device)
    msda._launch(
        "msda_raw_pool_fwd_i8_direct",
        [msda._P, msda._P, msda._I] + [msda._P] * 7 + [msda._I] * 7
        + [msda._P], q8.device, q8.data_ptr(), scales.data_ptr(),
        msda._DTYPE_CODE[out_dtype], shapes_t.data_ptr(), starts_t.data_ptr(),
        loc.data_ptr(), aw.data_ptr(), None if ext is None else ext.data_ptr(),
        pooled.data_ptr(), wsum.data_ptr(), b, s, c, lq, m, l, p,
        lib="msda_raw_pool_fwd")
    return pooled, wsum


def k1_against_direct(torch, msda, args):
    """K1 and the direct kernel on one call's arguments (q8, shapes, loc,
    aw, ext, scales, out_dtype): their largest difference (0 when they
    agree bit for bit) and the device ms of each, timed in turn (direct,
    K1, K1, direct) and averaged."""
    def run_k():
        return msda.ms_deform_attn_raw_pool(*args)

    def run_d():
        return k1_direct(torch, msda, *args)

    got, ref = run_k(), run_d()
    diff = max((g.float() - r.float()).abs().max().item()
               for g, r in zip(got, ref))
    # the same products summed in the same order: the same bits
    check(diff == 0.0, f"msda_raw_pool_fwd_i8 differs from the direct "
          f"kernel by {diff:.3e} ({args[-1]})")
    t = {"direct": [], "K1": []}
    for name in ("direct", "K1", "K1", "direct"):
        t[name].append(device_ms(torch, run_k if name == "K1" else run_d))
    return diff, statistics.mean(t["K1"]), statistics.mean(t["direct"])


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
        ("msda_raw_pool_fwd_i8", "msda_raw_pool_fwd_i8", "raw_i8", dec_shapes,
         600, 2, 6),
    ]
    results = {}
    for name, kernel, kind, shapes, lq, p, per_frame in cases:
        for dtype in (torch.float32, torch.bfloat16):
            r = kernel_case(torch, msda, gen, name, kind, shapes, lq, p,
                            dtype, None if kind == "msda" else ext)
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
                    "pr2_bound_ms", "fwd_ms", "direct_ms"):
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
    for f in range(2):
        for k, (rtol, atol) in MODEL_TOL.items():
            a, r = outs["cuda"][f][k], outs["cpu"][f][k]
            check(bool(torch.isfinite(a).all()), f"frame {f} {k} not finite")
            err = (a - r).abs().max().item()
            log(f"  frame {f} {k:<12} {tuple(a.shape)} max abs err {err:.3e} "
                f"(rtol {rtol}, atol {atol})")
            assert_close(torch, f"model frame {f} {k}", a, r, rtol, atol)


def box_tracks(np, h, w, n_frames, seed=0):
    """Eight boxes moving at constant speed, clipped to the frame: per frame
    a list of (y0, x0, box height, box width)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers([h // 10, w // 36], [h // 4, w // 12], size=(8, 2))
    starts = rng.uniform([0, 0], [h - h // 4, w - w // 12], size=(8, 2))
    vel = rng.uniform(-0.015, 0.015, size=(8, 2)) * [h, w]
    return [[(int(np.clip(y + vy * f, 0, h - bh)),
              int(np.clip(x + vx * f, 0, w - bw)), int(bh), int(bw))
             for (y, x), (vy, vx), (bh, bw) in zip(starts, vel, sizes)]
            for f in range(n_frames)]


def moving_boxes(np, h, w, n_frames, seed=0):
    """Synthetic sequence: eight bright boxes moving over a fixed noisy
    background, normalized like an image batch."""
    background = np.random.default_rng(seed).normal(
        0, 0.5, size=(h, w, 3)).astype(np.float32)
    for boxes in box_tracks(np, h, w, n_frames, seed):
        img = background.copy()
        for y0, x0, bh, bw in boxes:
            img[y0:y0 + bh, x0:x0 + bw] += 2.0
        yield {
            "images": img[None], "pad_mask": np.zeros((1, h, w), bool),
            "orig_size": (h, w), "dets": np.zeros((0, 4), np.float32),
        }


def served_parts(torch, cfg, blob, seed=1, nms_thresh=0.9):
    """The served model (random weights from ``seed``, class heads biased
    to class 0, bf16), its postprocess and a tracker config whose
    thresholds are calibrated on ``blob`` so that about 7 detections a
    frame start tracks, which live 3 frames: about 20 active track slots,
    as in the JAX bench (``nms_thresh``: the detection and track NMS
    thresholds, 0 for none). Returns (model, postprocess, tracker_cfg)."""
    from kinet_tpu_torch.models.build import build_model

    model, post = build_model(cfg, seed=seed)
    bias_to_person(torch, model, cfg)
    model.to(torch.bfloat16)
    # random weights give low, random scores: the thresholds come from one
    # calibration frame
    cand = class0_scores(torch, model, post["bbox"], blob,
                         int(cfg.max_track_queries))
    thresh = cand[min(7, cand.numel() - 1)].item()
    tracker_cfg = served_tracker_cfg(thresh, nms_thresh)
    log(f"  tracker thresholds {thresh:.5f} (calibrated), steps_termination 3")
    return model, post["bbox"], tracker_cfg


def class0_scores(torch, model, post, blob, t_slots):
    """The object queries' class-0 scores on one frame, descending."""
    from kinet_tpu_torch.structs import ImageBatch
    from kinet_tpu_torch.tracking.tracker import make_forward_fn

    h, w = blob["images"].shape[1:3]
    dev = next(model.parameters()).device
    batch = ImageBatch(torch.from_numpy(blob["images"]).to(dev),
                       torch.from_numpy(blob["pad_mask"]).to(dev))
    size = torch.tensor([[float(h), float(w)]], device=dev)
    res = make_forward_fn(model, post)(batch, None, size, None, None, None)
    scores = res["scores"][0, t_slots:].float()
    cand = scores[res["labels"][0, t_slots:] == 0].sort(descending=True).values
    check(cand.numel() > 0, "no query scores class 0")
    return cand


def served_tracker_cfg(thresh, nms_thresh=0.9):
    return dict(
        detection_obj_score_thresh=thresh, track_obj_score_thresh=thresh,
        reid_score_thresh=thresh, detection_nms_thresh=nms_thresh,
        track_nms_thresh=nms_thresh, steps_termination=3, inactive_patience=0,
        reid_sim_threshold=0.0, prev_frame_dist=1,
    )


def tracker_kwargs(cfg):
    return dict(num_object_queries=int(cfg.num_queries),
                num_track_slots=int(cfg.max_track_queries),
                hidden_dim=int(cfg.hidden_dim),
                overflow_boxes=bool(cfg.overflow_boxes))


def served_tracker(torch, cfg, seed=1, nms_thresh=0.9):
    """The served model of ``served_parts`` and a Tracker, calibrated on
    the first of the synthetic frames at MAIN_HW. Returns (tracker, model,
    frames)."""
    import numpy as np

    from kinet_tpu_torch.tracking.tracker import Tracker

    frames = list(moving_boxes(np, *MAIN_HW, N_FRAMES + 3))
    model, post, tracker_cfg = served_parts(torch, cfg, frames[0], seed,
                                            nms_thresh)
    tracker = Tracker(model, post, tracker_cfg, **tracker_kwargs(cfg))
    return tracker, model, frames


def class_heads(model):
    """The class heads of every decoder layer (Deformable DETR), or the one
    shared head (vanilla DETR)."""
    if hasattr(model, "class_head"):
        return [model.class_head(i) for i in range(model.dec_layers)]
    return [model.class_embed]


def bias_to_person(torch, model, cfg):
    """The tracker keeps class 0 (person); random heads rarely rank it
    first, so the biases of the other real classes are pushed down (not the
    no-object column of a softmax head, which then competes with class 0)."""
    others = slice(1, None) if cfg.focal_loss else slice(1, -1)
    with torch.no_grad():
        for head in class_heads(model):
            head.bias[others] -= 20.0


def timed_frames(torch, tracker, frames):
    """Steps the tracker over frames: (ms of each frame, host clock, each
    ending in its device-to-host copy; active track slots before each)."""
    times, active = [], []
    for blob in frames:
        active.append(min(len(tracker.tracks) + len(tracker.inactive_tracks),
                          tracker.num_track_slots))
        t0 = time.perf_counter()
        tracker.step(blob)
        times.append((time.perf_counter() - t0) * 1e3)
    return times, active


def phase_main_path(torch, msda, int8=False):
    """The served frame through Tracker.step: bf16 decoder table, or with
    ``int8`` the served config's int8 one (dec_msda_int8). Returns
    (launches, median ms/frame, replay device ms per kernel)."""
    import numpy as np

    cfg = flagship_cfg()
    if int8:
        cfg = cfg.replace(dec_msda_int8=True, allow_lossy=True)
    raw = "msda_raw_pool_fwd_i8" if int8 else "msda_raw_pool_fwd"
    tracker, model, frames = served_tracker(torch, cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(msda)
    times, active = timed_frames(torch, tracker, frames[:N_FRAMES])
    launches = read_launches(msda)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times[WARMUP:])
    log(f"  per-frame ms: {' '.join(f'{t:.2f}' for t in times)}")
    log(f"  active track slots per frame: {active}")
    log(f"  median {med:.3f} ms/frame after {WARMUP} warm-up frames -> "
        f"{1000.0 / med:.3f} frames/s; peak device memory {peak:.2f} GiB")
    log(f"  launches over {N_FRAMES} frames: {launches}")
    for k, n in launches.items():
        want = 6 * N_FRAMES if k in ("msda_fwd", raw) else 0
        check(n == want, f"{k} launched {n} times, expected {want} over "
              f"{N_FRAMES} frames")
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
    check(kinds.count("msda_fwd") == 6 and kinds.count(raw) == 6
          and len(kinds) == 12,
          f"a frame made the forward MSDA calls {kinds}, expected 6 + 6")
    log(f"  replay of one frame's 12 forward MSDA calls (bf16 memory; "
        f"compared on locations snapped to a 2^-16 grid):")
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


def reset_launches(msda):
    """Sets the forward kernels' launch counts to 0."""
    msda.ms_deform_attn.launches = 0
    msda.ms_deform_attn_raw_pool.launches = 0
    msda.ms_deform_attn_raw_pool.i8_launches = 0
    msda.ms_deform_attn_i8.launches = 0
    msda.ms_deform_attn_topk.launches = 0
    msda.ms_deform_attn_shared.launches = 0


def read_launches(msda):
    return {
        "msda_fwd": msda.ms_deform_attn.launches,
        "msda_raw_pool_fwd": msda.ms_deform_attn_raw_pool.launches,
        "msda_raw_pool_fwd_i8": msda.ms_deform_attn_raw_pool.i8_launches,
        "msda_fwd_i8": msda.ms_deform_attn_i8.launches,
        "msda_topk_fwd": msda.ms_deform_attn_topk.launches,
        "msda_shared_fwd": msda.ms_deform_attn_shared.launches,
    }


# ---------------------------------------------------------------------------
# phase 5's replay: the forward kernels on the main path's own samples


def record_forward_calls(torch, fn):
    """Runs fn() with the model's MSDA forward entry points (msda_fwd, the
    raw pool, and the encoder's int8, head-shared and top-k variants)
    wrapped where models/deformable_transformer.py binds them, and
    unwrapped after; returns (kernel, arguments) of every call, the tensors
    cloned."""
    from kinet_tpu_torch.models import deformable_transformer as dt

    calls = []
    orig = (dt.ms_deform_attn, dt.ms_deform_attn_raw_pool,
            dt.ms_deform_attn_i8, dt.ms_deform_attn_shared,
            dt.ms_deform_attn_topk)

    def recording(kernel, f):
        def wrapped(*args):
            calls.append((kernel, tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)))
            return f(*args)
        return wrapped

    def raw_pool(*args):
        int8 = len(args) > 5 and args[5] is not None  # quad_scales
        kernel = "msda_raw_pool_fwd_i8" if int8 else "msda_raw_pool_fwd"
        return recording(kernel, orig[1])(*args)

    dt.ms_deform_attn = recording("msda_fwd", orig[0])
    dt.ms_deform_attn_raw_pool = raw_pool
    dt.ms_deform_attn_i8 = recording("msda_fwd_i8", orig[2])
    dt.ms_deform_attn_shared = recording("msda_shared_fwd", orig[3])
    dt.ms_deform_attn_topk = recording("msda_topk_fwd", orig[4])
    try:
        fn()
    finally:
        (dt.ms_deform_attn, dt.ms_deform_attn_raw_pool, dt.ms_deform_attn_i8,
         dt.ms_deform_attn_shared, dt.ms_deform_attn_topk) = orig
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
    the recorded inputs, and what its corners read. {name: device ms}:
    for an int8 call also the bf16 kernel's, on the same samples over the
    bf16 table of the same values (the int8 rows times their scale), and
    for a top-k call msda_fwd's on the same samples with every weight
    kept. msda_fwd_i8's table is int8 either way: its f32 case takes the
    recorded scale (bf16 values) moved off the bf16 grid in f32."""
    if kernel == "msda_fwd_i8":
        q8, scale, shapes, loc, aw = args
        table = q8
    else:
        table, shapes, loc, aw = args[:4]
    lq, l = loc.shape[1], loc.shape[-3 if kernel == "msda_shared_fwd" else 3]
    esize = 1 if table.dtype == torch.int8 else torch.finfo(table.dtype).bits // 8
    loc_s = snapped(torch, loc)
    err, times, ms = 0.0, {}, None
    if kernel == "msda_fwd_i8":
        for sc in (scale, scale.float() * (1.0 + 2.0 ** -12)):
            out = msda.ms_deform_attn_i8(q8, sc, shapes, loc_s, aw)
            ref = msda.ms_deform_attn_i8_plain(q8, sc, shapes, loc_s, aw)
            assert_close(torch, f"replay {kernel} scale {sc.dtype}", out, ref,
                         1e-4, 1e-5)
            err = max(err, errors(torch, out, ref)[0])
        run_k = lambda: msda.ms_deform_attn_i8(q8, scale, shapes, loc, aw)  # noqa: E731
        st = read_stats(torch, "msda", loc, shapes, None, q8.shape[3], 1)
        bf16 = (q8.float() * scale.float()[:, None, :, None]).to(scale.dtype)
        times["msda_fwd (bf16 table)"] = device_ms(
            torch, lambda: msda.ms_deform_attn(bf16, shapes, loc, aw))
    elif kernel == "msda_shared_fwd":
        m, d = table.shape[2:]
        for v in (table, table.float()):
            out = msda.ms_deform_attn_shared(v, shapes, loc_s, aw)
            ref = msda.ms_deform_attn_shared_plain(v, shapes, loc_s, aw)
            assert_close(torch, f"replay {kernel} {v.dtype}", out, ref,
                         1e-4, 1e-5)
            err = max(err, errors(torch, out, ref)[0])
        run_k = lambda: msda.ms_deform_attn_shared(table, shapes, loc, aw)  # noqa: E731
        st = read_stats(torch, "raw", loc[:, :, None], shapes, None, m * d,
                        esize)
    elif kernel == "msda_topk_fwd":
        k = args[4]
        for v in (table, table.float()):
            out = msda.ms_deform_attn_topk(v, shapes, loc_s, aw, k)
            ref = msda.ms_deform_attn_topk_plain(v, shapes, loc_s, aw, k)
            assert_close(torch, f"replay {kernel} {v.dtype}", out, ref,
                         1e-4, 1e-5)
            err = max(err, errors(torch, out, ref)[0])
        run_k = lambda: msda.ms_deform_attn_topk(table, shapes, loc, aw, k)  # noqa: E731
        st = read_stats(torch, "msda", loc, shapes, None, table.shape[3],
                        esize, keep=msda.topk_sample_mask(aw, k))
        times["msda_fwd (unpruned)"] = device_ms(
            torch, lambda: msda.ms_deform_attn(table, shapes, loc, aw))
    elif kernel == "msda_fwd":
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
        int8 = kernel == "msda_raw_pool_fwd_i8"
        scales, out_dtype = (args[5], args[6]) if int8 else (None, None)
        tables = ((table, out_dtype), (table, torch.float32)) if int8 else \
            ((table, None), (table.float(), None))
        for v, dt_out in tables:
            pooled, wsum = msda.ms_deform_attn_raw_pool(
                v, shapes, loc_s, aw, ext, scales, dt_out)
            ref, ref_w = msda.ms_deform_attn_raw_pool_plain(
                v, shapes, loc_s, aw, ext, scales, dt_out)
            rtol = 1e-2 if pooled.dtype == torch.bfloat16 else 1e-4
            assert_close(torch, f"replay {kernel} {pooled.dtype}", pooled, ref,
                         rtol, 1e-5)
            assert_close(torch, f"replay {kernel} wsum {pooled.dtype}", wsum,
                         ref_w, 1e-4, 1e-5)
            err = max(err, errors(torch, pooled, ref)[0],
                      errors(torch, wsum, ref_w)[0])
        run_k = lambda: msda.ms_deform_attn_raw_pool(  # noqa: E731
            table, shapes, loc, aw, ext, scales, out_dtype)
        st = read_stats(torch, "raw", loc, shapes, ext, table.shape[2], esize)
        if int8:
            bf16 = dequantized_table(torch, args)
            times["msda_raw_pool_fwd (bf16 table)"] = device_ms(
                torch, lambda: msda.ms_deform_attn_raw_pool(
                    bf16, shapes, loc, aw, ext))
            diff, ms, d_ms = k1_against_direct(
                torch, msda, (table, shapes, loc, aw, ext, scales, out_dtype))
            times[f"{kernel} (direct kernel)"] = d_ms
            times[f"{kernel} direct diff"] = diff
    if ms is None:
        ms = device_ms(torch, run_k)
    times[kernel] = ms
    # the bound: the distinct rows (head slices) the corners read, every
    # other input and every output once
    outs = run_k()
    outs = outs if isinstance(outs, tuple) else (outs,)
    width = (table.shape[3] if kernel in ("msda_fwd", "msda_fwd_i8",
                                          "msda_topk_fwd")
             else table.shape[2] * table.shape[3]
             if kernel == "msda_shared_fwd" else table.shape[2])
    others = [a for a in args if torch.is_tensor(a) and a is not table]
    moved = st["distinct"] * width * esize + sum(
        t.numel() * t.element_size() for t in others + list(outs))
    flops = st["corners"] * width * 2 + aw.numel() * 20
    times[f"{kernel} bound"], _ = bound_ms(moved, flops)
    other = "".join(f"; {k} {t:.3e}" if k.endswith("diff") else
                    f"; {k} {t:.5f} ms"
                    for k, t in times.items() if k != kernel)
    log(f"  {kernel:<20} Lq {lq:5d} L {l}: {ms:.5f} ms device{other}, max abs "
        f"err {err:.3e}; {stats_text(st, ms)}")
    return times


def dequantized_table(torch, args):
    """The table of an int8 raw-pool call's values (each level's int8 rows
    times its scale) in the call's pooled dtype."""
    table, shapes, scales, out_dtype = args[0], args[1], args[5], args[6]
    per_row = torch.cat([scales[:, lid:lid + 1].expand(-1, h * w)
                         for lid, (h, w) in enumerate(shapes)], dim=1)
    return (table.float() * per_row[..., None]).to(out_dtype)


def phase_replay(torch, msda, calls):
    """{kernel: mean device ms a launch} over one served frame's recorded
    forward calls."""
    per_kernel = {}
    with torch.inference_mode():
        for kernel, args in calls:
            for k, t in replay_call(torch, msda, kernel, args).items():
                per_kernel.setdefault(k, []).append(t)
    return replay_means(per_kernel, "frame")


def replay_means(per_kernel, what):
    """{name: mean device ms a launch} over a replay's calls (the largest
    for a ``diff``), logged."""
    out = {}
    for k, t in per_kernel.items():
        if k.endswith("diff"):
            out[k] = max(t)
            log(f"  {k}: largest {out[k]:.3e} over the {what}'s {len(t)} "
                f"calls")
            continue
        out[k] = statistics.mean(t)
        log(f"  {k}: {out[k]:.5f} ms a launch over the {what}'s {len(t)} "
            f"calls, {sum(t):.5f} ms a {what}")
    return out


def forward_launch_ms(by_name, calls):
    """{forward kernel: (device ms a launch, launches a call of fn)} from a
    profile of ``calls`` calls (device_profile's by_name)."""
    found = {}
    for k, (t, n) in by_name.items():
        # the int8 kernels: msda_raw_pool_fwd_i8_kernel (K1; the direct
        # kernel's msda_raw_pool_fwd_kernel<signed char, ..> before it), and
        # msda_fwd_kernel / msda_fwd_wide_kernel <signed char, ..>; the
        # head-shared ones: msda_shared_fwd_*kernel
        kernel = ("msda_raw_pool_fwd_i8" if "pool_fwd_i8_kernel" in k
                  or "pool_fwd_kernel<signed" in k else
                  "msda_raw_pool_fwd" if "raw_pool_fwd" in k else
                  "msda_shared_fwd" if "msda_shared_fwd" in k else
                  "msda_topk_fwd" if "msda_topk_fwd" in k else
                  "msda_fwd_i8" if "msda_fwd" in k and "<signed char" in k
                  else "msda_fwd" if "msda_fwd" in k else None)
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
    (root/train/*.jpg, root/annotations/{train,val}.json): four boxes
    moving over noise."""
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
    for split in ("train", "val"):
        (root / "annotations" / f"{split}.json").write_text(json.dumps(coco))


def write_crowdhuman_dataset(root: Path, split: str, n_images=4, h=360,
                             w=640):
    """Synthetic CrowdHuman images in its COCO-converted layout
    (root/{split}/*.jpg, root/annotations/{split}.json): five people a
    picture, one of them an ignore region."""
    import numpy as np
    from PIL import Image

    (root / split).mkdir(parents=True)
    (root / "annotations").mkdir(exist_ok=True)
    rng = np.random.default_rng(1)
    images, annotations = [], []
    for i in range(n_images):
        name = f"ch_{i:04d}.jpg"
        arr = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        for k in range(5):
            bw, bh = int(rng.integers(30, 80)), int(rng.integers(80, 200))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            arr[y:y + bh, x:x + bw] = 200
            annotations.append({
                "id": len(annotations) + 1, "image_id": i, "category_id": 1,
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
                "ignore": int(k == 4)})
        Image.fromarray(arr).save(root / split / name)
        images.append({"id": i, "file_name": name, "height": h, "width": w})
    (root / "annotations" / f"{split}.json").write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": 1, "name": "person"}]}))


RECIPE = FLAGSHIP + ["train_mot17_crowdhuman"]


def phase_train_entry(torch):
    """train(cfg) on the published MOT17 recipe (train_mot17_crowdhuman: a
    synthetic MOT tree and a synthetic CrowdHuman train_val tree, the MOT
    tree also holding a MOT17 sequence for the tracking eval), two epochs,
    evaluating after each; then a resume for a third."""
    from kinet_tpu_torch.config import load_config
    from kinet_tpu_torch.engine import train as train_mod

    modes = []
    evaluate = train_mod.evaluate

    def recording(model, *args, **kw):
        t0 = time.perf_counter()
        stats = evaluate(model, *args, **kw)
        modes.append((model.training, time.perf_counter() - t0))
        return stats

    train_mod.evaluate = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            write_mot_dataset(root / "mot")
            write_mot17_sequence(root / "mot", 6, 360, 640)
            write_crowdhuman_dataset(root / "crowdhuman", "train_val")
            out = root / "out"
            cfg = load_config("train.yaml", named=RECIPE).replace(
                mot_path_train=str(root / "mot"),
                mot_path_val=str(root / "mot"),
                crowdhuman_path=str(root / "crowdhuman"),
                output_dir=str(out), epochs=2, val_interval=1,
                tracking_eval_dataset=T_SEQ)
            t0 = time.perf_counter()
            model, _, steps = train_mod.train(cfg, device=DEVICE)
            first_s = time.perf_counter() - t0
            check(model.training, "the model left train() in eval mode")
            check([m for m, _ in modes] == [True, True],
                  f"the model's mode after each evaluation: {modes}")
            lines = [json.loads(ln) for ln in
                     (out / "metrics.jsonl").read_text().splitlines()]
            check([ln.get("epoch") for ln in lines] == [1, 2],
                  f"metrics.jsonl: {lines}")
            for ln in lines:
                check(all(isinstance(ln.get(k), float) and ln[k] == ln[k]
                          and abs(ln[k]) < 1e6
                          for k in ("AP", "AP50", "mota", "idf1")),
                      f"metrics.jsonl line {ln}")
            best = sorted(p.name for p in out.glob("checkpoint_best_*"))
            check("checkpoint_best_AP.pth" in best
                  and (out / "checkpoint.pth").exists(),
                  f"best checkpoints {best}")
            log(f"  train(cfg) {' '.join(RECIPE)}: {steps} steps over 2 "
                f"epochs (6 MOT frames + 4 CrowdHuman images, batch "
                f"{cfg.batch_size}) in {first_s:.1f} s, model build and "
                f"{len(modes)} evaluations ({', '.join(f'{t:.1f}' for _, t in modes)}"
                f" s) included")
            for ln in lines:
                log(f"  metrics.jsonl: {json.dumps(ln)}")
            log(f"  best checkpoints: {best}")
            t0 = time.perf_counter()
            _, _, resumed = train_mod.train(cfg.replace(
                resume=str(out / "checkpoint.pth"), resume_optim=True,
                epochs=3), device=DEVICE)
            check(resumed == steps // 2 * 3,
                  f"the resumed run ended at step {resumed}, expected "
                  f"{steps // 2 * 3}")
            check(len((out / "metrics.jsonl").read_text().splitlines()) == 3,
                  "the resumed epoch wrote no metrics line")
            log(f"  resumed at epoch 3: {resumed - steps} more steps and an "
                f"evaluation in {time.perf_counter() - t0:.1f} s")
    finally:
        train_mod.evaluate = evaluate


# ---------------------------------------------------------------------------
# phase E: evaluation at full width


E_FRAMES = 33  # odd: the batch of 2 leaves a partial last batch


def write_mot_val_tree(root: Path, n_frames, h, w):
    """MOT17/train/MOT17-02-FRCNN as phase T writes it, and the same frames
    as a MOT-to-COCO val set (root/train -> MOT17/train,
    root/annotations/val.json with its gt boxes)."""
    import numpy as np

    write_mot17_sequence(root, n_frames, h, w)
    (root / "train").symlink_to(root / "MOT17" / "train")
    (root / "annotations").mkdir()
    images, annotations = [], []
    for f, boxes in enumerate(box_tracks(np, h, w, n_frames)):
        images.append({"id": f, "file_name": f"{T_SEQ}/img1/{f + 1:06d}.jpg",
                       "height": h, "width": w, "frame_id": f,
                       "first_frame_image_id": 0, "seq_length": n_frames})
        for tid, (y0, x0, bh, bw) in enumerate(boxes, start=1):
            annotations.append({
                "id": len(annotations) + 1, "image_id": f, "category_id": 1,
                "bbox": [int(x0), int(y0), int(bw), int(bh)],
                "area": int(bw * bh), "iscrowd": 0, "track_id": tid})
    (root / "annotations" / "val.json").write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": 1, "name": "person"}]}))


def synced_spans(torch, model, criterion, post):
    """Wraps the model's forward, the criterion, its matching and the
    postprocess so that each synchronises the card before and after it and
    adds its host-clock seconds (its enqueue and its device work) to
    ``spans``. Returns (criterion, postprocessors, spans, undo)."""
    import collections

    spans = collections.defaultdict(float)

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spans[name] += time.perf_counter() - t0
            return out
        return run

    model.forward = timed("model forward", model.forward)
    criterion.match = timed("matching (cost + host LSAP)", criterion.match)

    def undo():
        del model.forward, criterion.match

    return (timed("criterion", criterion),
            {"bbox": timed("postprocess", post["bbox"])}, spans, undo)


def phase_eval(torch, msda):
    """evaluate() on the full-width flagship in bf16 over a 1080x1920 val
    set of E_FRAMES frames (800x1422 after the val transform), with the
    tracking eval over the same sequence. Returns its launch counts."""
    import math

    from kinet_tpu_torch.data.builder import build_dataset
    from kinet_tpu_torch.data.sequences import MOT17Sequence
    from kinet_tpu_torch.engine import evaluate as eval_mod
    from kinet_tpu_torch.engine import track
    from kinet_tpu_torch.models.build import build_criterion
    from kinet_tpu_torch.models.postprocess import build_postprocessors

    seen, marks = set(), {}

    class Evaluator(eval_mod.CocoEvaluator):
        def update(self, predictions):
            seen.update(predictions)
            super().update(predictions)

    main_track = track.main_track

    def timed_track(*args, **kw):
        # the detection part ends here; the tracking eval starts
        marks["bbox"] = (time.perf_counter(), read_launches(msda))
        reset_launches(msda)
        out = main_track(*args, **kw)
        marks["track"] = (time.perf_counter(), read_launches(msda))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "mot"
        t0 = time.perf_counter()
        write_mot_val_tree(root, E_FRAMES, *T_HW)
        cfg = flagship_cfg().replace(
            mot_path_val=str(root), tracking_eval_dataset=T_SEQ,
            size_buckets=[[800, 1440]], **T_TRANSFORM)
        seq = MOT17Sequence(str(root), "MOT17-02", "FRCNN",
                            img_transform=cfg.img_transform)
        model, shift = calibrated_model(torch, cfg, seq[0])
        criterion, post = build_criterion(cfg), build_postprocessors(cfg)
        dataset = build_dataset("val", cfg)
        check(len(dataset) == E_FRAMES, f"val set of {len(dataset)} images")
        log(f"  val set: {E_FRAMES} JPEG frames {T_HW[0]}x{T_HW[1]}, batch "
            f"{cfg.batch_size}; model bf16, class-0 bias {shift:+.3f}; "
            f"set-up {time.perf_counter() - t0:.1f} s")

        eval_mod.CocoEvaluator, track.main_track = Evaluator, timed_track
        try:
            torch.cuda.synchronize()
            reset_launches(msda)
            t0 = time.perf_counter()
            stats = eval_mod.evaluate(model, criterion, post, dataset, cfg,
                                      device=DEVICE)
            t_end = time.perf_counter()
        finally:
            eval_mod.CocoEvaluator, track.main_track = (
                Evaluator.__bases__[0], main_track)
        check(not model.training, "evaluate() changed the model's mode")
        bbox_s = marks["bbox"][0] - t0
        track_s = marks["track"][0] - marks["bbox"][0]
        launches = {"bbox": marks["bbox"][1], "track": marks["track"][1]}
        batches = -(-E_FRAMES // int(cfg.batch_size))
        # a batch (a tracked frame) launches msda_fwd once a layer of the
        # encoder (the first frame's one encoder run) and the bf16 raw pool
        # once a decoder layer
        per_run = {"msda_fwd": int(cfg.enc_layers),
                   "msda_raw_pool_fwd": int(cfg.dec_layers),
                   "msda_raw_pool_fwd_i8": 0}
        for part, runs in (("bbox", batches), ("track", E_FRAMES)):
            for k, n in per_run.items():
                check(launches[part][k] == n * runs,
                      f"{part}: {k} launched {launches[part][k]} times, "
                      f"expected {n} x {runs}")
        check(seen == set(range(E_FRAMES)),
              f"images missing from the evaluator: "
              f"{sorted(set(range(E_FRAMES)) - seen)}")
        coco = stats["coco_eval_bbox"]
        check(len(coco) == 12 and all(math.isfinite(v) for v in coco),
              f"stats {coco}")
        check(all(math.isfinite(stats.get(k, math.nan))
                  for k in ("mota", "idf1")), f"MOTA/IDF1 {stats}")

        # the detection part again, profiled, for the device's busy time;
        # then once more with each part synchronised, for where the time
        # goes
        det_cfg = cfg.replace(tracking_eval=False)
        busy = sum(t for t, _ in device_profile(torch, lambda: eval_mod.evaluate(
            model, criterion, post, dataset, det_cfg, device=DEVICE), 1)
            .values())
        crit, posts, spans, undo = synced_spans(torch, model, criterion, post)
        try:
            t1 = time.perf_counter()
            eval_mod.evaluate(model, crit, posts, dataset, det_cfg,
                              device=DEVICE)
            spans["the synchronised pass"] = time.perf_counter() - t1
        finally:
            undo()
    ms_img = 1e3 * bbox_s / E_FRAMES
    log(f"  detection eval: {ms_img:.3f} ms per val image ({bbox_s:.2f} s "
        f"for {E_FRAMES} images in {batches} batches, the last partial); "
        f"tracking eval {track_s:.2f} s ({E_FRAMES} frames, "
        f"{1e3 * track_s / E_FRAMES:.1f} ms a frame); the eval's wall "
        f"{t_end - t0:.2f} s")
    log(f"  launches per val image: "
        f"{ {k: round(n / E_FRAMES, 4) for k, n in launches['bbox'].items()} }"
        f" ({launches['bbox']} over {batches} batches); tracking eval "
        f"{launches['track']}")
    if busy > 0:
        log(f"  profiler (detection eval again): device busy "
            f"{busy / E_FRAMES:.3f} ms per image = "
            f"{100 * busy / (1e3 * bbox_s):.1f}% of the timed pass (idle "
            f"{100 * (1 - busy / (1e3 * bbox_s)):.1f}%)")
    else:
        log("  profiler: no device time recorded")
    log("  detection eval once more, each part synchronised (ms per image; "
        "the matching is part of the criterion): " + ", ".join(
            f"{k} {1e3 * t / E_FRAMES:.1f}" for k, t in spans.items()))
    names = ["AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
             "AR100", "ARs", "ARm", "ARl"]
    log("  stats: " + " ".join(f"{n} {v:.4f}" for n, v in zip(names, coco)))
    log(f"  MOTA {stats['mota']:.4f} IDF1 {stats['idf1']:.4f} (seeded "
        f"random weights)")
    del model
    torch.cuda.empty_cache()
    return launches["bbox"], ms_img, t_end - t0


# ---------------------------------------------------------------------------
# phase A: accuracy on the card


def phase_accuracy(torch, msda, gate="simple"):
    """A synthetic-MOT accuracy gate (kinet_tpu_torch.tools.mota_gates):
    train a tiny tracking model on the card, track its sequence, hold it
    to the JAX gate's thresholds."""
    from kinet_tpu_torch.tools import mota_gates

    reset_launches(msda)
    msda.ms_deform_attn.bwd_launches = 0
    msda.ms_deform_attn_raw_pool.bwd_launches = 0
    run = mota_gates.run_simple if gate == "simple" else mota_gates.run_hard
    t0 = time.perf_counter()
    scores = run(device=DEVICE)
    wall = time.perf_counter() - t0
    launches = {**read_launches(msda),
                "msda_bwd": msda.ms_deform_attn.bwd_launches,
                "msda_raw_pool_bwd": msda.ms_deform_attn_raw_pool.bwd_launches}
    log(f"  {gate} gate: {scores['steps']} steps in {scores['train_s']:.1f} s "
        f"({1e3 * scores['train_s'] / scores['steps']:.1f} ms a step), last "
        f"loss {scores['last_loss']:.4f}; {wall:.1f} s in all")
    log(f"  scores: {json.dumps({k: v for k, v in scores.items() if k not in ('steps', 'train_s', 'last_loss')})}")
    log(f"  launches: {launches}")
    for k in ("msda_fwd", "msda_bwd", "msda_raw_pool_fwd", "msda_raw_pool_bwd"):
        check(launches[k] >= scores["steps"], f"{k} launched {launches[k]} "
              f"times in {scores['steps']} steps")
    missed = mota_gates.misses(gate, scores)
    check(not missed, f"the {gate} gate missed the JAX gate's thresholds: "
          f"{missed}")
    log(f"  thresholds {mota_gates.THRESHOLDS[gate]}: met")
    return scores


# ---------------------------------------------------------------------------
# phase T: the tracking CLI


# runs ``python -m kinet_tpu_torch.engine.track`` (runpy, as -m does) with
# its arguments, then prints the forward kernels' launch counts and the
# host-clock ms of each tracker step (Tracker, TrackerKinematic or
# BatchedTracker) as JSON
CLI_RUNNER = """
import json, runpy, sys, time
from kinet_tpu_torch.ops import msda
from kinet_tpu_torch.tracking.batched import BatchedTracker
from kinet_tpu_torch.tracking.kine_tracker import TrackerKinematic
from kinet_tpu_torch.tracking.tracker import Tracker
msda.ms_deform_attn.launches = 0
msda.ms_deform_attn_raw_pool.launches = 0
msda.ms_deform_attn_raw_pool.i8_launches = 0
step_ms = []
def timed(step):
    def timed_step(self, blob):
        t0 = time.perf_counter()
        step(self, blob)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return timed_step
Tracker.step = timed(Tracker.step)
TrackerKinematic.step = timed(TrackerKinematic.step)
BatchedTracker.step = timed(BatchedTracker.step)
sys.argv = ["kinet_tpu_torch.engine.track"] + sys.argv[1:]
runpy.run_module("kinet_tpu_torch.engine.track", run_name="__main__",
                 alter_sys=True)
print(json.dumps({"launches": {
    "msda_fwd": msda.ms_deform_attn.launches,
    "msda_raw_pool_fwd": msda.ms_deform_attn_raw_pool.launches,
    "msda_raw_pool_fwd_i8": msda.ms_deform_attn_raw_pool.i8_launches,
}, "step_ms": step_ms}))
"""


def write_mot17_sequence(root: Path, n_frames, h, w, name=T_SEQ, seed=0):
    """MOT17/train/<name> (MOT17-02-FRCNN) in the MOTChallenge layout:
    seqinfo.ini, img1/*.jpg (eight boxes of box_tracks(seed) moving over
    noise), det/det.txt and gt/gt.txt with the boxes (1-based pixels and
    frames)."""
    import configparser

    import numpy as np
    from PIL import Image

    seq = root / "MOT17" / "train" / name
    for d in ("img1", "det", "gt"):
        (seq / d).mkdir(parents=True)
    info = configparser.ConfigParser()
    info["Sequence"] = {"name": name, "imDir": "img1", "frameRate": "30",
                        "seqLength": str(n_frames), "imWidth": str(w),
                        "imHeight": str(h), "imExt": ".jpg"}
    with open(seq / "seqinfo.ini", "w") as f:
        info.write(f)
    rng = np.random.default_rng(7 + seed)
    background = rng.integers(40, 120, size=(h, w, 3)).astype(np.uint8)
    det, gt = [], []
    for f, boxes in enumerate(box_tracks(np, h, w, n_frames, seed), start=1):
        img = background.copy()
        for tid, (y0, x0, bh, bw) in enumerate(boxes, start=1):
            img[y0:y0 + bh, x0:x0 + bw] = 230
            det.append(f"{f},-1,{x0 + 1},{y0 + 1},{bw},{bh},0.9,-1,-1,-1")
            gt.append(f"{f},{tid},{x0 + 1},{y0 + 1},{bw},{bh},1,1,1.0")
        Image.fromarray(img).save(seq / "img1" / f"{f:06d}.jpg", quality=90)
    (seq / "det" / "det.txt").write_text("\n".join(det) + "\n")
    (seq / "gt" / "gt.txt").write_text("\n".join(gt) + "\n")


def calibrated_model(torch, cfg, blob):
    """The full-width model of ``cfg`` in bf16 with seeded weights, class
    heads biased to class 0 and the class-0 bias moved so that the track
    config's default thresholds (0.4) keep about 7 new detections a frame
    on ``blob`` (a sequence's first frame), as phase 5's calibrated ones
    do. Returns (model, the bias shift)."""
    import math

    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.structs import ImageBatch
    from kinet_tpu_torch.tracking.tracker import make_forward_fn

    model, post = build_model(cfg, device=DEVICE, seed=2)
    t_slots = int(cfg.max_track_queries)
    bias_to_person(torch, model, cfg)
    model.to(torch.bfloat16)
    h, w = blob["images"].shape[1:3]
    batch = ImageBatch(torch.from_numpy(blob["images"]).to(DEVICE),
                       torch.from_numpy(blob["pad_mask"]).to(DEVICE))
    res = make_forward_fn(model, post["bbox"])(
        batch, None, torch.tensor([[float(h), float(w)]], device=DEVICE),
        None, None, None)
    scores = res["scores"][0, t_slots:].float().sort(descending=True).values
    s8 = min(max(scores[7].item(), 1e-6), 1 - 1e-6)
    shift = math.log(0.4 / 0.6) - math.log(s8 / (1 - s8))
    with torch.no_grad():
        for head in class_heads(model):
            head.bias[0] += shift
    return model, shift


def phase_track_cli(torch, msda):
    """``python -m kinet_tpu_torch.engine.track`` on a synthetic
    MOT17-02-FRCNN at its 1080x1920 (800x1422 after the val transform), with
    a saved full-width flagship run: its config with dec_msda_int8 and the
    checkpoint of seeded bf16 weights, class heads biased to class 0 and
    the class-0 bias moved so that the track config's default thresholds
    (0.4) keep about 7 new detections a frame, as phase 5's calibrated
    ones do. Returns (launches, steady-state frames/s: the RUNTIME line's
    window less the first frame's step, over the other frames; frames/s of
    the whole RUNTIME line, which at 16 frames is mostly the first frame's
    start-up)."""
    import math
    import re

    import numpy as np

    from kinet_tpu_torch.config import save_config
    from kinet_tpu_torch.data.sequences import MOT17Sequence
    from kinet_tpu_torch.utils.checkpoint import CheckpointManager

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_mot17_sequence(tmp / "data", T_FRAMES, *T_HW)
        cfg = flagship_cfg().replace(dec_msda_int8=True, allow_lossy=True,
                                     **T_TRANSFORM)
        seq = MOT17Sequence(str(tmp / "data"), "MOT17-02", "FRCNN",
                            img_transform=cfg.img_transform)
        t1 = time.perf_counter()
        for i in range(4):
            blob = seq[i]
        load_ms = (time.perf_counter() - t1) * 1e3 / 4
        h, w = seq[0]["images"].shape[1:3]
        model, shift = calibrated_model(torch, cfg, seq[0])
        run = tmp / "run"
        save_config(cfg, run)
        CheckpointManager(str(run)).save_epoch(
            model, torch.optim.SGD(model.parameters(), lr=0.0), 0, 0)
        del model
        torch.cuda.empty_cache()
        log(f"  sequence {T_SEQ}: {T_FRAMES} frames {T_HW[0]}x{T_HW[1]}, "
            f"{h}x{w} after the val transform, {load_ms:.1f} ms a frame to "
            f"decode and transform (host, one thread); run saved (class-0 "
            f"bias {shift:+.3f}) in {time.perf_counter() - t0:.1f} s")

        out = tmp / "out"
        cmd = [sys.executable, "-c", CLI_RUNNER,
               f"obj_detect_checkpoint_dir={run}",
               f"data_root_dir={tmp / 'data'}", f"dataset_name={T_SEQ}",
               f"output_dir={out}", "tracker_cfg.steps_termination=3",
               "tracker_cfg.inactive_patience=0"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=900)
        wall = time.perf_counter() - t0
        text = proc.stdout
        check(proc.returncode == 0, f"the tracking CLI exited "
              f"{proc.returncode}:\n{text[-3000:]}\n{proc.stderr[-3000:]}")
        for line in text.strip().splitlines()[:-1]:
            log(f"  | {line}")
        child = json.loads(text.strip().splitlines()[-1])
        launches, step_ms = child["launches"], child["step_ms"]
        log(f"  launches over {T_FRAMES} frames: {launches} "
            f"(CLI process {wall:.1f} s)")
        log(f"  Tracker.step in the CLI: first frame {step_ms[0]:.1f} ms, "
            f"then median {statistics.median(step_ms[1:]):.3f} ms; "
            f"{sum(step_ms):.1f} ms of steps in all")
        for k, n in launches.items():
            want = 0 if k == "msda_raw_pool_fwd" else 6 * T_FRAMES
            check(n == want, f"the CLI launched {k} {n} times, expected {want}")
        hz = re.search(r"for (\d+) frames \(([\d.]+) Hz\)", text)
        check(hz is not None and int(hz.group(1)) == T_FRAMES,
              "no RUNTIME line for every frame")
        row = [ln for ln in text.splitlines() if ln.startswith(T_SEQ)]
        check(len(row) == 1, "no summary row")
        vals = [float(v) for v in row[0].split()[1:]]
        check(len(vals) == 7 and all(math.isfinite(v) for v in vals),
              f"summary row {row[0]!r}")
        rows = np.loadtxt(out / T_SEQ / f"{T_SEQ}.txt", delimiter=",", ndmin=2)
        check(rows.shape[0] > 0 and rows.shape[1] == 10
              and bool(np.isfinite(rows).all()), "result file")
        log(f"  {rows.shape[0]} result rows, {len(set(rows[:, 1]))} tracks; "
            f"MOTA {vals[0]:.3f} IDF1 {vals[1]:.3f} HOTA {vals[2]:.3f}")
    # the frame loops' time that is not Tracker.step: waiting for frames
    loop_s = int(hz.group(1)) / float(hz.group(2))
    log(f"  of the RUNTIME line's {loop_s * 1e3:.0f} ms, "
        f"{loop_s * 1e3 - sum(step_ms):.0f} ms outside Tracker.step "
        f"(waiting for the prefetch thread's frames)")
    steady = (T_FRAMES - 1) / (loop_s - step_ms[0] / 1e3)
    return launches, steady, float(hz.group(2))


# ---------------------------------------------------------------------------
# phase B: batched serving (tracking/batched.py); phase S: processes


B_SEQS, B_FRAMES, B_SIZES = 4, 8, (1, 2, 4)
# two more frame sizes, both forms at B = 4: a smaller one, and MOT17's
# 1080x1920 frames untransformed (padded to 1088 rows)
B_OTHER_HW = ((544, 960), (1088, 1920))
# the f32 stacked form's boxes against one Tracker a sequence, px: twice
# the largest reading of two sound runs on an "NVIDIA H100 80GB HBM3,
# 700.00 W" (PERF.md §6), where a frame as row 0 of an f32 batch of
# 4 differed from the frame alone by 0.0598 px and the results by up to
# 0.0308 px
F32_STACKED_BOX_PX = 0.12
# the CLI's sequences (1080x1920 JPEGs, T_TRANSFORM)
B_CLI_SEQS = [f"MOT17-{n:02d}-FRCNN" for n in (2, 4, 5, 9)]
# config overrides of phase S's training runs (a rehearsal on the CPU sets
# tiny widths)
S_OVERRIDES: dict = {}


def same_results(np, got, ref, atol=1e-3):
    """None when ``got`` has ``ref``'s track ids and frames with boxes
    within ``atol`` px, else what differs."""
    if got.keys() != ref.keys():
        return f"track ids {sorted(got)} vs {sorted(ref)}"
    for tid, frames in ref.items():
        if got[tid].keys() != frames.keys():
            return f"track {tid}: frames {sorted(got[tid])} vs {sorted(frames)}"
    worst = box_gap(np, got, ref)
    return None if worst <= atol else f"boxes up to {worst:.4g} px apart"


def box_gap(np, got, ref):
    """The largest box difference, px, of two results with the same track
    ids and frames."""
    return max((float(np.abs(got[tid][f]["bbox"] - r["bbox"]).max())
                for tid, frames in ref.items() for f, r in frames.items()),
               default=0.0)


def identical_results(np, got, ref):
    """Whether two results hold the same tracks, frames, boxes, scores and
    detection indices, bit for bit."""
    return got.keys() == ref.keys() and all(
        got[t].keys() == ref[t].keys() and all(
            got[t][f].keys() == r.keys()
            and all(np.array_equal(got[t][f][k], v) for k, v in r.items())
            for f, r in ref[t].items())
        for t in ref)


@contextlib.contextmanager
def plain_msda(torch):
    """The model's MSDA and raw pool entries, where
    models/deformable_transformer.py binds them, swapped for their plain
    PyTorch versions, so that no hand kernel runs inside; with float64
    values the samples are cast to float64 too (the model gives them in
    float32, which grid_sample refuses beside float64 values)."""
    from kinet_tpu_torch.models import deformable_transformer as dt
    from kinet_tpu_torch.ops import msda as ops

    orig = dt.ms_deform_attn, dt.ms_deform_attn_raw_pool

    def like(t, x):
        return t.to(x.dtype) if x.dtype == torch.float64 else t

    def attn(v, shapes, loc, aw):
        return ops.ms_deform_attn_plain(v, shapes, like(loc, v), like(aw, v))

    def raw_pool(src, shapes, loc, aw, *rest):
        return ops.ms_deform_attn_raw_pool_plain(
            src, shapes, like(loc, src), like(aw, src), *rest)

    dt.ms_deform_attn, dt.ms_deform_attn_raw_pool = attn, raw_pool
    try:
        yield
    finally:
        dt.ms_deform_attn, dt.ms_deform_attn_raw_pool = orig


def batched_run(bt, seqs, n):
    """The sequences, in chunks of n, through the batched tracker ``bt``
    (reset between chunks; every sequence B_FRAMES long): (results of each
    sequence, copied, since a tracker goes on adding to its own; host ms of
    each step, each ending in its fetch; seconds in all)."""
    results, step_ms = [], []
    t0 = time.perf_counter()
    for i0 in range(0, len(seqs), n):
        chunk = seqs[i0:i0 + n]
        bt.reset()
        for f in range(B_FRAMES):
            t = time.perf_counter()
            bt.step([s[f] for s in chunk])
            step_ms.append((time.perf_counter() - t) * 1e3)
        results += [copy.deepcopy(bt.get_results(i)) for i in range(n)]
    return results, step_ms, time.perf_counter() - t0


def forward_rows_diff(torch, tracker, blob, n):
    """Max abs difference of the scores, boxes (px) and embeddings of a
    frame forwarded alone and as row 0 of a stacked batch of n copies."""
    one = tracker._build_inputs(blob)
    many = {k: torch.cat([torch.from_numpy(v).to(tracker.device)] * n)
            for k, v in one.items()}
    a = tracker._fwd(*tracker.make_device_inputs(one), None, None, None)
    b = tracker._fwd(*tracker.make_device_inputs(many), None, None, None)
    return {k: (a[k][0].float() - b[k][0].float()).abs().max().item()
            for k in ("scores", "boxes", "hs_embed")}


def score_margin(np, tracker, run):
    """Runs ``run()`` with the tracker's state machine recording the scores
    it compares (its track rows and its object rows); returns the least
    distance of one of them to the score threshold."""
    thresh = tracker.detection_obj_score_thresh
    consume, least = tracker._consume, [np.inf]

    def recording(out, blob):
        s = out["scores"]
        used = np.concatenate([s[:tracker._num_prev],
                               s[tracker.num_track_slots:]])
        least[0] = min(least[0], float(np.abs(used - thresh).min()))
        consume(out, blob)

    tracker._consume = recording
    try:
        run()
    finally:
        del tracker._consume
    return least[0]


def single_runs(tracker, seqs):
    """Each sequence through one Tracker (reset between them): (results of
    each, host ms of each step, seconds in all)."""
    results, step_ms = [], []
    t0 = time.perf_counter()
    for s in seqs:
        tracker.reset()
        for blob in s:
            t = time.perf_counter()
            tracker.step(blob)
            step_ms.append((time.perf_counter() - t) * 1e3)
        results.append(tracker.get_results())
    return results, step_ms, time.perf_counter() - t0


def stacked_f32_gate(torch, cfg, seqs, kw):
    """The stacked form at B = 2 and 4 against one Tracker a sequence, in
    f32 (TF32 off), the thresholds halfway between the 7th and 8th class-0
    scores of the first frame: the same track ids and frames, boxes within
    F32_STACKED_BOX_PX (the kernels that cuBLAS and cuDNN pick by batch
    sum in another order, and 12 layers of random weights grow that to
    ~0.06 px at 800x1440). Returns (least score-to-threshold distance of
    the reference, the batch-4 forward's row differences, the largest box
    difference of the results)."""
    import numpy as np

    from kinet_tpu_torch.tracking.batched import BatchedTracker
    from kinet_tpu_torch.tracking.tracker import Tracker

    model, post, _ = served_parts(torch, cfg, seqs[0][0])
    model.float()
    cand = class0_scores(torch, model, post, seqs[0][0], kw["num_track_slots"])
    tcfg = served_tracker_cfg(float(cand[6] + cand[7]) / 2)
    single = Tracker(model, post, tcfg, **kw)
    ref = []
    margin = score_margin(np, single,
                          lambda: ref.extend(single_runs(single, seqs)[0]))
    diff = forward_rows_diff(torch, single, seqs[0][0], B_SEQS)
    worst = 0.0
    for n in (2, B_SEQS):
        bt = BatchedTracker(model, post, {**tcfg, "batch_exec": "stacked"},
                            n_sequences=n, **kw)
        got = batched_run(bt, seqs, n)[0]
        for i, (g, r) in enumerate(zip(got, ref)):
            d = same_results(np, g, r, atol=F32_STACKED_BOX_PX)
            check(d is None, f"f32 stacked B={n}: sequence {i} differs from "
                  f"its single Tracker: {d} (closest score to the threshold "
                  f"{margin:.3g} off; a batch-{B_SEQS} row differs by {diff})")
            worst = max(worst, box_gap(np, g, r))
    del model, single, bt
    torch.cuda.empty_cache()
    return margin, diff, worst


def phase_batched(torch, msda, b1_replay):
    """BatchedTracker on the served config (dec_msda_int8, bf16) over
    B_SEQS synthetic sequences of B_FRAMES frames: at MAIN_HW with B = 1,
    2, 4 in both forms, at each of B_OTHER_HW with B = 4 in both. Every
    sequence of the forms whose forward is the single Tracker's (B = 1,
    interleaved) is held to its single Tracker's results; the stacked
    form's bf16 rows differ from a batch-1 forward's in the last bits, so
    its results are reported beside the single Tracker's, held to
    themselves with the sequences in reverse order (each row's results
    depend on its own inputs alone), and held to the single Tracker's in
    f32 (stacked_f32_gate). The bf16 gap between a batch-4 row and the
    frame alone is also read with the plain MSDA versions in place of the
    kernels. Then a replay of one stacked B = 4 step's MSDA calls
    (``b1_replay``: phase 5's B = 1 replay, or None). Returns
    ({(hw, B, form): measures}, {kernel: replay ms}, {B: {kernel: launches
    a stacked step}})."""
    import numpy as np

    from kinet_tpu_torch.tracking.batched import BatchedTracker
    from kinet_tpu_torch.tracking.tracker import Tracker

    cfg = flagship_cfg().replace(dec_msda_int8=True, allow_lossy=True)
    kw = tracker_kwargs(cfg)
    rows, per_step, replay = {}, {}, {}
    for hw in (MAIN_HW, *B_OTHER_HW):
        seqs = [list(moving_boxes(np, *hw, B_FRAMES, seed=20 + s))
                for s in range(B_SEQS)]
        model, post, tcfg = served_parts(torch, cfg, seqs[0][0])
        single = Tracker(model, post, tcfg, **kw)
        for blob in seqs[0][:2]:  # warm-up
            single.step(blob)
        ref, ref_ms, ref_s = single_runs(single, seqs)
        check(all(ref), "a sequence got no track")
        diff = forward_rows_diff(torch, single, seqs[0][0], B_SEQS)
        log(f"  {hw[0]}x{hw[1]}: one Tracker a sequence: "
            f"{B_SEQS * B_FRAMES / ref_s:.3f} frames/s, median "
            f"{statistics.median(ref_ms):.3f} ms a frame; tracks per "
            f"sequence {[len(r) for r in ref]}, result boxes "
            f"{[sum(len(t) for t in r.values()) for r in ref]}; a frame as "
            f"row 0 of a stacked batch of {B_SEQS} copies vs alone, max abs "
            f"difference (bf16): {diff}")
        if hw == MAIN_HW:
            with plain_msda(torch):
                plain = forward_rows_diff(torch, single, seqs[0][0], B_SEQS)
            log(f"  the same with the plain MSDA versions in place of the "
                f"kernels: {plain}")
            for k in ("scores", "hs_embed"):
                check(diff[k] / 10 <= plain[k] <= 10 * diff[k],
                      f"a batch-{B_SEQS} row's {k} differ from the frame "
                      f"alone by {plain[k]:.3g} with the plain MSDA versions,"
                      f" {diff[k]:.3g} with the kernels")
        rows[(hw, 1, "single")] = dict(
            fps=B_SEQS * B_FRAMES / ref_s, step_ms=statistics.median(ref_ms))
        stacked4 = None
        for n in (B_SIZES if hw == MAIN_HW else (B_SEQS,)):
            for form in ("stacked",) if n == 1 else ("stacked", "interleaved"):
                bt = BatchedTracker(model, post, {**tcfg, "batch_exec": form},
                                    n_sequences=n, **kw)
                for f in range(2):  # warm-up at this batch and form
                    bt.step([s[f] for s in seqs[:n]])
                torch.cuda.synchronize()
                reset_launches(msda)
                got, step_ms, secs = batched_run(bt, seqs, n)
                counts = read_launches(msda)
                fwd = len(step_ms) * (1 if form == "stacked" else n)
                for k, c in counts.items():
                    want = 6 * fwd if k in ("msda_fwd",
                                            "msda_raw_pool_fwd_i8") else 0
                    check(c == want, f"B={n} {form}: {k} launched {c} times, "
                          f"expected {want}")
                diffs = [same_results(np, g, r) for g, r in zip(got, ref)]
                if n == 1 or form == "interleaved":
                    for i, d in enumerate(diffs):
                        check(d is None, f"B={n} {form} at {hw}: sequence {i}"
                              f" differs from its single Tracker: {d}")
                    agree = "every sequence as its single Tracker's"
                else:
                    agree = (f"{diffs.count(None)} of {B_SEQS} sequences as "
                             f"their single Tracker's in bf16"
                             + "".join(f"; sequence {i}: {d}"
                                       for i, d in enumerate(diffs) if d))
                cyc = itertools.cycle(range(B_FRAMES))
                last = seqs[len(seqs) - n:]
                by_name = device_profile(
                    torch, lambda: bt.step([s[next(cyc)] for s in last]), 3)
                busy = sum(t for t, _ in by_name.values())
                med = statistics.median(step_ms)
                row = rows[(hw, n, form)] = dict(
                    fps=B_SEQS * B_FRAMES / secs, step_ms=med, busy_ms=busy,
                    launches={k: c / len(step_ms) for k, c in counts.items()
                              if c})
                if form == "stacked" and hw == MAIN_HW:
                    per_step[n] = row["launches"]
                    if n == B_SEQS:
                        stacked4, forward_order = bt, got
                share = (f"{100 * busy / med:.1f} %" if busy > 0
                         else "not measured (the profiler saw nothing)")
                log(f"  B={n} {form:<11} {row['fps']:.3f} frames/s over "
                    f"{B_SEQS} sequences, median {med:.3f} ms a step "
                    f"({med / n:.3f} a frame); device busy {busy:.3f} ms a "
                    f"step = {share}; launches a step {row['launches']}; "
                    f"{agree}")
        if stacked4 is not None:
            backward = batched_run(stacked4, seqs[::-1], B_SEQS)[0][::-1]
            for i, (g, r) in enumerate(zip(backward, forward_order)):
                check(identical_results(np, g, r),
                      f"stacked B={B_SEQS} (bf16): sequence {i} in row "
                      f"{B_SEQS - 1 - i} differs from the same sequence in "
                      f"row {i}: {same_results(np, g, r, atol=0.0)}")
            log(f"  stacked B={B_SEQS} with the sequences in reverse order: "
                f"every sequence's results as in forward order, bit for bit")
            calls = record_forward_calls(
                torch, lambda: stacked4.step([s[-1] for s in seqs]))
            kinds = [k for k, _ in calls]
            check(kinds.count("msda_fwd") == 6
                  and kinds.count("msda_raw_pool_fwd_i8") == 6
                  and len(kinds) == 12, f"a stacked B=4 step made {kinds}")
            log(f"  replay of one stacked B={B_SEQS} step's 12 forward MSDA "
                f"calls, the int8 raw pool's also over its bf16 table "
                f"(msda_raw_pool_fwd):")
            got = {}
            with torch.inference_mode():
                for kernel, args in calls:
                    cases = [(kernel, args)]
                    if kernel == "msda_raw_pool_fwd_i8":
                        cases.append(("msda_raw_pool_fwd",
                                      (dequantized_table(torch, args),)
                                      + tuple(args[1:5])))
                    for k, a in cases:
                        for name, t in replay_call(torch, msda, k, a).items():
                            got.setdefault(name, []).append(t)
            replay = replay_means(got, "step")
            for k in ("msda_fwd", "msda_raw_pool_fwd_i8", "msda_raw_pool_fwd"):
                b1 = (b1_replay or {}).get(k)
                vs = (f"; {B_SEQS} x phase 5's B=1 replay {B_SEQS * b1:.5f} ms"
                      f" ({replay[k] / (B_SEQS * b1):.3f}x)") if b1 else ""
                log(f"  {k} at B={B_SEQS}: {replay[k]:.5f} device ms a launch"
                    f", bound {replay[k + ' bound']:.5f} ms "
                    f"({100 * replay[k + ' bound'] / replay[k]:.1f} %){vs}")
            d = replay["msda_raw_pool_fwd_i8 (direct kernel)"]
            log(f"  msda_raw_pool_fwd_i8 at B={B_SEQS} in turn with the "
                f"direct kernel it replaced: "
                f"{replay['msda_raw_pool_fwd_i8']:.5f} vs "
                f"{d:.5f} ms ({replay['msda_raw_pool_fwd_i8'] / d:.3f}x), "
                f"largest difference "
                f"{replay['msda_raw_pool_fwd_i8 direct diff']:.3e}")
            del calls
        del model, single, bt, stacked4
        torch.cuda.empty_cache()
        if hw == MAIN_HW:
            margin, diff, worst = stacked_f32_gate(torch, cfg, seqs, kw)
            log(f"  f32 (TF32 off), thresholds between two scores: stacked "
                f"B=2 and B={B_SEQS} give every sequence its single "
                f"Tracker's tracks and frames, boxes up to {worst:.4g} px "
                f"apart (bound {F32_STACKED_BOX_PX} px; a batch-{B_SEQS} row "
                f"differs from the frame alone by {diff}); the closest "
                f"compared score {margin:.3g} from its threshold")
    for hw in (MAIN_HW, *B_OTHER_HW):
        s4, i4 = rows[(hw, B_SEQS, "stacked")], rows[(hw, B_SEQS, "interleaved")]
        log(f"  {hw[0]}x{hw[1]} B={B_SEQS}: stacked {s4['fps']:.3f} vs "
            f"interleaved {i4['fps']:.3f} frames/s "
            f"({s4['fps'] / i4['fps']:.3f}x)")
    return rows, replay, per_step


def cli_runs(torch, root: Path):
    """B_CLI_SEQS (B_FRAMES 1080x1920 JPEG frames each) under root/data and
    a saved full-width run with dec_msda_int8 under root/run, calibrated as
    phase T's on the first sequence's first frame; written once. Returns
    (the run's directory, the frames' padded size after the transform)."""
    from kinet_tpu_torch.config import save_config
    from kinet_tpu_torch.data.sequences import MOT17Sequence
    from kinet_tpu_torch.utils.checkpoint import CheckpointManager

    run = root / "run"
    if (run / "checkpoint.pth").exists():
        return run, tuple(json.loads((root / "frame_hw.json").read_text()))
    for i, name in enumerate(B_CLI_SEQS):
        write_mot17_sequence(root / "data", B_FRAMES, *T_HW, name=name, seed=i)
    cfg = flagship_cfg().replace(dec_msda_int8=True, allow_lossy=True,
                                 **T_TRANSFORM)
    seq = MOT17Sequence(str(root / "data"), "MOT17-02", "FRCNN",
                        img_transform=cfg.img_transform)
    model, shift = calibrated_model(torch, cfg, seq[0])
    save_config(cfg, run)
    CheckpointManager(str(run)).save_epoch(
        model, torch.optim.SGD(model.parameters(), lr=0.0), 0, 0)
    del model
    torch.cuda.empty_cache()
    hw = tuple(seq[0]["images"].shape[1:3])
    (root / "frame_hw.json").write_text(json.dumps(hw))
    log(f"  {len(B_CLI_SEQS)} sequences of {B_FRAMES} frames "
        f"{T_HW[0]}x{T_HW[1]} ({hw[0]}x{hw[1]} after the transform) and a "
        f"saved run (class-0 bias {shift:+.3f})")
    return run, hw


def phase_batched_cli(torch, msda, root: Path):
    """``python -m kinet_tpu_torch.engine.track`` with batch_sequences 4 and
    batch_exec auto over cli_runs' four sequences. Returns (the RUNTIME
    line, steady-state aggregate frames/s: the RUNTIME window less the
    first step, over the other steps' frames; the share of the window
    outside the batched steps, waiting for the prefetch threads' frames)."""
    import math
    import re

    run, (h, w) = cli_runs(torch, root)
    n = len(B_CLI_SEQS)
    out = root / "out_batched"
    cmd = [sys.executable, "-c", CLI_RUNNER, f"obj_detect_checkpoint_dir={run}",
           f"data_root_dir={root / 'data'}",
           f"dataset_name={','.join(B_CLI_SEQS)}", f"output_dir={out}",
           "tracker_cfg.steps_termination=3", "tracker_cfg.inactive_patience=0",
           f"batch_sequences={n}", "batch_exec=auto", f"device={DEVICE}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    text = proc.stdout
    check(proc.returncode == 0, f"the batched tracking CLI exited "
          f"{proc.returncode}:\n{text[-3000:]}\n{proc.stderr[-3000:]}")
    for line in text.strip().splitlines()[:-1]:
        log(f"  | {line}")
    child = json.loads(text.strip().splitlines()[-1])
    launches, step_ms = child["launches"], child["step_ms"]
    frames = n * B_FRAMES
    want = 6 * B_FRAMES  # auto is the stacked form: one forward a step
    for k, c in launches.items():
        check(c == (0 if k == "msda_raw_pool_fwd" else want),
              f"the batched CLI launched {k} {c} times (stacked: {want})")
    check(len(step_ms) == B_FRAMES, f"{len(step_ms)} batched steps")
    line = next(ln for ln in text.splitlines() if ln.startswith("RUNTIME"))
    hz = re.search(r"for (\d+) frames \(([\d.]+) Hz\)", line)
    check(hz is not None and int(hz.group(1)) == frames,
          f"RUNTIME line {line!r}")
    rows = [ln for ln in text.splitlines()
            if ln.split() and ln.split()[0] in B_CLI_SEQS + ["OVERALL"]]
    check(len(rows) == n + 1 and all(
        math.isfinite(float(v)) for r in rows for v in r.split()[1:]),
        f"summary rows {rows}")
    loop_s = frames / float(hz.group(2))
    steady = (frames - n) / (loop_s - step_ms[0] / 1e3)
    waiting = (loop_s - sum(step_ms) / 1e3) / loop_s
    log(f"  batch_exec auto at {h}x{w}; launches "
        f"{launches} (CLI process {wall:.1f} s); batched steps: first "
        f"{step_ms[0]:.1f} ms, then median {statistics.median(step_ms[1:]):.3f}"
        f" ms")
    return line, steady, waiting


# the processes of phase S: each joins a gloo group of ``world`` on the
# rendezvous URL, on the card (DEVICE)
S_TRACK_RUNNER = """
import json, sys
import torch.distributed as tdist
from kinet_tpu_torch.config import load_config, parse_cli_overrides
from kinet_tpu_torch.engine.track import main_track
rank, world, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
tdist.init_process_group("gloo", init_method=rdv, world_size=world, rank=rank)
summary = main_track(load_config("track.yaml",
                                 overrides=parse_cli_overrides(sys.argv[4:])))
tdist.destroy_process_group()
print(json.dumps({s: {k: float(v) for k, v in r.items()}
                  for s, r in summary.items()}))
"""
S_STEPS_RUNNER = """
import sys
import torch
import torch.distributed as tdist
import chip_smoke
import json
rank, world, rdv, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
for name, value in json.loads(sys.argv[5]).items():  # the parent's settings
    setattr(chip_smoke, name, value)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
tdist.init_process_group("gloo", init_method=rdv, world_size=world, rank=rank)
losses, params, grads = chip_smoke.s_train_steps(torch, rank, world)
tdist.destroy_process_group()
torch.save({"losses": losses, "params": params, "grads": grads}, out)
"""
# tools/launch.py with each train step's losses recorded (as float.hex)
# and printed at the end; with ``--signal`` the process sends itself
# SIGUSR1 after its first step
S_LAUNCH_RUNNER = """
import json, os, signal, sys
import torch
import torch.distributed as tdist
from kinet_tpu_torch.engine import train_step
from kinet_tpu_torch.tools import launch
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.deterministic = True
send = sys.argv[1] == "--signal"
argv = sys.argv[2:] if send else sys.argv[1:]
steps = []
make = train_step.make_train_step
def recording(*a, **kw):
    step = make(*a, **kw)
    def run(*b, **k):
        out = step(*b, **k)
        steps.append({"group": tdist.is_initialized() and
                      tdist.get_world_size(),
                      **{n: float(v).hex() for n, v in out.items()}})
        if send and len(steps) == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out
    return run
train_step.make_train_step = recording
launch.main(argv)
print(json.dumps(steps))
"""
S_HW = (672, 1184)
S_STEPS, S_OBJECTS = 3, 20
S_LR = 1e-4  # s_train_steps' learning rate


def s_inputs(torch, step, images, t_slots, hidden, dtype=None):
    """(batch, targets, prev_batch, prev_targets) of images ``images`` (of
    two) at train step ``step``: random pictures, S_OBJECTS tracks an
    image at random boxes, on DEVICE, the pictures and boxes in ``dtype``
    (default float32). The same image gets the same data whatever the
    batch it is in."""
    from kinet_tpu_torch.structs import ImageBatch, Targets

    h, w = S_HW
    frames = []
    for f in range(2):  # the current frame, the previous one
        imgs, boxes = [], []
        for i in images:
            gen = torch.Generator().manual_seed(1000 * step + 10 * i + f)
            imgs.append(torch.randn(h, w, 3, generator=gen).to(dtype))
            boxes.append((0.2 + 0.4 * torch.rand(S_OBJECTS, 4, generator=gen))
                         .to(dtype))
        n = len(images)
        targets = Targets.create(
            torch.stack(boxes), torch.zeros(n, S_OBJECTS, dtype=torch.int64),
            torch.ones(n, S_OBJECTS, dtype=torch.bool),
            track_ids=torch.arange(S_OBJECTS).expand(n, -1).clone(),
            num_track_queries=t_slots, hidden_dim=hidden)
        frames += [ImageBatch(torch.stack(imgs),
                              torch.zeros(n, h, w, dtype=torch.bool)), targets]
    return [x.to(DEVICE) for x in frames]


def s_train_steps(torch, rank, world, split=False, steps=S_STEPS,
                  dtype=None, n_model=1, images=None):
    """``steps`` f32 train steps of the full-width flagship (dropout 0, the
    track-query simulation's false positives and negatives off) on this
    process's share of a batch of two images; with ``dtype`` float64 the
    model, pictures and boxes are float64 and the MSDA runs its plain
    versions (``plain_msda``; the kernels take float32 and bfloat16). With
    ``split`` (one process), each image steps through the model on its
    own, with a generator of its own, as each process of a 2-process run
    does, and the optimizer applies the mean of the two gradients: the
    arithmetic of the 2-process run without its processes. Returns (each
    step's weighted losses, total and gradient norm: a list of one dict
    per image with ``split``; the parameters after the last step and the
    first step's all-reduced, unclipped gradients, on the CPU). With
    ``n_model`` > 1 (phase P) the model is tensor parallel over the group's
    processes (``parallel/tp.py``), each stepping both images (or
    ``images``); the parameters and gradients come back whole (gathered
    over the group)."""
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import make_train_step
    from kinet_tpu_torch.models.build import build_criterion, build_model
    from kinet_tpu_torch.parallel import mesh as pmesh, tp
    from kinet_tpu_torch.utils import dist

    cfg = flagship_cfg().replace(compute_dtype="float32", lr=S_LR,
                                 track_query_false_positive_prob=0.0,
                                 track_query_false_negative_prob=0.0,
                                 **S_OVERRIDES)
    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    model, _ = build_model(cfg, device=DEVICE, seed=3)
    if n_model > 1:
        tp.shard_params_tp(model, pmesh.make_mesh(1, n_model))
        rank, world = 0, 1  # every process of the model group: both images
    if images is None:
        images = [0, 1][rank::world]
    model.train()
    f64 = dtype == torch.float64
    if f64:
        model.double()
    criterion = build_criterion(cfg)
    opt = Optimizer(model, cfg, 1000)
    keys = set(criterion.weight_dict) | {"loss", "grad_norm"}
    grads, losses = {}, []

    def first_grads():
        if not grads:
            dims, group = tp.sharded_dims(model), tp.model_group(model)
            grads.update({k: dist.all_gather_cat(p.grad.detach(), dims[k],
                                                 group).to("cpu", copy=True)
                          if k in dims else p.grad.detach().to("cpu", copy=True)
                          for k, p in model.named_parameters()})

    if not split:
        update = opt.step

        def recording():  # the first step's gradients, unclipped
            first_grads()
            return update()

        opt.step = recording
        step = make_train_step(model, criterion, opt, cfg,
                               generator=torch.Generator().manual_seed(5))
        for s in range(steps):
            with plain_msda(torch) if f64 else contextlib.nullcontext():
                out = step(*s_inputs(torch, s, images, t_slots,
                                     hidden, dtype))
            losses.append({k: float(v) for k, v in out.items() if k in keys})
    else:
        kept = []

        class Keeping:
            """The optimizer to each image's step: keeps its gradients."""
            params = opt.params
            zero_grad = opt.zero_grad

            def step(self):
                kept.append([torch.zeros_like(p) if p.grad is None else
                             p.grad.clone() for p in opt.params])
                return torch.zeros(())

        per_image = [make_train_step(model, criterion, Keeping(), cfg,
                                     generator=torch.Generator().manual_seed(5))
                     for _ in range(2)]
        for s in range(steps):
            with plain_msda(torch) if f64 else contextlib.nullcontext():
                outs = [per_image[i](*s_inputs(torch, s, [i], t_slots,
                                               hidden, dtype))
                        for i in range(2)]
            for p, g0, g1 in zip(opt.params, *kept):
                p.grad = (g0 + g1) / 2  # all_reduce_grads: the sum, / 2
            kept.clear()
            first_grads()
            norm = float(opt.step())
            losses.append([{**{k: float(v) for k, v in o.items() if k in keys},
                            "grad_norm": norm} for o in outs])
    return losses, {k: v.detach().cpu()
                    for k, v in tp.full_state_dict(model).items()
                    if k in dict(model.named_parameters())}, grads


class Children:
    """The subprocesses a phase starts (stdout and stderr to files under
    ``root``), all killed on the way out."""

    def __init__(self, root: Path):
        self.root, self.procs = root, []

    def start(self, name, cmd, env=None):
        import os

        out = open(self.root / f"{name}.out", "w")
        err = open(self.root / f"{name}.err", "w")
        proc = subprocess.Popen(
            cmd, cwd=Path(__file__).resolve().parent, stdout=out,
            stderr=err, text=True, env={**os.environ, **(env or {})})
        self.procs.append((name, proc, out, err))
        return name

    def failed(self):
        """The names of the children that exited with a non-zero code."""
        return [n for n, proc, _, _ in self.procs
                if proc.poll() not in (None, 0)]

    def wait(self, name, timeout=600):
        """The child's stdout; fails the run if it did not exit 0."""
        for n, proc, out, err in self.procs:
            if n == name:
                try:
                    proc.wait(timeout)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                out.close()
                err.close()
                text = (self.root / f"{name}.out").read_text()
                check(proc.returncode == 0, f"{name} exited {proc.returncode}:"
                      f"\n{text[-3000:]}\n"
                      f"{(self.root / f'{name}.err').read_text()[-3000:]}")
                return text
        raise KeyError(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for _, proc, out, err in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
        return False


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_args(root: Path, out: Path, **over):
    """tools/launch.py's arguments for the flagship recipe on the synthetic
    MOT tree under root/mot672 (frames of S_HW, one bucket of S_HW)."""
    run = dict(dataset="mot", epochs=1, batch_size=1, val_interval=0,
               tracking_eval=False,
               num_workers=1, log_interval=1, size_buckets=[list(S_HW)],
               **{"img_transform.max_size": S_HW[1],
                  "img_transform.val_width": S_HW[0]}, **S_OVERRIDES, **over)
    return (["--device", DEVICE, "--config", "train.yaml", "--named",
             *FLAGSHIP, "--", f"mot_path_train={root / 'mot672'}",
             f"mot_path_val={root / 'mot672'}", f"output_dir={out}"]
            + [f"{k}={json.dumps(v)}" for k, v in run.items()])


def phase_processes(torch, root: Path):
    """Processes on the one card: (a) main_track in 2 gloo processes
    against 1; (b) S_STEPS flagship train steps at S_HW through
    tools/launch.py in a world-1 NCCL group against the same run without
    a group, bit for bit; then S_STEPS f32 steps in 2 gloo processes
    against 1 process stepping each image on its own with the mean
    gradient, bit for bit, and against 1 process on the concatenated
    batch (printed); step 0 in f64 on the concatenated batch against the
    mean of each image's gradient (the witness that the f32 gap is
    rounding); (c) the launcher with --requeue-on-preempt given SIGUSR1
    after its first step: checkpoint, requeue, resume. Every process
    starts at once; returns ({part: seconds until its checks were made},
    the 1-process f32 steps on both images, which phase P reuses)."""
    from kinet_tpu_torch.utils.checkpoint import load_checkpoint

    run, _ = cli_runs(torch, root)
    write_mot_dataset(root / "mot672", S_STEPS, *S_HW)
    write_mot_dataset(root / "mot_small", 6)
    track = [f"obj_detect_checkpoint_dir={run}",
             f"data_root_dir={root / 'data'}",
             f"dataset_name={','.join(B_CLI_SEQS)}",
             "tracker_cfg.steps_termination=3",
             "tracker_cfg.inactive_patience=0", f"device={DEVICE}"]
    times = {}
    torch.cuda.empty_cache()
    with Children(root) as kids:
        t0 = time.perf_counter()
        # (a), (b)'s launcher and 2-process runs and (c), all at once
        rdv = f"file://{root}/rdv_track"
        for r in range(2):
            kids.start(f"track{r}", [sys.executable, "-c", S_TRACK_RUNNER,
                                     str(r), "2", rdv, *track,
                                     f"output_dir={root / 'out_s2'}"])
        kids.start("track_one", [sys.executable, "-c", S_TRACK_RUNNER, "0",
                                 "1", f"file://{root}/rdv_one", *track,
                                 f"output_dir={root / 'out_s1'}"])
        torchrun = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                    "MASTER_ADDR": "localhost",
                    "MASTER_PORT": str(free_port())}
        kids.start("launch_nccl", [sys.executable, "-c", S_LAUNCH_RUNNER,
                                   *launch_args(root, root / "run_nccl")],
                   env=torchrun)
        kids.start("launch_alone", [sys.executable, "-c", S_LAUNCH_RUNNER,
                                    *launch_args(root, root / "run_alone")])
        small = root / "run_preempt"
        kids.start("preempt", [
            sys.executable, "-c", S_LAUNCH_RUNNER, "--signal",
            "--requeue-on-preempt", "--device", DEVICE, "--config",
            "train.yaml", "--named", *FLAGSHIP, "--",
            f"mot_path_train={root / 'mot_small'}",
            f"mot_path_val={root / 'mot_small'}", f"output_dir={small}",
            "dataset=mot", "epochs=2", "val_interval=0",
            "tracking_eval=false", "num_workers=1", "log_interval=1",
            *[f"{k}={json.dumps(v)}" for k, v in S_OVERRIDES.items()]])
        settings = dict(DEVICE=DEVICE, S_OVERRIDES=S_OVERRIDES, S_HW=S_HW,
                        S_OBJECTS=S_OBJECTS)
        for r in range(2):
            kids.start(f"steps{r}", [sys.executable, "-c", S_STEPS_RUNNER,
                                     str(r), "2", f"file://{root}/rdv_steps",
                                     str(root / f"steps{r}.pt"),
                                     json.dumps(settings)])
        # meanwhile here: (b)'s 1-process runs and the f64 witness
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True  # as the children
        try:
            split = s_train_steps(torch, 0, 1, split=True)
            torch.cuda.empty_cache()
            whole = s_train_steps(torch, 0, 1)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            f64 = [s_train_steps(torch, 0, 1, split=split_, steps=1,
                                 dtype=torch.float64)[2]
                   for split_ in (True, False)]
            f64_gib = torch.cuda.max_memory_allocated() / 2**30
        finally:
            torch.backends.cudnn.deterministic = deterministic
        torch.cuda.empty_cache()
        times["b_parent"] = time.perf_counter() - t0

        summaries = [json.loads(kids.wait(n).strip().splitlines()[-1])
                     for n in ("track_one", "track0", "track1")]
        ref = summaries[0]
        check(set(ref) == set(B_CLI_SEQS) | {"OVERALL"}, f"summary {ref}")
        for got in summaries[1:]:
            check(got.keys() == ref.keys(), f"summary keys {sorted(got)}")
            for seq, row in ref.items():
                for k, v in row.items():
                    tol = 1e-9 if k in ("motp", "loc_a") else 0.0
                    check(abs(got[seq][k] - v) <= tol or got[seq][k] == v,
                          f"2-process summary {seq} {k}: {got[seq][k]} vs {v}")
        sub = ",".join(B_CLI_SEQS)
        for name in B_CLI_SEQS:
            a = (root / "out_s2" / sub / f"{name}.txt").read_bytes()
            check(a and a == (root / "out_s1" / sub / f"{name}.txt").read_bytes(),
                  f"{name}'s result file differs between 2 processes and 1")
        log(f"  (a) main_track over {len(B_CLI_SEQS)} sequences in 2 gloo "
            f"processes on the card = 1 process: summaries and result files "
            f"(OVERALL MOTA {ref['OVERALL']['mota']:.3f}, IDF1 "
            f"{ref['OVERALL']['idf1']:.3f})")
        times["a"] = time.perf_counter() - t0

        nccl = json.loads(kids.wait("launch_nccl").strip().splitlines()[-1])
        alone = json.loads(kids.wait("launch_alone").strip().splitlines()[-1])
        check(len(nccl) == S_STEPS and all(s["group"] == 1 for s in nccl),
              f"the launcher's steps under torchrun: {nccl}")
        check(len(alone) == S_STEPS and not any(s["group"] for s in alone),
              f"the launcher's steps alone: {alone}")
        strip = [[{k: v for k, v in s.items() if k != "group"} for s in r]
                 for r in (nccl, alone)]
        check(strip[0] == strip[1], f"world-1 NCCL losses {strip[0]} vs no "
              f"group {strip[1]}")
        pa = load_checkpoint(root / "run_nccl" / "checkpoint.pth")["params"]
        pb = load_checkpoint(root / "run_alone" / "checkpoint.pth")["params"]
        check(pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k])
                                            for k in pa),
              "world-1 NCCL parameters differ from the run without a group")
        log(f"  (b) {S_STEPS} flagship steps at {S_HW[0]}x{S_HW[1]} through "
            f"tools/launch.py in a world-1 NCCL group = without a group, bit "
            f"for bit: losses {[float.fromhex(s['loss']) for s in strip[0]]}"
            f", {len(pa)} parameter tensors")
        times["b_launch"] = time.perf_counter() - t0

        text = kids.wait("preempt")
        for want in ("preemption requested: checkpoint saved at step 1",
                     "requeueing after preemption",
                     f"auto-resuming from {small / 'checkpoint.pth'}"):
            check(want in text, f"the preempted launcher printed no {want!r}")
        ckpt = load_checkpoint(small / "checkpoint.pth")
        check(ckpt["epoch"] == 2 and ckpt["step"] == 7,
              f"the requeued run ended at epoch {ckpt['epoch']} step "
              f"{ckpt['step']}, expected epoch 2 step 7")
        log("  (c) SIGUSR1 after step 1: checkpoint (epoch 0), requeue "
            "(re-exec of tools/launch.py), resume: epoch 2 at step 7 "
            "(1 + 3 + 3)")
        times["c"] = time.perf_counter() - t0

        # (b) 2 gloo processes on the card against 1 on the whole batch
        for r in range(2):
            kids.wait(f"steps{r}")
        two = [torch.load(root / f"steps{r}.pt", weights_only=True)
               for r in range(2)]
        # the 2 processes against 1 process stepping each image on its own:
        # the same arithmetic, so the same bits
        for s in range(S_STEPS):
            for r in range(2):
                check(two[r]["losses"][s] == split[0][s][r],
                      f"step {s}: process {r}'s losses {two[r]['losses'][s]}"
                      f" vs image {r} stepped alone {split[0][s][r]}")
        for k, p in split[1].items():
            check(torch.equal(two[0]["params"][k], p)
                  and torch.equal(two[1]["params"][k], p),
                  f"{k} after {S_STEPS} steps: 2 processes vs each image "
                  f"stepped alone")
        for k, g in split[2].items():
            check(torch.equal(two[0]["grads"][k], g),
                  f"step 0's all-reduced gradient of {k} differs")
        log(f"  (b) {S_STEPS} f32 steps at {S_HW[0]}x{S_HW[1]} in 2 gloo "
            f"processes on the card, one image each, = 1 process stepping "
            f"each image on its own and applying the mean gradient: losses, "
            f"gradient norms, step 0's gradients and the parameters, bit "
            f"for bit (grad norms "
            f"{[round(x[0]['grad_norm'], 4) for x in split[0]]})")
        # readings: against 1 process on the concatenated batch, whose
        # batch-2 kernels sum in another order, and a bilinear sample's
        # location gradient jumps where rounding moves it across a pixel
        # edge. The witness: in f64, where rounding moves no sample across
        # an edge, the two agree to rounding
        rel = {}
        for s, ref_s in enumerate(whole[0]):
            for k, v in ref_s.items():
                got = (two[0]["losses"][s][k] if k == "grad_norm" else
                       statistics.mean(t["losses"][s][k] for t in two))
                rel[(s, k)] = abs(got - v) / abs(v)
        diffs = {k: torch.linalg.vector_norm(two[0]["grads"][k] - g).item()
                 for k, g in whole[2].items()}
        total = torch.linalg.vector_norm(torch.tensor(list(diffs.values())))
        for s in range(S_STEPS):
            worst = max((r, k) for (t, k), r in rel.items() if t == s)
            log(f"  (b) step {s} vs 1 process on both images: losses and "
                f"gradient norm within rel {worst[0]:.2e} ({worst[1]}); "
                f"grad_norm {rel[(s, 'grad_norm')]:.2e}")
        log(f"  (b) step 0's gradient vs 1 process on both images: "
            f"|difference| / |gradient| {total / whole[0][0]['grad_norm']:.2e}"
            f", most in " + ", ".join(
                f"{k} {v:.3g}" for k, v in sorted(
                    diffs.items(), key=lambda kv: -kv[1])[:5]))
        gap = torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(f64[1][k] - g) for k, g in f64[0].items()]))
        size = torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(g) for g in f64[1].values()]))
        rel64 = (gap / size).item()
        check(rel64 <= 1e-6, f"f64 step 0: the gradient of both images "
              f"differs from the mean of each image's by {rel64:.3g} of "
              f"its norm")
        log(f"  (b) witness, f64 with the plain MSDA versions: step 0's "
            f"gradient of both images vs the mean of each image's "
            f"gradient, |difference| / |gradient| {rel64:.3g} (f32 "
            f"{total / whole[0][0]['grad_norm']:.3g}); peak "
            f"{f64_gib:.1f} GiB")
        times["b_steps"] = time.perf_counter() - t0
    return times, whole


# ---------------------------------------------------------------------------
# phase P: the parallel package (parallel/) in 2 gloo processes sharing the
# card: tensor-parallel training (mesh.model 2) and spatially parallel
# serving (spatial_parallel 2), each against 1 process

P_RUNNER = """
import json, sys
from pathlib import Path
import torch
import torch.distributed as tdist
import chip_smoke
part, rank, world, rdv = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
root = Path(sys.argv[5])
for name, value in json.loads(sys.argv[6]).items():  # the parent's settings
    setattr(chip_smoke, name, value)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
tdist.init_process_group("gloo", init_method=rdv, world_size=world, rank=rank)
out = getattr(chip_smoke, "p_" + part + "_child")(torch, root)
tdist.destroy_process_group()
torch.save(out, root / f"p_{part}{rank}.pt")
"""
P_TIMED_STEPS, P_FRAMES, P_WARMUP = 3, 8, 2
# f32 TP=2 against 1 process on the same two images, at full width. Step
# 0 (the same parameters) differs by f32 rounding only: its losses within
# P_LOSS0_RTOL (PR 14's reading 2.9e-5) and its gradient within
# P_GRAD_REL of its norm (7.3e-3: rounding in other sums, grown where a
# sample crosses a pixel edge; the f64 witness holds the arithmetic to
# 1e-6, reading 7.6e-16). Adam then turns near-zero gradients of
# either sign into full steps, so the parameters can part by 2 lr a step
# (P_PARAM_ATOL: 3 steps of lr 1e-4; reading 5.0e-4) and the later losses
# follow (P_LOSS_RTOL; reading 7.5e-2). P_PARAM_ATOL bounds that drift
# only and would hold whatever the update did; the update itself is held
# in f64 (f64_update_gap): the witness's parameters after its step within
# P_F64_UPDATE lr of 1 process's, where a shard the optimizer did not move
# would be ~1 lr off
P_LOSS0_RTOL, P_GRAD_REL, P_LOSS_RTOL = 1e-4, 2e-2, 0.2
P_PARAM_RTOL, P_PARAM_ATOL = 1e-4, 2 * S_LR * 3
P_F64_UPDATE, P_F64_GRAD_FLOOR = 1e-6, 1e-6
# f32 SP=2 against 1 process: the same tracks and frames, boxes within
# P_BOX_PX (PR 14's reading 0.028 px; PR 13's f32 stacked batches 0.031)
P_BOX_PX = 0.1


def f64_update_gap(torch, params, whole_params, whole_grads):
    """The largest |parameter after the f64 witness's step - 1 process's|
    in units of lr (the same start), over the entries whose clipped
    gradient (1 process's) exceeds P_F64_GRAD_FLOOR, 100 x Adam's eps; and
    (entries compared, entries). Adam's first step is lr g / (|g| + eps):
    a gradient error e moves it by lr e eps / (|g| + eps)^2, at most
    1e4 lr e above the floor, while a gradient that is rounding noise (a
    key bias's in attention, zero analytically) turns into up to a whole
    lr of either sign."""
    norm = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(g) for g in whole_grads.values()]))
    scale = min(1.0, flagship_cfg().clip_max_norm / norm.item())
    gap, n, total = 0.0, 0, 0
    for k, p in whole_params.items():
        big = whole_grads[k].abs() * scale > P_F64_GRAD_FLOOR
        if big.any():
            gap = max(gap, (params[k] - p)[big].abs().max().item())
        n, total = n + int(big.sum()), total + big.numel()
    return gap / S_LR, (n, total)


def p_cfg(**over):
    """The flagship with the children's overrides (S_OVERRIDES: none on the
    card) and ``over``."""
    return flagship_cfg().replace(**S_OVERRIDES, **over)


def wait_for(path: Path, kids=None, timeout=1200):
    """Waits until ``path`` exists; fails the run after ``timeout`` s or as
    soon as one of ``kids`` (a Children) has failed."""
    t0 = time.perf_counter()
    while not path.exists():
        check(time.perf_counter() - t0 < timeout, f"no {path.name} after "
              f"{timeout} s")
        if kids is not None and kids.failed():
            kids.wait(kids.failed()[0])  # fails the run with its output
        time.sleep(0.05)


def p_call_errors(torch, msda, kernel, args, grads):
    """One recorded call's kernel against its plain version on the snapped
    samples: the outputs with the table as recorded (bf16 on the timed
    paths) and in f32 (an int8 table: the recorded output dtype and f32),
    and with ``grads`` the backward kernel's gradients (value / src,
    locations, weights) against autograd through the plain version, in
    the recorded dtype, phase 3b's tolerances. Returns {kernel: {dtype of
    the table (of the output for an int8 table): largest max abs error}},
    the backward kernel's under its own name."""
    table, shapes, loc, aw = args[0].detach(), args[1], args[2], args[3]
    rest = args[4:]
    loc, aw = snapped(torch, loc.detach()), aw.detach()
    raw = kernel.startswith("msda_raw_pool_fwd")
    fn, plain = ((msda.ms_deform_attn_raw_pool,
                  msda.ms_deform_attn_raw_pool_plain) if raw else
                 (msda.ms_deform_attn, msda.ms_deform_attn_plain))
    if table.dtype == torch.int8:  # (ext, scales, output dtype)
        cases = [(table, rest), (table, (*rest[:2], torch.float32))]
    else:
        cases = [(table, rest), (table.float(), rest)]
    errs = {}
    for v, r in cases:
        with torch.no_grad():
            outs = fn(v, shapes, loc, aw, *r)
            refs = plain(v, shapes, loc, aw, *r)
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        for i, (o, ref) in enumerate(zip(outs, refs)):
            rtol = 1e-2 if o.dtype == torch.bfloat16 else 1e-4
            assert_close(torch, f"phase P {kernel} {v.dtype} output {i}", o,
                         ref, rtol, 1e-5)
            dt = str(v.dtype if v.dtype != torch.int8 else
                     outs[0].dtype).replace("torch.", "")
            errs[dt] = max(errs.get(dt, 0.0), errors(torch, o, ref)[0])
    if not grads:
        return {kernel: errs}
    gen = torch.Generator(device=table.device).manual_seed(2)
    ins = [t.detach().clone().requires_grad_(True) for t in (table, loc, aw)]
    with torch.enable_grad():
        outs = plain(ins[0], shapes, ins[1], ins[2], *rest)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cots = [torch.randn(o.shape, generator=gen, device=o.device).to(
            o.dtype) for o in outs]
        ref = torch.autograd.grad(outs, ins, cots)
    got = (msda._raw_pool_bwd(table, shapes, loc, aw, rest[0], *cots) if raw
           else msda._msda_bwd(table, shapes, loc, aw, cots[0]))
    tol_v = (1e-2, 1e-5) if table.dtype == torch.bfloat16 else (1e-4, 1e-5)

    def scaled(r, floor):
        return max(floor, 1e-5 * r.abs().max().item())

    bwd = "msda_raw_pool_bwd" if raw else "msda_bwd"
    return {kernel: errs, bwd: {
        str(table.dtype).replace("torch.", ""): grad_errors(
            torch, f"phase P {bwd}", [
                ("dtable", got[0], ref[0], *tol_v),
                ("dloc", got[1], ref[1], 1e-3, scaled(ref[1], 1e-4)),
                ("daw", got[2], ref[2], 1e-4, scaled(ref[2], 1e-5))])}}


def p_check_calls(torch, msda, calls, grads):
    """{kernel: {dtype: largest error}} over the first recorded call of
    each (kernel, query count, levels), held to its plain version (and
    with ``grads`` its backward kernel)."""
    seen, errs = set(), {}
    if DEVICE == "cpu":  # a CPU rehearsal: no kernel ran
        return errs
    for kernel, args in calls:
        key = (kernel, args[2].shape[1], tuple(args[1]))
        if key in seen:
            continue
        seen.add(key)
        for k, by_dtype in p_call_errors(torch, msda, kernel, args,
                                         grads).items():
            for dt, e in by_dtype.items():
                errs.setdefault(k, {})[dt] = max(
                    errs.get(k, {}).get(dt, 0.0), e)
    return errs


def p_counters(msda, names):
    table = {
        "msda_fwd": (msda.ms_deform_attn, "launches"),
        "msda_bwd": (msda.ms_deform_attn, "bwd_launches"),
        "msda_raw_pool_fwd": (msda.ms_deform_attn_raw_pool, "launches"),
        "msda_raw_pool_bwd": (msda.ms_deform_attn_raw_pool, "bwd_launches"),
        "msda_raw_pool_fwd_i8": (msda.ms_deform_attn_raw_pool, "i8_launches"),
    }
    return {k: table[k] for k in names}


def p_train_timing(torch, msda, n_model):
    """Phase 7's bf16 remat step of the flagship at TRAIN_HW (one image and
    its previous frame), tensor parallel over the group with ``n_model`` >
    1: median ms a step over P_TIMED_STEPS after one warm-up step, the
    kernels' launches over those steps, and the warm-up step's recorded
    MSDA calls held to their plain versions, forward and backward."""
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import make_train_step
    from kinet_tpu_torch.models.build import build_criterion, build_model
    from kinet_tpu_torch.parallel import mesh as pmesh, tp

    cfg = p_cfg(compute_dtype="bfloat16", remat=True, dropout=0.1)
    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    model, _ = build_model(cfg, device=DEVICE, seed=5)
    if n_model > 1:
        tp.shard_params_tp(model, pmesh.make_mesh(1, n_model))
    model.train()
    step = make_train_step(model, build_criterion(cfg), Optimizer(model, cfg),
                           cfg)
    frames = train_frames(torch, 6, *TRAIN_HW, TRAIN_OBJECTS, t_slots, hidden,
                          DEVICE)
    # the warm-up step's MSDA calls, checked after the timed steps
    calls = record_forward_calls(torch, lambda: float(step(*frames)["loss"]))
    counters = p_counters(msda, TRAIN_LAUNCHES)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    times, losses = [], []
    for _ in range(P_TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(*frames)["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    errs = p_check_calls(torch, msda, calls, grads=True)
    del model, step, frames, calls
    torch.cuda.empty_cache()
    return dict(ms=statistics.median(times), times=times, losses=losses,
                launches=launches, errors=errs)


def p_served(torch, cfg, thresh, frames, group=None):
    """The flagship served (seed 1, class heads biased to class 0, in the
    config's compute dtype) over ``frames`` through a Tracker, spatially
    parallel over ``group``: (results, host ms of each frame)."""
    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.tracking.tracker import Tracker

    model, post = build_model(cfg, seed=1, device=DEVICE)
    bias_to_person(torch, model, cfg)
    if cfg.compute_dtype == "bfloat16":
        model.to(torch.bfloat16)
    tracker = Tracker(model, post["bbox"], served_tracker_cfg(thresh),
                      **tracker_kwargs(cfg), spatial_group=group)
    times, _ = timed_frames(torch, tracker, frames)
    return tracker, times


def p_tp_child(torch, root):
    """One of the 2 processes of tensor-parallel training: S_STEPS f32
    steps of both images at S_HW; then, once the parent says so, the bf16
    timing and the kernels on this path's calls. (The TP f64 witness runs
    in the SP pair, after its short f32 session, beside these steps.)"""
    from kinet_tpu_torch.ops import msda

    torch.backends.cudnn.deterministic = True  # as the parent's reference
    f32 = s_train_steps(torch, 0, 1, n_model=2)
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    (root / f"p_tp_ready{torch.distributed.get_rank()}").touch()
    wait_for(root / "p_go_tp")
    return dict(f32=f32, bf16=p_train_timing(torch, msda, 2))


def p_f64_step(torch, n_model):
    """(the parameters after step 0, step 0's gradient), gathered whole,
    of image 0 in f64 with the plain MSDA versions, tensor parallel with
    ``n_model`` > 1: the witness that the f32 gap is rounding (in f64 no
    rounding moves a sample across a pixel edge, and every algorithm's
    sums agree to ~1e-15), and that the sharded AdamW state takes the
    update of 1 process."""
    return s_train_steps(torch, 0, 1, steps=1, dtype=torch.float64,
                         n_model=n_model, images=[0])[1:]


def p_sp_child(torch, root):
    """One of the 2 processes of spatially parallel serving: the f32
    session, then the TP f64 witness (``p_f64_step``, this pair being the
    other idle one); then, once the parent says so, the served config's
    bf16 session timed, its launches, and one frame's MSDA calls held to
    their plain versions."""
    import numpy as np
    import torch.distributed as tdist

    from kinet_tpu_torch.ops import msda

    group = tdist.group.WORLD
    thresh = json.loads((root / "p_thresh.json").read_text())
    frames = list(moving_boxes(np, *MAIN_HW, P_FRAMES + 1))
    tracker, _ = p_served(torch, p_cfg(compute_dtype="float32"),
                          thresh["f32"], frames[:P_FRAMES], group)
    f32 = tracker.get_results()
    del tracker
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True  # as the parent's reference
    f64 = p_f64_step(torch, 2)  # this pair as a tensor-parallel group
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    (root / f"p_sp_ready{tdist.get_rank()}").touch()
    wait_for(root / "p_go_sp")
    return dict(f32=f32, f64=f64, bf16=p_serve_timing(
        torch, msda, thresh["bf16"], frames, group))


def p_serve_cfg():
    return p_cfg(dec_msda_int8=True, allow_lossy=True)


def p_serve_timing(torch, msda, thresh, frames, group=None):
    """The served config (bf16, dec_msda_int8) over P_FRAMES frames:
    median ms a frame after P_WARMUP, launches, and one more frame's
    recorded MSDA calls (this process's own encoder queries) held to their
    plain versions."""
    counters = p_counters(msda, ("msda_fwd", "msda_raw_pool_fwd_i8"))
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    tracker, times = p_served(torch, p_serve_cfg(), thresh, frames[:P_FRAMES],
                              group)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    calls = record_forward_calls(torch,
                                 lambda: tracker.step(frames[P_FRAMES]))
    errs = p_check_calls(torch, msda, calls, grads=False)
    queries = sorted({args[2].shape[1] for k, args in calls
                      if k == "msda_fwd"})
    n_results = sum(len(f) for f in tracker.get_results().values())
    del tracker, calls
    torch.cuda.empty_cache()
    return dict(ms=statistics.median(times[P_WARMUP:]), times=times,
                launches=launches, errors=errs, queries=queries,
                results=n_results)


def phase_parallel(torch, msda, root: Path, whole=None):
    """Phase P: (a) S_STEPS f32 flagship steps at S_HW in 2 gloo processes
    at mesh.model 2 against 1 process on the same two images; bf16 ms a
    step at TRAIN_HW for TP=2 and TP=1 (no scaling claimed); each kernel
    of the path counted and held to its plain version on the path's own
    calls. (b) an f32 Tracker session at MAIN_HW spatially parallel over 2
    gloo processes against 1 process: the same tracks, boxes within
    P_BOX_PX; the served config's bf16 ms a frame for SP=2 and 1; msda_fwd
    on one process's own queries and the int8 decoder kernel held to
    their plain versions. The correctness parts run at once; the timed
    parts one after another. ``whole``: phase S's 1-process f32 steps on
    both images (the same steps; computed here without it). Returns
    ({kernel: launches a step or frame on the TP / SP path}, {kernel:
    largest error}, {name: ms}, {part: seconds})."""
    import numpy as np

    frames = list(moving_boxes(np, *MAIN_HW, P_FRAMES + 1))
    settings = dict(DEVICE=DEVICE, S_OVERRIDES=S_OVERRIDES, S_HW=S_HW,
                    S_OBJECTS=S_OBJECTS, MAIN_HW=MAIN_HW, TRAIN_HW=TRAIN_HW,
                    TRAIN_OBJECTS=TRAIN_OBJECTS, P_FRAMES=P_FRAMES,
                    P_TIMED_STEPS=P_TIMED_STEPS, P_WARMUP=P_WARMUP)
    # the tracker thresholds, between two calibration candidates, so that
    # rounding moves no score across them
    thresh = {}
    for key, cfg in (("f32", p_cfg(compute_dtype="float32")),
                     ("bf16", p_serve_cfg())):
        from kinet_tpu_torch.models.build import build_model

        model, post = build_model(cfg, seed=1, device=DEVICE)
        bias_to_person(torch, model, cfg)
        if key == "bf16":
            model.to(torch.bfloat16)
        cand = class0_scores(torch, model, post["bbox"], frames[0],
                             int(cfg.max_track_queries))
        check(cand.numel() > 8, f"{cand.numel()} class-0 candidates")
        thresh[key] = 0.5 * (cand[7].item() + cand[8].item())
        del model
    torch.cuda.empty_cache()
    (root / "p_thresh.json").write_text(json.dumps(thresh))
    times = {}
    with Children(root) as kids:
        t0 = time.perf_counter()
        for part in ("tp", "sp"):
            for r in range(2):
                kids.start(f"p_{part}{r}", [
                    sys.executable, "-c", P_RUNNER, part, str(r), "2",
                    f"file://{root}/rdv_p_{part}", str(root),
                    json.dumps(settings)])
        # the 1-process references meanwhile
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            if whole is None:
                whole = s_train_steps(torch, 0, 1)
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            whole64 = p_f64_step(torch, 1)
            f64_gib = torch.cuda.max_memory_allocated() / 2**30
        finally:
            torch.backends.cudnn.deterministic = deterministic
        tracker, _ = p_served(torch, p_cfg(compute_dtype="float32"),
                              thresh["f32"], frames[:P_FRAMES])
        ref = tracker.get_results()
        del tracker
        torch.cuda.empty_cache()
        for part in ("tp", "sp"):
            for r in range(2):
                wait_for(root / f"p_{part}_ready{r}", kids)
        times["correctness"] = time.perf_counter() - t0
        # the timed parts, one at a time
        (root / "p_go_tp").touch()
        for r in range(2):
            kids.wait(f"p_tp{r}")
        (root / "p_go_sp").touch()
        for r in range(2):
            kids.wait(f"p_sp{r}")
        tp2 = [torch.load(root / f"p_tp{r}.pt", weights_only=False)
               for r in range(2)]
        sp2 = [torch.load(root / f"p_sp{r}.pt", weights_only=False)
               for r in range(2)]
        times["children"] = time.perf_counter() - t0
    one_train = p_train_timing(torch, msda, 1)
    one_serve = p_serve_timing(torch, msda, thresh["bf16"], frames)
    times["one_process"] = time.perf_counter() - t0

    def rel_gap(a, b):
        gap = torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(a[k] - g) for k, g in b.items()]))
        size = torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(g) for g in b.values()]))
        return (gap / size).item()

    # (a) TP=2 against 1 process on the same images, f32, and the f64
    # witness; every reading logged before the checks
    failures = []
    for r, got in enumerate(tp2):
        losses, params, grads = got["f32"]
        rel = {(s, k): abs(losses[s][k] - v) / abs(v)
               for s, row in enumerate(whole[0]) for k, v in row.items() if v}
        worst = max(rel, key=rel.get)
        worst0 = max(v for (t, _), v in rel.items() if t == 0)
        grad_rel = rel_gap(grads, whole[2])
        beyond = {k: ((params[k] - p).abs() - P_PARAM_RTOL * p.abs()).max()
                  .item() for k, p in whole[1].items()}
        worst_p = max(beyond, key=beyond.get)
        rel64 = rel_gap(sp2[r]["f64"][1], whole64[1])  # the TP pair in SP's
        upd64, n_upd = f64_update_gap(torch, sp2[r]["f64"][0], *whole64)
        log(f"  (a) TP=2 process {r} vs 1 process, {S_STEPS} f32 steps at "
            f"{S_HW[0]}x{S_HW[1]} on both images: losses within rel "
            f"{rel[worst]:.3e} (step {worst[0]} {worst[1]}; bound "
            f"{P_LOSS_RTOL}); by step: " + ", ".join(
                f"{max(v for (t, _), v in rel.items() if t == s):.2e}"
                for s in range(S_STEPS))
            + f" (bounds: step 0 {P_LOSS0_RTOL}, later {P_LOSS_RTOL}); "
            f"parameters beyond rtol {P_PARAM_RTOL} by at most "
            f"{beyond[worst_p]:.3e} ({worst_p}; bound {P_PARAM_ATOL:.0e}); "
            f"step 0's gathered gradient |difference| / |gradient| "
            f"{grad_rel:.3e} (bound {P_GRAD_REL}); f64 witness (image 0, "
            f"plain MSDA) {rel64:.3e} (bound 1e-6), its parameters after "
            f"the update within {upd64:.3e} lr (bound {P_F64_UPDATE}) on "
            f"the {n_upd[0]} of {n_upd[1]} entries whose clipped gradient "
            f"exceeds {P_F64_GRAD_FLOOR:.0e}; peak {f64_gib:.1f} GiB in 1 "
            f"process)")
        if worst0 > P_LOSS0_RTOL or rel[worst] > P_LOSS_RTOL:
            failures.append(f"TP=2 process {r}'s losses: step 0 "
                            f"{worst0:.3g}, worst {rel[worst]:.3g} rel")
        if grad_rel > P_GRAD_REL:
            failures.append(f"TP=2 process {r}'s step-0 gradient "
                            f"{grad_rel:.3g}")
        if beyond[worst_p] > P_PARAM_ATOL:
            failures.append(f"TP=2 process {r}'s {worst_p} beyond rtol "
                            f"{P_PARAM_RTOL} by {beyond[worst_p]:.3g}")
        if rel64 > 1e-6:
            failures.append(f"TP=2 process {r}'s f64 gradient {rel64:.3g}")
        if upd64 > P_F64_UPDATE or not n_upd[0]:
            failures.append(f"TP=2 process {r}'s f64 parameters after the "
                            f"update {upd64:.3g} lr from 1 process's on "
                            f"{n_upd[0]} of {n_upd[1]} entries")
        if not all(torch.equal(params[k], tp2[1 - r]["f32"][1][k])
                   for k in params):
            failures.append("the TP ranks' parameters differ")
    # (b) SP=2 against 1 process, f32
    n_boxes = sum(len(f) for f in ref.values())
    for r, got in enumerate(sp2):
        diff = same_results(np, got["f32"], ref, atol=P_BOX_PX)
        log(f"  (b) SP=2 process {r}, f32 session at {MAIN_HW[0]}x"
            f"{MAIN_HW[1]}, {P_FRAMES} frames, vs 1 process ({len(ref)} "
            f"tracks, {n_boxes} boxes): "
            + (f"the same ids and frames, boxes within "
               f"{box_gap(np, got['f32'], ref):.3g} px (bound {P_BOX_PX})"
               if diff is None else diff))
        if diff is not None:
            failures.append(f"SP process {r}'s f32 session: {diff}")
    if n_boxes == 0:
        failures.append("the f32 session tracked nothing")

    tp_b, sp_b = tp2[0]["bf16"], sp2[0]["bf16"]
    for name, runs, n in (("TP", [t["bf16"] for t in tp2] + [one_train],
                           P_TIMED_STEPS),
                          ("SP", [t["bf16"] for t in sp2] + [one_serve],
                           P_FRAMES)):
        for i, run in enumerate(runs):
            who = f"process {i} of 2" if i < 2 else "1 process"
            log(f"  {name} {who}: launches {run['launches']} over {n}; "
                f"max abs err vs plain {run['errors']}")
        for k, c in runs[0]["launches"].items():
            want = (TRAIN_LAUNCHES[k] * P_TIMED_STEPS if name == "TP"
                    else 6 * P_FRAMES)
            got = [run["launches"][k] for run in runs]
            check(got == [want] * 3, f"{name}: {k} launched {got} times "
                  f"(2 processes, 1 process), expected {want}")
    check(sp_b["queries"] and max(sp_b["queries"]) < max(
        one_serve["queries"]), f"the SP encoder's queries {sp_b['queries']} "
        f"vs 1 process {one_serve['queries']}")

    log(f"  SP encoder msda_fwd query counts, process 0: {sp_b['queries']} "
        f"(1 process: {one_serve['queries']}); process 1: "
        f"{sp2[1]['bf16']['queries']}")
    ms = {"tp2_step": tp_b["ms"], "tp1_step": one_train["ms"],
          "sp2_frame": sp_b["ms"], "sp1_frame": one_serve["ms"]}
    log(f"  bf16 ms a train step at {TRAIN_HW[0]}x{TRAIN_HW[1]}: TP=2 (2 gloo "
        f"processes sharing the card) {tp_b['ms']:.1f} "
        f"({' '.join(f'{t:.1f}' for t in tp_b['times'])}), 1 process "
        f"{one_train['ms']:.1f}; served bf16 ms a frame at "
        f"{MAIN_HW[0]}x{MAIN_HW[1]}: SP=2 {sp_b['ms']:.3f}, 1 process "
        f"{one_serve['ms']:.3f} (readings, no scaling claimed: one card)")
    check(not failures, "; ".join(failures))
    launches = {k: n / P_TIMED_STEPS for k, n in tp_b["launches"].items()}
    launches.update({f"{k} (SP)": n / P_FRAMES
                     for k, n in sp_b["launches"].items()})
    errs = {}  # {kernel: {dtype: largest error}} over the four processes
    for run in (tp2[0]["bf16"], tp2[1]["bf16"], sp2[0]["bf16"],
                sp2[1]["bf16"]):
        for k, by_dtype in run["errors"].items():
            for dt, e in by_dtype.items():
                errs.setdefault(k, {})[dt] = max(
                    errs.get(k, {}).get(dt, 0.0), e)
    return launches, errs, ms, times


# ---------------------------------------------------------------------------
# phase D: vanilla DETR; phase K: the KineT family. Neither path has an
# MSDA kernel: every MSDA count must stay 0 while they run.


def reset_all_launches(msda):
    reset_launches(msda)
    msda.ms_deform_attn.bwd_launches = 0
    msda.ms_deform_attn_raw_pool.bwd_launches = 0


def read_all_launches(msda):
    return {**read_launches(msda),
            "msda_bwd": msda.ms_deform_attn.bwd_launches,
            "msda_raw_pool_bwd": msda.ms_deform_attn_raw_pool.bwd_launches}


def detr_cfg():
    """train.yaml + train_tracking: vanilla DETR, ResNet-50, hidden 256, 8
    heads, 6 + 6 layers, 100 queries, 100 track slots."""
    from kinet_tpu_torch.config import load_config

    return load_config("train.yaml", named=["train_tracking"]).replace(
        dataset="mot", dropout=0.0)


def phase_detr(torch, msda):
    """Vanilla DETR at full width: card vs CPU (f32, 256x448, two chained
    frames), the served frame through Tracker.step (bf16, 800x1440), one
    frame's decoder attention maps. Returns (ms/frame, busy share)."""
    import numpy as np

    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.models.detr import DETR
    from kinet_tpu_torch.models.postprocess import build_postprocessors
    from kinet_tpu_torch.structs import ImageBatch
    from kinet_tpu_torch.tracking.tracker import make_forward_fn

    reset_all_launches(msda)
    cfg = detr_cfg()
    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    n = min(20, t_slots, int(cfg.num_queries))
    outs = {}
    for dev in ("cpu", DEVICE):
        model, _ = build_model(cfg, device=dev, seed=0)
        check(type(model) is DETR, f"built {type(model).__name__}")
        rng = np.random.default_rng(5)
        b1, t1 = model_inputs(torch, rng, 256, 448, t_slots, hidden, 0, dev)
        b2, t2 = model_inputs(torch, rng, 256, 448, t_slots, hidden, n, dev)
        with torch.inference_mode():
            o1 = model(b1, t1)
            # frame 2's 20 track queries: frame 1's pre-norm output rows of
            # its first 20 object queries, at their boxes
            rows = slice(t_slots, t_slots + n)
            emb = t2.track_query_embeds.clone()
            emb[:, :n] = o1["hs_embed"][:, rows]
            boxes = t2.track_query_boxes.clone()
            boxes[:, :n] = o1["pred_boxes"][:, rows]
            o2 = model(b2, t2.replace(track_query_embeds=emb,
                                      track_query_boxes=boxes))
        outs[dev] = [{k: o[k].float().cpu() for k in
                      ("pred_logits", "pred_boxes", "hs_embed")} for o in (o1, o2)]
        del model, o1, o2
    torch.cuda.empty_cache()
    for f in range(2):
        for k, (rtol, atol) in MODEL_TOL.items():
            a, r = outs[DEVICE][f][k], outs["cpu"][f][k]
            check(bool(torch.isfinite(a).all()), f"DETR frame {f} {k} not finite")
            log(f"  card vs CPU frame {f} {k:<12} {tuple(a.shape)} max abs "
                f"err {(a - r).abs().max().item():.3e} (rtol {rtol}, atol {atol})")
            assert_close(torch, f"DETR frame {f} {k}", a, r, rtol, atol)

    # at random weights the vanilla decoder's queries predict nearly the
    # same box (IoU > 0.99), which NMS would merge into one track: without
    # NMS about 20 track slots are active, as in phase 5
    tracker, model, frames = served_tracker(torch, cfg, nms_thresh=0)
    torch.cuda.synchronize()
    times, active = timed_frames(torch, tracker, frames[:N_FRAMES])
    med = statistics.median(times[WARMUP:])
    log(f"  Tracker.step per-frame ms: {' '.join(f'{t:.2f}' for t in times)}")
    log(f"  active track slots per frame: {active}")
    log(f"  median {med:.3f} ms/frame after {WARMUP} warm-up frames -> "
        f"{1000.0 / med:.3f} frames/s")
    check(max(active[WARMUP:]) > 0, "no DETR track was ever active")
    n_boxes = sum(len(v) for v in tracker.get_results().values())
    check(n_boxes > 0 and all(
        np.isfinite(r["bbox"]).all() for v in tracker.get_results().values()
        for r in v.values()), "DETR tracker results")
    profiled = itertools.cycle(frames[N_FRAMES:N_FRAMES + 3])
    by_name = device_profile(torch, lambda: tracker.step(next(profiled)), 3)
    busy = sum(t for t, _ in by_name.values())
    share = busy / med if busy > 0 else None
    if share is None:
        log("  profiler: no device time recorded")
    else:
        log(f"  profiler: device busy {busy:.3f} ms/frame = {100 * share:.1f}% "
            f"of the median frame; {sum(n for _, n in by_name.values()) // 3} "
            f"device ops/frame")
        for k, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
            log(f"    {t:8.3f} ms/frame {n // 3:5d}/frame  {k[:90]}")

    # decoder attention maps: the head mean of the last layer's
    # cross-attention, one map [Hf, Wf] a query, each summing to 1
    fwd = make_forward_fn(model, build_postprocessors(cfg)["bbox"],
                          attention_maps=True)
    blob = frames[0]
    h, w = MAIN_HW
    res = fwd(ImageBatch(torch.from_numpy(blob["images"]).to(DEVICE),
                         torch.from_numpy(blob["pad_mask"]).to(DEVICE)),
              None, torch.tensor([[float(h), float(w)]], device=DEVICE),
              None, None, None)
    maps = res["attention_maps"]
    want = (1, t_slots + int(cfg.num_queries), -(-h // 32), -(-w // 32))
    check(tuple(maps.shape) == want, f"attention maps {tuple(maps.shape)}, "
          f"expected {want}")
    sums = maps.float().flatten(2).sum(-1)
    check(bool(torch.isfinite(maps).all())
          and bool(((sums - 1).abs() < 2e-2).all()),
          f"attention maps: finite and summing to 1 ({sums.min().item():.4f}"
          f"..{sums.max().item():.4f})")
    log(f"  attention maps {tuple(maps.shape)} ([B, Q, Hf, Wf]), finite, "
        f"each summing to 1 (within {(sums - 1).abs().max().item():.1e})")
    del tracker, model, res, maps
    torch.cuda.empty_cache()
    launches = read_all_launches(msda)
    check(not any(launches.values()),
          f"the vanilla DETR path launched MSDA kernels: {launches}")
    log(f"  MSDA launches on the DETR path: {launches}")
    return med, share


K_SEQ, K_FRAMES, K_HW = "MOT17-04-FRCNN", 24, (1080, 1920)
K_OBJECTS, K_DETS = 40, 44  # objects a frame; public detections a frame


def kine_cfg(encoder: bool, **over):
    """train_kinet (dual-stream) or train_kinet2 (encoder-only) at their
    widths (hidden 288, 8 heads, 1 + 1 layers, 150 queries, 60 detection
    slots, batch 8) after train_tracking (tracking, 100 track slots, trails
    of 5); max_objects 60, as the box matcher needs no more targets than
    detection slots."""
    from kinet_tpu_torch.config import load_config

    named = ["train_tracking", "train_kinet2" if encoder else "train_kinet"]
    return load_config("train.yaml", named=named).replace(
        max_objects=60, **over)


def kine_scene(np, n_frames, h, w, seed=0):
    """K_OBJECTS boxes moving at constant speed (x, y, w, h in whole pixels)
    and each frame's public detections: the boxes jittered by up to 3 px
    plus K_DETS - K_OBJECTS random false positives."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform([30, 60], [90, 220], size=(K_OBJECTS, 2))
    xy = rng.uniform([0, 0], [w - 90, h - 220], size=(K_OBJECTS, 2))
    vel = rng.uniform(-6, 6, size=(K_OBJECTS, 2))
    boxes, dets = [], []
    for f in range(n_frames):
        p = np.clip(xy + vel * f, 0, [w, h] - wh)
        b = np.round(np.concatenate([p, wh], 1))
        boxes.append(b)
        fp = np.concatenate([rng.uniform([0, 0], [w - 90, h - 220],
                                         (K_DETS - K_OBJECTS, 2)),
                             rng.uniform([30, 60], [90, 220],
                                         (K_DETS - K_OBJECTS, 2))], 1)
        dets.append(np.concatenate([b + rng.integers(-3, 4, b.shape),
                                    np.round(fp)]))
    return boxes, dets


def write_kine_tree(root: Path, n_frames, h, w):
    """The K scene twice: annotations/{train,val}.json and
    det_{train,val}.json for mot_kine, and MOT17/train/K_SEQ (JPEGs, gt,
    det) for the tracking eval and the CLI."""
    import configparser

    import numpy as np
    from PIL import Image

    boxes, dets = kine_scene(np, n_frames, h, w)
    images, anns, det_anns, gt_lines, det_lines = [], [], [], [], []
    for f in range(n_frames):
        images.append({"id": f, "file_name": f"{K_SEQ}_{f + 1:06d}.jpg",
                       "height": h, "width": w, "frame_id": f,
                       "first_frame_image_id": 0, "seq_length": n_frames,
                       "seq": K_SEQ})
        for tid, (x, y, bw, bh) in enumerate(boxes[f].tolist(), start=1):
            anns.append({"id": len(anns), "image_id": f, "category_id": 1,
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": 0, "track_id": tid})
            gt_lines.append(f"{f + 1},{tid},{x + 1:.0f},{y + 1:.0f},{bw:.0f},"
                            f"{bh:.0f},1,1,1.0")
        for x, y, bw, bh in dets[f].tolist():
            det_anns.append({"id": len(det_anns), "image_id": f,
                             "category_id": 1, "bbox": [x, y, bw, bh],
                             "area": bw * bh, "iscrowd": 0,
                             "confidence": 0.9})
            det_lines.append(f"{f + 1},-1,{x + 1:.0f},{y + 1:.0f},{bw:.0f},"
                             f"{bh:.0f},0.9,-1,-1,-1")
    (root / "annotations").mkdir(parents=True)
    base = {"images": images, "categories": [{"id": 1, "name": "person"}],
            "sequences": [K_SEQ]}
    for split in ("train", "val"):
        (root / "annotations" / f"{split}.json").write_text(
            json.dumps({**base, "annotations": anns}))
        (root / "annotations" / f"det_{split}.json").write_text(
            json.dumps({**base, "annotations": det_anns}))
    seq = root / "MOT17" / "train" / K_SEQ
    for d in ("img1", "det", "gt"):
        (seq / d).mkdir(parents=True)
    info = configparser.ConfigParser()
    info["Sequence"] = {"name": K_SEQ, "imDir": "img1", "frameRate": "30",
                        "seqLength": str(n_frames), "imWidth": str(w),
                        "imHeight": str(h), "imExt": ".jpg"}
    with open(seq / "seqinfo.ini", "w") as fh:
        info.write(fh)
    background = np.random.default_rng(3).integers(
        40, 120, size=(h, w, 3)).astype(np.uint8)
    for f in range(n_frames):
        Image.fromarray(background).save(seq / "img1" / f"{f + 1:06d}.jpg",
                                         quality=90)
    (seq / "det" / "det.txt").write_text("\n".join(det_lines) + "\n")
    (seq / "gt" / "gt.txt").write_text("\n".join(gt_lines) + "\n")


def kine_batch_at(np, cfg, seed=0):
    """A collate_kine batch (8 frames of the K scene) of the config's
    shapes."""
    from kinet_tpu_torch.data.kinematic import collate_kine, normalize_kine
    from kinet_tpu_torch.models.build import kine_dims

    h, w = K_HW
    trail_len = kine_dims(cfg)[0]
    boxes, dets = kine_scene(np, 8 + trail_len, h, w, seed)
    samples = []
    for f in range(trail_len, trail_len + 8):
        xyxy = lambda b: np.concatenate([b[:, :2], b[:, :2] + b[:, 2:]], 1)  # noqa: E731
        trails = np.stack([xyxy(boxes[f - trail_len + i])
                           for i in range(trail_len)])
        target = {"boxes": xyxy(boxes[f]).astype(np.float32),
                  "labels": np.zeros(K_OBJECTS, np.int64),
                  "track_ids": np.arange(1, K_OBJECTS + 1),
                  "tracklets": trails.astype(np.float32),
                  "orig_size": np.array([h, w]), "image_id": f}
        d, target = normalize_kine(xyxy(dets[f]).astype(np.float32), target)
        samples.append((d, np.full((len(d), 1), 0.9, np.float32), target))
    return collate_kine(samples, max_detections=int(cfg.max_number_detection),
                        max_objects=int(cfg.max_objects), trail_len=trail_len)


def phase_kine_vs_cpu(torch, encoder):
    """One KineT model at full width, card against CPU in f32: the forward
    on a batch of 8 frames with 30 active track slots, then one train step
    (make_kine_train_step, the same generator seed: the same trail
    augmentation) with its loss and gradient norm."""
    import numpy as np

    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import (
        kine_batch, kine_targets, make_kine_train_step)
    from kinet_tpu_torch.models.build import build_criterion, build_model

    cfg = kine_cfg(encoder, dropout=0.0)
    batch = kine_batch_at(np, cfg)
    outs = {}
    for dev in ("cpu", DEVICE):
        model, _ = build_model(cfg, device=dev, seed=3)
        kb = kine_batch(batch, dev)
        targets = kine_targets(batch, cfg, dev, int(cfg.max_track_queries))
        rng = np.random.default_rng(4)
        e = targets.track_query_embeds.shape[-1]
        targets = targets.replace(
            track_query_embeds=torch.from_numpy(rng.uniform(
                0, 1, (8, targets.num_track_slots, e)).astype(np.float32)).to(dev),
            track_query_mask=(torch.arange(targets.num_track_slots,
                                           device=dev) < 30)[None].expand(8, -1))
        with torch.inference_mode():
            out = model(kb, targets)
        model.train()
        step = make_kine_train_step(
            model, build_criterion(cfg), Optimizer(model, cfg, 100), cfg,
            generator=torch.Generator().manual_seed(9))
        losses = step(batch)
        outs[dev] = ({k: out[k].float().cpu() for k in
                      ("pred_logits", "pred_boxes", "hs_embed")},
                     {k: float(losses[k]) for k in ("loss", "grad_norm")})
        del model, out
    name = "encoder-only" if encoder else "dual-stream"
    for k, a in outs[DEVICE][0].items():
        r = outs["cpu"][0][k]
        check(bool(torch.isfinite(a).all()), f"{name} {k} not finite")
        log(f"  {name} card vs CPU {k:<12} {tuple(a.shape)} max abs err "
            f"{(a - r).abs().max().item():.3e} (rtol 1e-4, atol 1e-4)")
        assert_close(torch, f"{name} {k}", a, r, 1e-4, 1e-4)
    for k, v in outs[DEVICE][1].items():
        r = outs["cpu"][1][k]
        log(f"  {name} train step {k}: card {v:.6f} CPU {r:.6f}")
        check(v == v and abs(v - r) <= 1e-4 + 1e-4 * abs(r),
              f"{name} train step {k}: card {v} CPU {r}")


def calibrate_kine_run(torch, run: Path, blob):
    """Biases the saved run's class head to class 0 (person) and moves its
    class-0 bias so that track_kinet.yaml's 0.4 thresholds keep as many
    spawn rows as ``blob`` has detections."""
    import math

    from kinet_tpu_torch.engine.track import restore_model
    from kinet_tpu_torch.models.build import kine_dims
    from kinet_tpu_torch.models.postprocess import build_postprocessors
    from kinet_tpu_torch.tracking.kine_tracker import TrackerKinematic
    from kinet_tpu_torch.utils.checkpoint import CheckpointManager

    model, cfg = restore_model(run, DEVICE)
    bias_to_person(torch, model, cfg)
    trail_len, enc, meta_dim = kine_dims(cfg)
    tracker = TrackerKinematic(
        model, build_postprocessors(cfg)["bbox"],
        dict(detection_obj_score_thresh=0.4, track_obj_score_thresh=0.4,
             detection_nms_thresh=0.9, track_nms_thresh=0.9),
        int(cfg.num_queries), int(cfg.max_track_queries), trail_len=trail_len,
        trail_enc_dim=enc, meta_dim=meta_dim)
    inputs = tracker._build_inputs(blob)
    rows = tracker._fwd_kine(*tracker.make_device_inputs(inputs))[0]
    t = int(cfg.max_track_queries)
    spawn = rows[t:t + tracker._num_spawn_rows()]
    scores = spawn[:, 0].sort(descending=True).values
    k = min(len(blob["detections"]), len(scores)) - 1
    s = min(max(scores[k].item(), 1e-6), 1 - 1e-6)
    shift = math.log(0.4 / 0.6) - math.log(s / (1 - s)) + 0.05
    with torch.no_grad():
        model.class_embed.bias[0] += shift
    ckpt = CheckpointManager(str(run))
    payload = ckpt.restore()
    payload["params"] = model.state_dict()
    ckpt._save(ckpt.dir / "checkpoint.pth", payload)
    return shift


def phase_kine(torch, msda):
    """The KineT family at full width: card vs CPU for both models;
    train(cfg) over a synthetic mot_kine tree for each config, with its
    evaluation and tracking eval; the tracking CLI with track_kinet.yaml on
    the dual-stream run; the encoder-only accuracy gate. Returns a dict of
    the numbers to report."""
    import math
    import re

    import numpy as np

    from kinet_tpu_torch.data.sequences import MOT17Sequence
    from kinet_tpu_torch.engine import train as train_mod
    from kinet_tpu_torch.engine.track import _kine_blob
    from kinet_tpu_torch.tools import mota_gates

    reset_all_launches(msda)
    report = {}
    for encoder in (False, True):
        phase_kine_vs_cpu(torch, encoder)

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_kine_tree(tmp / "data", K_FRAMES, *K_HW)
        log(f"  mot_kine tree: {K_FRAMES} frames {K_HW[0]}x{K_HW[1]}, "
            f"{K_OBJECTS} objects and {K_DETS} public detections a frame, "
            f"written in {time.perf_counter() - t0:.1f} s")
        make_step = train_mod.make_kine_train_step
        step_ms = []

        def timed(*a, **kw):
            step = make_step(*a, **kw)

            def run(batch):
                t0 = time.perf_counter()
                out = step(batch)
                float(out["loss"])
                step_ms.append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        train_mod.make_kine_train_step = timed
        try:
            for encoder in (False, True):
                name = "train_kinet2" if encoder else "train_kinet"
                step_ms.clear()
                cfg = kine_cfg(encoder).replace(
                    mot_path_train=str(tmp / "data"),
                    mot_path_val=str(tmp / "data"),
                    output_dir=str(tmp / name), epochs=1, val_interval=1,
                    num_workers=2, tracking_eval_dataset=K_SEQ)
                t0 = time.perf_counter()
                model, _, steps = train_mod.train(cfg, device=DEVICE)
                wall = time.perf_counter() - t0
                line = json.loads((tmp / name / "metrics.jsonl").read_text())
                check(steps == K_FRAMES // 8 and all(
                    isinstance(line.get(k), float) and math.isfinite(line[k])
                    for k in ("AP", "AP50", "mota", "idf1")),
                    f"{name}: {steps} steps, metrics {line}")
                ms = statistics.median(step_ms[1:])
                report[f"{name}_ms_per_step"] = ms
                log(f"  train(cfg) {name}: {type(model).__name__}, {steps} "
                    f"steps of batch {cfg.batch_size} in {wall:.1f} s with its "
                    f"evaluation and tracking eval; steps (ms, host clock, "
                    f"each ending in its loss' copy): "
                    f"{' '.join(f'{t:.1f}' for t in step_ms)}; median after "
                    f"the first {ms:.2f} ms; metrics {json.dumps(line)}")
                del model
        finally:
            train_mod.make_kine_train_step = make_step

        # the tracking CLI with track_kinet.yaml on the dual-stream run
        run = tmp / "train_kinet"
        seq = MOT17Sequence(str(tmp / "data"), "MOT17-04", "FRCNN",
                            img_transform=kine_cfg(False).img_transform)
        t1 = time.perf_counter()
        for i in range(4):
            first = seq[i]
        decode_ms = (time.perf_counter() - t1) * 1e3 / 4
        shift = calibrate_kine_run(
            torch, run, _kine_blob(seq[0], int(kine_cfg(False).max_number_detection)))
        del first
        out = tmp / "out"
        cmd = [sys.executable, "-c", CLI_RUNNER, "--config",
               "track_kinet.yaml", f"obj_detect_checkpoint_dir={run}",
               f"data_root_dir={tmp / 'data'}", f"dataset_name={K_SEQ}",
               f"output_dir={out}"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        text = proc.stdout
        check(proc.returncode == 0, f"the KineT tracking CLI exited "
              f"{proc.returncode}:\n{text[-3000:]}\n{proc.stderr[-3000:]}")
        for line in text.strip().splitlines()[:-1]:
            log(f"  | {line}")
        child = json.loads(text.strip().splitlines()[-1])
        check(not any(child["launches"].values()),
              f"the KineT CLI launched MSDA kernels: {child['launches']}")
        step_ms = child["step_ms"]
        hz = re.search(r"for (\d+) frames \(([\d.]+) Hz\)", text)
        check(hz is not None and int(hz.group(1)) == K_FRAMES,
              "no RUNTIME line for every frame")
        row = [ln for ln in text.splitlines() if ln.startswith(K_SEQ)]
        check(len(row) == 1, "no summary row")
        vals = [float(v) for v in row[0].split()[1:]]
        check(len(vals) == 7 and all(math.isfinite(v) for v in vals[:3]),
              f"summary row {row[0]!r}")
        rows = np.loadtxt(out / K_SEQ / f"{K_SEQ}.txt", delimiter=",", ndmin=2)
        check(rows.shape[0] > 0 and bool(np.isfinite(rows).all()), "result file")
        loop_s = int(hz.group(1)) / float(hz.group(2))
        steady_s = loop_s - step_ms[0] / 1e3
        steady = (K_FRAMES - 1) / steady_s
        # the steady frames' time outside TrackerKinematic.step: waiting for
        # the prefetch thread's JPEG decode
        waiting = 1.0 - sum(step_ms[1:]) / (steady_s * 1e3)
        report.update(cli_fps=steady, cli_runtime_fps=float(hz.group(2)),
                      cli_step_ms=statistics.median(step_ms[1:]),
                      decode_ms=decode_ms, decode_share=waiting)
        log(f"  CLI (class-0 bias {shift:+.3f}, process {wall:.1f} s): "
            f"{rows.shape[0]} result rows, {len(set(rows[:, 1]))} tracks; "
            f"MOTA {vals[0]:.3f} IDF1 {vals[1]:.3f} HOTA {vals[2]:.3f}")
        log(f"  TrackerKinematic.step: first frame {step_ms[0]:.1f} ms, then "
            f"median {report['cli_step_ms']:.3f} ms; {steady:.2f} frames/s "
            f"steady state ({1e3 / steady:.1f} ms a frame), {hz.group(2)} on "
            f"the RUNTIME line; {100 * waiting:.1f}% of the steady frames' "
            f"time is spent waiting for the prefetch thread's JPEG decode "
            f"(which KineT never reads; {decode_ms:.1f} ms a 1080x1920 frame "
            f"decoded alone on one thread)")

    # the encoder-only gate on the card
    scores = mota_gates.run_kine("kine", device=DEVICE)
    log(f"  encoder-only KineT gate: {scores['steps']} steps in "
        f"{scores['train_s']:.1f} s ({scores['ms_per_step']:.1f} ms a step); "
        f"{json.dumps({k: scores[k] for k in ('mota', 'idf1', 'num_switches', 'num_false_positives', 'num_misses')})}")
    missed = mota_gates.misses("kine", scores)
    check(not missed, f"the KineT gate missed the JAX gate's thresholds: "
          f"{missed}")
    report.update(gate_mota=scores["mota"], gate_idf1=scores["idf1"],
                  gate_ms_per_step=scores["ms_per_step"])
    launches = read_all_launches(msda)
    check(not any(launches.values()),
          f"the KineT paths launched MSDA kernels: {launches}")
    log(f"  MSDA launches on the KineT paths: {launches}")
    return report


# ---------------------------------------------------------------------------
# phase M: MOTS, the mask head on vanilla DETR (the published recipe) and on
# the flagship Deformable DETR


MOTS = ["train_tracking", "train_mots20"]
M_SEQ, M_FRAMES, M_HW = "MOTS20-02", 10, (1080, 1920)
M_TRAIN_FRAMES = 6  # three steps of the recipe's batch of 2
M5_FRAMES, M5_CPU_HW = 4, (128, 224)


def mots_cfg(**over):
    """train.yaml + train_tracking + train_mots20: vanilla DETR (ResNet-50,
    hidden 256, 8 heads, 6 + 6 layers, 100 queries, 100 track slots) in
    SegmWrapper, freeze_detr."""
    from kinet_tpu_torch.config import load_config

    return load_config("train.yaml", named=MOTS).replace(**over)


def deformable_masks_cfg(**over):
    """The flagship (hidden 288, 500 queries, 100 track slots) with
    masks."""
    return flagship_cfg().replace(masks=True, **over)


def next_frame_kwargs(model, out):
    """The second frame's extra forward arguments: the first frame's cached
    encoder memory (Deformable DETR with cache_prev_encoder), or none."""
    if getattr(model, "cache_prev_encoder", False):
        return dict(prev_memory=out["frame_memory"], pos_cache=out["pos_cache"])
    return {}


def mots_vs_cpu(torch, cfg, hw, tol):
    """The masked model of ``cfg`` on the card against the CPU, f32, over
    two chained frames (frame 2's 20 track queries are frame 1's pre-norm
    rows): pred_masks of both frames and the tracker's mask probabilities
    (logits resized to the input, then sigmoid) of frame 2."""
    import numpy as np

    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.tracking.tracker import make_forward_fn

    h, w = hw
    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    n = min(20, t_slots, int(cfg.num_queries))
    outs = {}
    for dev in ("cpu", DEVICE):
        model, post = build_model(cfg, device=dev, seed=0)
        check(type(model).__name__ == "SegmWrapper",
              f"built {type(model).__name__}")
        rng = np.random.default_rng(5)
        b1, t1 = model_inputs(torch, rng, h, w, t_slots, hidden, 0, dev)
        b2, t2 = model_inputs(torch, rng, h, w, t_slots, hidden, n, dev)
        with torch.inference_mode():
            o1 = model(b1, t1)
            rows = slice(t_slots, t_slots + n)
            emb = t2.track_query_embeds.clone()
            emb[:, :n] = o1["hs_embed"][:, rows]
            boxes = t2.track_query_boxes.clone()
            boxes[:, :n] = o1["pred_boxes"][:, rows]
            t2 = t2.replace(track_query_embeds=emb, track_query_boxes=boxes)
            kw = next_frame_kwargs(model, o1)
            o2 = model(b2, t2, **kw)
            res = make_forward_fn(model, post["bbox"])(
                b2, t2, torch.tensor([[float(h), float(w)]], device=dev),
                o1["frame_features"], kw.get("prev_memory"),
                kw.get("pos_cache"))
        outs[dev] = [{k: o[k].float().cpu() for k in
                      ("pred_logits", "pred_boxes", "pred_masks")}
                     for o in (o1, o2)]
        outs[dev][1]["mask_probs"] = res["mask_probs"].cpu()
        del model, o1, o2, res
    torch.cuda.empty_cache()
    for f in range(2):
        for k, (rtol, atol) in tol.items():
            if k not in outs["cpu"][f]:
                continue
            a, r = outs[DEVICE][f][k], outs["cpu"][f][k]
            check(bool(torch.isfinite(a).all()), f"frame {f} {k} not finite")
            log(f"  card vs CPU frame {f} {k:<12} {tuple(a.shape)} max abs "
                f"err {(a - r).abs().max().item():.3e} (rtol {rtol}, atol {atol})")
            assert_close(torch, f"masked model frame {f} {k}", a, r, rtol, atol)


def with_box_masks(torch, targets, h, w):
    """``targets`` with a filled-box mask [1, N, h, w] for each target."""
    b = targets.boxes[0].cpu()
    x0, x1 = ((b[:, 0] - b[:, 2] / 2) * w).long(), ((b[:, 0] + b[:, 2] / 2) * w).long()
    y0, y1 = ((b[:, 1] - b[:, 3] / 2) * h).long(), ((b[:, 1] + b[:, 3] / 2) * h).long()
    ys, xs = torch.arange(h)[None, :, None], torch.arange(w)[None, None, :]
    masks = ((ys >= y0[:, None, None]) & (ys < y1[:, None, None])
             & (xs >= x0[:, None, None]) & (xs < x1[:, None, None]))
    return targets.replace(masks=masks[None].float().to(targets.boxes.device))


def mots_train_vs_cpu(torch, msda, cfg, hw):
    """One f32 train step (dropout 0) of the masked model on the CPU and on
    the card from the same seeded weights, with the augmented targets the
    CPU made fed to both, every target with a box mask: the losses, mask
    losses included, the gradient norm and which parameters moved. Returns
    the card's {"changed": names of updated parameters, "bwd": MSDA
    backward launches}."""
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import make_train_step
    from kinet_tpu_torch.models.build import build_criterion, build_model
    from kinet_tpu_torch.tracking import train_augment

    h, w = hw
    cfg = cfg.replace(compute_dtype="float32", dropout=0.0)
    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    made, res = [], {}
    augment = train_augment.add_track_queries_to_targets
    for dev in ("cpu", DEVICE):
        model, _ = build_model(cfg, device=dev, seed=3)
        model.train()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = Optimizer(model, cfg, 1000)
        step = make_train_step(model, build_criterion(cfg), opt, cfg)

        def recorded(*a, **kw):
            if dev == "cpu":
                made.append(augment(*a, **kw))
            return made[0].to(dev)

        frames = train_frames(torch, 4, h, w, TRAIN_OBJECTS, t_slots, hidden,
                              dev)
        frames[1] = with_box_masks(torch, frames[1], h, w)
        frames[3] = with_box_masks(torch, frames[3], h, w)
        reset_all_launches(msda)
        train_augment.add_track_queries_to_targets = recorded
        try:
            losses = step(*frames)
        finally:
            train_augment.add_track_queries_to_targets = augment
        res[dev] = ({k: v.float().cpu() for k, v in losses.items()},
                    {n for n, p in model.named_parameters()
                     if not torch.equal(p, before[n])},
                    read_all_launches(msda))
        del model, opt, step, before
    torch.cuda.empty_cache()
    (l_cpu, _, _), (l_gpu, changed, launches) = res["cpu"], res[DEVICE]
    for key in ("loss", "loss_ce", "loss_bbox", "loss_giou", "loss_mask",
                "loss_dice", "grad_norm"):
        a, r = l_gpu[key], l_cpu[key]
        check(bool(torch.isfinite(a)), f"train step {key} not finite")
        log(f"  {key:<10} card {a.item():.6f}  cpu {r.item():.6f}")
        assert_close(torch, f"masked train step {key}", a, r, 1e-3, 1e-5)
    scale = min(1.0, float(cfg.clip_max_norm) / l_gpu["grad_norm"].item())
    log(f"  clip scale {scale:.6f} (clip_max_norm {cfg.clip_max_norm}, every "
        f"gradient counted); {len(changed)} parameter tensors updated")
    return {"changed": changed, "bwd": launches}


def mots_served(torch, msda, cfg, n_frames, warmup, vanilla=False):
    """The masked model of ``cfg`` in bf16 at 800x1440 through
    Tracker.step over n_frames of the moving-boxes sequence (class heads
    calibrated as in phase 5 so that about 7 detections a frame start
    tracks, no NMS). ``vanilla`` (DETR at random weights, whose queries
    score nearly alike and whose boxes coincide: once tracks exist every
    object row passes phase 5's threshold, and every track row stays
    above it) adds two bounds so that about 20-30 tracks live: each frame
    carries 7 public detections, the boxes of the 7 best object rows of
    the first frame, and new tracks need one (``center_distance``, as on
    MOT17's public detections); and the track threshold is set just
    above every track row's score of a 5-frame calibration run, so that a
    track ends 3 frames after its detection, as the flagship's do in
    phase 5 (else the track list outgrows the 100 slots, and the tracks
    beyond them are never updated). Afterwards each frame's
    resolved masks are checked boolean, disjoint and of the padded input
    size. Returns {ms, mb_to_host, peak_gib, launches, busy, live}."""
    import numpy as np

    reset_all_launches(msda)
    tracker, model, frames = served_tracker(torch, cfg, nms_thresh=0)
    copied, track_scores = [], []
    consume = tracker._consume

    def recording(out, blob):
        copied.append(out["mask_probs"].nbytes
                      + out["hs_embed"].shape[0] * (6 + out["hs_embed"].shape[1]) * 4)
        track_scores.append(out["scores"][:tracker._num_prev])
        consume(out, blob)

    tracker._consume = recording
    if vanilla:
        from kinet_tpu_torch.models.postprocess import build_postprocessors
        from kinet_tpu_torch.structs import ImageBatch
        from kinet_tpu_torch.tracking.tracker import make_forward_fn

        blob, dev = frames[0], next(model.parameters()).device
        h, w = MAIN_HW
        res = make_forward_fn(model, build_postprocessors(cfg)["bbox"])(
            ImageBatch(torch.from_numpy(blob["images"]).to(dev),
                       torch.from_numpy(blob["pad_mask"]).to(dev)),
            None, torch.tensor([[float(h), float(w)]], device=dev),
            None, None, None)
        t = tracker.num_track_slots
        best = res["scores"][0, t:].float().argsort(descending=True)[:7]
        dets = res["boxes"][0, t:][best].float().cpu().numpy()
        for f in frames:
            f["dets"] = dets
        tracker.public_detections = "center_distance"
        for blob in frames[:5]:
            tracker.step(blob)
        thresh = float(np.concatenate(track_scores).max()) + 1e-4
        tracker.track_obj_score_thresh = tracker.reid_score_thresh = thresh
        tracker.reset()
        copied.clear()
        log(f"  track threshold {thresh:.5f} (above every track row's score "
            f"over 5 calibration frames)")
    reset_all_launches(msda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = []
    times, active = [], []
    for blob in frames[:n_frames]:
        t, a = timed_frames(torch, tracker, [blob])
        times += t
        active += a
        live.append(len(tracker.tracks))
    launches = read_all_launches(msda)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times[warmup:])
    mb = statistics.median(copied) / 1e6
    tracker._consume = consume
    log(f"  per-frame ms: {' '.join(f'{t:.2f}' for t in times)}")
    log(f"  active track slots before each frame: {active}; live tracks "
        f"after it: {live}")
    log(f"  median {med:.3f} ms/frame after {warmup} warm-up frames; "
        f"{mb:.1f} MB copied to the host a frame (mask probabilities of "
        f"every row, f32, and the rows); peak device memory {peak:.2f} GiB")
    check(max(active[warmup:]) > 0, "no track was ever active")
    check(max(live) <= tracker.num_track_slots,
          f"the track list outgrew the {tracker.num_track_slots} slots: {live}")
    for f in range(n_frames):
        masks = [r[f]["mask"] for r in tracker.results.values() if f in r]
        check(bool(masks), f"frame {f}: no track has a mask")
        stack = np.stack(masks)
        check(stack.dtype == bool and stack.shape[1:] == MAIN_HW
              and int(stack.sum(0, dtype=np.int32).max()) <= 1,
              f"frame {f}: resolved masks {stack.dtype} {stack.shape}, "
              f"overlap {int(stack.sum(0, dtype=np.int32).max())}")
    log(f"  every frame's resolved masks: boolean, disjoint, "
        f"{MAIN_HW[0]}x{MAIN_HW[1]} (the padded input size)")
    profiled = itertools.cycle(frames[n_frames:n_frames + 2])
    by_name = device_profile(torch, lambda: tracker.step(next(profiled)), 2)
    busy = sum(t for t, _ in by_name.values())
    share = busy / med if busy > 0 else None
    if share is None:
        log("  profiler: no device time recorded")
    else:
        log(f"  profiler: device busy {busy:.3f} ms/frame = {100 * share:.1f}% "
            f"of the median frame")
        for k, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            log(f"    {t:8.3f} ms/frame {c // 2:5d}/frame  {k[:90]}")
    del tracker, model
    torch.cuda.empty_cache()
    return {"ms": med, "mb_to_host": mb, "peak_gib": peak,
            "launches": launches, "busy": share,
            "live": statistics.median(live[warmup:])}


def write_mots_tree(root: Path, n_train, n_seq, h, w):
    """The MOTS recipe's data: root/train/*.jpg with
    root/annotations/{train,val}.json (the MOT-to-COCO layout, each
    annotation a ``segmentation`` RLE written by the port's utils/rle.py),
    and root/MOTS20/train/MOTS20-02 (img1/*.jpg, seqinfo.ini and a MOTS
    gt/gt.txt of RLE lines) for the tracking eval and the CLI; eight
    filled boxes of box_tracks moving over noise."""
    import configparser

    import numpy as np
    from PIL import Image

    from kinet_tpu_torch.utils.rle import mask_to_rle

    (root / "train").mkdir(parents=True)
    (root / "annotations").mkdir()
    seq = root / "MOTS20" / "train" / M_SEQ
    (seq / "img1").mkdir(parents=True)
    (seq / "gt").mkdir()
    rng = np.random.default_rng(7)
    background = rng.integers(40, 120, size=(h, w, 3)).astype(np.uint8)
    images, anns, gt = [], [], []
    for f, boxes in enumerate(box_tracks(np, h, w, max(n_train, n_seq))):
        img = background.copy()
        for tid, (y0, x0, bh, bw) in enumerate(boxes, start=1):
            img[y0:y0 + bh, x0:x0 + bw] = 230
            mask = np.zeros((h, w), bool)
            mask[y0:y0 + bh, x0:x0 + bw] = True
            enc = mask_to_rle(mask)
            if f < n_train:
                anns.append({"id": len(anns), "image_id": f,
                             "category_id": 1, "bbox": [x0, y0, bw, bh],
                             "area": bw * bh, "iscrowd": 0, "track_id": tid,
                             "segmentation": enc})
            if f < n_seq:
                gt.append(f"{f + 1} {2000 + tid} 2 {h} {w} {enc['counts']}")
        if f < n_train:
            name = f"{M_SEQ}_{f + 1:06d}.jpg"
            Image.fromarray(img).save(root / "train" / name, quality=90)
            images.append({"id": f, "file_name": name, "height": h,
                           "width": w, "frame_id": f, "first_frame_image_id": 0,
                           "seq_length": n_train, "seq": M_SEQ})
        if f < n_seq:
            Image.fromarray(img).save(seq / "img1" / f"{f + 1:06d}.jpg",
                                      quality=90)
    doc = {"images": images, "annotations": anns, "sequences": [M_SEQ],
           "categories": [{"id": 1, "name": "person"}]}
    for split in ("train", "val"):
        (root / "annotations" / f"{split}.json").write_text(json.dumps(doc))
    (seq / "gt" / "gt.txt").write_text("\n".join(gt) + "\n")
    info = configparser.ConfigParser()
    info["Sequence"] = {"name": M_SEQ, "imDir": "img1", "frameRate": "30",
                        "seqLength": str(n_seq), "imWidth": str(w),
                        "imHeight": str(h), "imExt": ".jpg"}
    with open(seq / "seqinfo.ini", "w") as f:
        info.write(f)


def calibrate_run(torch, run: Path, blob):
    """Biases the saved run's class head to class 0 (person), moves its
    class-0 bias so that track.yaml's 0.4 thresholds keep about 7 new
    detections on ``blob``, and saves it back in bf16, the served type.
    Returns the shift."""
    import math

    from kinet_tpu_torch.engine.track import restore_model
    from kinet_tpu_torch.models.postprocess import build_postprocessors
    from kinet_tpu_torch.structs import ImageBatch
    from kinet_tpu_torch.tracking.tracker import make_forward_fn
    from kinet_tpu_torch.utils.checkpoint import CheckpointManager

    model, cfg = restore_model(run, DEVICE)
    bias_to_person(torch, model, cfg)
    model.to(torch.bfloat16)
    h, w = blob["images"].shape[1:3]
    res = make_forward_fn(model, build_postprocessors(cfg)["bbox"])(
        ImageBatch(torch.from_numpy(blob["images"]).to(DEVICE),
                   torch.from_numpy(blob["pad_mask"]).to(DEVICE)),
        None, torch.tensor([[float(h), float(w)]], device=DEVICE),
        None, None, None)
    t = int(cfg.max_track_queries)
    scores = res["scores"][0, t:].float().sort(descending=True).values
    s8 = min(max(scores[7].item(), 1e-6), 1 - 1e-6)
    shift = math.log(0.4 / 0.6) - math.log(s8 / (1 - s8))
    with torch.no_grad():
        for head in class_heads(model):
            head.bias[0] += shift
    ckpt = CheckpointManager(str(run))
    payload = ckpt.restore()
    payload["params"] = model.state_dict()
    ckpt._save(ckpt.dir / "checkpoint.pth", payload)
    return shift


def mots_recipe_and_cli(torch, msda):
    """M3: train(cfg) on train_mots20 as it stands (one epoch) over the
    synthetic MOTS tree, with its evaluation and the tracking eval; M4:
    the tracking CLI on MOTS20-02 with that run. Returns the numbers to
    report."""
    import math
    import re

    import numpy as np

    from kinet_tpu_torch.data.mots20_sequence import MOTS20Sequence
    from kinet_tpu_torch.engine import train as train_mod
    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.utils.rle import rle_to_mask

    report = {}
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_mots_tree(tmp / "data", M_TRAIN_FRAMES, M_FRAMES, *M_HW)
        log(f"  MOTS tree: {M_TRAIN_FRAMES} training frames and a {M_SEQ} of "
            f"{M_FRAMES} frames, {M_HW[0]}x{M_HW[1]}, 8 objects a frame with "
            f"RLE masks, written in {time.perf_counter() - t0:.1f} s")
        run = tmp / "run"
        cfg = mots_cfg(mot_path_train=str(tmp / "data"),
                       mot_path_val=str(tmp / "data"), output_dir=str(run),
                       epochs=1, val_interval=1, tracking_eval_dataset=M_SEQ)
        check(cfg.masks and cfg.freeze_detr, "train_mots20 sets masks and "
              "freeze_detr")
        initial = {k: v.cpu() for k, v in build_model(
            cfg, device=DEVICE, seed=int(cfg.seed))[0].state_dict().items()}
        make_step = train_mod.make_train_step
        step_ms = []

        def timed(*a, **kw):
            step = make_step(*a, **kw)

            def run_step(*args):
                t1 = time.perf_counter()
                out = step(*args)
                float(out["loss"])
                step_ms.append((time.perf_counter() - t1) * 1e3)
                for k in ("loss_mask", "loss_dice"):
                    check(math.isfinite(float(out[k])), f"{k} {out[k]}")
                return out
            return run_step

        train_mod.make_train_step = timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            model, _, steps = train_mod.train(cfg, device=DEVICE)
        finally:
            train_mod.make_train_step = make_step
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        changed = {k for k, v in model.state_dict().items()
                   if not torch.equal(v.cpu(), initial[k])}
        check(bool(changed) and all(k.startswith(("bbox_attention.", "mask_head."))
                                    for k in changed),
              f"freeze_detr: updated {sorted(changed)[:5]}")
        line = json.loads((run / "metrics.jsonl").read_text())
        check(steps == M_TRAIN_FRAMES // int(cfg.batch_size) and all(
            isinstance(line.get(k), float) and math.isfinite(line[k])
            for k in ("AP", "AP50", "mota", "idf1")),
            f"train_mots20: {steps} steps, metrics {line}")
        ms = statistics.median(step_ms[1:])
        report.update(train_ms_per_step=ms, train_peak_gib=peak)
        log(f"  train(cfg) {' '.join(MOTS)}: {steps} steps of batch "
            f"{cfg.batch_size} in {wall:.1f} s with its evaluation and "
            f"tracking eval over {M_SEQ}; steps (ms, host clock, each ending "
            f"in its loss' copy): {' '.join(f'{t:.1f}' for t in step_ms)}; "
            f"median after the first {ms:.2f} ms; peak device memory "
            f"{peak:.2f} GiB; {len(changed)} mask-head tensors updated, the "
            f"detector unchanged; metrics {json.dumps(line)}")
        del model, initial
        torch.cuda.empty_cache()

        # M4: the tracking CLI on the run, its class heads calibrated
        seq = MOTS20Sequence(str(tmp / "data"), M_SEQ,
                             img_transform=cfg.img_transform)
        first = seq[0]
        hw = first["images"].shape[1:3]
        shift = calibrate_run(torch, run, first)
        out = tmp / "out"
        cmd = [sys.executable, "-c", CLI_RUNNER,
               f"obj_detect_checkpoint_dir={run}",
               f"data_root_dir={tmp / 'data'}", f"dataset_name={M_SEQ}",
               f"output_dir={out}", "tracker_cfg.steps_termination=3",
               "tracker_cfg.inactive_patience=0"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        text = proc.stdout
        check(proc.returncode == 0, f"the MOTS tracking CLI exited "
              f"{proc.returncode}:\n{text[-3000:]}\n{proc.stderr[-3000:]}")
        for ln in text.strip().splitlines()[:-1]:
            log(f"  | {ln}")
        child = json.loads(text.strip().splitlines()[-1])
        check(not any(child["launches"].values()),
              f"the MOTS CLI launched MSDA kernels: {child['launches']}")
        step_ms = child["step_ms"]
        hz = re.search(r"for (\d+) frames \(([\d.]+) Hz\)", text)
        check(hz is not None and int(hz.group(1)) == M_FRAMES,
              "no RUNTIME line for every frame")
        row = [ln for ln in text.splitlines() if ln.startswith(M_SEQ)]
        check(len(row) == 1, "no summary row")
        vals = [float(v) for v in row[0].split()[1:]]
        check(len(vals) == 7 and all(math.isfinite(v) for v in vals[:2]),
              f"summary row {row[0]!r}")
        lines = (out / M_SEQ / f"{M_SEQ}.txt").read_text().splitlines()
        check(bool(lines), "an empty MOTS result file")
        ids, pixels = set(), 0
        for ln in lines:
            frame, tid, cls, h, w, counts = ln.split(" ")
            mask = rle_to_mask(counts, (int(h), int(w)))
            check(cls == "2" and mask.shape == (int(h), int(w)) == tuple(hw),
                  f"result line {ln[:60]!r}: {mask.shape}, input {tuple(hw)}")
            ids.add(tid)
            pixels += int(mask.sum())
        check(pixels > 0, "every MOTS result mask is empty")
        loop_s = int(hz.group(1)) / float(hz.group(2))
        steady = (M_FRAMES - 1) / (loop_s - step_ms[0] / 1e3)
        report.update(cli_fps=steady, cli_step_ms=statistics.median(step_ms[1:]))
        log(f"  CLI (class-0 bias {shift:+.3f}, process {wall:.1f} s): "
            f"{len(lines)} MOTS result lines, {len(ids)} tracks, every mask "
            f"decoding to its stated {hw[0]}x{hw[1]} ({pixels} pixels in all; "
            f"the padded input size; "
            f"the sequence is {M_HW[0]}x{M_HW[1]}); MOTA {vals[0]:.3f} IDF1 "
            f"{vals[1]:.3f}; Tracker.step first frame {step_ms[0]:.1f} ms, "
            f"then median {report['cli_step_ms']:.3f} ms; {steady:.2f} "
            f"frames/s steady state, {hz.group(2)} on the RUNTIME line")
    return report


def phase_mots(torch, msda):
    """M1-M5 (see the module docstring). Returns (report, config (b)'s MSDA
    launches: forward over its served frames, backward in its step)."""
    rep = {}
    log("  M1. train_mots20 model: card vs CPU, f32, 256x448, two frames; "
        "one freeze_detr train step")
    mots_vs_cpu(torch, mots_cfg(dropout=0.0), (256, 448), {
        "pred_logits": (1e-3, 2e-3), "pred_boxes": (1e-3, 5e-4),
        "pred_masks": (1e-3, 5e-3), "mask_probs": (0.0, 1e-3)})
    step = mots_train_vs_cpu(torch, msda, mots_cfg(), (256, 448))
    check(bool(step["changed"]) and all(
        n.startswith(("bbox_attention.", "mask_head.")) for n in step["changed"]),
        f"freeze_detr updated {sorted(step['changed'])[:5]}")
    check(not any(step["bwd"].values()),
          f"the train_mots20 step launched MSDA kernels: {step['bwd']}")
    log(f"== M2. serving train_mots20: Tracker.step, bf16, "
        f"{MAIN_HW[0]}x{MAIN_HW[1]}, {N_FRAMES} frames")
    served = mots_served(torch, msda, mots_cfg(dropout=0.0), N_FRAMES, WARMUP,
                         vanilla=True)
    check(not any(served["launches"].values()),
          f"config (a) launched MSDA kernels: {served['launches']}")
    log(f"  MSDA launches on config (a): {served['launches']}")
    rep["a"] = {k: served[k] for k in ("ms", "mb_to_host", "peak_gib", "busy",
                                       "live")}
    log("== M3/M4. train(cfg) on train_mots20, then the tracking CLI on "
        f"{M_SEQ}")
    rep.update(mots_recipe_and_cli(torch, msda))
    log(f"== M5. the flagship with masks: card vs CPU, f32, "
        f"{M5_CPU_HW[0]}x{M5_CPU_HW[1]}; one train step; Tracker.step bf16 "
        f"{MAIN_HW[0]}x{MAIN_HW[1]}, {M5_FRAMES} frames")
    mots_vs_cpu(torch, deformable_masks_cfg(), M5_CPU_HW, {
        "pred_logits": (1e-3, 2e-3), "pred_boxes": (1e-3, 5e-4),
        "pred_masks": (1e-3, 5e-3), "mask_probs": (0.0, 1e-3)})
    step = mots_train_vs_cpu(torch, msda, deformable_masks_cfg(), M5_CPU_HW)
    check(step["bwd"]["msda_bwd"] > 0 and step["bwd"]["msda_raw_pool_bwd"] > 0,
          f"config (b)'s train step ran no MSDA backward kernel: {step['bwd']}")
    served = mots_served(torch, msda, deformable_masks_cfg(), M5_FRAMES, 1)
    fwd = served["launches"]
    for k, n in fwd.items():
        want = 6 * M5_FRAMES if k in ("msda_fwd", "msda_raw_pool_fwd") else 0
        check(n == want, f"config (b): {k} launched {n} times over "
              f"{M5_FRAMES} frames, expected {want}")
    log(f"  MSDA launches on config (b): {fwd} over {M5_FRAMES} frames (6 + 6 "
        f"a frame); its train step: {step['bwd']}")
    rep["b"] = {k: served[k] for k in ("ms", "mb_to_host", "peak_gib", "busy",
                                       "live")}
    launches = {k: v for k, v in fwd.items() if "bwd" not in k}
    launches.update({k: v for k, v in step["bwd"].items() if "bwd" in k})
    return rep, launches


# ---------------------------------------------------------------------------
# phase V: the encoder's MSDA variants, two-stage and merge_frame_features

V_FRAMES = 8
# the served flagship with one encoder variant at a time: (overrides, the
# forward launches a frame; the decoder's raw pool 6 in each). top-k 3
# prunes the five high-level Lite layers (L * P = 4); the low-level one
# (L * P = 2 <= 3) stays exact
V_VARIANTS = {
    "enc_msda_int8": (dict(enc_msda_int8=True, allow_lossy=True),
                      {"msda_fwd_i8": 6}),
    "enc_msda_topk": (dict(enc_msda_topk=3, allow_lossy=True),
                      {"msda_topk_fwd": 5, "msda_fwd": 1}),
    "enc_msda_shared_locs": (dict(enc_msda_shared_locs=True),
                             {"msda_shared_fwd": 6}),
}
# the variants whose encoder calls V2 replays, and their kernel
V_REPLAYED = {"enc_msda_int8": "msda_fwd_i8",
              "enc_msda_topk": "msda_topk_fwd",
              "enc_msda_shared_locs": "msda_shared_fwd"}
# a train step's launches (phase 7's count): previous frame, current frame
# and the remat recomputation forward, the current frame backward
V_TRAIN_LAUNCHES = {
    "enc_msda_topk": {"msda_topk_fwd": 15, "msda_fwd": 3, "msda_bwd": 6},
    "enc_msda_shared_locs": {"msda_shared_fwd": 18, "msda_bwd": 6},
}
V_TRAIN_STEPS = 3
V_CPU_HW = (256, 448)
V_EVAL_FRAMES = 3


def variant_case(torch, msda, gen, name, kind, shapes, lq, p, dtype, k=None):
    """One variant kernel at one shape and dtype against its plain version:
    errors, device times of both, and the bound of this run's inputs (only
    the kept samples' corners for top-k; whole rows for shared locations)."""
    b, m, d = 1, 8, 36
    s = sum(h * w for h, w in shapes)
    l = len(shapes)
    dev = gen.device
    loc, aw = make_samples(torch, gen, b, lq, m, shapes, p)
    n_samples = b * lq * m * l * p
    esize = 1 if kind == "i8" else torch.finfo(dtype).bits // 8
    out_bytes = b * lq * m * d * 4
    if kind == "i8":
        q8 = torch.randint(-127, 128, (b, s, m, d), generator=gen, device=dev,
                           dtype=torch.int8)
        # the model rounds the scale to the value's type (bf16 here)
        scale = (torch.rand(b, m, generator=gen, device=dev) * 0.05).to(dtype)
        args = (q8, scale, shapes, loc, aw)
        run_k = lambda: msda.ms_deform_attn_i8(*args)  # noqa: E731
        run_p = lambda: msda.ms_deform_attn_i8_plain(*args)  # noqa: E731
        st = read_stats(torch, "msda", loc, shapes, None, d, esize)
        moved = st["distinct"] * d + n_samples * 12 + b * m * 4 + out_bytes
        flops = st["corners"] * d * 2 + n_samples * 20
    elif kind == "topk":
        value = torch.randn(b, s, m, d, generator=gen, device=dev).to(dtype)
        args = (value, shapes, loc, aw, k)
        run_k = lambda: msda.ms_deform_attn_topk(*args)  # noqa: E731
        run_p = lambda: msda.ms_deform_attn_topk_plain(*args)  # noqa: E731
        keep = msda.topk_sample_mask(aw, k)
        st = read_stats(torch, "msda", loc, shapes, None, d, esize, keep=keep)
        run_fwd = lambda: msda.ms_deform_attn(value, shapes, loc, aw)  # noqa: E731
        kept = int(keep.sum())
        # every weight read, the kept samples' locations read
        moved = st["distinct"] * d * esize + n_samples * 4 + kept * 8 + \
            out_bytes
        flops = st["corners"] * d * 2 + kept * 20 + b * lq * m * (l * p) ** 2
    else:
        value = torch.randn(b, s, m, d, generator=gen, device=dev).to(dtype)
        loc = loc[:, :, 0].contiguous()
        args = (value, shapes, loc, aw)
        run_k = lambda: msda.ms_deform_attn_shared(*args)  # noqa: E731
        run_p = lambda: msda.ms_deform_attn_shared_plain(*args)  # noqa: E731
        # a corner is a whole row of M * D channels, read once for all heads
        st = read_stats(torch, "raw", loc[:, :, None], shapes, None, m * d,
                        esize)
        moved = st["distinct"] * m * d * esize + b * lq * l * p * 8 + \
            n_samples * 4 + out_bytes
        flops = st["corners"] * m * d * 2 + n_samples * 20
    with torch.no_grad():
        out = run_k()
        torch.cuda.synchronize()
        ref = run_p()
        # both sum f32 products of the same values in another order
        assert_close(torch, f"{name} {dtype}", out, ref, 1e-4, 1e-5)
        err = errors(torch, out, ref)
        t_b, by = bound_ms(moved, flops)
        timed = time_kernel(torch, run_k, run_p)
        if kind == "topk":
            timed["fwd_ms"] = device_ms(torch, run_fwd)
    log(f"  {name:<28} {str(dtype):<15} max abs err {err[0]:.3e} | "
        f"{timed_text(timed)} bound {t_b:.4f} ms ({by}: {moved / 1e6:.1f} MB, "
        f"{flops / 1e6:.1f} Mflop)")
    if kind == "topk":
        ratio = timed["ms"] / timed["fwd_ms"]
        log(f"      msda_fwd on the same inputs, every sample kept: "
            f"{timed['fwd_ms']:.4f} ms device ({ratio:.3f}x)")
    log(f"      {stats_text(st, timed['ms'])}")
    return dict(err=err[0], bound_ms=t_b, bound_by=by, **timed)


def variant_grad_case(torch, msda, gen, kind, shapes, lq, p):
    """The top-k or shared-locations wrapper's gradients (its backward
    launches msda_bwd) against autograd through the plain version, f32."""
    b, m, d = 1, 8, 36
    s = sum(h * w for h, w in shapes)
    dev = gen.device
    loc, aw = make_samples(torch, gen, b, lq, m, shapes, p)
    if kind == "shared":
        loc = loc[:, :, 0].contiguous()
        fns = (lambda v, lc, a: msda.ms_deform_attn_shared(v, shapes, lc, a),
               lambda v, lc, a: msda.ms_deform_attn_shared_plain(v, shapes,
                                                                 lc, a))
    else:
        fns = (lambda v, lc, a: msda.ms_deform_attn_topk(v, shapes, lc, a, 3),
               lambda v, lc, a: msda.ms_deform_attn_topk_plain(v, shapes, lc,
                                                               a, 3))
    value = torch.randn(b, s, m, d, generator=gen, device=dev)
    cot = torch.randn(b, lq, m * d, generator=gen, device=dev)
    grads = []
    before = msda.ms_deform_attn.bwd_launches
    for fn in fns:
        ins = [t.detach().clone().requires_grad_(True) for t in (value, loc, aw)]
        grads.append(torch.autograd.grad(fn(*ins), ins, cot))
    check(msda.ms_deform_attn.bwd_launches == before + 1,
          f"{kind}: the backward launched msda_bwd "
          f"{msda.ms_deform_attn.bwd_launches - before} times, expected 1")
    # as phase 3b: dloc and daw sum dot products in another order
    pairs = []
    for label, g, r in zip(("dvalue", "dloc", "daw"), *grads):
        atol = max(1e-5, 1e-5 * r.abs().max().item())
        pairs.append((label, g, r, 1e-3 if label == "dloc" else 1e-4, atol))
    err = grad_errors(torch, f"{kind} backward", pairs)
    log(f"  {kind} backward (msda_bwd) vs plain autograd: max abs err "
        f"{err:.3e}")
    return err


def phase_variant_kernels(torch, msda):
    """V1: the three variant kernels against their plain versions at the
    flagship's encoder shapes and a generic (4, 4); then the gradients."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    high = (LEVELS[:2], sum(h * w for h, w in LEVELS[1:]), 2)
    low = (LEVELS[:1], LEVELS[0][0] * LEVELS[0][1], 2)
    generic = (LEVELS, 4000, 4)
    cases = [
        # (kernel, name, kind, (shapes, Lq, P), k, launches a served frame)
        ("msda_fwd_i8", "msda_fwd_i8 high-lite", "i8", high, None, 5),
        ("msda_fwd_i8", "msda_fwd_i8 low-lite", "i8", low, None, 1),
        ("msda_fwd_i8", "msda_fwd_i8 (4, 4)", "i8", generic, None, 0),
        ("msda_topk_fwd", "msda_topk_fwd high-lite k=3", "topk", high, 3, 5),
        ("msda_topk_fwd", "msda_topk_fwd (4, 4) k=8", "topk", generic, 8, 0),
        ("msda_shared_fwd", "msda_shared_fwd high-lite", "shared", high, None,
         5),
        ("msda_shared_fwd", "msda_shared_fwd low-lite", "shared", low, None, 1),
        ("msda_shared_fwd", "msda_shared_fwd (4, 4)", "shared", generic, None,
         0),
    ]
    results = {}
    for kernel, name, kind, (shapes, lq, p), k, per_frame in cases:
        for dtype in (torch.float32, torch.bfloat16):
            r = variant_case(torch, msda, gen, name, kind, shapes, lq, p,
                             dtype, k)
            results.setdefault(kernel, []).append((dtype, per_frame, r))
    # times: the bf16 cases' mean a launch over a served frame's mix (the
    # (4, 4) cases weigh 0); errors: every case's worst
    summary = kernel_summary(torch, results)
    for kind, kernel in (("topk", "msda_topk_fwd"), ("shared", "msda_shared_fwd")):
        err = variant_grad_case(torch, msda, gen, kind, *high)
        summary[kernel]["grad_max_abs_err"] = err
    return summary


def phase_variants_served(torch, msda):
    """V2: each encoder variant on the served flagship through Tracker.step
    (V_FRAMES frames, 800x1440, bf16); then a replay of the next frame's
    encoder calls of the variant's kernel (kernel vs plain on the snapped
    samples, device ms and reads on the frame's own samples). Returns
    ({kernel: launches over its variant's served frames}, {name: mean
    replay device ms a launch})."""
    served, replay = {}, {}
    for name, (over, per_frame) in V_VARIANTS.items():
        tracker, model, frames = served_tracker(torch, flagship_cfg().replace(
            **over))
        reset_all_launches(msda)
        times, active = timed_frames(torch, tracker, frames[:V_FRAMES])
        launches = read_all_launches(msda)
        want = {"msda_raw_pool_fwd": 6, **per_frame}
        for k, n in launches.items():
            check(n == want.get(k, 0) * V_FRAMES,
                  f"{name}: {k} launched {n} times over {V_FRAMES} frames, "
                  f"expected {want.get(k, 0)} a frame")
        n_boxes = sum(len(f) for f in tracker.get_results().values())
        check(max(active[WARMUP:]) > 0 and n_boxes > 0,
              f"{name}: no track was active")
        med = statistics.median(times[WARMUP:])
        log(f"  {name}: {med:.3f} ms/frame (median after {WARMUP} warm-up "
            f"frames; {' '.join(f'{t:.1f}' for t in times)}); launches a "
            f"frame { {k: n / V_FRAMES for k, n in launches.items() if n} }; "
            f"{n_boxes} result boxes")
        for k in per_frame:
            if k != "msda_fwd":
                served[k] = launches[k]
        if name in V_REPLAYED:
            kernel = V_REPLAYED[name]
            calls = record_forward_calls(
                torch, lambda: tracker.step(frames[V_FRAMES]))
            kinds = [k for k, _ in calls]
            check({k: kinds.count(k) for k in kinds} == want,
                  f"{name}: a frame made the forward MSDA calls {kinds}, "
                  f"expected {want}")
            log(f"  replay of one {name} frame's {want[kernel]} {kernel} "
                f"calls (bf16 memory; compared on locations snapped to a "
                f"2^-16 grid):")
            replay.update(phase_replay(
                torch, msda, [c for c in calls if c[0] == kernel]))
            del calls
        del tracker, model, frames
        torch.cuda.empty_cache()
    return served, replay


def phase_variants_train(torch, msda):
    """V2 (training): one bf16 remat train step at phase 7's size with
    top-k and with shared locations; their backward runs msda_bwd."""
    from kinet_tpu_torch.engine.state import Optimizer
    from kinet_tpu_torch.engine.train_step import make_train_step
    from kinet_tpu_torch.models.build import build_criterion, build_model

    for name, want in V_TRAIN_LAUNCHES.items():
        cfg = flagship_cfg().replace(compute_dtype="bfloat16", remat=True,
                                     dropout=0.1, **V_VARIANTS[name][0])
        t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
        model, _ = build_model(cfg, device=DEVICE, seed=5)
        model.train()
        step = make_train_step(model, build_criterion(cfg),
                               Optimizer(model, cfg), cfg)
        frames = train_frames(torch, 6, *TRAIN_HW, TRAIN_OBJECTS, t_slots,
                              hidden, DEVICE)
        step(*frames)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(V_TRAIN_STEPS):
            reset_all_launches(msda)
            t0 = time.perf_counter()
            out = step(*frames)
            loss, norm = float(out["loss"]), float(out["grad_norm"])
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        launches = read_all_launches(msda)
        check(loss == loss and abs(loss) < 1e6 and norm == norm
              and abs(norm) < 1e9, f"{name} train step: loss {loss}, "
              f"gradient norm {norm}")
        check(all(torch.isfinite(p.grad).all() for p in model.parameters()
                  if p.grad is not None), f"{name}: a gradient is not finite")
        want = {"msda_raw_pool_fwd": 12, "msda_raw_pool_bwd": 6, **want}
        for k, n in launches.items():
            check(n == want.get(k, 0), f"{name} train step: {k} launched {n} "
                  f"times, expected {want.get(k, 0)}")
        log(f"  {name} train step (bf16, remat, {TRAIN_HW[0]}x{TRAIN_HW[1]}): "
            f"{ms:.1f} ms (median of {V_TRAIN_STEPS} after a warm-up: "
            f"{' '.join(f'{t:.1f}' for t in times)}), last loss {loss:.4f}, "
            f"gradient norm {norm:.4f}, launches a step {launches}")
        del model, step, frames
        torch.cuda.empty_cache()


def two_stage_cfg():
    """train.yaml + train_deformable + two_stage with box refinement:
    upstream Deformable DETR's two-stage recipe (hidden 256, 8 heads, 6 + 6
    layers, 300 proposals, 4 levels of 4 points)."""
    from kinet_tpu_torch.config import load_config

    return load_config("train.yaml", named=["train_deformable"]).replace(
        dataset="mot", two_stage=True, with_box_refine=True, dropout=0.0)


def card_vs_cpu(torch, cfg, hw, two_stage):
    """cfg's model on the card against the same weights on the CPU, f32, over
    two chained frames (the second given the first's features). Two-stage:
    the card keeps the CPU's proposal choice (recorded on the CPU), whose
    scores can tie within the f32 rounding of the two devices."""
    import numpy as np

    from kinet_tpu_torch.models import deformable_transformer as dt
    from kinet_tpu_torch.models.build import build_model

    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    picked, overlap = [], []
    topk = dt.descending_topk
    outs = {}
    for dev in ("cpu", DEVICE):
        model, _ = build_model(cfg, device=dev, seed=0)
        rng = np.random.default_rng(5)
        frames = [model_inputs(torch, rng, *hw, t_slots, hidden, 20, dev)
                  for _ in range(2)]

        def choose(score, k):
            own = topk(score, k)
            if dev == "cpu":
                picked.append(own)
                return own
            ref = picked[len(overlap)].to(score.device)
            overlap.append(len(set(own.flatten().tolist())
                               & set(ref.flatten().tolist())) / own.numel())
            return ref

        dt.descending_topk = choose
        try:
            with torch.inference_mode():
                o1 = model(*frames[0])
                o2 = model(*frames[1], prev_features=o1["frame_features"])
        finally:
            dt.descending_topk = topk
        keys = ("pred_logits", "pred_boxes", "hs_embed")
        outs[dev] = []
        for o in (o1, o2):
            row = {k: o[k].float().cpu() for k in keys}
            if two_stage:
                row.update({f"enc_{k}": o["enc_outputs"][k].float().cpu()
                            for k in ("pred_logits", "pred_boxes")})
            outs[dev].append(row)
        del model, o1, o2
    torch.cuda.empty_cache()
    # f32, TF32 off, as phase 4: sums in another order through the backbone
    # and the transformer
    tol = {"pred_logits": (1e-3, 2e-3), "pred_boxes": (1e-3, 5e-4),
           "hs_embed": (1e-3, 2e-3), "enc_pred_logits": (1e-3, 2e-3),
           "enc_pred_boxes": (1e-3, 5e-4)}
    for f in range(2):
        for k in outs["cpu"][f]:
            a, r = outs[DEVICE][f][k], outs["cpu"][f][k]
            check(bool(torch.isfinite(a).all()), f"frame {f} {k} not finite")
            log(f"  frame {f} {k:<16} {tuple(a.shape)} max abs err "
                f"{(a - r).abs().max().item():.3e} (rtol {tol[k][0]}, atol "
                f"{tol[k][1]})")
            assert_close(torch, f"frame {f} {k}", a, r, *tol[k])
    if overlap:
        log(f"  the card's own proposal choice shares "
            f"{', '.join(f'{100 * x:.2f}%' for x in overlap)} of the CPU's")


def phase_two_stage(torch, msda):
    """V3: two-stage card vs CPU, train(cfg) a few steps on a synthetic MOT
    tree, evaluate() on 1080x1920 frames; the host LSAP over the encoder's
    proposals timed."""
    from kinet_tpu_torch.data.builder import build_dataset
    from kinet_tpu_torch.engine import evaluate as eval_mod
    from kinet_tpu_torch.engine import train as train_mod
    from kinet_tpu_torch.models.build import build_criterion, build_model
    from kinet_tpu_torch.models.postprocess import build_postprocessors

    cfg = two_stage_cfg()
    card_vs_cpu(torch, cfg, V_CPU_HW, True)
    seen = []
    make_step = train_mod.make_train_step

    def recording(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args, **kws):
            losses = step(*args, **kws)
            seen.append({k: float(v) for k, v in losses.items()})
            return losses
        return run

    train_mod.make_train_step = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            write_mot_dataset(root / "mot")
            t0 = time.perf_counter()
            train_mod.train(cfg.replace(
                mot_path_train=str(root / "mot"), mot_path_val=str(root / "mot"),
                output_dir=str(root / "out"), epochs=1, val_interval=0,
                compute_dtype="bfloat16"), device=DEVICE)
            train_s = time.perf_counter() - t0
    finally:
        train_mod.make_train_step = make_step
    enc = sorted(k for k in seen[-1] if k.endswith("_enc"))
    check(len(seen) >= 2 and {"loss_ce_enc", "loss_bbox_enc",
                              "loss_giou_enc"} <= set(enc),
          f"train(cfg) steps {len(seen)}, encoder losses {enc}")
    check(all(v == v and abs(v) < 1e6 for s in seen for v in s.values()),
          "a non-finite training loss")
    log(f"  train(cfg) two-stage (bf16, 360x640 frames): {len(seen)} steps in "
        f"{train_s:.1f} s with the model build; last step's encoder losses "
        + ", ".join(f"{k} {seen[-1][k]:.4f}" for k in enc))

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "mot"
        write_mot_val_tree(root, V_EVAL_FRAMES, *T_HW)
        ecfg = cfg.replace(mot_path_val=str(root), size_buckets=[[800, 1440]],
                           **T_TRANSFORM)
        model, _ = build_model(ecfg, device=DEVICE, seed=2)
        model.to(torch.bfloat16)
        criterion, post = build_criterion(ecfg), build_postprocessors(ecfg)
        match = criterion.match
        spans = []

        def timed_match(outputs, targets):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            q4t = match(outputs, targets)
            spans.append((outputs["pred_logits"].shape[1],
                          time.perf_counter() - t1))
            return q4t

        criterion.match = timed_match
        dataset = build_dataset("val", ecfg)
        t0 = time.perf_counter()
        stats = eval_mod.evaluate(model, criterion, post, dataset, ecfg,
                                  device=DEVICE)
        eval_s = time.perf_counter() - t0
    coco = stats["coco_eval_bbox"]
    check(len(coco) == 12 and all(v == v for v in coco), f"stats {coco}")
    enc_spans = [t for q, t in spans if q > int(cfg.num_queries)]
    tokens = max(q for q, _ in spans)
    check(bool(enc_spans), "the criterion matched no encoder proposals")
    log(f"  evaluate() two-stage: {V_EVAL_FRAMES} frames {T_HW[0]}x{T_HW[1]} "
        f"(800x1422 after the val transform) in {eval_s:.2f} s, "
        f"{1e3 * eval_s / V_EVAL_FRAMES:.1f} ms a frame; AP {coco[0]:.4f}")
    log(f"  the criterion's match over the {tokens} encoder proposals (cost "
        f"on the card, LSAP on the host): "
        f"{1e3 * statistics.median(enc_spans):.2f} ms a batch (median of "
        f"{len(enc_spans)}), the decoder layers' "
        f"{1e3 * statistics.median([t for q, t in spans if q <= int(cfg.num_queries)]):.2f}"
        f" ms a layer")
    del model
    torch.cuda.empty_cache()


def phase_merge(torch, msda):
    """V4: merge_frame_features on the flagship (without cache_prev_encoder,
    which it excludes): card vs CPU, then Tracker.step."""
    cfg = flagship_cfg().replace(merge_frame_features=True,
                                 cache_prev_encoder=False)
    card_vs_cpu(torch, cfg, V_CPU_HW, False)
    tracker, model, frames = served_tracker(torch, cfg)
    reset_all_launches(msda)
    times, active = timed_frames(torch, tracker, frames[:V_FRAMES])
    launches = read_all_launches(msda)
    # both frames' halves are encoded every frame: 2 x 6 encoder launches
    want = {"msda_fwd": 12, "msda_raw_pool_fwd": 6}
    for k, n in launches.items():
        check(n == want.get(k, 0) * V_FRAMES,
              f"merge: {k} launched {n} times over {V_FRAMES} frames")
    check(max(active[WARMUP:]) > 0, "merge: no track was active")
    med = statistics.median(times[WARMUP:])
    log(f"  merge_frame_features: {med:.3f} ms/frame (median after {WARMUP} "
        f"warm-up frames; {' '.join(f'{t:.1f}' for t in times)}); launches "
        f"a frame { {k: n / V_FRAMES for k, n in launches.items() if n} }")
    del tracker, model, frames
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase H: the host tools (the importer, track_param_search, write_images)


# around the saved run's calibration: 0.4 keeps about 7 new detections a
# frame (phase T); the best combination by MOTA must track frame 0, whose
# image phase H checks (at 0.5 the run's best kept one late track)
H_GRID = {"detection_obj_score_thresh": [0.3, 0.4],
          "track_obj_score_thresh": [0.3, 0.4]}
# the track config's overrides of phase T's CLI run
H_TRACK_OVER = {"tracker_cfg.steps_termination": 3,
                "tracker_cfg.inactive_patience": 0}
# phase 4's tolerances: f32 on both devices, TF32 off
MODEL_TOL = {"pred_logits": (1e-3, 2e-3), "pred_boxes": (1e-3, 5e-4),
             "hs_embed": (1e-3, 2e-3)}

H_CLI_RUNNER = """
import json, runpy, sys, time
from kinet_tpu_torch.ops import msda
from kinet_tpu_torch.utils import mot_metrics, vis
msda.ms_deform_attn.launches = 0
msda.ms_deform_attn_raw_pool.launches = 0
msda.ms_deform_attn_raw_pool.i8_launches = 0
write_ms, frame0, summary = [], [], {}
plot = vis.plot_sequence
def timed_plot(results, seq, output_dir, write_images="pretty"):
    frame0.extend([int(t), [float(v) for v in tr[0]["bbox"]]]
                  for t, tr in results.items() if 0 in tr)
    t0 = time.perf_counter()
    plot(results, seq, output_dir, write_images=write_images)
    write_ms.append((time.perf_counter() - t0) * 1e3)
vis.plot_sequence = timed_plot
evaluate = mot_metrics.evaluate_mot_accums
def captured(*args, **kwargs):
    out = evaluate(*args, **kwargs)
    summary.update(out)
    return out
mot_metrics.evaluate_mot_accums = captured
sys.argv = ["kinet_tpu_torch.engine.track"] + sys.argv[1:]
runpy.run_module("kinet_tpu_torch.engine.track", run_name="__main__",
                 alter_sys=True)
print(json.dumps({"launches": {
    "msda_fwd": msda.ms_deform_attn.launches,
    "msda_raw_pool_fwd": msda.ms_deform_attn_raw_pool.launches,
    "msda_raw_pool_fwd_i8": msda.ms_deform_attn_raw_pool.i8_launches,
}, "write_ms": write_ms, "frame0": frame0, "summary": summary},
    default=float))
"""


def ref_state_dict_module():
    """tests/_ref_state_dict.py: writes a port model's tensors under a
    reference checkpoint's names (not part of the package)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "_ref_state_dict.py"
    spec = importlib.util.spec_from_file_location("_ref_state_dict", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nan_model(torch, cfg, device, seed):
    """A port model of ``cfg`` whose floating tensors are all NaN (its
    other tensors stay), so a tensor an import leaves unwritten shows."""
    from kinet_tpu_torch.models.build import build_model

    model, post = build_model(cfg, device=device, seed=seed)
    with torch.no_grad():
        for t in itertools.chain(model.parameters(), model.buffers()):
            if t.is_floating_point():
                t.fill_(float("nan"))
    return model, post


def strict_import(torch, sd, model, cfg):
    """The importer under strict into ``model``; checks its report."""
    import warnings

    from kinet_tpu_torch.tools.import_torch_weights import import_state_dict

    with warnings.catch_warnings():  # the msda_ref_normalizer notice
        warnings.simplefilter("ignore")
        _, report = import_state_dict(sd, model, nheads=int(cfg.nheads),
                                      strict=True)
    n = len(model.state_dict())
    check(report["unmapped"] == [] and report["applied"] == n,
          f"strict import: applied {report['applied']} of {n} tensors, "
          f"unmapped {report['unmapped'][:5]}")
    return report


def phase_tools_import(torch, msda):
    """(a): the reference-named state dict of a seeded full-width flagship
    (class heads biased to class 0) imported strictly into another port
    model on the card, then card vs CPU on one f32 frame, the served
    frames and one frame's calls vs the plain versions. Returns
    (launches over the served frames, median ms a frame, {kernel: {dtype:
    max abs err}})."""
    import numpy as np

    from kinet_tpu_torch.models.build import build_model
    from kinet_tpu_torch.tracking.tracker import Tracker

    cfg = flagship_cfg()
    src, _ = build_model(cfg, device=DEVICE, seed=5)
    bias_to_person(torch, src, cfg)
    t0 = time.perf_counter()
    sd = ref_state_dict_module().reference_state_dict(src)
    write_s = time.perf_counter() - t0
    model, post = nan_model(torch, cfg, DEVICE, seed=6)
    t0 = time.perf_counter()
    report = strict_import(torch, sd, model, cfg)
    import_s = time.perf_counter() - t0
    want = src.state_dict()
    for k, v in model.state_dict().items():
        check(torch.equal(v, want[k]), f"imported {k} is not the source's")
    del src, want
    log(f"  reference state dict: {len(sd)} tensors, "
        f"{sum(v.numel() for v in sd.values()) / 1e6:.2f} M values, written "
        f"in {write_s:.2f} s; strict import on the card: {report['applied']} "
        f"port tensors (every parameter and buffer, bit for bit the source's), "
        f"0 unmapped, in {import_s:.2f} s")

    # one f32 frame against the CPU on the same imported weights
    cpu, _ = nan_model(torch, cfg, "cpu", seed=6)
    strict_import(torch, sd, cpu, cfg)
    t_slots, hidden = int(cfg.max_track_queries), int(cfg.hidden_dim)
    outs = {}
    for dev, m in (("cpu", cpu), (DEVICE, model)):
        inputs = model_inputs(torch, np.random.default_rng(5), 256, 448,
                              t_slots, hidden, 20, dev)
        with torch.inference_mode():
            o = m(*inputs)
        outs[dev] = {k: o[k].float().cpu() for k in MODEL_TOL}
    del cpu, sd
    for k, (rtol, atol) in MODEL_TOL.items():
        a, r = outs[DEVICE][k], outs["cpu"][k]
        check(bool(torch.isfinite(a).all()), f"imported {k} not finite")
        log(f"  f32 256x448 {k:<12} {tuple(a.shape)} card vs CPU max abs err "
            f"{(a - r).abs().max().item():.3e} (rtol {rtol}, atol {atol})")
        assert_close(torch, f"imported model {k}", a, r, rtol, atol)

    # phase 5's served frames on the imported weights
    model.to(torch.bfloat16)
    frames = list(moving_boxes(np, *MAIN_HW, N_FRAMES + 1))
    cand = class0_scores(torch, model, post["bbox"], frames[0], t_slots)
    thresh = cand[min(7, cand.numel() - 1)].item()
    tracker = Tracker(model, post["bbox"], served_tracker_cfg(thresh),
                      **tracker_kwargs(cfg))
    torch.cuda.synchronize()
    reset_launches(msda)
    times, active = timed_frames(torch, tracker, frames[:N_FRAMES])
    launches = read_launches(msda)
    med = statistics.median(times[WARMUP:])
    log(f"  served frames on the imported weights (thresholds {thresh:.5f}): "
        f"{' '.join(f'{t:.2f}' for t in times)} ms; median {med:.3f} ms a "
        f"frame after {WARMUP}; active track slots {active}")
    log(f"  launches over {N_FRAMES} frames: {launches}")
    for k, n in launches.items():
        want_n = 6 * N_FRAMES if k in ("msda_fwd", "msda_raw_pool_fwd") else 0
        check(n == want_n, f"{k} launched {n} times on the imported weights, "
              f"expected {want_n}")
    n_boxes = 0
    for per_frame in tracker.get_results().values():
        for r in per_frame.values():
            check(bool(np.isfinite(r["bbox"]).all()), "non-finite result box")
            n_boxes += 1
    check(n_boxes > 0 and max(active[WARMUP:]) > 0,
          "the imported weights tracked nothing")
    calls = record_forward_calls(torch,
                                 lambda: tracker.step(frames[N_FRAMES]))
    kinds = [k for k, _ in calls]
    check(kinds.count("msda_fwd") == 6
          and kinds.count("msda_raw_pool_fwd") == 6 and len(kinds) == 12,
          f"a frame made the forward MSDA calls {kinds}, expected 6 + 6")
    errs = p_check_calls(torch, msda, calls, False)
    log(f"  one frame's calls vs the plain versions (each kernel, query "
        f"count and levels once): {json.dumps(errs)}")
    del tracker, model, calls
    torch.cuda.empty_cache()
    return launches, med, errs


def h_write_check(np, out_dir: Path, frame0, src_jpg: Path):
    """Frame 0's image: byte-equal to the source frame drawn again with
    the CLI's frame-0 tracks, and the largest box's top edge (the middle
    half of its width) nearer its track's palette colour than the source
    frame's pixels there are. Returns (track id, edge colour)."""
    import io

    from PIL import Image

    from kinet_tpu_torch.utils.vis import PALETTE, draw_boxes

    written = (out_dir / "000000.jpg").read_bytes()
    img = np.asarray(Image.open(src_jpg).convert("RGB"))
    for tid, box in frame0:
        img = draw_boxes(img, [box], tuple(int(c) for c in
                                           PALETTE[tid % len(PALETTE)]))
    again = io.BytesIO()
    Image.fromarray(img).save(again, format="JPEG")
    check(again.getvalue() == written,
          "frame 0's image is not the frame drawn with the CLI's tracks")
    check(len(frame0) > 0, "no track in frame 0")
    tid, box = max(frame0, key=lambda tb: (tb[1][2] - tb[1][0])
                   * (tb[1][3] - tb[1][1]))
    h, w = img.shape[:2]
    x0, y0, x1 = (int(np.clip(round(v), 0, lim - 1))
                  for v, lim in ((box[0], w), (box[1], h), (box[2], w)))
    q = max((x1 - x0) // 4, 0)
    rows, cols = slice(max(y0 - 1, 0), y0 + 1), slice(x0 + q, x1 - q + 1)
    got = np.asarray(Image.open(out_dir / "000000.jpg").convert("RGB"))
    src = np.asarray(Image.open(src_jpg).convert("RGB"))
    edge = np.median(got[rows, cols].reshape(-1, 3).astype(float), axis=0)
    before = np.median(src[rows, cols].reshape(-1, 3).astype(float), axis=0)
    colour = PALETTE[tid % len(PALETTE)]
    check(np.linalg.norm(edge - colour) < np.linalg.norm(before - colour),
          f"track {tid}'s top edge {edge} is not nearer its colour {colour} "
          f"than the source's {before}")
    return tid, edge


def phase_tools_search(torch, msda):
    """(b) and (c): track_param_search on phase T's saved run, then the
    tracking CLI with the best combination and write_images. Returns
    ({kernel: launches of H's main_track runs}, seconds a combination,
    the CLI's write ms a frame, its RUNTIME ms a frame)."""
    import math
    import re

    import numpy as np

    from kinet_tpu_torch.config import load_config, save_config
    from kinet_tpu_torch.data.sequences import MOT17Sequence
    from kinet_tpu_torch.tools import track_param_search as tps
    from kinet_tpu_torch.utils.checkpoint import CheckpointManager

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_mot17_sequence(tmp / "data", T_FRAMES, *T_HW)
        cfg = flagship_cfg().replace(dec_msda_int8=True, allow_lossy=True,
                                     **T_TRANSFORM)
        seq = MOT17Sequence(str(tmp / "data"), "MOT17-02", "FRCNN",
                            img_transform=cfg.img_transform)
        model, shift = calibrated_model(torch, cfg, seq[0])
        run = tmp / "run"
        save_config(cfg, run)
        CheckpointManager(str(run)).save_epoch(
            model, torch.optim.SGD(model.parameters(), lr=0.0), 0, 0)
        del model
        torch.cuda.empty_cache()
        log(f"  phase T's sequence and saved run (class-0 bias {shift:+.3f}) "
            f"in {time.perf_counter() - t0:.1f} s")

        track_cfg = load_config("track.yaml").replace(
            obj_detect_checkpoint_dir=str(run), data_root_dir=str(tmp / "data"),
            dataset_name=T_SEQ, output_dir=str(tmp / "search"),
            **H_TRACK_OVER)
        seconds = []
        main_track = tps.main_track

        def timed_main_track(run_cfg):
            t1 = time.perf_counter()
            out = main_track(run_cfg)
            seconds.append(time.perf_counter() - t1)
            return out

        reset_launches(msda)
        tps.main_track = timed_main_track
        try:
            results = tps.search(track_cfg, H_GRID)
        finally:
            tps.main_track = main_track
        launches = read_launches(msda)
        n_combos = math.prod(len(v) for v in H_GRID.values())
        check(results is not None and len(results) == n_combos,
              f"the search gave {results}")
        for r, s in zip(results, seconds):
            check(math.isfinite(r["mota"]) and math.isfinite(r["idf1"]),
                  f"combination {r}")
            log(f"  combination {r}: {s:.2f} s")
        best = max(results, key=lambda r: r["mota"])
        log(f"  best {best}; {statistics.mean(seconds):.2f} s a combination "
            f"({T_FRAMES} frames and the checkpoint's restore each); "
            f"launches over the search: {launches}")
        for k, n in launches.items():
            want = (6 * T_FRAMES * n_combos
                    if k in ("msda_fwd", "msda_raw_pool_fwd_i8") else 0)
            check(n == want, f"the search launched {k} {n} times, expected "
                  f"{want}")

        out = tmp / "cli"
        cmd = [sys.executable, "-c", H_CLI_RUNNER,
               f"obj_detect_checkpoint_dir={run}",
               f"data_root_dir={tmp / 'data'}", f"dataset_name={T_SEQ}",
               f"output_dir={out}", "write_images=pretty"] + [
            f"{k}={v}" for k, v in H_TRACK_OVER.items()] + [
            f"tracker_cfg.{k}={best[k]}" for k in H_GRID]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=900)
        wall = time.perf_counter() - t0
        text = proc.stdout
        check(proc.returncode == 0, f"the tracking CLI exited "
              f"{proc.returncode}:\n{text[-3000:]}\n{proc.stderr[-3000:]}")
        for line in text.strip().splitlines()[:-1]:
            log(f"  | {line}")
        child = json.loads(text.strip().splitlines()[-1])
        summary = child["summary"]
        overall = summary.get("OVERALL") or next(iter(summary.values()))
        check(overall["mota"] == best["mota"]
              and overall["idf1"] == best["idf1"],
              f"the CLI's MOTA {overall['mota']} IDF1 {overall['idf1']} are "
              f"not the search's {best['mota']} {best['idf1']}")
        for k, n in child["launches"].items():
            want = 0 if k == "msda_raw_pool_fwd" else 6 * T_FRAMES
            check(n == want, f"the CLI launched {k} {n} times, expected {want}")
            launches[k] += n
        img_dir = out / T_SEQ / T_SEQ
        names = sorted(p.name for p in img_dir.iterdir())
        check(names == [f"{i:06d}.jpg" for i in range(T_FRAMES)],
              f"written images {names}")
        tid, edge = h_write_check(
            np, img_dir, child["frame0"],
            tmp / "data" / "MOT17" / "train" / T_SEQ / "img1" / "000001.jpg")
        hz = re.search(r"([\d.]+) s for (\d+) frames", text)
        check(hz is not None and int(hz.group(2)) == T_FRAMES,
              "no RUNTIME line for every frame")
        run_ms = float(hz.group(1)) * 1e3 / T_FRAMES
        write_ms = sum(child["write_ms"]) / T_FRAMES
        log(f"  the CLI with the best combination and write_images: MOTA "
            f"{overall['mota']:.6f} IDF1 {overall['idf1']:.6f}, the search's; "
            f"{len(names)} images in {img_dir.relative_to(out)}; frame 0: "
            f"track {tid}'s top edge {edge.round(1).tolist()}; CLI process "
            f"{wall:.1f} s")
        log(f"  writing images: {write_ms:.2f} ms a frame (host) beside the "
            f"RUNTIME line's {run_ms:.2f} ms a frame: "
            f"{100 * write_ms / (write_ms + run_ms):.1f} % of a written frame")
    return launches, statistics.mean(seconds), write_ms, run_ms


# ---------------------------------------------------------------------------


KERNEL_META = {
    # name: (source, the TPU kernel or XLA formulation it replaces)
    "msda_fwd": ("kinet_tpu_torch/ops/csrc/msda_fwd.cu",
                 "kinet_tpu/ops/pallas_msda.py:91"),
    "msda_raw_pool_fwd": ("kinet_tpu_torch/ops/csrc/msda_raw_pool_fwd.cu",
                          "kinet_tpu/ops/msda.py:691"),
    # the same function over the int8 table (quad_scales, quantize_rows)
    "msda_raw_pool_fwd_i8": ("kinet_tpu_torch/ops/csrc/msda_raw_pool_fwd.cu",
                             "kinet_tpu/ops/msda.py:691"),
    "msda_bwd": ("kinet_tpu_torch/ops/csrc/msda_bwd.cu",
                 "kinet_tpu/ops/pallas_msda.py:220"),
    "msda_raw_pool_bwd": ("kinet_tpu_torch/ops/csrc/msda_raw_pool_bwd.cu",
                          "kinet_tpu/ops/msda.py:426"),
    "gather_rows": ("kinet_tpu_torch/ops/csrc/gather_rows.cu",
                    "scripts/pallas_gather_probe.py:14"),
    # the encoder's variants (phase V), instances of msda_fwd.cu: int8
    # values, top-k pruning, head-shared locations
    "msda_fwd_i8": ("kinet_tpu_torch/ops/csrc/msda_fwd.cu",
                    "kinet_tpu/ops/msda.py:498"),
    "msda_topk_fwd": ("kinet_tpu_torch/ops/csrc/msda_fwd.cu",
                      "kinet_tpu/ops/msda.py:844"),
    "msda_shared_fwd": ("kinet_tpu_torch/ops/csrc/msda_fwd.cu",
                        "kinet_tpu/ops/msda.py:1149"),
}
PHASES = ("3", "3b", "P2", "4", "5", "6", "7", "T", "E", "A", "D", "K", "M",
          "V", "H", "B", "S", "P")


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
            log(f"  {kernel}: {entry[:110]}: {regs}; {spills}")

    summary, launches = {}, {}
    facts = k1_facts(msda)
    summary["msda_raw_pool_fwd_i8"] = {"instances": facts}
    for k, f in facts.items():
        log(f"  msda_raw_pool_fwd_i8 instance {k}: "
            + ", ".join(f"{n} {v}" for n, v in f.items()))
    if "3" in phases:
        log("== 3. forward kernels vs plain (800x1440 shapes, B=1)")
        for k, r in kernel_summary(torch, phase_kernels(torch, msda)).items():
            summary.setdefault(k, {}).update(r)
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
        launches.update({k: v for k, v in served.items() if "i8" not in k})
        for k, t in replay.items():
            summary.setdefault(k, {})["replay_ms"] = t
        log(f"  {1000.0 / frame_ms:.3f} frames/s")
        log(f"== 5 (int8). the served config: Tracker.step with "
            f"dec_msda_int8, bf16, 800x1440, {N_FRAMES} frames")
        _, frame_ms, replay = phase_main_path(torch, msda, int8=True)
        i8 = summary.setdefault("msda_raw_pool_fwd_i8", {})
        i8["replay_ms"] = replay["msda_raw_pool_fwd_i8"]
        i8["replay_bf16_ms"] = replay["msda_raw_pool_fwd (bf16 table)"]
        i8["replay_direct_ms"] = replay["msda_raw_pool_fwd_i8 (direct kernel)"]
        log(f"  {1000.0 / frame_ms:.3f} frames/s; the decoder's int8 kernel "
            f"{i8['replay_ms']:.5f} ms a launch, the bf16 kernel on the same "
            f"calls {i8['replay_bf16_ms']:.5f} "
            f"({i8['replay_ms'] / i8['replay_bf16_ms']:.3f}x), the direct "
            f"kernel it replaced, in turn with it, "
            f"{i8['replay_direct_ms']:.5f} "
            f"({i8['replay_ms'] / i8['replay_direct_ms']:.3f}x); on {smi}")
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
    if "T" in phases:
        log(f"== T. tracking CLI: python -m kinet_tpu_torch.engine.track, "
            f"dec_msda_int8, bf16, {T_FRAMES} frames {T_HW[0]}x{T_HW[1]}")
        tracked, steady, hz = phase_track_cli(torch, msda)
        launches["msda_raw_pool_fwd_i8"] = tracked["msda_raw_pool_fwd_i8"]
        log(f"  {steady:.2f} frames/s steady state (the RUNTIME window less "
            f"the first frame's step, {T_FRAMES - 1} frames, prefetched JPEG "
            f"decode included); {hz:.2f} frames/s over the whole RUNTIME "
            f"line, mostly the first frame's start-up at {T_FRAMES} frames; "
            f"on {smi}")
    if "E" in phases:
        log(f"== E. evaluate(): the flagship in bf16 over {E_FRAMES} val "
            f"frames {T_HW[0]}x{T_HW[1]}, with the tracking eval")
        eval_launches, ms_img, eval_s = phase_eval(torch, msda)
        for k, n in eval_launches.items():
            if n:
                summary.setdefault(k, {})["eval_launches"] = n
        log(f"  {ms_img:.3f} ms per val image, {eval_s:.2f} s for the whole "
            f"evaluation; on {smi}")
    if "A" in phases:
        log("== A. accuracy on the card: the simple synthetic-MOT gate")
        phase_accuracy(torch, msda)
    if "D" in phases:
        log(f"== D. vanilla DETR at full width (train.yaml + train_tracking): "
            f"card vs CPU, then Tracker.step bf16 800x1440 {N_FRAMES} frames, "
            f"attention maps")
        ms, share = phase_detr(torch, msda)
        log(f"  {ms:.3f} ms/frame ({1000.0 / ms:.3f} frames/s), device busy "
            f"{'not measured' if share is None else f'{100 * share:.1f}%'}; "
            f"on {smi}")
    if "K" in phases:
        log("== K. the KineT family at full width (train_kinet, "
            "train_kinet2): card vs CPU, train(cfg), the track_kinet CLI, "
            "the encoder-only gate")
        rep = phase_kine(torch, msda)
        log(f"  {json.dumps(rep)}; on {smi}")
    if "M" in phases:
        log("== M. MOTS: the mask head on vanilla DETR (train_mots20) and on "
            "the flagship")
        t0 = time.perf_counter()
        rep, mots_launches = phase_mots(torch, msda)
        for k, n in mots_launches.items():
            summary.setdefault(k, {})["mots_launches"] = n
        log(f"  {json.dumps(rep)}; phase M in {time.perf_counter() - t0:.1f} "
            f"s; on {smi}")
    if phases & {"V", "V1", "V2"}:
        t0 = time.perf_counter()
        if phases & {"V", "V1"}:
            log("== V1. the encoder's MSDA variant kernels vs plain "
                "(800x1440 encoder shapes and a generic (4, 4), B=1)")
            summary.update(phase_variant_kernels(torch, msda))
        if phases & {"V", "V2"}:
            log(f"== V2. the variants on the served flagship: Tracker.step "
                f"bf16 {MAIN_HW[0]}x{MAIN_HW[1]}, {V_FRAMES} frames each; a "
                f"train step each of top-k and shared locations")
            served, replay = phase_variants_served(torch, msda)
            launches.update(served)
            for k in V_REPLAYED.values():
                summary.setdefault(k, {})["replay_ms"] = replay[k]
            summary["msda_fwd_i8"]["replay_bf16_ms"] = \
                replay["msda_fwd (bf16 table)"]
            summary["msda_topk_fwd"]["replay_fwd_ms"] = \
                replay["msda_fwd (unpruned)"]
            for k, t in sorted(replay.items()):
                log(f"  {k}: {t:.5f} device ms a launch on a served frame's "
                    f"own calls")
        if "V" in phases:
            phase_variants_train(torch, msda)
            log("== V3. two-stage (train.yaml + train_deformable, two_stage, "
                "box refine): card vs CPU, train(cfg), evaluate()")
            phase_two_stage(torch, msda)
            log("== V4. merge_frame_features on the flagship: card vs CPU, "
                "Tracker.step")
            phase_merge(torch, msda)
        log(f"  phase V in {time.perf_counter() - t0:.1f} s; on {smi}")
    if "H" in phases:
        log(f"== H. the host tools: a reference checkpoint imported into the "
            f"full-width flagship and served (bf16 {MAIN_HW[0]}x{MAIN_HW[1]}); "
            f"track_param_search over {len(H_GRID)} keys on phase T's run; "
            f"the CLI with write_images")
        t0 = time.perf_counter()
        served, ms, errs = phase_tools_import(torch, msda)
        for k in ("msda_fwd", "msda_raw_pool_fwd"):
            summary.setdefault(k, {})["import_launches"] = served[k]
        for k, by_dtype in errs.items():
            summary.setdefault(k, {})["import_max_abs_err"] = \
                max(by_dtype.values())
        tools, combo_s, write_ms, run_ms = phase_tools_search(torch, msda)
        for k in ("msda_fwd", "msda_raw_pool_fwd_i8"):
            summary.setdefault(k, {})["tools_launches"] = tools[k]
        log(f"  {ms:.3f} ms a served frame on the imported weights; "
            f"{combo_s:.2f} s a search combination; writing images "
            f"{write_ms:.2f} ms a frame beside {run_ms:.2f} ms; phase H in "
            f"{time.perf_counter() - t0:.1f} s; on {smi}")
    # phase B's CLI runs, reused by S; S's 1-process steps, reused by P
    shared = tempfile.TemporaryDirectory()
    s_whole = None
    try:
        if "B" in phases:
            log(f"== B. batched serving: BatchedTracker on the served config "
                f"(dec_msda_int8, bf16), {B_SEQS} sequences of {B_FRAMES} "
                f"frames, B = {B_SIZES} at {MAIN_HW[0]}x{MAIN_HW[1]}, B = "
                f"{B_SEQS} at "
                + " and ".join(f"{h}x{w}" for h, w in B_OTHER_HW)
                + f"; then the CLI with batch_sequences {len(B_CLI_SEQS)}")
            t0 = time.perf_counter()
            b1 = {k: summary.get(k, {}).get("replay_ms") for k in (
                "msda_fwd", "msda_raw_pool_fwd", "msda_raw_pool_fwd_i8")}
            _, breplay, per_step = phase_batched(torch, msda, b1)
            for n, counts in per_step.items():
                for k, c in counts.items():
                    summary.setdefault(k, {}).setdefault(
                        "batched_launches", {})[f"B{n}"] = c
            for k in b1:
                summary.setdefault(k, {})["batched_replay_ms"] = breplay[k]
                summary[k]["batched_bound_ms"] = breplay[k + " bound"]
            summary["msda_raw_pool_fwd_i8"]["batched_replay_direct_ms"] = \
                breplay["msda_raw_pool_fwd_i8 (direct kernel)"]
            line, steady, waiting = phase_batched_cli(torch, msda,
                                                      Path(shared.name))
            log(f"  {line}")
            log(f"  {steady:.3f} frames/s steady state over "
                f"{len(B_CLI_SEQS)} sequences (the RUNTIME window less the "
                f"first batched step); {100 * waiting:.1f} % of the window "
                f"waiting for the prefetch threads' frames; phase B in "
                f"{time.perf_counter() - t0:.1f} s; on {smi}")
        if "S" in phases:
            log("== S. processes on the one card: main_track in 2 gloo "
                "processes, tools/launch.py in a world-1 NCCL group, 2 gloo "
                "train processes, preemption and requeue")
            t0 = time.perf_counter()
            times, s_whole = phase_processes(torch, Path(shared.name))
            log(f"  phase S in {time.perf_counter() - t0:.1f} s "
                f"({', '.join(f'{k} {v:.1f} s' for k, v in times.items())}); "
                f"on {smi}")
        if "P" in phases:
            log(f"== P. the parallel package in 2 gloo processes on the one "
                f"card: tensor-parallel training (mesh.model 2; {S_STEPS} f32 "
                f"steps at {S_HW[0]}x{S_HW[1]}, bf16 steps at "
                f"{TRAIN_HW[0]}x{TRAIN_HW[1]}) and spatially parallel serving "
                f"(spatial_parallel 2, {MAIN_HW[0]}x{MAIN_HW[1]}), each "
                f"against 1 process")
            t0 = time.perf_counter()
            p_launches, p_errs, p_ms, times = phase_parallel(
                torch, msda, Path(shared.name), s_whole)
            for k, n in p_launches.items():
                if k.endswith(" (SP)"):
                    summary.setdefault(k[:-5], {})["sp_launches"] = n
                else:
                    summary.setdefault(k, {})["tp_launches"] = n
            for k, by_dtype in p_errs.items():
                summary.setdefault(k, {}).update(
                    parallel_max_abs_err=max(by_dtype.values()),
                    parallel_max_abs_err_by_dtype=by_dtype)
            log(f"  {json.dumps(p_ms)}; phase P in "
                f"{time.perf_counter() - t0:.1f} s ("
                + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
                + f"); on {smi}")
    finally:
        shared.cleanup()
    log(f"  seconds by phase: {phase_seconds()}")
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
            for key in ("replay_ms", "replay_bf16_ms", "replay_direct_ms",
                        "replay_fwd_ms", "direct_ms",
                        "batched_replay_direct_ms", "instances",
                        "fwd_ms", "cold_ms", "library_cold_ms",
                        "eval_launches", "mots_launches", "grad_max_abs_err",
                        "batched_launches", "batched_replay_ms",
                        "batched_bound_ms", "tp_launches", "sp_launches",
                        "parallel_max_abs_err",
                        "parallel_max_abs_err_by_dtype", "import_launches",
                        "import_max_abs_err", "tools_launches")
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
