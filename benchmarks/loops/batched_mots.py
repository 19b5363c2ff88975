"""Loop: camera streams served with masks through the program's batched
tracker (TrackFormer's MOTS20 model: vanilla DETR and DETR's mask head).

The same closed loop, set-up, window and sampled steps as
``batched_tracking.py``, whose helpers this file takes: the model is built
by the program's ``models/build.py::build_model`` (whose
``masks`` branch wraps DETR in ``SegmWrapper``), cast to the served type
and given the seed's weights (``weights_segm.py``); each step runs
``BatchedTracker.step`` in the stacked form (``make_forward_fn``: the
forward and the masks' upsample; ``fetch_rows``: the rows and every
row's mask probabilities; each stream's ``Tracker._consume`` with the
per-pixel mask resolution). The window times ``seconds`` of steps: the
seconds the benchmark spends between steps (keeping the sampled steps,
trimming the results, steering the threshold) extend it, so that every run
measures as many seconds of serving.

A tracker keeps a boolean mask a track and frame in its results (about
1 MB at 750x1333), which a server writes out. Here, after every step and
outside the timed part of it, each tracker's results keep only the frame
it stepped last (the check reads that frame), so the host's memory stays
bounded however long a run lasts.

The score thresholds are set in set-up as ``batched_tracking.py`` sets
them, and the keep threshold then goes on steering toward the traffic's
``live_tracks`` after every step (``Steer``), outside the timed part of
it, so that the window serves the named load on every seed. The window's
mean live tracks a stream, off ``live_tracks`` by a share, is a compared
number (``live_tracks_gap``): a run that served another load is not a
reading of this cell.

With ``trace``: the benchmark's wrappers time the layers as in
``batched_tracking.py``; the program's tracer (``utils/trace.py``) is on
through the window, so the record holds the window's spans and counters
(``program``), and ``profile_steps`` steps are profiled, each kernel's
device time and each idle gap named by the program's spans
(``program_trace.py``), the mask head's bound beside its device time
(``counts/segm.py``).

At ``check_steps`` steps drawn from the seed, and at the run's first step,
each stream's state before and after the step (masks included), its staged
inputs, its backbone features, each decoder layer's output, the mask
head's inputs and logits, and its fetched rows with the probabilities of
the rows its state machine acts on are kept (on the host);
``check_mots.py`` judges them once the window has closed, the peak memory
has been read and the program's state is freed.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch
from kinet_tpu_torch.models.build import build_model
from kinet_tpu_torch.tracking.batched import BatchedTracker
from kinet_tpu_torch.utils import trace as program

from .. import check_mots, program_trace, weights_segm
from ..check import acted_rows
from ..counts import segm as segm_counts
from ..reference.detr_segm import DetrSegm
from ..traffic.generator import frame_index, make_streams
from .batched_tracking import (DTYPES, EVENTS, Hooks, Settle, calibrate,
                               device_events, logit, program_config,
                               read_profile, sigmoid, split_summary)

LIVE_TRACKS_GAP = "live_tracks_gap"  # the compared number of the load


def build_program(cfg, conf, seed, device, dtype, c5_mean):
    """The program's model from ``build_model``, cast to the served type, its
    weights the seed's, the input projection centring ``c5_mean`` (see
    ``weights_segm.py``). Returns (model, postprocess)."""
    model, post = build_model(cfg, device=device)  # its own weights: replaced
    with torch.device("meta"):
        ref = DetrSegm(conf["model"])
    model.to(dtype)
    model.load_state_dict(weights_segm.state_dict(ref, seed, device, dtype,
                                                  c5_mean), strict=True)
    return model.eval(), post["bbox"]


class Steer(Settle):
    """``Settle``, whose keep and re-identification threshold goes on
    steering toward ``live_tracks`` live tracks a stream after every step
    of the warm-up and the window, by the settle steps' controller; the
    detection threshold holds. Random weights' scores wander over a run: a
    keep threshold held from the window's start let the live tracks drift
    to 4.8-9.7 a stream over a window, so the load followed the seed."""

    def freeze(self):
        super().freeze()
        self.phi_k = logit(self.bt.trackers[0].track_obj_score_thresh)

    def steer(self, births: float, expired: float, live: float):
        """After a step: the streams' mean new, expired and live tracks."""
        if self.slot_spread is None:  # no track slot in the settle steps
            return
        going = self.horizon * (expired - births)
        self.phi_k += 0.1 * self.slot_spread * float(np.clip(
            live - going - self.traffic["live_tracks"], -5.0, 5.0))
        keep = sigmoid(self.phi_k)
        for tr in self.bt.trackers:
            tr.track_obj_score_thresh = tr.reid_score_thresh = keep


class MaskHooks(Hooks):
    """``batched_tracking.Hooks`` and, during a kept step, the mask head's
    inputs and logits (references to the program's own tensors, copied to
    the host after the step)."""

    def __init__(self, bt, spans: bool, sync: bool):
        super().__init__(bt, spans, sync)
        model = bt.trackers[0].model
        model.bbox_attention.register_forward_hook(self._attention)
        model.mask_head.register_forward_hook(self._mask_head)

    def _attention(self, module, args, out):
        if self.capture is not None:
            self.capture["attention_in"] = args[:2]  # hs_last, memory

    def _mask_head(self, module, args, out):
        if self.capture is not None:
            self.capture["mask_head"] = (args[0], out)  # src_proj, logits


def trim_results(bt):
    """Each tracker's results down to the frame it stepped last."""
    for tr in bt.trackers:
        last = tr.frame_index - 1
        for tid in list(tr.results):
            frames = tr.results[tid]
            for f in [f for f in frames if f != last]:
                del frames[f]
            if not frames:
                del tr.results[tid]


def keep_sample(smp, bt, n_slots):
    """A kept step's captures, each stream's row copied to the host; the
    fetched probabilities cut to the rows the state machine acted on."""
    hs_last, memory = smp.pop("attention_in")
    src_proj, logits = smp.pop("mask_head")
    feats = bt._prev_features[0][0]  # C2..C5 of the frame just stepped
    smp["layers"] = [x.cpu() for x in smp["layers"]]
    for i, tr in enumerate(bt.trackers):
        if i not in smp["outs"]:
            continue
        out = smp["outs"][i]
        rows = np.nonzero(acted_rows(out, tr._num_prev, n_slots,
                                     smp["thresholds"]))[0]
        smp["outs"][i] = dict(out, mask_probs={
            int(r): np.array(out["mask_probs"][r]) for r in rows})
        smp["feats"][i] = [f[i].cpu() for f in feats]
        smp["mask_in"][i] = dict(
            hs_last=hs_last[i].cpu(), memory=memory[i].cpu(),
            src_proj=src_proj[i].cpu(), logits=logits[i].cpu())
        smp["after"][i] = (check_mots.snapshot(tr), check_mots.frame_results(tr))


def run(ctx) -> dict:
    """One run of a cell; ``ctx``: the harness's context (see
    ``harness.Context``). Returns the run's record."""
    conf, traffic, work = ctx.config, ctx.traffic, ctx.workload
    device, log = ctx.device, ctx.log
    dtype = DTYPES[conf["precision"]]
    parts = {"imports": time.perf_counter() - ctx.t_start}
    t = time.perf_counter()
    streams = make_streams(traffic, ctx.seed)
    cycle = traffic["cycle_frames"]
    parts["frames"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg = program_config(conf)
    c5_mean = check_mots.c5_mean(conf["model"], ctx.seed, device, dtype,
                                 streams[0][0])
    model, post = build_program(cfg, conf, ctx.seed, device, dtype, c5_mean)
    parts["weights"] = time.perf_counter() - t

    t = time.perf_counter()
    n_slots = int(cfg.max_track_queries)
    det0, det_spread = calibrate(model, post, streams,
                                 int(traffic["live_tracks"]), n_slots, device)
    tracker_cfg = dict(work["tracker"], detection_obj_score_thresh=det0,
                       track_obj_score_thresh=det0, reid_score_thresh=det0,
                       batch_exec="stacked")
    for key in ("public_detections", "reid_greedy_matching", "reid_sim_only"):
        if tracker_cfg.get(key):
            raise ValueError(f"the reference tracker has no {key}")
    bt = BatchedTracker(model, post, tracker_cfg,
                        num_object_queries=int(cfg.num_queries),
                        num_track_slots=n_slots,
                        hidden_dim=int(cfg.hidden_dim),
                        n_sequences=len(streams),
                        overflow_boxes=bool(cfg.overflow_boxes))
    hooks = MaskHooks(bt, spans=ctx.trace, sync=device.type == "cuda")
    settle = Steer(bt, det0, det_spread, traffic,
                    int(tracker_cfg["inactive_patience"]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["calibration"] = time.perf_counter() - t

    def blobs(g):
        return [s[frame_index(g, cycle)] for s in streams]

    def live_mean():
        return sum(len(tr.tracks) for tr in bt.trackers) / len(streams)

    samples, kept_s, steering = [], [0.0], [False]

    def step(g):
        """One step; its host seconds (the trimming of the results and,
        once the thresholds are settled, their steering not counted:
        ``kept_s``)."""
        ev = dict(hooks.events)
        secs = hooks.step(blobs(g))
        t = time.perf_counter()
        trim_results(bt)
        if steering[0]:
            settle.steer((hooks.events["born"] - ev["born"]) / len(streams),
                         (hooks.events["expired"] - ev["expired"])
                         / len(streams), live_mean())
        kept_s[0] += time.perf_counter() - t
        return secs

    def kept_step(g):
        """A step whose inputs, outputs and states are kept for the check;
        its host seconds (the keeping not counted: ``kept_s``)."""
        t = time.perf_counter()
        smp = {"step": g, "inputs": {}, "outs": {}, "after": {}, "layers": [],
               "feats": {}, "mask_in": {}, "thresholds": settle.thresholds(),
               "before": {i: check_mots.snapshot(tr)
                          for i, tr in enumerate(bt.trackers)}}
        hooks.capture = smp
        kept_s[0] += time.perf_counter() - t
        secs = step(g)
        t = time.perf_counter()
        hooks.capture = None
        keep_sample(smp, bt, n_slots)
        samples.append(smp)
        kept_s[0] += time.perf_counter() - t
        return secs

    # the scene's first frame (kept for the check: the start), then the
    # steps that settle the thresholds, then the warm-up at them
    t = time.perf_counter()
    first_s = kept_step(0)
    g = 1
    for _ in range(int(traffic["settle_steps"])):
        ev = dict(hooks.events)
        hooks.slot_scores = []
        step(g)
        g += 1
        settle.update((hooks.events["born"] - ev["born"]) / len(streams),
                      (hooks.events["expired"] - ev["expired"]) / len(streams),
                      live_mean(), np.asarray(hooks.slot_scores))
    hooks.slot_scores = None
    settle.freeze()
    steering[0] = True
    tracker_cfg.update(settle.thresholds())
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["settle"] = time.perf_counter() - t
    t = time.perf_counter()
    warm_s = []
    for _ in range(int(work["warmup_steps"])):
        warm_s.append(step(g))
        g += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["warmup"] = time.perf_counter() - t
    start = g  # the window's first step
    prof_steps = int(work.get("profile_steps", 0)) if ctx.trace else 0
    prof_from = start + 1
    prof, prof_done = None, 0
    # the kept steps, drawn from the seed among the steps that the window
    # reaches at the warm steps' median pace (after the profiled ones); one
    # that a slow window does not reach is stepped after the window closes
    pace = float(np.median(warm_s or [first_s]))
    est = max(int(0.8 * ctx.seconds / max(pace, 1e-3)), work["check_steps"])
    first = prof_from + prof_steps if ctx.trace else start
    rng = np.random.default_rng(np.random.SeedSequence([abs(ctx.seed), 7]))
    kept = set((first + rng.choice(est, work["check_steps"],
                                   replace=False)).tolist())
    expected = [0] + sorted(kept)
    log("setup parts (s): " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in parts.items()))
    log("thresholds at the window's start " + ", ".join(f"{k} {v:.6g}" for k, v in
                                   settle.thresholds().items())
        + f" (first frame's detection {det0:.6g}); live tracks a stream "
        f"{live_mean():.2f} at the window's start")

    ctx.smi_before = ctx.smi()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    frame_ms, steps, live = [], 0, []
    hooks.consumed = 0
    hooks.times = {k: [] for k in hooks.times}  # the window's spans only
    hooks.splits = []
    hooks.events = dict.fromkeys(EVENTS, 0)
    kept_s[0] = 0.0
    gc.collect()
    gc.freeze()
    pauses, gc_t = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - gc_t[0]))
    gc.callbacks.append(on_gc)
    if ctx.trace:
        program.enable()
    # the epoch's ns at the monotonic clock's zero (the tracer's clock)
    anchor = time.time_ns() - time.perf_counter_ns()
    live_start = live_mean()
    t0 = time.perf_counter()
    t_setup = t0 - ctx.t_start
    deadline = t0 + ctx.seconds
    # ``seconds`` of serving: the seconds kept out of the window (keeping
    # samples, trimming the results, steering) extend it, so a run always
    # times as many seconds of steps
    while time.perf_counter() - kept_s[0] < deadline:
        if g == prof_from and prof_steps:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        secs = kept_step(g) if g in kept else step(g)
        frame_ms += [secs * 1e3] * len(streams)
        live.append(live_mean())
        steps += 1
        g += 1
        if prof is not None and g == prof_from + prof_steps:
            if device.type == "cuda":
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof_done = prof_steps
    t1 = time.perf_counter()
    window_s = t1 - t0 - kept_s[0]
    gc.callbacks.remove(on_gc)
    drained = program.drain()
    program.disable()
    if prof is not None and g < prof_from + prof_steps:  # cut by the window
        if device.type == "cuda":
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof_done = g - prof_from
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    ctx.smi_after = ctx.smi()
    frames = steps * len(streams)
    h, w = traffic["height"], traffic["width"]
    rows = n_slots + int(cfg.num_queries)
    head = segm_counts.mask_head(conf["model"], h, w, rows,
                                 torch.finfo(dtype).bits // 8)
    peak_flops = ctx.peaks["bf16_flops_per_s" if dtype == torch.bfloat16
                           else "f32_flops_per_s"]
    record = dict(setup_s=t_setup, setup_parts=parts, window_s=window_s,
                  kept_s=kept_s[0],
                  frames=frames, steps=steps, frame_ms=frame_ms,
                  peak_bytes=peak, failed=frames - hooks.consumed,
                  live_tracks=float(np.mean(live)) if live else 0.0,
                  live_range=(live_start, min(live or [0]), max(live or [0]),
                              live[-1] if live else 0.0),
                  events={k: v / max(frames, 1)
                          for k, v in hooks.events.items()},
                  thresholds=settle.thresholds(),
                  peaks=ctx.peaks, spans=hooks.times if ctx.trace else None,
                  splits=hooks.splits, gc_pauses=pauses,
                  frame_flops=segm_counts.frame_flops(
                      conf["model"], h, w, n_slots)["total"],
                  program=program_trace.window(
                      drained, anchor + t0 * 1e9, anchor + t1 * 1e9)
                  if ctx.trace else None,
                  profile=None)
    if prof is not None:
        with torch.inference_mode():
            p = read_profile(prof, prof_done * len(streams), [], ctx.peaks)
        if p is not None:
            dev, host = device_events(prof)
            steps_us = host.get("step", [])
            p.update(program_trace.program_profile(
                prof, record["program"]["spans"], dev,
                min([a for a, _ in steps_us] + [dev[0][0]]),
                max([z for _, z in steps_us] + [dev[-1][1]])))
            p["mask_head_bound_s"] = p["frames"] * max(
                head["flops"] / peak_flops,
                head["bytes"] / ctx.peaks["hbm_bytes_per_s"])
        record["profile"] = p
        del prof
    log(f"window: {steps} steps, {frames} frames in {window_s:.3f} s "
        f"(and {kept_s[0]:.3f} s keeping steps for the check and trimming "
        f"the results); live tracks a stream {record['live_tracks']:.2f}; "
        f"peak {peak} bytes")
    log(split_summary(hooks.splits, pauses))
    log("live tracks a stream: start {:.2f}, least {:.2f}, most {:.2f}, "
        "end {:.2f}; a frame and stream: ".format(*record["live_range"])
        + ", ".join(f"{k} {v:.3f}" for k, v in record["events"].items()))
    if record["program"] is not None:
        for line in program.summary(record["program"]):
            log(line)
    p = record["profile"]
    if p and "program_device_s" in p:
        for key in ("program_device_s", "program_gaps"):
            log(f"{key} (s, {p['frames']} frames): " + ", ".join(
                f"{k} {v:.5f}" for k, v in sorted(p[key].items(),
                                                   key=lambda kv: -kv[1])))
    late = 0
    hooks.times, hooks.splits = {k: [] for k in hooks.times}, []
    while g <= max(kept):  # kept steps the window did not reach
        if g in kept:
            kept_step(g)
            late += 1
        else:
            step(g)
        g += 1
    record["late_samples"] = late

    # the check, once the program's state is freed
    del bt, hooks, settle, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cell = dict(tracker_cfg=tracker_cfg, n_slots=n_slots,
                hidden_dim=int(cfg.hidden_dim),
                clip=not bool(cfg.overflow_boxes), c5_mean=c5_mean)
    t = time.perf_counter()
    ref = check_mots.Reference(conf["model"], ctx.seed, device, dtype, c5_mean)
    detail = []
    nums = check_mots.run_check(cell, samples, streams, cycle, ref,
                                detail=detail, expected=expected)
    # the load served: the window's mean live tracks a stream, off the
    # traffic's by this share
    want = float(traffic["live_tracks"])
    nums[LIVE_TRACKS_GAP] = abs(record["live_tracks"] - want) / want
    record["check_s"] = time.perf_counter() - t
    record["check"], record["check_detail"] = nums, detail
    record["check_samples"] = [s["step"] for s in samples]
    ctx.kept = dict(cell=cell, samples=samples, streams=streams, cycle=cycle,
                    expected=expected)
    return record
