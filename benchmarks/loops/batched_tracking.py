"""Loop: streams served together through the program's batched tracker.

``kinet_tpu_torch.tracking.batched.BatchedTracker.step`` in the stacked
form runs the streams in a closed loop: each step takes every stream's
next frame, and a stream's next frame waits for its tracker state of the
last one, as a tracker must. Inside the window: the host-to-device copies,
the forward, the one fetch and every stream's state machine. Before it:
the weights (made on the device from the seed), the streams' frames, one
calibration forward at the window's batch, the scene's first frame, the
steps that settle the score thresholds (``Settle``: ``live_tracks`` live
tracks a stream, ``births_per_frame`` new ones), and ``warmup_steps``
steps at the window's shapes (the first step builds the kernels on a
checkout's first run). The cell's other tracker settings come from its
workload file.

With ``trace`` the benchmark's own wrappers time the layers (spans: the
step, its stage before the forward, the forward with a synchronisation
after it, each state machine; the device's idle gaps are named by them,
and by the fetch between the forward and the first state machine), and
``profile_steps`` steps are profiled, after as many unprofiled steps that
keep their MSDA calls' arguments (so the caching allocator holds the room
that keeping them takes), keeping every MSDA call's arguments for its
bytes and operations.

At ``check_steps`` steps drawn from the seed, and at the run's first step,
each stream's state before and after the step, its staged inputs, its
memories (of the frame and of the frame before), each decoder layer's
output and its fetched rows are kept; ``check.py`` judges them once the
window has closed, the peak memory has been read and the program's state
is freed.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch
from kinet_tpu_torch.config import load_config
from kinet_tpu_torch.models import deformable_transformer as dt
from kinet_tpu_torch.models.build import _build_deformable, num_classes_for
from kinet_tpu_torch.models.postprocess import build_postprocessors
from kinet_tpu_torch.structs import ImageBatch
from kinet_tpu_torch.tracking.batched import BatchedTracker
from kinet_tpu_torch.tracking.tracker import make_forward_fn

from .. import check, weights
from ..counts import model as model_counts
from ..counts.msda import bound_s, call_counts
from ..reference.detr import TrackFormer
from ..traffic.generator import frame_index, make_streams

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
EVENTS = ("born", "kept", "missed", "reidentified", "removed_by_nms",
          "expired", "lsap")


def program_config(conf):
    """The program's configuration of a configuration file: its named cfgs
    and overrides through the program's loader, held to the file's
    ``model`` block key by key."""
    cfg = load_config(conf["base"], named=conf["named"],
                      overrides=conf["overrides"])
    for k, v in conf["model"].items():
        got = num_classes_for(cfg.get("dataset", "coco")) \
            if k == "num_classes" else cfg.get(k)
        if k == "dec_msda_int8":
            got = bool(got)
        if got != v:
            raise ValueError(f"{conf['name']}: the program's {k} is {got!r}, "
                             f"the file states {v!r}")
    return cfg


def build_program(cfg, conf, seed, device, dtype):
    """The program's model, its weights the seed's, in the served type."""
    with torch.device("meta"):
        model = _build_deformable(cfg, int(cfg.max_track_queries))
        ref = TrackFormer(conf["model"])
    sd = weights.state_dict(ref, seed, device, dtype)
    model.to_empty(device=device)
    model.to(dtype)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def logit(p: float) -> float:
    p = min(max(p, 1e-12), 1.0 - 1e-12)
    return math.log(p / (1.0 - p))


def sigmoid(x: float) -> float:
    return 1.0 / (1.0 + math.exp(-x))


def calibrate(model, post, streams, births, n_slots, device):
    """The score threshold at which about ``births`` object queries a
    frame score above it: one forward of every stream's first frame at the
    window's batch, no track slots active. Also the spread (standard
    deviation of the logits) of the object queries' scores near it."""
    imgs = torch.cat([torch.from_numpy(s[0]["images"])
                      for s in streams]).to(device)
    pad = torch.cat([torch.from_numpy(s[0]["pad_mask"])
                     for s in streams]).to(device)
    h, w = streams[0][0]["orig_size"]
    size = torch.tensor([[float(h), float(w)]] * len(streams), device=device)
    res = make_forward_fn(model, post)(ImageBatch(imgs, pad), None, size,
                                       None, None, None)
    scores = res["scores"][:, n_slots:].float()
    cand = scores[res["labels"][:, n_slots:] == 0].sort(descending=True).values
    n = births * len(streams)
    if cand.numel() <= 2 * n:
        raise RuntimeError("too few object queries score class 0")
    near = torch.logit(cand[:2 * n].double().clamp(1e-12, 1 - 1e-12))
    return float(cand[n]), float(near.std())


class Settle:
    """The scene's start and the score thresholds of the window.

    Random weights give scores with no meaning, so the three score
    thresholds (detection, keep and re-identification; TrackFormer's are
    0.4, 0.4, 0.4) are set from the seed's own scores, in set-up:

    - the first frame starts ``live_tracks`` tracks a stream (the detection
      threshold at that rank of the first frame's object queries);
    - over ``settle_steps`` steps, two controllers in logit space move the
      detection threshold toward ``births_per_frame`` new tracks a frame
      and stream, and the keep and re-identification threshold (one
      value, as published) toward ``live_tracks`` live tracks a stream,
      starting below every live track slot's score; the keep controller
      also counts the tracks that expire beyond those born, over the
      frames an inactive track waits (``inactive_patience`` + 1), as live
      tracks that are about to go;
    - each is then fixed at its mean over the last half of those steps, and
      holds for the rest of the run.
    """

    def __init__(self, bt, det0, det_spread, traffic, patience):
        self.bt, self.traffic = bt, traffic
        self.horizon = patience + 1
        self.det_spread = max(det_spread, 0.05)
        self.phi_d, self.phi_k = logit(det0), None
        self.slot_spread = None
        self.trace = []  # (phi_d, phi_k) after each settle step
        self.set(det0, det0)

    def set(self, det, keep):
        for tr in self.bt.trackers:
            tr.detection_obj_score_thresh = det
            tr.track_obj_score_thresh = tr.reid_score_thresh = keep

    def thresholds(self) -> dict:
        tr = self.bt.trackers[0]
        return dict(detection_obj_score_thresh=tr.detection_obj_score_thresh,
                    track_obj_score_thresh=tr.track_obj_score_thresh,
                    reid_score_thresh=tr.reid_score_thresh)

    def update(self, births: float, expired: float, live: float,
               slot_scores):
        """After a settle step: the streams' mean new, expired and live
        tracks, and the live track slots' scores of that step."""
        t = self.traffic
        if self.phi_k is None and len(slot_scores) == 0:
            keep = self.bt.trackers[0].track_obj_score_thresh
            self.trace.append((self.phi_d, logit(keep)))
            return
        if self.phi_k is None:  # the first step with track slots
            lg = np.log(np.clip(slot_scores, 1e-12, None)) - \
                np.log1p(-np.clip(slot_scores, None, 1 - 1e-12))
            self.slot_spread = max(float(lg.std()), 0.05)
            self.phi_k = float(lg.min()) - self.slot_spread
        else:
            going = self.horizon * (expired - births)
            self.phi_k += 0.1 * self.slot_spread * float(
                np.clip(live - going - t["live_tracks"], -5.0, 5.0))
        self.phi_d += 0.5 * self.det_spread * float(
            np.clip(births - t["births_per_frame"], -1.0, 3.0))
        self.trace.append((self.phi_d, self.phi_k))
        self.set(sigmoid(self.phi_d), sigmoid(self.phi_k))

    def freeze(self):
        last = self.trace[len(self.trace) // 2:]
        self.set(sigmoid(float(np.mean([d for d, _ in last]))),
                 sigmoid(float(np.mean([k for _, k in last]))))


class Hooks:
    """The benchmark's wrappers on the instances it built (no file of the
    program is edited): keep a sampled step's staged inputs and fetched
    rows, count the frames consumed, and with spans time the layers.

    Every step's host time is also split, by the host clock alone (no
    synchronisation): stage (to the forward's call), launch (the forward's
    call; with spans, its device work too), fetch (from the forward's
    return to the first state machine: the wait for the device and the
    copy back), state machines, and the rest (``splits``, ms).

    ``events`` counts, over every stream, the tracks born (and still there
    after the frame's NMS), kept by their slot's score, missed (moved to
    the inactive tracks), re-identified, removed by NMS and expired (an
    inactive track past its patience), and the frames on which the
    re-identification's assignment (LSAP) ran. ``slot_scores``, when a
    list, gets the live track slots' scores of each frame."""

    def __init__(self, bt, spans: bool, sync: bool):
        self.bt, self.spans, self.sync = bt, spans, sync
        self.capture = None  # a sample's dict during a kept step
        self.consumed = 0
        self.times = {"stage": [], "forward": [], "state_machine": []}
        self.splits = []
        self.fwd_t0 = self.fwd_t1 = self.sm_t0 = None
        self.sm_s = 0.0
        self.events = dict.fromkeys(EVENTS, 0)
        self.slot_scores = None
        for i, tr in enumerate(bt.trackers):
            tr._build_inputs = self._build(i, tr._build_inputs)
            tr._consume = self._consume(i, tr._consume)
            tr.reid = self._reid(tr, tr.reid)
        bt._forward = self._forward(bt._forward)
        decoder = bt.trackers[0].model.transformer.decoder
        for i in range(decoder.num_layers):
            getattr(decoder, f"layer{i}").register_forward_hook(self._layer)

    def _layer(self, module, args, out):
        """A decoder layer's output, kept (copied on the device) during a
        kept step."""
        if self.capture is not None:
            self.capture["layers"].append(out.detach().clone())

    def _build(self, i, orig):
        tr = self.bt.trackers[i]

        def build(blob):
            waiting = len(tr.inactive_tracks)
            inputs = orig(blob)
            self.events["expired"] += waiting - len(tr.inactive_tracks)
            if self.capture is not None:
                self.capture["inputs"][i] = inputs
            return inputs
        return build

    def _reid(self, tr, orig):
        def reid(new_boxes, *args, **kw):
            if len(new_boxes) and any(
                    t.has_positive_area()
                    and t.count_inactive <= tr.inactive_patience
                    for t in tr.inactive_tracks):
                self.events["lsap"] += 1
            return orig(new_boxes, *args, **kw)
        return reid

    def _count(self, tr, live, born_from, reids, kept):
        """The events of one stream's frame, from its state around it."""
        now = {t.id for t in tr.tracks}
        ev = self.events
        ev["born"] += sum(1 for x in now if x >= born_from)
        ev["kept"] += kept
        ev["missed"] += len((live - now) & {t.id for t in tr.inactive_tracks})
        ev["reidentified"] += tr.num_reids - reids
        ev["removed_by_nms"] += len(live - now) - len(
            (live - now) & {t.id for t in tr.inactive_tracks})

    def _consume(self, i, orig):
        tr = self.bt.trackers[i]

        def consume(out, blob):
            if self.capture is not None:
                self.capture["outs"][i] = out
            self.consumed += 1
            n_live = min(len(tr.tracks), tr._num_prev)
            if self.slot_scores is not None:
                self.slot_scores.extend(out["scores"][:n_live].tolist())
            kept = int(((out["scores"][:n_live] > tr.track_obj_score_thresh)
                        & (out["labels"][:n_live] == 0)).sum())
            state = ({t.id for t in tr.tracks}, tr.track_num, tr.num_reids)
            t0 = time.perf_counter()
            if self.sm_t0 is None:
                self.sm_t0 = t0
            if not self.spans:
                r = orig(out, blob)
                self.sm_s += time.perf_counter() - t0
            else:
                with torch.profiler.record_function("bench.state_machine"):
                    r = orig(out, blob)
                dt = time.perf_counter() - t0
                self.sm_s += dt
                self.times["state_machine"].append(dt * 1e3)
            self._count(tr, *state, kept)
            return r
        return consume

    def _forward(self, orig):
        def forward(inputs):
            if not self.spans:
                self.fwd_t0 = time.perf_counter()
                res = orig(inputs)
                self.fwd_t1 = time.perf_counter()
                return res
            self.fwd_t0 = time.perf_counter()
            with torch.profiler.record_function("bench.forward"):
                res = orig(inputs)
                if self.sync:
                    torch.cuda.synchronize()
            self.fwd_t1 = time.perf_counter()
            return res
        return forward

    def step(self, blobs):
        """One ``BatchedTracker.step``; its host seconds."""
        self.sm_t0, self.sm_s = None, 0.0
        t0 = time.perf_counter()
        if self.spans:
            with torch.profiler.record_function("bench.step"):
                self.bt.step(blobs)
        else:
            self.bt.step(blobs)
        t1 = time.perf_counter()
        if self.fwd_t0 is not None:
            if self.spans:
                self.times["stage"].append((self.fwd_t0 - t0) * 1e3)
                self.times["forward"].append(
                    (self.fwd_t1 - self.fwd_t0) * 1e3)
            sm0 = self.sm_t0 if self.sm_t0 is not None else t1
            self.splits.append(tuple(x * 1e3 for x in (
                self.fwd_t0 - t0, self.fwd_t1 - self.fwd_t0,
                sm0 - self.fwd_t1, self.sm_s,
                t1 - t0 - (sm0 - t0) - self.sm_s)))
            self.fwd_t0 = None
        return t1 - t0


class MsdaRecorder:
    """Keeps the arguments of every MSDA call the model makes while on,
    by wrapping the entry points where the model's module binds them."""

    def __init__(self):
        self.dt, self.calls, self.on = dt, [], False
        self.orig = (dt.ms_deform_attn, dt.ms_deform_attn_raw_pool)

        def attn(value, shapes, loc, aw):
            if self.on:
                self.calls.append(("msda", value, shapes, loc, aw, None, None))
            return self.orig[0](value, shapes, loc, aw)

        def raw_pool(src, shapes, loc, aw, ext=None, scales=None, pooled=None):
            if self.on:
                out = pooled.itemsize if pooled is not None else None
                self.calls.append(("raw_pool", src, shapes, loc, aw, ext, out))
            return self.orig[1](src, shapes, loc, aw, ext, scales, pooled)

        dt.ms_deform_attn, dt.ms_deform_attn_raw_pool = attn, raw_pool

    def close(self):
        self.dt.ms_deform_attn, self.dt.ms_deform_attn_raw_pool = self.orig


def device_events(prof):
    """(kernels and copies [(start us, end us, name)], host ranges {name:
    [(start, end)]}) of a profile."""
    from torch.autograd import DeviceType

    dev, host = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith("bench."):
                continue
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith("bench."):
            host.setdefault(e.name[6:], []).append(
                (e.time_range.start, e.time_range.end))
    dev.sort()
    return dev, host


def gap_owner(t, host):
    """The host span at time ``t`` (us): state_machine, forward, fetch (after
    a step's forward, before its first state machine), stage (in a step,
    before its forward) or other."""
    for name in ("state_machine", "forward"):
        if any(a <= t <= z for a, z in host.get(name, ())):
            return name
    for a, z in host.get("step", ()):
        if a <= t <= z:
            fw = [f for f in host.get("forward", ()) if a <= f[0] <= z]
            if fw and t < fw[0][0]:
                return "stage"
            return "fetch" if fw else "other"
    return "other"


def read_profile(prof, frames, calls, peaks):
    """The profiled window's device readings."""
    dev, host = device_events(prof)
    if not dev:
        return None
    busy_us = sum(z - a for a, z, _ in dev)
    steps = host.get("step", [])
    start = min([a for a, _ in steps] + [dev[0][0]])
    end = max([z for _, z in steps] + [dev[-1][1]])
    ops, gaps = {}, {}
    for a, z, name in dev:
        ops[name] = ops.get(name, 0.0) + (z - a) * 1e-6
    prev = start
    for a, z, _ in dev:
        if a > prev:
            owner = gap_owner((a + prev) / 2, host)
            gaps[owner] = gaps.get(owner, 0.0) + (a - prev) * 1e-6
        prev = max(prev, z)
    if end > prev:
        owner = gap_owner((end + prev) / 2, host)
        gaps[owner] = gaps.get(owner, 0.0) + (end - prev) * 1e-6
    is_copy = lambda n: n.startswith(("Memcpy", "Memset", "cudaMemcpy"))
    msda = [(a, z) for a, z, n in dev if "msda" in n]
    bound = sum(bound_s(*call_counts(kind, t, shapes, loc, aw, ext, out),
                        peaks)
                for kind, t, shapes, loc, aw, ext, out in calls)
    return dict(busy_s=busy_us * 1e-6, window_s=(end - start) * 1e-6,
                frames=frames, kernels=sum(not is_copy(n) for _, _, n in dev),
                kernel_s=sum(z - a for a, z, n in dev if not is_copy(n)) * 1e-6,
                msda_s=sum(z - a for a, z in msda) * 1e-6,
                msda_launches=len(msda), msda_calls=len(calls),
                msda_bound_s=bound, ops=ops, gaps=gaps)


def close_profile(prof, recorder):
    """Ends the profiled steps; returns the MSDA calls they made."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    calls, recorder.calls = recorder.calls, []
    recorder.on = False
    return calls


def split_summary(splits, pauses) -> str:
    """A line of the window's step splits (median and 90th percentile, ms)
    and the collector's pauses."""
    if not splits:
        return "step splits: none"
    a = np.asarray(splits)
    parts = ", ".join(
        f"{n} {np.median(a[:, i]):.2f}/{np.percentile(a[:, i], 90):.2f}"
        for i, n in enumerate(("stage", "launch", "fetch", "state_machines",
                               "rest")))
    return (f"step splits ms (median/p90): {parts}; gc pauses "
            f"{len(pauses)}, {sum(p for _, p in pauses) * 1e3:.2f} ms in all, "
            f"gen2 {sum(g == 2 for g, _ in pauses)}")


def run(ctx) -> dict:
    """One run of a cell; ``ctx``: the harness's context (see
    ``harness.Context``). Returns the run's record."""
    conf, traffic, work = ctx.config, ctx.traffic, ctx.workload
    device, log = ctx.device, ctx.log
    dtype = DTYPES[conf["precision"]]
    parts = {"imports": time.perf_counter() - ctx.t_start}
    t = time.perf_counter()
    cfg = program_config(conf)
    model = build_program(cfg, conf, ctx.seed, device, dtype)
    post = build_postprocessors(cfg)["bbox"]
    parts["weights"] = time.perf_counter() - t

    t = time.perf_counter()
    streams = make_streams(traffic, ctx.seed)
    cycle = traffic["cycle_frames"]
    parts["frames"] = time.perf_counter() - t

    t = time.perf_counter()
    n_slots = int(cfg.max_track_queries)
    det0, det_spread = calibrate(model, post, streams,
                                 int(traffic["live_tracks"]), n_slots, device)
    tracker_cfg = dict(work["tracker"], detection_obj_score_thresh=det0,
                       track_obj_score_thresh=det0, reid_score_thresh=det0,
                       batch_exec="stacked")
    bt = BatchedTracker(model, post, tracker_cfg,
                        num_object_queries=int(cfg.num_queries),
                        num_track_slots=n_slots,
                        hidden_dim=int(cfg.hidden_dim),
                        n_sequences=len(streams),
                        overflow_boxes=bool(cfg.overflow_boxes))
    hooks = Hooks(bt, spans=ctx.trace, sync=device.type == "cuda")
    settle = Settle(bt, det0, det_spread, traffic,
                    int(tracker_cfg["inactive_patience"]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["calibration"] = time.perf_counter() - t

    def blobs(g):
        return [s[frame_index(g, cycle)] for s in streams]

    def live_mean():
        return sum(len(tr.tracks) for tr in bt.trackers) / len(streams)

    samples, kept_s = [], [0.0]

    def memories():
        """Each stream's memory in the batched tracker's cache (the frame it
        stepped last), on the host; {} before a first step."""
        cached = bt._prev_memory[0]
        return {} if cached is None else dict(enumerate(cached[0].cpu()))

    def kept_step(g):
        """A step whose inputs, outputs and states are kept for the check;
        its host seconds (the keeping not counted: ``kept_s``)."""
        t = time.perf_counter()
        smp = {"step": g, "inputs": {}, "outs": {}, "after": {}, "layers": [],
               "prev_memory": memories(), "thresholds": settle.thresholds(),
               "before": {i: check.snapshot(tr)
                          for i, tr in enumerate(bt.trackers)}}
        hooks.capture = smp
        kept_s[0] += time.perf_counter() - t
        secs = hooks.step(blobs(g))
        t = time.perf_counter()
        hooks.capture = None
        smp["layers"] = [x.cpu() for x in smp["layers"]]
        smp["memory"] = {i: m for i, m in memories().items()
                         if i in smp["outs"]}
        for i, tr in enumerate(bt.trackers):
            if i in smp["outs"]:
                smp["after"][i] = (check.snapshot(tr), check.frame_results(tr))
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
        hooks.step(blobs(g))
        g += 1
        settle.update((hooks.events["born"] - ev["born"]) / len(streams),
                      (hooks.events["expired"] - ev["expired"]) / len(streams),
                      live_mean(), np.asarray(hooks.slot_scores))
    hooks.slot_scores = None
    settle.freeze()
    tracker_cfg.update(settle.thresholds())
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["settle"] = time.perf_counter() - t
    t = time.perf_counter()
    warm_s = []
    for _ in range(int(work["warmup_steps"])):
        warm_s.append(hooks.step(blobs(g)))
        g += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["warmup"] = time.perf_counter() - t
    start = g  # the window's first step
    recorder = MsdaRecorder() if ctx.trace else None
    prof_steps = int(work.get("profile_steps", 0)) if ctx.trace else 0
    prof_from = start + 2 * prof_steps + 1  # after the rehearsal steps
    prof, prof_calls = None, []
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
    log("thresholds " + ", ".join(f"{k} {v:.6g}" for k, v in
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
    # set-up's objects out of the collector's way, its pauses counted
    gc.collect()
    gc.freeze()
    pauses, gc_t = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t[0] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - gc_t[0]))
    gc.callbacks.append(on_gc)
    live_start = live_mean()
    t0 = time.perf_counter()
    t_setup = t0 - ctx.t_start
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        if recorder is not None:
            recorder.on = prof_from - prof_steps <= g < prof_from + prof_steps
            if g == prof_from:
                recorder.calls.clear()  # the rehearsal's: freed to the cache
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
        if g in kept:
            secs = kept_step(g)
        else:
            secs = hooks.step(blobs(g))
        frame_ms += [secs * 1e3] * len(streams)
        live.append(live_mean())
        steps += 1
        g += 1
        if prof is not None and g == prof_from + prof_steps:
            prof_calls = close_profile(prof, recorder)
    # the window's seconds less the benchmark's own keeping for the check
    window_s = time.perf_counter() - t0 - kept_s[0]
    gc.callbacks.remove(on_gc)
    if prof is not None and g < prof_from + prof_steps:  # cut by the window
        prof_calls, prof_steps = close_profile(prof, recorder), g - prof_from
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    ctx.smi_after = ctx.smi()
    frames = steps * len(streams)

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
                  frame_flops=model_counts.frame_flops(
                      dict(conf["model"], dec_gather_raw=bool(
                          cfg.get("dec_gather_raw", False))),
                      traffic["height"], traffic["width"], n_slots)["total"],
                  profile=None)
    if recorder is not None:
        recorder.close()
        if prof is not None and prof_calls:
            with torch.inference_mode():
                record["profile"] = read_profile(
                    prof, prof_steps * len(streams), prof_calls, ctx.peaks)
        del prof, prof_calls
    log(f"window: {steps} steps, {frames} frames in {window_s:.3f} s "
        f"(and {kept_s[0]:.3f} s keeping steps for the check); "
        f"live tracks a stream {record['live_tracks']:.2f}; "
        f"peak {peak} bytes")
    log(split_summary(hooks.splits, pauses))
    log("live tracks a stream: start {:.2f}, least {:.2f}, most {:.2f}, "
        "end {:.2f}; a frame and stream: ".format(*record["live_range"])
        + ", ".join(f"{k} {v:.3f}" for k, v in record["events"].items()))
    late = 0
    hooks.times, hooks.splits = {k: [] for k in hooks.times}, []
    while g <= max(kept):  # kept steps the window did not reach
        if g in kept:
            kept_step(g)
            late += 1
        else:
            hooks.step(blobs(g))
        g += 1
    record["late_samples"] = late

    # the check, once the program's state is freed
    del bt, hooks, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for key in ("public_detections", "reid_greedy_matching", "reid_sim_only"):
        if tracker_cfg.get(key):
            raise ValueError(f"the reference tracker has no {key}")
    if not cfg.overflow_boxes:
        raise ValueError("the reference tracker keeps boxes unclipped "
                         "(overflow_boxes)")
    cell = dict(tracker_cfg=tracker_cfg, n_slots=n_slots,
                hidden_dim=int(cfg.hidden_dim))
    t = time.perf_counter()
    ref = check.Reference(conf["model"], ctx.seed, device, dtype)
    detail = []
    nums = check.run_check(cell, samples, streams, cycle, ref, detail=detail,
                           expected=expected)
    record["check_s"] = time.perf_counter() - t
    record["check"], record["check_detail"] = nums, detail
    record["check_samples"] = [s["step"] for s in samples]
    ctx.kept = dict(cell=cell, samples=samples, streams=streams, cycle=cycle,
                    expected=expected)
    return record
