"""Tracking entry point (port of ``kinet_tpu/engine/track.py``; reference:
TrackFormer's src/track.py).

    python -m kinet_tpu_torch.engine.track --config track.yaml \
        obj_detect_checkpoint_dir=models/exp1 dataset_name=MOT17-02-FRCNN

runs on the GPU; ``device=cpu`` runs it on the CPU. Pipeline, as in the
JAX package:
- reload the train-time ``config.yaml`` of the checkpoint and rebuild the
  model exactly, then restore its weights (``utils/checkpoint.py``); the
  model runs in the dtype its weights were saved in;
- ``Tracker`` over every sequence of ``TrackDatasetFactory``, a worker
  thread decoding frame i + 1 while the tracker steps frame i; a KineT
  model (``kinet`` in the track config or ``kine`` in the model's)
  runs ``TrackerKinematic`` on each frame's public detections
  (``_kine_blob``; the frame's JPEG is decoded all the same, as in the JAX
  package);
- ``generate_attention_maps`` (vanilla DETR only): per-query decoder
  attention maps in the results;
- write MOTChallenge result files, optional linear gap interpolation; a
  run with a mask head (``masks``) over MOTS20 sequences
  (``dataset_name=MOTS20-02`` ...) writes MOTS result lines with each
  track's RLE mask (``data/mots20_sequence.py``);
- CLEAR-MOT, IDF1 and HOTA over all sequences with ground truth;
- ``batch_sequences: N`` > 1 steps up to N sequences of one padded frame
  shape through one forward a step (``tracking/batched.py``, in the form
  ``batch_exec`` names); every decision stays each sequence's own;
- over several processes (an initialised ``torch.distributed`` group,
  ``utils/dist.py``) each process tracks every world-th sequence from its
  rank, and the metrics accumulators of all processes are gathered, so
  each process prints the summary over every sequence; a tensor-parallel
  live model (evaluation during training, ``parallel/tp.py``) splits the
  sequences over its data groups, every rank of a model group tracking
  the same ones, and only the first rank of each model group writes and
  contributes its accumulators;
- ``spatial_parallel: N`` > 1 (N must be the process count): every
  process serves every frame of every sequence, each frame's rows split
  over the N processes (``parallel/sp.py``), with the outputs replicated,
  so each runs the same host state machine; rank 0 alone writes the
  result files and prints the metrics. Not with ``batch_sequences`` > 1
  nor a KineT model;
- ``write_images`` (with an ``output_dir``): each sequence's frames with
  its tracks' boxes as ``output_dir/<dataset dir>/<sequence>/%06d.jpg``
  (``utils/vis.py::plot_sequence``), written by the process that writes
  the result files, after the frame loop (the RUNTIME line leaves it out);
- ``trace=true`` on the command line (a key ``cfgs/track.yaml`` leaves
  out; off unless given) turns on the port's tracer (``utils/trace.py``)
  for the run; after the RUNTIME line one line a span (count, median and 95th
  percentile in ms: the step, its stage and state machine a stream, the
  host-to-device copy, the forward and its backbone, encoder, decoder and
  postprocess, the fetch) and one of the counters (frames, MB copied to
  the device, tracks born, re-identified, ended, live a frame).
"""
from __future__ import annotations

import argparse
import os.path as osp
import time

import numpy as np
import torch
import torch.distributed as tdist

from ..config import Config, load_config, load_saved_config, parse_cli_overrides
from ..data.sequences import TrackDatasetFactory
from ..models.build import build_model, kine_dims, resolve_device
from ..models.postprocess import build_postprocessors
from ..parallel.mesh import mesh_of
from ..tracking.batched import (
    BatchedTracker,
    BatchedTrackerKinematic,
    run_batched,
)
from ..tracking.kine_tracker import TrackerKinematic
from ..tracking.tracker import Tracker
from ..utils import dist, trace
from ..utils.checkpoint import CheckpointManager
from ..utils.mot_metrics import evaluate_mot_accums, format_summary, get_mot_accum
from ..utils.vis import plot_sequence


def _dataset_dirname(dataset_name) -> str:
    """Output subdir for result files: dataset_name may be a YAML list
    or a comma-separated string; normalize to one path-safe token."""
    if isinstance(dataset_name, (list, tuple)):
        return ",".join(str(n).strip() for n in dataset_name)
    return str(dataset_name).strip()


def interpolate_tracks(tracks: dict) -> dict:
    """Linear gap interpolation (the evident intent of the reference's
    track_utils.py:240-272)."""
    out = {}
    for tid, frames in tracks.items():
        out[tid] = dict(frames)
        keys = sorted(frames.keys())
        for a, b in zip(keys[:-1], keys[1:]):
            if b - a <= 1:
                continue
            ba = np.asarray(frames[a]["bbox"], np.float64)
            bb = np.asarray(frames[b]["bbox"], np.float64)
            for f in range(a + 1, b):
                t = (f - a) / (b - a)
                out[tid][f] = {
                    "bbox": (ba * (1 - t) + bb * t).astype(np.float32),
                    "score": frames[a]["score"],
                    "obj_ind": frames[a].get("obj_ind", -1),
                }
    return out


class _Prefetcher:
    """Single-worker look-ahead frame loader: decodes + preprocesses frame
    i+1 on a thread while the tracker steps frame i, overlapping host IO
    with device work. Worker exceptions are re-raised in the consumer."""

    def __init__(self, seq, start: int, end: int, depth: int = 2):
        import queue
        import threading

        self._q = queue.Queue(maxsize=depth)
        self._exc = None
        self._stop = threading.Event()
        self._t = threading.Thread(
            target=self._work, args=(seq, start, end), daemon=True
        )
        self._t.start()

    def _work(self, seq, start, end):
        import queue

        try:
            for i in range(start, end):
                blob = seq[i]
                # bounded put + stop checks: if the consumer aborts its
                # frame loop (e.g. a tracker exception), close() raises the
                # stop flag and this worker exits instead of blocking on a
                # full queue forever
                while not self._stop.is_set():
                    try:
                        self._q.put(blob, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._exc = e
        finally:
            # the sentinel MUST be delivered (a dropped sentinel deadlocks
            # the consumer at q.get() once it drains the remaining blobs,
            # when the consumer lags the producer by >= depth at the end of
            # a sequence); retry until it lands or close() stops us
            while not self._stop.is_set():
                try:
                    self._q.put(None, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self):
        """Unblock and join the worker (idempotent; safe mid-iteration)."""
        import queue

        self._stop.set()
        while self._t.is_alive():
            try:  # drain so a blocked put can observe the stop flag
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.05)

    def __iter__(self):
        while True:
            blob = self._q.get()
            if blob is None:
                if self._exc is not None:
                    raise self._exc
                return
            yield blob

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False


def restore_model(ckpt_dir, device, train_cfg=None):
    """(model, train_cfg) from a training run's output directory: its saved
    config (``train_cfg`` if given) rebuilds the model, its checkpoint fills
    the weights (strictly), and the model takes the dtype the weights were
    saved in."""
    if train_cfg is None:
        train_cfg = load_saved_config(ckpt_dir)
    model, _ = build_model(train_cfg, device=device)
    restored = CheckpointManager(ckpt_dir).restore()
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    params = restored["params"]
    dtypes = {t.dtype for t in params.values() if t.is_floating_point()}
    if len(dtypes) != 1:
        raise ValueError(f"checkpoint weights in several dtypes: {dtypes}")
    model.to(dtypes.pop())
    model.load_state_dict(params)
    model.eval()
    return model, train_cfg


def main_track(cfg, obj_detector_model=None):
    """Tracks every sequence of ``cfg.dataset_name`` and returns the
    metrics summary (None without ground truth). ``obj_detector_model``:
    (model, postprocessors, train_cfg) instead of the checkpoint in
    ``cfg.obj_detect_checkpoint_dir``; the model holds its weights, runs
    on ``cfg.device`` (the card when it is not set) and is left in the
    mode, and on the device, it had."""
    seed = int(cfg.get("seed", 333))
    np.random.seed(seed)
    device = resolve_device(cfg.get("device"))

    _spatial_processes(cfg)

    if obj_detector_model is None:
        train_cfg = load_saved_config(cfg.obj_detect_checkpoint_dir)
    else:
        model, _, train_cfg = obj_detector_model
    # attention maps: vanilla DETR only (the KineT tracker ignores them)
    gen_attn = bool(cfg.get("generate_attention_maps", False))
    if gen_attn and train_cfg.get("deformable", False):
        raise ValueError(
            "Generation of attention maps not possible for deformable DETR.")
    if obj_detector_model is None:
        model, _ = restore_model(cfg.obj_detect_checkpoint_dir, device,
                                 train_cfg)
    # a live model (evaluation during training) goes back to its mode and
    # device afterwards
    mode, where = model.training, next(model.parameters()).device
    model.to(device).eval()
    if cfg.get("trace", False):
        trace.enable()
    try:
        return _track_sequences(cfg, model, train_cfg, gen_attn)
    finally:
        model.to(where).train(mode)
        if cfg.get("trace", False):
            trace.disable()


def _spatial_processes(cfg, train_cfg=None) -> int:
    """``spatial_parallel`` (0 or 1: off), checked against the run: the
    process count, ``batch_sequences`` and, given its train config, the
    model (JAX ``engine/track.py:205-231``)."""
    n = int(cfg.get("spatial_parallel", 0))
    if n <= 1:
        return 1
    if n != dist.get_world_size():
        raise ValueError(f"spatial_parallel {n} needs {n} processes, the "
                         f"group has {dist.get_world_size()}")
    if int(cfg.get("batch_sequences", 1)) > 1:
        raise ValueError("spatial_parallel and batch_sequences > 1 are "
                         "mutually exclusive serving modes")
    if cfg.get("kinet", False) or (train_cfg is not None
                                   and train_cfg.get("kine", False)):
        raise ValueError("spatial_parallel splits image rows; a KineT model "
                         "reads no image")
    return n


def _kine_blob(blob: dict, max_det: int) -> dict:
    """An image-sequence blob as the kinematic tracker's input: the public
    detections as normalized cxcywh with their confidences, and the
    absolute boxes for public-detection filtering."""
    h0, w0 = blob["orig_size"]
    d = blob["dets"]
    cxcywh = np.stack(
        [
            (d[:, 0] + d[:, 2]) / 2 / w0,
            (d[:, 1] + d[:, 3]) / 2 / h0,
            (d[:, 2] - d[:, 0]) / w0,
            (d[:, 3] - d[:, 1]) / h0,
        ],
        axis=1,
    ) if len(d) else np.zeros((0, 4), np.float32)
    return {
        "detections": cxcywh.astype(np.float32),
        "metadata": blob.get("dets_conf", np.ones(len(d), np.float32))[:, None],
        "orig_size": blob["orig_size"],
        "max_detections": max_det,
        "dets": d,
    }


def _tracker_cfg(cfg) -> dict:
    tracker_cfg = (
        cfg.tracker_cfg.to_dict()
        if isinstance(cfg.tracker_cfg, Config)
        else dict(cfg.tracker_cfg)
    )
    # the batched mode's execution form: a top-level track.yaml key
    tracker_cfg.setdefault("batch_exec", cfg.get("batch_exec", "auto"))
    return tracker_cfg


def _make_tracker(cfg, model, train_cfg, gen_attn, n_sequences=None,
                  spatial_group=None):
    """The config's tracker, or with ``n_sequences`` its batched tracker
    over that many sequences; ``spatial_group``: the spatially parallel
    forward's group."""
    post = build_postprocessors(train_cfg)["bbox"]
    common = dict(
        num_object_queries=int(train_cfg.num_queries),
        num_track_slots=int(train_cfg.get("max_track_queries", 100)),
        overflow_boxes=bool(train_cfg.get("overflow_boxes", False)),
    )
    batched = {} if n_sequences is None else {"n_sequences": n_sequences}
    if cfg.get("kinet", False) or train_cfg.get("kine", False):
        trail_len, enc, meta_dim = kine_dims(train_cfg)
        cls = TrackerKinematic if n_sequences is None else BatchedTrackerKinematic
        return cls(model, post, _tracker_cfg(cfg), trail_len=trail_len,
                   trail_enc_dim=enc, meta_dim=meta_dim, **common, **batched)
    if spatial_group is not None:
        batched["spatial_group"] = spatial_group
    cls = Tracker if n_sequences is None else BatchedTracker
    return cls(model, post, _tracker_cfg(cfg),
               hidden_dim=int(train_cfg.hidden_dim),
               generate_attention_maps=gen_attn, **common, **batched)


def _write_and_score(cfg, seq, results, num_reids, accums, accum_names,
                     write=True):
    if cfg.get("interpolate", False):
        results = interpolate_tracks(results)
    if cfg.output_dir and write:
        out_dir = osp.join(cfg.output_dir, _dataset_dirname(cfg.dataset_name))
        seq.write_results(results, out_dir)
        if cfg.get("write_images", False):
            plot_sequence(results, seq, osp.join(out_dir, str(seq)),
                          write_images=cfg.write_images)
    if not seq.no_gt:
        accums.append(get_mot_accum(results, seq))
        accum_names.append(str(seq))
    print(f"NUM TRACKS: {len(results)} ReIDs: {num_reids}", flush=True)


def _track_sequences(cfg, model, train_cfg, gen_attn=False):
    kinet = bool(cfg.get("kinet", False) or train_cfg.get("kine", False))
    max_det = int(train_cfg.get("max_number_detection", 0))
    dataset = TrackDatasetFactory(
        cfg.dataset_name,
        root_dir=cfg.data_root_dir,
        img_transform=train_cfg.img_transform,
    )
    # over several processes each data group tracks every data_world-th
    # sequence; the accumulators are gathered below (reference
    # engine.py:291-304, 333-344). Spatially parallel: every process serves
    # every sequence, and rank 0 writes.
    world = dist.get_world_size()
    spatial = _spatial_processes(cfg, train_cfg) > 1
    mesh = mesh_of(model)
    seqs = list(dataset)
    if not spatial:
        seqs = seqs[mesh.data_rank::mesh.data_world]
    # the first rank of each model group writes and scores; with spatial
    # parallelism rank 0
    lead = dist.is_main_process() if spatial else mesh.model_rank == 0

    time_total = 0.0
    num_frames = 0
    accums, accum_names = [], []
    batch_n = int(cfg.get("batch_sequences", 1))
    if batch_n > 1 and not cfg.get("load_results_dir"):
        time_total, num_frames = _track_batched(
            cfg, model, train_cfg, gen_attn, seqs, batch_n, accums,
            accum_names)
        seqs = []
    spatial_group = tdist.group.WORLD if spatial else None
    tracker = (_make_tracker(cfg, model, train_cfg, gen_attn,
                             spatial_group=spatial_group)
               if seqs else None)
    for seq in seqs:
        tracker.reset()
        print(f"TRACK SEQ: {seq}", flush=True)
        start_frame = int(cfg.frame_range.start * len(seq))
        end_frame = int(cfg.frame_range.end * len(seq))
        t0 = time.time()
        results = None
        if cfg.get("load_results_dir"):
            results = seq.load_results(cfg.load_results_dir)
        if not results:
            # the context manager stops the worker thread even if
            # tracker.step raises mid-sequence
            with _Prefetcher(seq, start_frame, end_frame) as frames:
                for blob in frames:
                    if kinet:
                        blob = _kine_blob(blob, max_det)
                    tracker.step(blob)
                    num_frames += 1
            results = tracker.get_results()
        time_total += time.time() - t0
        _write_and_score(cfg, seq, results, tracker.num_reids, accums,
                         accum_names, write=lead)

    if num_frames:
        print(
            f"RUNTIME ALL SEQS (w/o EVAL or IMG WRITE): "
            f"{time_total:.2f} s for {num_frames} frames "
            f"({num_frames / max(time_total, 1e-9):.2f} Hz)",
            flush=True,
        )
        if cfg.get("trace", False):
            print("\n".join(trace.summary(trace.drain())), flush=True)
    if world > 1 and not spatial:
        gathered = dist.all_gather_objects(
            (accums, accum_names) if lead else ([], []))
        accums = [a for accs, _ in gathered for a in accs]
        accum_names = [n for _, names in gathered for n in names]
    if accums:
        summary = evaluate_mot_accums(accums, accum_names)
        if lead:
            print(format_summary(summary), flush=True)
        return summary
    return None


def _track_batched(cfg, model, train_cfg, gen_attn, seqs, batch_n, accums,
                   accum_names):
    """Groups the sequences by padded frame shape (a KineT model's forward
    reads no image: one group) and tracks each group in chunks of at most
    ``batch_n`` through a batched tracker, one per chunk size, reset
    between chunks, with one prefetch thread per sequence. Returns
    (seconds, frames)."""
    kinet = bool(cfg.get("kinet", False) or train_cfg.get("kine", False))
    max_det = int(train_cfg.get("max_number_detection", 0))
    groups: dict[tuple, list] = {}
    for seq in seqs:
        if kinet:
            shape = ("kine",)
        else:
            # the first frame in range: the batch starts on it
            probe = min(int(cfg.frame_range.start * len(seq)),
                        max(len(seq) - 1, 0))
            shape = tuple(seq[probe]["images"].shape)
        groups.setdefault(shape, []).append(seq)

    time_total, num_frames = 0.0, 0
    by_size: dict[int, object] = {}
    for shape, group in groups.items():
        for i0 in range(0, len(group), batch_n):
            chunk = group[i0:i0 + batch_n]
            batched = by_size.get(len(chunk))
            if batched is None:
                batched = by_size[len(chunk)] = _make_tracker(
                    cfg, model, train_cfg, gen_attn, n_sequences=len(chunk))
            else:
                batched.reset()
            desc = "kine" if kinet else f"{shape[1]}x{shape[2]}"
            print(f"TRACK BATCH ({len(chunk)} seqs, {desc}): "
                  + ", ".join(str(s) for s in chunk), flush=True)
            ranges = [(int(cfg.frame_range.start * len(s)),
                       int(cfg.frame_range.end * len(s))) for s in chunk]
            t0 = time.time()
            prefetchers = [_Prefetcher(s, a, b)
                           for s, (a, b) in zip(chunk, ranges)]

            def frames(p):
                for blob in p:
                    yield _kine_blob(blob, max_det) if kinet else blob

            try:
                run_batched(batched, [frames(p) for p in prefetchers])
            finally:
                for p in prefetchers:
                    p.close()
            time_total += time.time() - t0
            num_frames += sum(b - a for a, b in ranges)
            for i, seq in enumerate(chunk):
                _write_and_score(cfg, seq, batched.get_results(i),
                                 batched.trackers[i].num_reids, accums,
                                 accum_names,
                                 write=mesh_of(model).model_rank == 0)
    return time_total, num_frames


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="track.yaml")
    p.add_argument("--named", nargs="*", default=[])
    p.add_argument("overrides", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = load_config(
        args.config, named=args.named,
        overrides=parse_cli_overrides(args.overrides),
    )
    main_track(cfg)


if __name__ == "__main__":
    main()
