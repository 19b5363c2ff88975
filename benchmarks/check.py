"""Whether what the timed path produced is correct: the program's outputs
at sampled steps against the plain reference.

A step of a stream is three stages: the tracker stages its track-query
slots from its state, the forward maps the frame, the previous frame and
the slots to rows (scores, labels, boxes, embeddings), and the state
machine turns the rows into the next state and the frame's results. The
reference follows the program step by step from the program's own state
before the step (``reference/tracker.py`` cannot follow it over a whole
run: a score that rounds across a threshold in bfloat16 sends the two
states apart for good), and holds each stage to its own reference:

- staging: the reference stages the same state; the slots and the frame
  must be equal, bit for bit (``stage_mismatches``);
- encoder: the reference encoding (``reference/detr.py``, float32, TF32
  off) of the frame against the memory the program made of it and cached
  for the next step (``memory_gap``, the largest relative difference of a
  stream's memory);
- decoder, a layer at a time: each reference decoder layer over the
  program's memories of the frame and of the previous frame (its state, as
  a step finds it; the int8 table is worked out from it again) and over the
  program's output of the layer before (the first: the slots and the
  queries), against the program's output of that layer (``decoder_gap``,
  the largest relative difference of a layer's output for a stream);
- heads: the box refinement and the class head over the program's layer
  outputs, against the fetched rows: ``box_gap_px`` (the largest
  box-coordinate difference of a row that the state machine acts on) and
  ``score_gap`` (the largest score difference).

  On random weights the decoder at the cells' sizes turns a rounding of a
  layer into a difference tens of times larger six layers on (the lite
  cell's: the program's own plain int8 pool in place of its kernel, which
  agrees with it to 2e-5 a call, moves the last layer's output by 5-7 %):
  held over all six layers at once, bfloat16 and fp8 read alike. Held a
  layer at a time, each reads its own rounding;
- state machine: the reference state machine on the program's own rows
  from the program's own state; the next state and the frame's results
  must be equal, bit for bit (``state_mismatches``);
- a stream of a sampled step that was never staged or never consumed is an
  answer that never came (``missing_answers``).

The first step of a run (no tracks, the frame its own previous frame) is
always among the samples: it checks the start that the stepwise
comparison otherwise takes from the program.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import weights
from .reference import tracker as rt
from .reference.detr import TrackFormer
from .reference.lowp import to_fp8


def snapshot(tr) -> rt.State:
    """A program tracker's state as the reference's plain data."""
    def conv(t):
        return rt.Track(int(t.id), np.array(t.pos, copy=True), float(t.score),
                        np.array(t.hs_embed, copy=True), int(t.obj_ind),
                        int(t.count_inactive), int(t.count_termination),
                        [np.array(p, copy=True) for p in t.last_pos])
    return rt.State([conv(t) for t in tr.tracks],
                    [conv(t) for t in tr.inactive_tracks], int(tr.track_num),
                    int(tr.frame_index), int(tr.num_reids))


def frame_results(tr) -> dict:
    """The program tracker's results of the frame it stepped last."""
    f = tr.frame_index - 1
    return {tid: (np.asarray(r[f]["bbox"]), float(r[f]["score"]),
                  int(r[f]["obj_ind"]))
            for tid, r in tr.results.items() if f in r}


def _tracks_equal(a, b):
    return len(a) == len(b) and all(
        x.id == y.id and np.array_equal(x.pos, y.pos) and x.score == y.score
        and np.array_equal(x.hs_embed, y.hs_embed) and x.obj_ind == y.obj_ind
        and x.count_inactive == y.count_inactive
        and x.count_termination == y.count_termination
        and len(x.last_pos) == len(y.last_pos)
        and all(np.array_equal(p, q) for p, q in zip(x.last_pos, y.last_pos))
        for x, y in zip(a, b))


def state_diff(ref: rt.State, got: rt.State, results: dict) -> int:
    """How many parts of the state after a step differ."""
    bad = int(not _tracks_equal(ref.tracks, got.tracks))
    bad += int(not _tracks_equal(ref.inactive, got.inactive))
    bad += int((ref.track_num, ref.frame_index, ref.num_reids)
               != (got.track_num, got.frame_index, got.num_reids))
    same = ref.frame_results.keys() == results.keys() and all(
        np.array_equal(v[0], results[k][0]) and v[1:] == results[k][1:]
        for k, v in ref.frame_results.items())
    return bad + int(not same)


class Reference:
    """The reference model of a configuration on the seed's weights (the
    served values, in float32), with each frame's encoding kept once
    made."""

    def __init__(self, model_cfg, seed, device, served_dtype, fp8=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.device("meta"):
            model = TrackFormer(model_cfg)
        sd = weights.state_dict(model, seed, device, served_dtype)
        model.to_empty(device=device)
        model.load_state_dict({k: v.float() for k, v in sd.items()})
        self.model = to_fp8(model.eval()) if fp8 else model.eval()
        self.device = device
        self.encoded = {}

    @torch.inference_mode()
    def encode(self, key, blob):
        if key not in self.encoded:
            put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device)
            self.encoded[key] = self.model.encode(put(blob["images"]).float(),
                                                  put(blob["pad_mask"]))
        return self.encoded[key]

    @torch.inference_mode()
    def with_memory(self, enc, memory, pad_mask):
        """A frame's encoding with ``memory`` ([S, C], the program's) in
        place of the reference's, laid out by the frame's pad mask."""
        lay = self.model.layout(
            torch.from_numpy(np.asarray(pad_mask)).to(self.device),
            enc["shapes"])
        return dict(lay, memory=memory[None].to(self.device).float())

    @torch.inference_mode()
    def rows(self, cur, prev, slots, orig_size, given) -> dict:
        """The decoder's stages over the given layer outputs ([Q, C] each):
        {scores, labels, boxes, hs_embed} as numpy, "layers" as tensors."""
        put = lambda a: torch.from_numpy(np.asarray(a)).to(self.device)
        out = self.model.decode(cur, prev, put(slots["tq_embeds"]),
                                put(slots["tq_boxes"]), put(slots["tq_mask"]),
                                put(np.array([orig_size], np.float32)),
                                [g[None].to(self.device).float() for g in given])
        layers = [x[0] for x in out.pop("layers")]
        rows = {k: v[0].float().cpu().numpy() for k, v in out.items()}
        return dict(rows, layers=layers)


def head_gaps(got, ref, acted):
    """(score gap, box gap px over the rows in ``acted``) of one stream's
    rows."""
    score = float(np.abs(got["scores"] - ref["scores"]).max())
    box = float(np.abs(got["boxes"][acted] - ref["boxes"][acted]).max()) \
        if acted.any() else 0.0
    return score, box


def acted_rows(out, n_prev, n_slots, c):
    """The rows the state machine acts on: the staged track slots and the
    object rows above the detection threshold."""
    rows = np.zeros(len(out["scores"]), bool)
    rows[:n_prev] = True
    rows[n_slots:] = out["scores"][n_slots:] > c["detection_obj_score_thresh"]
    return rows


def rel_gap(got, want) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()).clamp(min=1e-12))


def run_check(cell, samples, streams, cycle, ref: Reference, control=None,
              detail=None, expected=()):
    """The compared numbers {name: value} over ``samples`` (see
    ``loops/batched_tracking.py``). ``control``: a ``Reference`` (in a
    lower precision) whose rows are judged in place of the program's.
    ``detail``: a list that gets each stream's readings of each step.
    ``expected``: the steps drawn for the check; each stream of one with no
    sample is an answer that never came."""
    c, n_slots = cell["tracker_cfg"], cell["n_slots"]
    hidden, patience = cell["hidden_dim"], c["inactive_patience"]
    nums = dict(missing_answers=0, stage_mismatches=0, state_mismatches=0,
                memory_gap=0.0, decoder_gap=0.0, box_gap_px=0.0, score_gap=0.0)
    have = {smp["step"] for smp in samples}
    nums["missing_answers"] += len(streams) * len(set(expected) - have)
    from .traffic.generator import frame_index
    base = c
    for smp in samples:
        g = smp["step"]
        c = dict(base, **smp.get("thresholds", {}))  # the step's own
        for s, frames in enumerate(streams):
            if s not in smp["inputs"] or s not in smp["outs"] \
                    or s not in smp["after"] or s not in smp["memory"] \
                    or not smp["layers"]:
                nums["missing_answers"] += 1
                continue
            blob = frames[frame_index(g, cycle)]
            st = copy.deepcopy(smp["before"][s])
            staged = rt.stage(st, blob["orig_size"], n_slots, hidden, patience)
            got_in = smp["inputs"][s]
            same = all(np.array_equal(got_in[k], v) for k, v in staged.items())
            same = same and np.array_equal(got_in["images"], blob["images"]) \
                and np.array_equal(got_in["pad_mask"], blob["pad_mask"])
            nums["stage_mismatches"] += int(not same)

            key = (s, frame_index(g, cycle))
            enc = ref.encode(key, blob)
            side = ref if control is None else control
            mem = smp["memory"][s] if control is None else \
                control.encode(key, blob)["memory"][0]
            gap = rel_gap(mem.to(ref.device), enc["memory"][0])
            nums["memory_gap"] = max(nums["memory_gap"], gap)
            prev_blob = blob if g == 0 else frames[frame_index(g - 1, cycle)]
            cur = ref.with_memory(enc, smp["memory"][s], blob["pad_mask"])
            prev = cur if g == 0 else ref.with_memory(
                enc, smp["prev_memory"][s], prev_blob["pad_mask"])
            given = [x[s] for x in smp["layers"]]
            want = ref.rows(cur, prev, staged, blob["orig_size"], given)
            if control is None:
                got, layers = smp["outs"][s], given
            else:
                got = side.rows(cur, prev, staged, blob["orig_size"], given)
                layers = got["layers"]
            dec = max(rel_gap(x.to(ref.device), y)
                      for x, y in zip(layers, want["layers"]))
            nums["decoder_gap"] = max(nums["decoder_gap"], dec)
            acted = acted_rows(got, st.num_prev, n_slots, c) | \
                acted_rows(want, st.num_prev, n_slots, c)
            score, box = head_gaps(got, want, acted)
            nums["score_gap"] = max(nums["score_gap"], score)
            nums["box_gap_px"] = max(nums["box_gap_px"], box)
            if detail is not None:
                diff = np.abs(got["boxes"][acted] - want["boxes"][acted])
                detail.append(dict(step=g, stream=s, score=score, box=box,
                                   decoder=dec, memory=gap,
                                   box_p50=float(np.median(diff)) if diff.size
                                   else 0.0, acted=int(acted.sum())))

            rt.consume(st, smp["outs"][s], c, n_slots)
            after, results = smp["after"][s]
            nums["state_mismatches"] += state_diff(st, after, results)
    return nums
