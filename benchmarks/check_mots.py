"""Whether what the MOTS cell's timed path produced is correct: the
program's outputs at sampled steps against the plain reference
(``reference/detr_segm.py``, float32, TF32 off;
``reference/mots_tracker.py``), stage by stage as ``check.py`` does.

Each stage's reference runs on the program's own input of that stage, so
each reading is that stage's own rounding:

- staging: the reference stages the program's state before the step; the
  slots and the frame must be equal, bit for bit (``stage_mismatches``);
- backbone: the reference's C2..C5 of the frame against the program's
  (``feature_gap``, the largest relative L2 gap of a level);
- encoder: the reference's input projection and encoder over the
  program's C5 against the program's projected C5 and memory
  (``memory_gap``, the larger gap of the two);
- decoder, a layer at a time: each reference layer over the program's
  memory and the program's output of the layer before (the first: the
  staged slots and the queries), against the program's output of that
  layer, and the shared norm of the program's last layer against the
  program's normed output that the mask head reads (``decoder_gap``);
- heads: the class and box heads over the program's last layer, against
  the fetched rows: ``box_gap_px`` (over the rows the state machine acts
  on) and ``score_gap``;
- mask head: the reference's attention map and mask head over the
  program's normed last layer, memory, projected C5 and C4..C2 (its
  backbone's) and the frame's pad mask, against
  the program's mask logits [Q, H/4, W/4], over the acted rows
  (``mask_gap``: the largest relative L2 gap of a row), computed in blocks
  of ``BLOCK`` rows;
- upsample: the fetched probabilities against a float32 bilinear upsample
  and sigmoid of the program's own logits, over the rows the state machine
  acts on (``prob_gap``: the largest absolute difference);
- state machine: the reference state machine with masks on the program's
  rows and probabilities from the program's state; the next state, every
  track's mask and the frame's results (each mask with them) must be
  equal, bit for bit (``state_mismatches``);
- a stream of a sampled step that was never staged or never consumed is an
  answer that never came (``missing_answers``).

With ``control`` (a ``Reference`` in fp8, ``reference/lowp.py``) the
control's stage takes the program's place on the same inputs, and its
upsample takes its logits in fp8 as its convolutions take their inputs.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from . import weights_segm
from .check import acted_rows, head_gaps, rel_gap
from .reference import mots_tracker as rm
from .reference.detr_segm import DetrSegm, sine2d
from .reference.lowp import fp8_round, to_fp8
from .traffic.generator import frame_index

BLOCK = 16  # rows of the reference mask head at once


def _track(t) -> rm.Track:
    return rm.Track(int(t.id), np.array(t.pos, copy=True), float(t.score),
                    np.array(t.hs_embed, copy=True), int(t.obj_ind),
                    int(t.count_inactive), int(t.count_termination),
                    [np.array(p, copy=True) for p in t.last_pos],
                    mask=None if t.mask is None else np.array(t.mask, copy=True))


def snapshot(tr) -> rm.State:
    """A program tracker's state, masks included, as the reference's data."""
    return rm.State([_track(t) for t in tr.tracks],
                    [_track(t) for t in tr.inactive_tracks],
                    int(tr.track_num), int(tr.frame_index), int(tr.num_reids))


def frame_results(tr) -> dict:
    """The program tracker's results of the frame it stepped last:
    {id: (bbox, score, obj_ind, mask)}."""
    f = tr.frame_index - 1
    return {tid: (np.asarray(r[f]["bbox"]), float(r[f]["score"]),
                  int(r[f]["obj_ind"]), r[f].get("mask"))
            for tid, r in tr.results.items() if f in r}


def _same_mask(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and np.array_equal(a, b)


def _tracks_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.id == y.id and np.array_equal(x.pos, y.pos) and x.score == y.score
        and np.array_equal(x.hs_embed, y.hs_embed) and x.obj_ind == y.obj_ind
        and x.count_inactive == y.count_inactive
        and x.count_termination == y.count_termination
        and len(x.last_pos) == len(y.last_pos)
        and all(np.array_equal(p, q) for p, q in zip(x.last_pos, y.last_pos))
        and _same_mask(x.mask, y.mask)
        for x, y in zip(a, b))


def state_diff(ref: rm.State, got: rm.State, results: dict) -> int:
    """How many parts of the state after a step differ."""
    bad = int(not _tracks_equal(ref.tracks, got.tracks))
    bad += int(not _tracks_equal(ref.inactive, got.inactive))
    bad += int((ref.track_num, ref.frame_index, ref.num_reids)
               != (got.track_num, got.frame_index, got.num_reids))
    same = ref.frame_results.keys() == results.keys() and all(
        np.array_equal(v[0], results[k][0]) and v[1:3] == results[k][1:3]
        and _same_mask(v[3], results[k][3])
        for k, v in ref.frame_results.items())
    return bad + int(not same)


def row_gap(got, want) -> float:
    """The largest relative L2 gap of a row of [R, ...] tensors."""
    if not len(want):
        return 0.0
    dims = tuple(range(1, want.dim()))
    num = torch.linalg.vector_norm(got.float() - want.float(), dim=dims)
    den = torch.linalg.vector_norm(want.float(), dim=dims).clamp(min=1e-12)
    return float((num / den).max())


class Reference:
    """The reference model of a configuration on the seed's weights (the
    served values, in float32; ``c5_mean``: the run's, from ``c5_mean``
    below, see ``weights_segm.py``), stage by stage."""

    def __init__(self, model_cfg, seed, device, served_dtype, c5_mean,
                 fp8=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.device("meta"):
            model = DetrSegm(model_cfg)
        sd = weights_segm.state_dict(model, seed, device, served_dtype,
                                     c5_mean)
        model.to_empty(device=device)
        model.load_state_dict({k: v.float() for k, v in sd.items()})
        self.model = to_fp8(model.eval()) if fp8 else model.eval()
        self.device, self.fp8 = device, fp8

    def put(self, a):
        if torch.is_tensor(a):
            return a.to(self.device).float() if a.is_floating_point() \
                else a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def features(self, blob):
        """A frame's C2..C5 [C, h, w]."""
        return [f[0] for f in self.model.features(
            self.put(blob["images"]).float())]

    @torch.inference_mode()
    def encode(self, c5, pad):
        """(the projected C5 [D, h, w], the encoder's memory [S, D]) over
        C5 [2048, h, w] and the frame's pad mask [1, H, W]."""
        enc = self.model.encode(self.put(c5)[None], self.put(pad))
        return enc["src_proj"][0], enc["memory"][0]

    def pad(self, pad, hw):
        """The frame's pad mask [1, H, W] at a level of size ``hw``, flat."""
        return self.model.level_pad(self.put(pad), hw).reshape(-1)

    @torch.inference_mode()
    def layers(self, given, slots, memory, pad, shapes):
        """Each decoder layer over the given input (the first: the staged
        slots) and the program's memory [S, D]: [N, D] each."""
        m = self.model
        h, w = shapes
        lvl_pad = m.level_pad(self.put(pad), (h, w))
        enc = dict(memory=self.put(memory)[None],
                   pos=sine2d(lvl_pad, m.d).reshape(1, h * w, m.d),
                   pad=lvl_pad.reshape(1, h * w))
        query_pos, tgt, tgt_pad = m.slots(self.put(slots["tq_embeds"]),
                                          self.put(slots["tq_mask"]))
        ins = [tgt] + [self.put(x)[None] for x in given[:-1]]
        return [m.decoder_layer(i, x, query_pos, tgt_pad, enc)[0]
                for i, x in enumerate(ins)]

    @torch.inference_mode()
    def heads(self, last, orig_size):
        """({scores, labels, boxes} as numpy, the normed output [N, D]) of
        the last layer's output [N, D]."""
        out = self.model.heads(self.put(last)[None], self.put(
            np.array([orig_size], np.float32)))
        return ({k: v[0].cpu().numpy() for k, v in out.items()
                 if k != "hs_last"}, out["hs_last"][0])

    @torch.inference_mode()
    def mask_logits(self, rows, hs_last, memory, pad, src_proj, fpns):
        """The mask logits of ``rows`` [R, H4, W4], in blocks of rows."""
        args = [self.put(x) for x in (memory, pad, src_proj)]
        fpns = [self.put(f) for f in fpns]
        hs = self.put(hs_last)[torch.as_tensor(rows, dtype=torch.long)]
        return torch.cat([self.model.mask_logits(hs[i:i + BLOCK], *args, fpns)
                          for i in range(0, len(rows), BLOCK)]) if len(rows) \
            else hs.new_zeros(0, *fpns[-1].shape[-2:])

    @torch.inference_mode()
    def probs(self, logits, hw):
        """The bilinear upsample to ``hw`` and sigmoid of [R, h, w] logits,
        in float32 (their input in fp8 for the control)."""
        x = self.put(logits)
        if self.fp8:
            x = fp8_round(x)
        return F.interpolate(x[None], size=tuple(hw), mode="bilinear",
                             align_corners=False)[0].sigmoid()


def c5_mean(model_cfg, seed, device, served_dtype, blob) -> torch.Tensor:
    """The C5 feature of the frame ``blob`` averaged over positions ([2048],
    float64, on the host), by the reference's own float32 backbone on the
    seed's weights (which do not depend on it): the value that both the
    program's and the reference's input projection centre (see
    ``weights_segm.py``). TF32 is left as it was found."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        ref = Reference(model_cfg, seed, device, served_dtype, None)
        return weights_segm.c5_mean(ref.features(blob)[-1][None])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def run_check(cell, samples, streams, cycle, ref: Reference, control=None,
              detail=None, expected=()):
    """The compared numbers {name: value} over ``samples`` (see
    ``loops/batched_mots.py``). ``control``: a ``Reference`` (in fp8)
    whose stages are judged in place of the program's. ``detail``: a list
    that gets each stream's readings of each step. ``expected``: the steps
    drawn for the check; each stream of one with no sample is an answer
    that never came."""
    c, n_slots = cell["tracker_cfg"], cell["n_slots"]
    hidden, patience = cell["hidden_dim"], c["inactive_patience"]
    nums = dict(missing_answers=0, stage_mismatches=0, state_mismatches=0,
                feature_gap=0.0, memory_gap=0.0, decoder_gap=0.0,
                box_gap_px=0.0, score_gap=0.0, mask_gap=0.0, prob_gap=0.0)
    have = {smp["step"] for smp in samples}
    nums["missing_answers"] += len(streams) * len(set(expected) - have)
    side = ref if control is None else control
    base = c
    for smp in samples:
        g = smp["step"]
        c = dict(base, **smp.get("thresholds", {}))
        for s, frames in enumerate(streams):
            if any(s not in smp[k] for k in ("inputs", "outs", "after",
                                             "feats", "mask_in")) \
                    or not smp["layers"]:
                nums["missing_answers"] += 1
                continue
            blob = frames[frame_index(g, cycle)]
            st = copy.deepcopy(smp["before"][s])
            staged = rm.stage(st, blob["orig_size"], n_slots, hidden, patience)
            got_in = smp["inputs"][s]
            same = all(np.array_equal(got_in[k], v) for k, v in staged.items())
            same = same and np.array_equal(got_in["images"], blob["images"]) \
                and np.array_equal(got_in["pad_mask"], blob["pad_mask"])
            nums["stage_mismatches"] += int(not same)

            feats = smp["feats"][s]  # the program's C2..C5
            want = ref.features(blob)
            got = feats if control is None else control.features(blob)
            feat = max(rel_gap(x.to(ref.device), y) for x, y in zip(got, want))
            mi = smp["mask_in"][s]  # hs_last, memory, src_proj, logits
            h5, w5 = mi["memory"].shape[:2]
            mem_prog = mi["memory"].reshape(h5 * w5, -1)
            want = ref.encode(feats[-1], blob["pad_mask"])
            got = (mi["src_proj"], mem_prog) if control is None else \
                control.encode(feats[-1], blob["pad_mask"])
            mem = max(rel_gap(x.to(ref.device), y) for x, y in zip(got, want))
            given = [x[s] for x in smp["layers"]]
            args = (given, staged, mem_prog, blob["pad_mask"], (h5, w5))
            want_rows, want_norm = ref.heads(given[-1], blob["orig_size"])
            if control is None:
                got_layers, got_rows = given, smp["outs"][s]
                got_norm = mi["hs_last"]
            else:
                got_layers = control.layers(*args)
                got_rows, got_norm = control.heads(given[-1],
                                                   blob["orig_size"])
            dec = max(rel_gap(x.to(ref.device), y) for x, y in zip(
                got_layers + [got_norm], ref.layers(*args) + [want_norm]))
            acted_got = acted_rows(smp["outs"][s], st.num_prev, n_slots, c)
            acted = acted_got | acted_rows(want_rows, st.num_prev, n_slots, c)
            score, box = head_gaps(got_rows, want_rows, acted)

            rows = np.nonzero(acted)[0]
            margs = (mi["hs_last"], mi["memory"],
                     ref.pad(blob["pad_mask"], (h5, w5)), mi["src_proj"],
                     feats[-2::-1])
            logits_want = ref.mask_logits(rows, *margs)
            logits_got = mi["logits"][rows] if control is None else \
                control.mask_logits(rows, *margs)
            mask = row_gap(logits_got.to(ref.device), logits_want)
            mine = np.nonzero(acted_got)[0]
            hw = blob["images"].shape[1:3]
            prob = 0.0
            if len(mine):
                prob_want = ref.probs(mi["logits"][mine], hw)
                if control is None:
                    fetched = smp["outs"][s]["mask_probs"]
                    prob_got = ref.put(np.stack([fetched[r] for r in mine]))
                else:
                    prob_got = control.probs(mi["logits"][mine], hw)
                prob = float((prob_got - prob_want).abs().max())
            for k, v in (("feature_gap", feat), ("memory_gap", mem),
                         ("decoder_gap", dec), ("score_gap", score),
                         ("box_gap_px", box), ("mask_gap", mask),
                         ("prob_gap", prob)):
                nums[k] = max(nums[k], v)
            if detail is not None:
                detail.append(dict(step=g, stream=s, feature=feat, memory=mem,
                                   decoder=dec, score=score, box=box,
                                   mask=mask, prob=prob, acted=int(len(rows))))

            rm.consume(st, smp["outs"][s], c, n_slots,
                       blob["orig_size"] if cell["clip"] else None)
            after, results = smp["after"][s]
            nums["state_mismatches"] += state_diff(st, after, results)
    return nums
