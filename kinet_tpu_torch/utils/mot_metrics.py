"""MOTChallenge metrics: CLEAR-MOT (MOTA/MOTP/FP/FN/IDSW), ID measures
(IDF1/IDP/IDR) and HOTA, self-contained numpy: the port's own copy of
``kinet_tpu/utils/mot_metrics.py``, with the same algorithms and numbers.

- CLEAR-MOT matching (Bernardin & Stiefelhagen 2008): per frame, persist
  previous correspondences whose IoU distance still <= 0.5, then
  min-cost (1 - IoU) Hungarian on the rest; count FP / miss / switch.
- ID measures (Ristani et al. 2016): global bipartite assignment between
  GT and hypothesis trajectories minimising unmatched frames; IDF1 =
  2·IDTP / (2·IDTP + IDFP + IDFN).
- HOTA (Luiten et al. 2021): per localization threshold α, per-frame
  Hungarian on global-alignment·IoU scores, DetA·AssA decomposition,
  geometric mean, averaged over α ∈ {0.05..0.95}. HOTA needs the RAW IoU
  (not the CLEAR-clipped distance), so `update()` takes an optional `sim`
  similarity matrix.

`MOTAccumulator.update(gt_ids, hyp_ids, dist)` has the shape of the
motmetrics API that the reference tracker (TrackFormer) calls.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

INF = 1e9


def iou_matrix(gt_boxes: np.ndarray, hyp_boxes: np.ndarray) -> np.ndarray:
    """Pairwise IoU for xywh boxes (raw, unclipped — HOTA similarity)."""
    if len(gt_boxes) == 0 or len(hyp_boxes) == 0:
        return np.zeros((len(gt_boxes), len(hyp_boxes)))
    g = gt_boxes.astype(np.float64)
    h = hyp_boxes.astype(np.float64)
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    hx2, hy2 = h[:, 0] + h[:, 2], h[:, 1] + h[:, 3]
    x0 = np.maximum(g[:, None, 0], h[None, :, 0])
    y0 = np.maximum(g[:, None, 1], h[None, :, 1])
    x1 = np.minimum(gx2[:, None], hx2[None, :])
    y1 = np.minimum(gy2[:, None], hy2[None, :])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    union = (g[:, 2] * g[:, 3])[:, None] + (h[:, 2] * h[:, 3])[None] - inter
    return inter / np.maximum(union, 1e-12)


def iou_distance(gt_boxes: np.ndarray, hyp_boxes: np.ndarray, max_iou=0.5):
    """1 - IoU of xywh boxes, NaN (unmatchable) where it is above
    `max_iou` (the motmetrics convention)."""
    if len(gt_boxes) == 0 or len(hyp_boxes) == 0:
        return np.full((len(gt_boxes), len(hyp_boxes)), np.nan)
    dist = 1.0 - iou_matrix(gt_boxes, hyp_boxes)
    dist[dist > max_iou] = np.nan
    return dist


class MOTAccumulator:
    """Per-sequence event accumulator (motmetrics.MOTAccumulator shape)."""

    def __init__(self):
        self.events = []  # list of per-frame dicts
        self._last_match = {}  # gt_id -> hyp_id
        # per-trajectory bookkeeping for ID measures
        self.gt_frames = {}  # gt_id -> list[(frame, box_idx key)]
        self.frame_pairs = []  # (frame, gt_ids, hyp_ids, dist)
        self.frame_sims = []  # raw IoU similarity per frame (HOTA)
        self.frame_idx = 0
        # track-quality bookkeeping (MT/PT/ML + fragmentations,
        # motmetrics' track_ratios/num_fragmentations)
        self._gt_seen = {}  # gt_id -> frames present
        self._gt_matched = {}  # gt_id -> frames matched
        self._gt_last_state = {}  # gt_id -> was matched at last appearance
        self._fragmentations = 0

    def update(self, gt_ids, hyp_ids, dist, sim=None):
        """`sim` (optional): RAW IoU similarity matrix for HOTA. When
        omitted it is derived from `dist` (1 - dist, NaN -> 0), which
        loses pairs below the CLEAR 0.5-IoU clip — fine for CLEAR/ID
        tests that drive update() directly, while get_mot_accum passes
        the exact raw IoU."""
        gt_ids = list(gt_ids)
        hyp_ids = list(hyp_ids)
        dist = np.asarray(dist, np.float64).reshape(len(gt_ids), len(hyp_ids))
        if sim is None:
            sim = np.where(np.isfinite(dist), 1.0 - dist, 0.0)
        else:
            sim = np.asarray(sim, np.float64).reshape(dist.shape)
        self.frame_pairs.append((self.frame_idx, gt_ids, hyp_ids, dist))
        self.frame_sims.append(sim)

        matches = {}
        used_g, used_h = set(), set()
        # 1. persist previous correspondences still valid
        for gi, g in enumerate(gt_ids):
            h = self._last_match.get(g)
            if h is not None and h in hyp_ids:
                hi = hyp_ids.index(h)
                if np.isfinite(dist[gi, hi]):
                    matches[g] = h
                    used_g.add(gi)
                    used_h.add(hi)
        # 2. Hungarian on the rest
        rem_g = [i for i in range(len(gt_ids)) if i not in used_g]
        rem_h = [i for i in range(len(hyp_ids)) if i not in used_h]
        if rem_g and rem_h:
            sub = dist[np.ix_(rem_g, rem_h)]
            cost = np.where(np.isfinite(sub), sub, INF)
            rows, cols = linear_sum_assignment(cost)
            for r, c in zip(rows, cols):
                if cost[r, c] < INF:
                    matches[gt_ids[rem_g[r]]] = hyp_ids[rem_h[c]]
                    used_g.add(rem_g[r])
                    used_h.add(rem_h[c])

        switches = 0
        dist_sum = 0.0
        for g, h in matches.items():
            prev = self._last_match.get(g)
            if prev is not None and prev != h:
                switches += 1
            gi, hi = gt_ids.index(g), hyp_ids.index(h)
            dist_sum += dist[gi, hi]
        # update last matches only for currently-present gt
        for g, h in matches.items():
            self._last_match[g] = h

        # MT/ML ratios + fragmentations: a fragmentation is a
        # lost->re-tracked transition of a gt that had been tracked before
        for g in gt_ids:
            now = g in matches
            self._gt_seen[g] = self._gt_seen.get(g, 0) + 1
            if now:
                self._gt_matched[g] = self._gt_matched.get(g, 0) + 1
                if self._gt_last_state.get(g) is False and self._gt_matched[g] > 1:
                    self._fragmentations += 1
            self._gt_last_state[g] = now

        misses = len(gt_ids) - len(matches)
        fps = len(hyp_ids) - len(matches)
        self.events.append(
            {
                "num_gt": len(gt_ids),
                "num_hyp": len(hyp_ids),
                "matches": len(matches),
                "misses": misses,
                "fps": fps,
                "switches": switches,
                "dist_sum": dist_sum,
            }
        )
        self.frame_idx += 1

    # ---- metrics -----------------------------------------------------
    def clear_mot(self):
        num_gt = sum(e["num_gt"] for e in self.events)
        misses = sum(e["misses"] for e in self.events)
        fps = sum(e["fps"] for e in self.events)
        switches = sum(e["switches"] for e in self.events)
        matches = sum(e["matches"] for e in self.events)
        dist_sum = sum(e["dist_sum"] for e in self.events)
        mota = 1.0 - (misses + fps + switches) / max(num_gt, 1)
        motp = dist_sum / max(matches, 1)
        mt = pt = ml = 0
        for g, seen in self._gt_seen.items():
            ratio = self._gt_matched.get(g, 0) / max(seen, 1)
            if ratio >= 0.8:
                mt += 1
            elif ratio <= 0.2:
                ml += 1
            else:
                pt += 1
        return {
            "num_objects": num_gt,
            "num_misses": misses,
            "num_false_positives": fps,
            "num_switches": switches,
            "num_matches": matches,
            "num_fragmentations": self._fragmentations,
            "mostly_tracked": mt,
            "partially_tracked": pt,
            "mostly_lost": ml,
            "mota": mota,
            "motp": motp,
            "recall": matches / max(num_gt, 1),
            "precision": matches / max(matches + fps, 1),
        }

    def id_measures(self):
        """Global trajectory-level assignment (Ristani et al. 2016)."""
        gt_traj = {}  # gt_id -> frames dict frame -> index
        hyp_traj = {}
        for frame, gt_ids, hyp_ids, dist in self.frame_pairs:
            for i, g in enumerate(gt_ids):
                gt_traj.setdefault(g, {})[frame] = i
            for j, h in enumerate(hyp_ids):
                hyp_traj.setdefault(h, {})[frame] = j
        gids = list(gt_traj)
        hids = list(hyp_traj)
        n_g, n_h = len(gids), len(hids)
        total_gt = sum(len(v) for v in gt_traj.values())
        total_hyp = sum(len(v) for v in hyp_traj.values())
        if n_g == 0 or n_h == 0:
            idtp = 0
        else:
            overlap = np.zeros((n_g, n_h), np.int64)
            for frame, gt_ids, hyp_ids, dist in self.frame_pairs:
                fin = np.isfinite(dist)
                for gi, g in enumerate(gt_ids):
                    for hi, h in enumerate(hyp_ids):
                        if fin[gi, hi]:
                            overlap[gids.index(g), hids.index(h)] += 1
            # pad to square: unmatched trajectory costs its own length
            size = n_g + n_h
            cost = np.zeros((size, size))
            for i, g in enumerate(gids):
                cost[i, n_h:] = len(gt_traj[g])
            for j, h in enumerate(hids):
                cost[n_g:, j] = len(hyp_traj[h])
            for i, g in enumerate(gids):
                for j, h in enumerate(hids):
                    cost[i, j] = (
                        len(gt_traj[g]) + len(hyp_traj[h]) - 2 * overlap[i, j]
                    )
            rows, cols = linear_sum_assignment(cost)
            idtp = 0
            for r, c in zip(rows, cols):
                if r < n_g and c < n_h:
                    idtp += overlap[r, c]
        idfp = total_hyp - idtp
        idfn = total_gt - idtp
        idf1 = 2 * idtp / max(2 * idtp + idfp + idfn, 1)
        idp = idtp / max(idtp + idfp, 1)
        idr = idtp / max(idtp + idfn, 1)
        return {
            "idf1": idf1, "idp": idp, "idr": idr,
            "idtp": int(idtp), "idfp": int(idfp), "idfn": int(idfn),
        }

    def hota(self, alphas=None):
        """HOTA (Luiten et al., IJCV 2021) — the TrackEval algorithm:

        1. global alignment score per (gt track, hyp track): accumulated
           soft potential-match counts A_max = P/(|gt_i| + |hyp_j| - P),
           P = Σ_frames sim/(Σ_row sim + Σ_col sim - sim);
        2. per frame, ONE Hungarian maximizing A_max·sim (α-independent),
           then per α keep matches with sim ≥ α as TPs;
        3. DetA_α = TP/(TP+FN+FP); AssA_α = TP-weighted mean of
           A(c) = TPA/(TPA+FNA+FPA) = m_ij/(|gt_i| + |hyp_j| - m_ij);
           HOTA_α = sqrt(DetA_α · AssA_α); HOTA = mean over α.
        """
        if alphas is None:
            alphas = np.arange(0.05, 0.96, 0.05)
        alphas = np.asarray(alphas, np.float64)
        eps = np.finfo(np.float64).eps
        gids, hids = {}, {}  # id -> dense index
        for _, gt_ids, hyp_ids, _ in self.frame_pairs:
            for g in gt_ids:
                gids.setdefault(g, len(gids))
            for h in hyp_ids:
                hids.setdefault(h, len(hids))
        n_g, n_h = len(gids), len(hids)
        if n_g == 0 and n_h == 0:
            z = {"hota": 1.0, "det_a": 1.0, "ass_a": 1.0, "loc_a": 1.0}
            return z
        if n_g == 0 or n_h == 0:
            return {"hota": 0.0, "det_a": 0.0, "ass_a": 0.0, "loc_a": 0.0}
        gt_count = np.zeros(n_g)
        hyp_count = np.zeros(n_h)
        potential = np.zeros((n_g, n_h))
        for (_, gt_ids, hyp_ids, _), sim in zip(
            self.frame_pairs, self.frame_sims
        ):
            gi = np.array([gids[g] for g in gt_ids], np.intp)
            hi = np.array([hids[h] for h in hyp_ids], np.intp)
            gt_count[gi] += 1
            hyp_count[hi] += 1
            if len(gi) == 0 or len(hi) == 0:
                continue
            denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
            soft = np.where(denom > eps, sim / np.maximum(denom, eps), 0.0)
            potential[np.ix_(gi, hi)] += soft
        align = potential / np.maximum(
            gt_count[:, None] + hyp_count[None, :] - potential, eps
        )

        n_a = len(alphas)
        tp = np.zeros(n_a)
        fn = np.zeros(n_a)
        fp = np.zeros(n_a)
        loc_sum = np.zeros(n_a)
        match_counts = np.zeros((n_a, n_g, n_h))
        for (_, gt_ids, hyp_ids, _), sim in zip(
            self.frame_pairs, self.frame_sims
        ):
            gi = np.array([gids[g] for g in gt_ids], np.intp)
            hi = np.array([hids[h] for h in hyp_ids], np.intp)
            if len(gi) == 0 or len(hi) == 0:
                fn += len(gi)
                fp += len(hi)
                continue
            score = align[np.ix_(gi, hi)] * sim
            rows, cols = linear_sum_assignment(-score)
            msim = sim[rows, cols]
            for a, alpha in enumerate(alphas):
                ok = msim >= alpha - eps
                k = int(ok.sum())
                tp[a] += k
                fn[a] += len(gi) - k
                fp[a] += len(hi) - k
                loc_sum[a] += float(msim[ok].sum())
                if k:
                    match_counts[a][gi[rows[ok]], hi[cols[ok]]] += 1

        det_a = tp / np.maximum(tp + fn + fp, 1)
        ass = match_counts / np.maximum(
            gt_count[None, :, None] + hyp_count[None, None, :]
            - match_counts,
            1,
        )
        ass_a = (match_counts * ass).sum((1, 2)) / np.maximum(tp, 1)
        hota_a = np.sqrt(det_a * ass_a)
        loc_a = np.where(tp > 0, loc_sum / np.maximum(tp, 1), 1.0)
        return {
            "hota": float(hota_a.mean()),
            "det_a": float(det_a.mean()),
            "ass_a": float(ass_a.mean()),
            "loc_a": float(loc_a.mean()),
        }

    def metrics(self):
        out = self.clear_mot()
        out.update(self.id_measures())
        out.update(self.hota())
        return out


def get_mot_accum(results: dict, seq) -> MOTAccumulator:
    """Build an accumulator from tracker results + a sequence's GT blobs
    (reference track_utils.py:355-403)."""
    accum = MOTAccumulator()
    for frame_idx in range(len(seq)):
        gt = seq.data[frame_idx]["gt"]
        gt_ids = list(gt.keys())
        gt_boxes = (
            np.stack([gt[i] for i in gt_ids]) if gt_ids else np.zeros((0, 4))
        )
        hyp_ids, hyp_boxes = [], []
        for tid, track in results.items():
            if frame_idx in track:
                hyp_ids.append(tid)
                hyp_boxes.append(np.asarray(track[frame_idx]["bbox"][:4]))
        hyp_boxes = np.stack(hyp_boxes) if hyp_boxes else np.zeros((0, 4))

        def to_xywh(b):
            if len(b) == 0:
                return b
            return np.stack(
                [b[:, 0], b[:, 1], b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1
            )

        g_xywh, h_xywh = to_xywh(gt_boxes), to_xywh(hyp_boxes)
        dist = iou_distance(g_xywh, h_xywh)
        accum.update(gt_ids, hyp_ids, dist, sim=iou_matrix(g_xywh, h_xywh))
    return accum


def evaluate_mot_accums(accums, names, generate_overall: bool = True):
    """Summary table (reference track_utils.py:406-418). Returns a dict of
    per-sequence metric dicts (+ 'OVERALL')."""
    summary = {}
    overall = MOTAccumulator()
    for accum, name in zip(accums, names):
        summary[name] = accum.metrics()
        if generate_overall:
            overall.events.extend(accum.events)
            base = overall.frame_idx
            # namespace ids per sequence so OVERALL ID measures don't
            # conflate same-numbered tracks from different sequences
            for frame, g, h, d in accum.frame_pairs:
                overall.frame_pairs.append(
                    (
                        base + frame,
                        [f"{name}:{i}" for i in g],
                        [f"{name}:{i}" for i in h],
                        d,
                    )
                )
            overall.frame_sims.extend(accum.frame_sims)
            overall.frame_idx = base + accum.frame_idx
    if generate_overall and len(accums) > 1:
        summary["OVERALL"] = overall.metrics()
    return summary


def format_summary(summary: dict) -> str:
    cols = ["mota", "idf1", "hota", "motp", "num_false_positives",
            "num_misses", "num_switches"]
    lines = [" " * 16 + "  ".join(f"{c:>8}" for c in cols)]
    for name, m in summary.items():
        vals = []
        for c in cols:
            v = m[c]
            vals.append(f"{v:8.3f}" if isinstance(v, float) else f"{v:8d}")
        lines.append(f"{name:<16}" + "  ".join(vals))
    return "\n".join(lines)
