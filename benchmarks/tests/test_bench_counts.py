"""The counts of ``benchmarks/counts`` against hand counts at small shapes."""
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmarks.counts import model as mc
from benchmarks.counts.msda import call_counts, corner_rows
from benchmarks.reference.detr import TrackFormer
from benchmarks.tests.tiny import BENCH, TINY


def test_corner_rows_follow_the_corner_rule():
    # one level 4 x 5; x, y in pixels = loc * size - 0.5
    shapes = [(4, 5)]
    loc = torch.tensor([[0.5 / 5 + 1 / 5, 1.5 / 4],  # on cell (1, 1) exactly
                        [0.0, 0.0],                    # corners left/above out
                        [1.2, 0.5]]).view(1, 3, 1, 1, 1, 2)  # right of the level
    rows = corner_rows(loc, shapes)[0, :, 0, 0, 0]
    assert rows[0].tolist() == [6, 7, 11, 12]
    # x = -0.5, y = -0.5: only the corner (0, 0) is inside
    assert rows[1].tolist() == [-1, -1, -1, 0]
    assert (rows[2] == -1).all()


def test_msda_bytes_and_operations_by_hand():
    # two queries, one head, one level 4 x 5, one point each, D = 3 (f32):
    # both samples at the centre of cell (1, 1): the four corners (1, 1),
    # (1, 2), (2, 1), (2, 2) are read once
    shapes = [(4, 5)]
    loc = torch.tensor([1.5 / 5, 1.5 / 4]).expand(1, 2, 1, 1, 1, 2).clone()
    aw = torch.ones(1, 2, 1, 1, 1)
    value = torch.zeros(1, 20, 1, 3)
    nbytes, ops = call_counts("msda", value, shapes, loc, aw)
    samples = 2
    assert nbytes == 4 * 3 * 4 + samples * (8 + 4) + 2 * 3 * 4
    assert ops == samples * 4 * 2 * 3 + samples * 4
    # the raw pool over an int8 table of 6 channels, pooled to float32,
    # with valid extents that cut column 2 off: 2 rows read
    src = torch.zeros(1, 20, 6, dtype=torch.int8)
    ext = torch.tensor([[[4.0, 2.0]]])
    nbytes, ops = call_counts("raw_pool", src, shapes, loc, aw, ext)
    side = samples * 12 + ext.numel() * 4 + 1 * 1 * 4
    assert nbytes == 2 * 6 * 1 + side + 2 * 1 * 6 * 4 + 2 * 1 * 4
    assert ops == 2 * 2 * 2 * 6 + samples * 4


def test_model_flops_against_the_flop_counter():
    """The linears, convolutions and attention products that the counter
    sees in one frame of the reference (projection first) equal the count
    without its sampling sums."""
    conf = json.loads((BENCH / "configs" / "trackformer_mot17.json").read_text())
    for over in ({}, {"enc_lite": True, "dec_klevels": 2}):
        cfg = dict(conf["model"], **TINY, **over)
        torch.manual_seed(0)
        model = TrackFormer(cfg).eval().requires_grad_(False)
        h, w, t = 96, 160, cfg["max_track_queries"]
        img = torch.randn(1, h, w, 3)
        pad = torch.zeros(1, h, w, dtype=torch.bool)
        slots = (torch.zeros(1, t, cfg["hidden_dim"]), torch.full((1, t, 4), 0.5),
                 torch.zeros(1, t, dtype=torch.bool))
        with FlopCounterMode(display=False) as fc:
            enc = model.encode(img, pad)
            model.decode(enc, enc, *slots, torch.tensor([[h, w]], dtype=torch.float32))
        parts = mc.frame_flops(dict(cfg, dec_gather_raw=False), h, w, t)
        sums = 0
        shapes = [tuple(s) for s in enc["shapes"]]
        tokens = [a * b for a, b in shapes]
        lv, m, d = cfg["num_feature_levels"], cfg["nheads"], cfg["hidden_dim"]
        for i, (mode, k) in enumerate(model.transformer.modes):
            n_q = {"all": sum(tokens), "high": sum(tokens) - tokens[0],
                   "low": tokens[0]}[mode]
            sums += mc.sample_sums(n_q, m, k, cfg["enc_n_points"], d // m)
        kd = model.transformer.dec_k
        sums += cfg["dec_layers"] * mc.sample_sums(
            t + cfg["num_queries"], m, 2 * kd, cfg["dec_n_points"], d // m)
        # the counter counts the decoder's memory projection for both
        # frames: the same frame encoded once serves as both here
        assert fc.get_total_flops() == parts["total"] - sums
        # gathering raw rows first swaps the memory's projection for the
        # pooled rows' and widens the sums from a head's slice to the row
        raw = mc.frame_flops(dict(cfg, dec_gather_raw=True), h, w, t)
        nq = t + cfg["num_queries"]
        n_mem = 2 * sum(tokens[:kd])
        per_layer = (2 * nq * d * d - 2 * n_mem * d * d
                     + mc.sample_sums(nq, m, 2 * kd, cfg["dec_n_points"], d)
                     - mc.sample_sums(nq, m, 2 * kd, cfg["dec_n_points"], d // m))
        assert raw["total"] - parts["total"] == cfg["dec_layers"] * per_layer
