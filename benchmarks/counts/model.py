"""The floating-point operations that one served frame's forward needs,
worked out from a configuration's shapes (two operations a
multiply-accumulate).

Counted: the backbone's convolutions, the input projections, every
linear of the encoder and the decoder, the decoder's self-attention
products, the deformable sampling sums (a multiply and an add a channel
for each of a sample's four bilinear corners), the box-refinement heads
of every decoder layer and the last layer's class head. Not counted:
norms, activations, softmaxes, position encodings and the postprocess,
which are elementwise. With ``cache_prev_encoder`` a frame is encoded
once: its memory serves again as the next frame's previous one. With
``dec_gather_raw`` the decoder's value projection acts on the pooled raw
rows (a [C] row a query and head times that head's [C, C / M] slice);
without it, on every memory token before sampling.
"""
from __future__ import annotations

STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet_test": (1, 1, 1, 1)}


def conv_out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def conv_flops(h, w, cin, cout, k, s, p):
    ho, wo = conv_out(h, k, s, p), conv_out(w, k, s, p)
    return 2 * ho * wo * cin * cout * k * k, ho, wo


def backbone(cfg, h, w):
    """(flops, [(h, w, channels) of C3, C4, C5])."""
    f, h, w = conv_flops(h, w, 3, 64, 7, 2, 3)
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)  # max pool
    cin, levels = 64, []
    for stage, (n, width) in enumerate(zip(STAGES[cfg["backbone"]],
                                           (64, 128, 256, 512))):
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            a, _, _ = conv_flops(h, w, cin, width, 1, 1, 0)
            c, ho, wo = conv_flops(h, w, width, width, 3, stride, 1)
            e, _, _ = conv_flops(ho, wo, width, width * 4, 1, 1, 0)
            f += a + c + e
            if b == 0:
                f += conv_flops(h, w, cin, width * 4, 1, stride, 0)[0]
            h, w, cin = ho, wo, width * 4
        levels.append((h, w, cin))
    return f, levels[1:]


def linear(n, cin, cout):
    return 2 * n * cin * cout


def sample_sums(n_queries, heads, levels, points, chans):
    return n_queries * heads * levels * points * 4 * 2 * chans


def frame_flops(cfg, h, w, track_slots):
    """{part: flops} of one frame of an ``h`` x ``w`` image with
    ``track_slots`` track-query slots, and their sum under "total"."""
    d, m = cfg["hidden_dim"], cfg["nheads"]
    ffn, lv = cfg["dim_feedforward"], cfg["num_feature_levels"]
    parts = {}
    parts["backbone"], c345 = backbone(cfg, h, w)
    proj, shapes = 0, []
    for i in range(lv):
        if i < 3:
            hh, ww, cin = c345[i]
            proj += 2 * hh * ww * cin * d
        else:  # the extra levels: from C5, then from the level before
            hh, ww, cin = c345[-1] if i == 3 else (*shapes[-1], d)
            f, hh, ww = conv_flops(hh, ww, cin, d, 3, 2, 1)
            proj += f
        shapes.append((hh, ww))
    parts["input_proj"] = proj

    tokens = [hh * ww for hh, ww in shapes]
    n_all = sum(tokens)
    enc = 0
    p = cfg["enc_n_points"]
    for i in range(cfg["enc_layers"]):
        last = i == cfg["enc_layers"] - 1
        k, n_q = lv, n_all
        if cfg["enc_lite"] and lv > 1:
            kk = cfg["enc_lite_klevels"] if last else cfg["enc_lite_high_klevels"]
            k = min(kk, lv) if kk else lv
            n_q = tokens[0] if last else n_all - tokens[0]
        n_v = sum(tokens[:k])
        enc += linear(n_v, d, d)  # value projection
        enc += linear(n_q, d, m * k * p * 2) + linear(n_q, d, m * k * p)
        enc += sample_sums(n_q, m, k, p, d // m)
        enc += linear(n_q, d, d)  # output projection
        enc += linear(n_q, d, ffn) + linear(n_q, ffn, d)
    parts["encoder"] = enc

    kd = min(cfg["dec_klevels"], lv) if cfg["dec_klevels"] else lv
    n_mem = 2 * sum(tokens[:kd])  # the current and the previous frame
    nq = track_slots + cfg["num_queries"]
    p = cfg["dec_n_points"]
    dec = linear(cfg["num_queries"], d, 2)  # reference points
    for _ in range(cfg["dec_layers"]):
        dec += 4 * linear(nq, d, d) + 2 * 2 * nq * nq * d  # self-attention
        if cfg.get("dec_gather_raw", False):
            dec += 2 * nq * m * d * (d // m)
            dec += sample_sums(nq, m, 2 * kd, p, d)
        else:
            dec += linear(n_mem, d, d)
            dec += sample_sums(nq, m, 2 * kd, p, d // m)
        dec += linear(nq, d, m * 2 * kd * p * 2) + linear(nq, d, m * 2 * kd * p)
        dec += linear(nq, d, d)  # output projection
        dec += linear(nq, d, ffn) + linear(nq, ffn, d)
        dec += 2 * linear(nq, d, d) + linear(nq, d, 4)  # box refinement
    parts["decoder"] = dec
    parts["heads"] = linear(nq, d, cfg["num_classes"])
    parts["total"] = sum(parts.values())
    return parts
