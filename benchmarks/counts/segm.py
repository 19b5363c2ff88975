"""The operations and bytes of the MOTS20 configuration's served frame
(vanilla DETR with track slots and DETR's mask head), worked out from its
shapes (two operations a multiply-accumulate).

``mask_head``: the attention map and the mask head over a frame's rows
(``SegmWrapper``'s ``bbox_attention`` and ``mask_head``, the program's
``mask_head`` span), each operation's products and its least bytes: its
inputs read once and its output written once. The operations: the query
and key projections, the query-key products, the softmax, the
concatenation of the projected C5 feature with each row's attention
maps, the five 3x3 convolutions with their GroupNorm (the ReLU folded
in), the three skip adapters (a 1x1 convolution a frame, whose output
each row reads), each skip's nearest resize with its add, and the output
convolution. The adapters' output is read once, though each row adds it;
the scaling, the pad mask's fill and the biases are left out. So the
bound is the least the chip could take for the head as the program
splits it, or for any split into these operations.

``frame_flops``: a frame's products, as ``torch.utils.flop_counter``
counts them: the backbone's convolutions, the input projection, every
linear and attention product of the encoder and the decoder, the last
layer's heads and the mask head. Elementwise work is not counted.
"""
from __future__ import annotations

from . import model as model_counts


def levels(cfg, h, w):
    """[(h, w, channels)] of C2, C3, C4, C5 for an ``h`` x ``w`` frame."""
    hh = model_counts.conv_out(model_counts.conv_out(h, 7, 2, 3), 3, 2, 1)
    ww = model_counts.conv_out(model_counts.conv_out(w, 7, 2, 3), 3, 2, 1)
    return [(hh, ww, 256)] + model_counts.backbone(cfg, h, w)[1]


def mask_head(cfg, h, w, rows, itemsize=2):
    """{"flops", "bytes"} of the attention map and the mask head over
    ``rows`` decoder rows of one ``h`` x ``w`` frame, with tensors of
    ``itemsize`` bytes an element."""
    d, m = cfg["hidden_dim"], cfg["nheads"]
    lv = levels(cfg, h, w)
    h5, w5, _ = lv[3]
    s, q = h5 * w5, rows
    ops = []  # (flops, elements read and written)
    ops.append((2 * q * d * d, 2 * q * d + d * d))  # q_linear
    ops.append((2 * s * d * d, 2 * s * d + d * d))  # k_linear
    ops.append((2 * q * s * d, q * d + s * d + q * m * s))  # the products
    ops.append((0, 2 * q * m * s))  # softmax
    c = d + m
    ops.append((0, d * s + q * m * s + q * c * s))  # concatenation

    def conv(cin, cout, n, k=3):
        """A k x k convolution over q maps of n pixels, then GroupNorm."""
        ops.append((2 * q * n * cin * cout * k * k,
                    q * cin * n + cin * cout * k * k + q * cout * n))
        ops.append((0, 2 * q * cout * n))

    conv(c, c, s)
    conv(c, d // 2, s)
    cur, n_prev = d // 2, s
    for i, (hk, wk, cin) in enumerate(reversed(lv[:3])):  # C4, C3, C2
        n = hk * wk
        ops.append((2 * n * cin * cur, cin * n + cin * cur + cur * n))
        ops.append((0, q * cur * n_prev + cur * n + q * cur * n))
        conv(cur, cur // 2, n)
        cur, n_prev = cur // 2, n
    ops.append((2 * q * n_prev * cur * 9, q * cur * n_prev + cur * 9
                + q * n_prev))  # out_lay
    return {"flops": sum(f for f, _ in ops),
            "bytes": itemsize * sum(e for _, e in ops)}


def frame_flops(cfg, h, w, track_slots):
    """{part: flops} of one ``h`` x ``w`` frame with ``track_slots`` track
    slots, and their sum under "total"."""
    d, ffn = cfg["hidden_dim"], cfg["dim_feedforward"]
    parts = {}
    parts["backbone"] = model_counts.backbone(cfg, h, w)[0]
    h5, w5, c5 = levels(cfg, h, w)[3]
    s = h5 * w5
    parts["input_proj"] = 2 * s * c5 * d
    layer = 4 * 2 * s * d * d + 2 * 2 * s * s * d + 2 * 2 * s * d * ffn
    parts["encoder"] = cfg["enc_layers"] * layer
    n = track_slots + cfg["num_queries"]
    layer = (4 * 2 * n * d * d + 2 * 2 * n * n * d  # self-attention
             + 2 * 2 * n * d * d + 2 * 2 * s * d * d + 2 * 2 * n * s * d
             + 2 * 2 * n * d * ffn)
    parts["decoder"] = cfg["dec_layers"] * layer
    n_cls = cfg["num_classes"] + (0 if cfg["focal_loss"] else 1)
    parts["heads"] = 2 * n * d * n_cls + 2 * n * (2 * d * d + 4 * d)
    parts["mask_head"] = mask_head(cfg, h, w, n)["flops"]
    parts["total"] = sum(parts.values())
    return parts
