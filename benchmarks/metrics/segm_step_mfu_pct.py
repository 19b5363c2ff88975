"""The whole step's share of the chip's bf16 dense peak over the profiled
steps, for the mask model: a frame's floating-point operations
(``counts/segm.py``: backbone, encoder, decoder, heads and mask head, from
the configuration's shapes) times the profiled frames, over the profiled
window's seconds (device trace, first to last operation or host step),
over the peak of ``peaks.json``. ``step_mfu_pct``'s definition, on this
model's count."""


def read(run):
    p = run.get("profile")
    if not p or p["window_s"] <= 0 or not p["frames"]:
        return None
    rate = run["frame_flops"] * p["frames"] / p["window_s"]
    return 100.0 * rate / run["peaks"]["bf16_flops_per_s"]
