"""The whole step's share of the chip's bf16 dense peak over the profiled
steps: the floating-point operations one frame's forward needs
(``counts/model.py``, from the configuration's shapes) times the profiled
frames, over the profiled window's seconds (device trace, first to last
operation or host step), over the peak of ``peaks.json``."""


def read(run):
    p = run.get("profile")
    if not p or p["window_s"] <= 0 or not p["frames"]:
        return None
    rate = run["frame_flops"] * p["frames"] / p["window_s"]
    return 100.0 * rate / run["peaks"]["bf16_flops_per_s"]
