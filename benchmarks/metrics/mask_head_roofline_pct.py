"""Mask head's share of its roofline: over the profiled steps, the least
time the chip could take for the attention map and the mask head (the
larger of their operations over the dense peak of the served type and
their bytes over the memory bandwidth, ``counts/segm.py`` from the
frame's shapes, ``peaks.json``) over the device time of the kernels
launched inside the program's ``mask_head`` span."""


def read(run):
    p = run.get("profile")
    if not p or "mask_head_bound_s" not in p:
        return None
    secs = p.get("program_device_s", {}).get("mask_head", 0.0)
    return 100.0 * p["mask_head_bound_s"] / secs if secs > 0 else None
