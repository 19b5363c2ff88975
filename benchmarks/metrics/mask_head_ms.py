"""Mask head: device ms a frame of the kernels launched inside the
program's ``mask_head`` span (the attention map and the mask head over
every decoder row), over the profiled steps."""


def read(run):
    p = run.get("profile")
    if not p or not p["frames"] or \
            "mask_head" not in p.get("program_device_s", {}):
        return None
    return 1e3 * p["program_device_s"]["mask_head"] / p["frames"]
