"""Model forward, the decoder: device ms a frame of the kernels launched
inside the program's ``decoder`` span, over the profiled steps."""


def read(run):
    p = run.get("profile")
    if not p or "program_device_s" not in p or not p["frames"]:
        return None
    return 1e3 * p["program_device_s"].get("decoder", 0.0) / p["frames"]
