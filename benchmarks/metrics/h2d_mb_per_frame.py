"""Batched tracker: MB (1e6 bytes) of host arrays copied to the device a
frame, over the window (the program's ``h2d_bytes`` and ``frames``
counters)."""


def read(run):
    c = (run.get("program") or {}).get("counters") or {}
    return c["h2d_bytes"] / 1e6 / c["frames"] if c.get("frames") else None
