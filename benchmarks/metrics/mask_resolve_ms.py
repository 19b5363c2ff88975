"""Tracker state machine, the masks' resolution: host ms a frame of the
program's ``mask_resolve`` spans (each pixel to the live track of highest
probability above 0.5), over the window's frames (the program's
``frames`` counter)."""


def read(run):
    prog = run.get("program") or {}
    frames = (prog.get("counters") or {}).get("frames")
    ms = [(s["end_ns"] - s["start_ns"]) * 1e-6 for s in prog.get("spans") or ()
          if s["name"] == "mask_resolve"]
    return sum(ms) / frames if ms and frames else None
