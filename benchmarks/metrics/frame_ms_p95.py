"""The 95th percentile, over every frame of the window, of the time from
the start of the step call that takes the frame to that call's return
(host clock; the frames of one step share its time; numpy's linear
interpolation)."""
import numpy as np


def read(run):
    return float(np.percentile(run["frame_ms"], 95)) if run["frame_ms"] else None
