"""The 95th percentile, over every frame of the window, of the time from
the call of ``VOSystem.track`` to the end of the frame's work on the
card: the lag from camera to pose."""

import numpy as np


def read(run):
    lat = run.data.get("latency_ms")
    if not lat:
        return None
    return float(np.percentile(lat, 95))
