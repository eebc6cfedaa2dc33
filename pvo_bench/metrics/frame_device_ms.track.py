"""Kernel time a replayed frame (copies left out) over the traced
frames, from the profiler's device timeline. Held to the frame graph's
launch counts by ``corr_roofline.track``."""


def read(run):
    p = run.profile
    if p is None or "traced_frames" not in run.data:
        return None
    return p.kernel_ms() / p.units
