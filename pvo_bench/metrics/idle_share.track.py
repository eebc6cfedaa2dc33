"""The share of the traced frames' wall time in which no device
operation runs: one less the union of the device intervals over the
stretch's synchronized wall."""


def read(run):
    p = run.profile
    if p is None or "traced_frames" not in run.data:
        return None
    return 100.0 * max(0.0, 1.0 - p.busy_s / p.window_s)
