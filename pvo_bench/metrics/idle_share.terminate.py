"""The share of the profiled terminate call's device timeline in which
no device operation runs (one less the union of the device intervals
over their span)."""


def read(run):
    p = run.profile
    if p is None or "call_s" not in run.data:
        return None
    return 100.0 * max(0.0, 1.0 - p.busy_s / p.window_s)
