"""Frames tracked in the window over the window's seconds (the window
ends when the last frame's work ends on the card). A live user keeps up
with the camera only above its frame rate."""


def read(run):
    if "latency_ms" not in run.data:
        return None
    return run.data["frames"] / run.data["window_s"]
