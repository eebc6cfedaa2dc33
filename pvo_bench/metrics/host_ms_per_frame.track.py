"""Host time spent inside ``VOSystem.track`` a frame over the window
(unprofiled), less its waits for the decision records (read two frames
behind, so the wait is the card's time): the upload, the replay's
launch and the records' bookkeeping."""


def read(run):
    if "host_s_in_track" not in run.data:
        return None
    return 1e3 * run.data["host_s_in_track"] / run.data["frames"]
