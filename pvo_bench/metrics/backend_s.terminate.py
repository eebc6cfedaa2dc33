"""The backend's seconds a terminate call (its two global passes),
synchronized before and after each pass, over the traced run's window."""


def read(run):
    t, calls = run.data.get("backend_s"), run.data.get("call_s")
    if not t or not calls:
        return None
    return sum(t) / len(calls)
