"""The trajectory filler's seconds a terminate call, synchronized before
and after, over the traced run's window."""


def read(run):
    t, calls = run.data.get("filler_s"), run.data.get("call_s")
    if not t or not calls:
        return None
    return sum(t) / len(calls)
