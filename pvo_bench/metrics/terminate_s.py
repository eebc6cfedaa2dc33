"""The mean of every ``terminate(image_stream)`` call of the window, each
timed whole on the host clock (it ends in the poses' readback): the
wait after a clip ends before its whole trajectory exists."""


def read(run):
    calls = run.data.get("call_s")
    if not calls:
        return None
    return sum(calls) / len(calls)
