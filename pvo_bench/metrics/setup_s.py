"""Set-up time: from the start of the process to the first timed unit
of work (imports, weights from the seed, the system, the warm-up with
its eager frames and graph capture, and the kernels' build in a fresh
checkout). Host clock."""


def read(run):
    return run.setup_s
