"""The DBA kernels' share of their roofline in the profiled terminate
call: the frozen bounds (``bounds.dba_bound``) of every launch of
``dba_linearize``, ``dba_schur``, ``dba_solve`` / ``dba_solve_grid`` and
``dba_backsub`` at the shapes the harness saw them called with, over
their profiled time. The profile's launches must match the calls seen;
otherwise nothing is read."""

from collections import Counter

from pvo_bench import bounds
from pvo_bench.harness import log

NAMES = {"dba_linearize": ("dba_linearize_kernel",),
         "dba_schur": ("dba_schur_kernel",),
         "dba_solve": ("dba_solve_kernel", "dba_solve_grid_kernel"),
         "dba_backsub": ("dba_backsub_kernel",)}


def read(run):
    p, shapes = run.profile, run.data.get("dba_shapes")
    if p is None or not shapes:
        return None
    seen = Counter(name for name, _ in shapes)
    got = {k: len(p.kernels(*v)) for k, v in NAMES.items()}
    if any(got[k] != seen.get(k, 0) for k in NAMES):
        log(f"dba_roofline.terminate: profiled launches {got} differ from "
            f"the calls seen {dict(seen)}")
        return None
    bound = sum(bounds.dba_bound(name, **kw)["ms"] for name, kw in shapes)
    ms = sum(t for v in NAMES.values() for _, t in p.kernels(*v))
    return 100.0 * bound / ms if ms > 0 else None
