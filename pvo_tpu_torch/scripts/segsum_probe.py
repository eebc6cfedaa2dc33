"""The segment sum (``csrc/segsum.cu``) at the planner's full widths, and
against an earlier source of it, on the card.

    python -m pvo_tpu_torch.scripts.segsum_probe [--parent PATH]
        [--reps N]

``CASES`` are the sums of a planner frame at 240x808 (30x101 features,
48 update edges, the DBA's 144 edges into P = K = 32 frames and 2048
edge pairs) and, ``*_wide``, those of them whose rows grow with the
pixels at 376x1248 (47x156), about a tenth of each case's rows out of
range; ``GROUPS`` are the launches the tracker makes of them (GraphAgg's
sum and counts; the DBA's two launches a full iteration; the first two
also at 376x1248). Each case is run in both
modes (accumulate, zero start) and each group batched, and held bit for
bit against the CPU's ``index_add_`` (:func:`cuda_segsum.sums_plain`).
Times are kernel times: ``kbench.graph_time_ms`` replays the calls
captured in one CUDA graph. Beside each: the card's ``index_add_``
(float atomics) on the in-range rows, one call a job (the library call;
the port never makes it), and the bound (``kbench.segsum_bound``; a
zero-start sum does not read ``out``).

With ``--parent PATH`` (an earlier ``segsum.cu`` of the one-job
interface ``pvo_segsum(x, idx, out, n_rows, n_out, D, stream)``, which
accumulates only) each case and group is also timed on it, in turns
(parent, this, this, parent), its zero start a ``zero_()`` and then its
kernel, as the earlier ``segment_sum`` did, its groups one launch a job;
its outputs must equal this kernel's. For the parent tree of a commit:

    mkdir -p .parent && git archive <commit> | tar -x -C .parent
    python -m pvo_tpu_torch.scripts.segsum_probe \\
        --parent .parent/pvo_tpu_torch/csrc/segsum.cu

One JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.vo.net import cuda_corr, cuda_segsum

# (rows, output rows, row shape) of the planner frame's sums at 240x808:
# GraphAgg's sum and counts (48 edges into 32 frames); the DBA's Hessian
# (4 x 144 blocks into 32 x 32), gradient (2 x 144 into 32), C and w
# (144 into 32 depth frames), edge x depth (Ei), the Schur sum (32 self,
# 2 x 144 edge terms, then the 2048 pairs), the pairs alone and the rhs
# correction (32 + 144); the back-substitution sums its edge terms itself
# (csrc/dba.cu)
CASES = {
    "graph_agg": (48, 32, (128, 30, 101)),
    "graph_agg_counts": (48, 32, ()),
    "dba_hessian": (576, 1024, (6, 6)),
    "dba_v": (288, 32, (6,)),
    "dba_c": (144, 32, (3030,)),
    "dba_w": (144, 32, (3030,)),
    "dba_ei": (144, 32, (6, 3030)),
    "dba_schur": (2368, 1024, (6, 6)),
    "dba_pairs": (2048, 1024, (6, 6)),
    "dba_rhs": (176, 32, (6,)),
    # the same frame's sums that depend on the pixels, at 376x1248
    # (47x156 features, 7332 pixels an edge): GraphAgg's, C, w and Ei
    "graph_agg_wide": (48, 32, (128, 47, 156)),
    "dba_c_wide": (144, 32, (7332,)),
    "dba_w_wide": (144, 32, (7332,)),
    "dba_ei_wide": (144, 32, (6, 7332)),
}
# the launches the tracker makes of them: GraphAgg's, and the DBA's
# two a full iteration (H, v, C, w, Ei; the Schur sum and the rhs
# correction)
GROUPS = {
    "graph_agg": ("graph_agg", "graph_agg_counts"),
    "dba_1": ("dba_hessian", "dba_v", "dba_c", "dba_w", "dba_ei"),
    "dba_2": ("dba_schur", "dba_rhs"),
    "graph_agg_wide": ("graph_agg_wide", "graph_agg_counts"),
    "dba_1_wide": ("dba_hessian", "dba_v", "dba_c_wide", "dba_w_wide",
                   "dba_ei_wide"),
}


def case_inputs(name, seed=0, device="cpu"):
    """(out, idx, x) of case ``name`` from numpy: x and out standard
    normal f32, idx uniform over the output rows with a tenth of the rows
    sent out of range (-1 or n_out)."""
    n, n_out, shape = CASES[name]
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    idx = rng.randint(0, n_out, n)
    drop = rng.rand(n) < 0.1
    idx[drop] = np.where(rng.rand(int(drop.sum())) < 0.5, -1, n_out)
    out = rng.standard_normal((n_out,) + shape).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (out, idx, x))


def _parent(path):
    lib = ctypes.CDLL(str(cuda_corr.build(path)))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.pvo_segsum.argtypes = [p, p, p, i64, i64, i64, p]
    lib.pvo_segsum.restype = ctypes.c_int

    def index_add(out, idx, x):
        D = out[0].numel() if out.shape[0] else 0
        rc = lib.pvo_segsum(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                            x.shape[0], out.shape[0], D,
                            torch.cuda.current_stream().cuda_stream)
        cuda_corr.check_rc(rc, "parent segsum")
        return out

    def sums(jobs):
        for out, idx, x, zero in jobs:
            if zero:
                out.zero_()
            index_add(out, idx, x)
        return [job[0] for job in jobs]
    return sums


def _library(jobs):
    """The card's index_add_ on each job's in-range rows."""
    kept = []
    for out, idx, x, _ in jobs:
        ok = (idx >= 0) & (idx < out.shape[0])
        kept.append((out, idx[ok], x[ok]))

    def run():
        for out, idx, x in kept:
            out.index_add_(0, idx, x)
    return run


def measure(names, zero, reps, parent=None, seed=0, plain=False):
    """One launch of the cases ``names`` (a group, or one case) in the
    mode ``zero``: bit-equal to the CPU, its time (and the parent's, in
    turns), the library's time and the bound; with ``plain`` also the
    plain version's time on the card (``cuda_segsum.sums_plain``)."""
    cpu = [case_inputs(n, seed + k) for k, n in enumerate(names)]
    want = cuda_segsum.sums_plain(
        [cuda_segsum.Sum(o.clone(), i, x, zero) for o, i, x in cpu])
    dev = [tuple(t.cuda() for t in c) for c in cpu]
    jobs = [cuda_segsum.Sum(o.clone(), i, x, zero) for o, i, x in dev]
    got = [t.cpu() for t in cuda_segsum.sums(jobs)]
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    res = {"cases": list(names), "zero": zero, "bit_equal_cpu": equal,
           "max_abs_err": err}
    work = [cuda_segsum.Sum(o.clone(), i, x, zero) for o, i, x in dev]

    def this():
        cuda_segsum.sums(work)
    if parent is not None:
        pjobs = [cuda_segsum.Sum(o.clone(), i, x, zero) for o, i, x in dev]
        pgot = [t.cpu() for t in parent(pjobs)]
        res["parent_equal"] = all(torch.equal(a, b)
                                  for a, b in zip(pgot, got))
        t = [kbench.graph_time_ms(f, reps) for f in
             (lambda: parent(work), this, this, lambda: parent(work))]
        res["ms"], res["parent_ms"] = t[1:3], [t[0], t[3]]
    else:
        res["ms"] = [kbench.graph_time_ms(this, reps)]
    if plain:
        res["plain_ms"] = kbench.graph_time_ms(
            lambda: cuda_segsum.sums_plain(work), reps)
    res["library_ms"] = kbench.graph_time_ms(
        _library([cuda_segsum.Sum(o.clone(), i, x, zero)
                  for o, i, x in dev]), reps)
    res["bound"] = kbench.segsum_jobs_bound(
        [cuda_segsum.Sum(o, i, x, zero) for o, i, x in cpu])
    res["share_of_bound"] = res["bound"]["ms"] / min(res["ms"])
    return res


def run(reps=20, parent_path=None):
    kbench.require_cuda()
    parent = _parent(parent_path) if parent_path else None
    rows = []
    for name in CASES:
        for zero in (False, True):
            rows.append(dict(kind="case", name=name,
                             **measure((name,), zero, reps, parent)))
    for name, names in GROUPS.items():
        rows.append(dict(kind="group", name=name,
                         **measure(names, True, reps, parent)))
    for r in rows:
        par = (f" parent_ms={','.join(f'{t:.4f}' for t in r['parent_ms'])}"
               f" parent_equal={r['parent_equal']}" if parent else "")
        print(f"segsum {r['kind']}={r['name']} zero={r['zero']} "
              f"bit_equal_cpu={r['bit_equal_cpu']} "
              f"ms={','.join(f'{t:.4f}' for t in r['ms'])}{par} "
              f"library_ms={r['library_ms']:.4f} "
              f"bound_ms={r['bound']['ms']:.4f} "
              f"share={r['share_of_bound']:.4f}", flush=True)
    bad = [r["name"] for r in rows
           if not r["bit_equal_cpu"] or not r.get("parent_equal", True)]
    out = {"gpu": kbench.gpu_line(), "reps": reps, "rows": rows,
           "not_equal": bad}
    print(json.dumps(out))
    if bad:
        raise AssertionError(f"segsum: not bit-equal: {bad}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--parent", default=None,
                   help="an earlier segsum.cu (one-job interface)")
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    return run(args.reps, args.parent)


if __name__ == "__main__":
    main()
