"""The DBA's kernels (``csrc/dba.cu``, ``vo/net/cuda_dba.py``) against their
plain versions on the card, at the tracker's shapes.

    python -m pvo_tpu_torch.scripts.dba_probe [shape ...] [--reps N]

``SHAPES`` are DBA calls from numpy (:func:`inputs`): the planner's full
regime at 240x808 (E=144 edges, P = K = 32, 2048 pair slots, 30x101),
``bench_dba``'s E=48 (512 slots), the 47x156 features of the 376x1248
export and wide streams, a 128x40 stream, one edge, and the planner's
shape motion-only. For each kernel (:func:`stages` makes the inputs of
the Schur terms and the back-substitution from one plain iteration):
the largest difference from the plain version relative to the largest
magnitude of that output (:func:`rel_err`; within ``TOL``), whether two
calls are bit-equal, and whether a CUDA-graph replay equals the eager
call; and the whole ``dba.dba`` (2 iterations) against the same call on
the plain versions (poses and disparities, abs/rel ``TOL``; beside the
plain versions' own difference between the card and the CPU, which sets
the limit at shapes outside ``STRICT``), and two calls bit-equal. With
times:
kernel and plain in turns (kernel, plain, plain, kernel), each the mean
of ``reps`` calls captured in one CUDA graph (``kbench.graph_time_ms``),
the bound (``kbench.dba_bound``, the valid edges and pair slots of the
inputs) and, for the Schur terms, ``torch.einsum`` of the (a) and (b)
items on gathered operands (the library call; the port never makes it).
The back-substitution's row is its two passes. One JSON line last.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.vo import dba as dba_mod
from pvo_tpu_torch.vo.net import cuda_dba, cuda_segsum

# (E, K, h, w, pair slots, motion_only); P = K
SHAPES = {
    "planner": (144, 32, 30, 101, 2048, False),
    "bench_dba": (48, 32, 30, 101, 512, False),
    "wide": (48, 32, 47, 156, 512, False),
    "tall": (48, 32, 128, 40, 512, False),
    "one": (1, 4, 30, 101, 4, False),
    "motion_only": (144, 32, 30, 101, 2048, True),
}
TOL = 1e-4
# the whole call against the plain versions' within TOL at these shapes;
# at the others within TOL or FLOOR_FACTOR times the plain versions'
# own difference between the card and the CPU (the same f32 sums in
# other orders), whichever is larger: with few edges a pose (bench_dba's
# E=48 over 32 frames) the solve amplifies the orders' last bits
STRICT = ("planner", "motion_only")
FLOOR_FACTOR = 4
# frames of disparities past the window (the back-substitution copies them)
EXTRA_FRAMES = 8


def inputs(E, K, h, w, n_pairs, device, seed=0):
    """``dba.dba``'s arguments from numpy: F = K + EXTRA_FRAMES frames,
    poses with small rotations and 0.05-scale translations, disparities
    about 1, E edges (the last quarter, at most 4, invalid) between
    nearby frames of the window, targets where the true poses and
    disparities project each pixel (plus half-pixel noise) and random
    weights, the poses and disparities given to the DBA off the true
    ones by noise, the edge pairs of ``dba.build_edge_pairs`` in
    ``n_pairs`` slots, and t0, t1, w0 as 0-d device tensors (the
    planner's)."""
    rng = np.random.RandomState(seed)
    F = K + EXTRA_FRAMES
    poses = np.zeros((F, 7), np.float32)
    q = np.concatenate([0.01 * rng.randn(F, 3), np.ones((F, 1))], 1)
    poses[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    poses[:, :3] = 0.05 * rng.randn(F, 3)
    disps = (1.0 + 0.1 * rng.rand(F, h, w)).astype(np.float32)
    intr = np.array([100.0, 100.0, w / 2, h / 2], np.float32)
    n_real = E - min(4, E // 4)
    ii = rng.randint(0, K, E)
    jj = (ii + 1 + rng.randint(0, 3, E)) % K
    valid = np.arange(E) < n_real
    ii[~valid] = jj[~valid] = 0
    coords, _ = projective.projective_transform(
        torch.from_numpy(poses)[None], torch.from_numpy(disps)[None],
        torch.from_numpy(intr).expand(1, F, 4), ii, jj)
    target = (coords[0].numpy() +
              0.5 * rng.randn(E, h, w, 2)).astype(np.float32)
    weight = rng.rand(E, h, w, 2).astype(np.float32)
    poses[1:, :3] += 0.01 * rng.randn(F - 1, 3).astype(np.float32)
    disps = (disps + 0.05 * rng.randn(F, h, w)).astype(np.float32)
    eta = 0.01 * np.ones((K, h, w), np.float32)
    pa, pb, pv = dba_mod.build_edge_pairs(ii, valid, n_pairs)
    t = (lambda a: torch.from_numpy(np.asarray(a)).to(device))
    return dict(poses=t(poses), disps=t(disps), intrinsics=t(intr),
                target=t(target), weight=t(weight), eta=t(eta),
                ii=t(ii.astype(np.int64)), jj=t(jj.astype(np.int64)),
                valid=t(valid), pairs_a=t(pa), pairs_b=t(pb),
                pairs_valid=t(pv), t0=torch.tensor(1, device=device),
                t1=torch.tensor(K, device=device),
                w0=torch.tensor(0, device=device), P=K, K=K)


def call_dba(a, iters=2, motion_only=False):
    keys = ("poses", "disps", "intrinsics", "target", "weight", "eta", "ii",
            "jj", "valid", "pairs_a", "pairs_b", "pairs_valid", "t0", "t1",
            "w0")
    return dba_mod.dba(*(a[k] for k in keys), P=a["P"], K=a["K"],
                       iters=iters, motion_only=motion_only)


@contextlib.contextmanager
def plain():
    """Every DBA kernel wrapper swapped for its plain version."""
    names = ("linearize", "schur", "edge_terms", "backsub")
    saved = {k: getattr(cuda_dba, k) for k in names}
    for k in names:
        setattr(cuda_dba, k, getattr(cuda_dba, k + "_plain"))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(cuda_dba, k, fn)


def stages(a, seed=1):
    """The arguments of each kernel at ``a``'s shape, from one plain
    iteration: {"linearize": args, "schur": args, "edge_terms": args,
    "backsub": args}; dx is seeded (P,6), 1e-2 normals."""
    K, P = a["K"], a["P"]
    ix = dba_mod._indices(a["ii"], a["jj"], a["valid"], a["pairs_a"],
                          a["pairs_b"], a["pairs_valid"], a["t0"], a["t1"],
                          a["w0"], P, K, a["poses"].shape[0])
    lin = (a["poses"], a["disps"], a["intrinsics"], a["target"], a["weight"],
           a["ii"], a["jj"], a["valid"])
    _, _, Ei, Ej, Ck, wk = cuda_dba.linearize_plain(*lin)
    C, w_m, Ei_m = cuda_segsum.sums([
        cuda_segsum.zero_sum(Ck, ix.m_k, K),
        cuda_segsum.zero_sum(wk, ix.m_k, K),
        cuda_segsum.zero_sum(Ei, ix.m_ki, K)])
    eta = a["eta"].reshape(K, -1)
    g = torch.Generator().manual_seed(seed)
    dx = (1e-2 * torch.randn(P, 6, generator=g)).to(Ei.device)
    t_edge = cuda_segsum.segment_sum(
        cuda_dba.edge_terms_plain(Ej, dx, ix.pj_sel), ix.m_k, K)
    return {"linearize": lin,
            "schur": (Ei_m, Ej, C, eta, w_m, ix.m_c, a["pairs_a"],
                      a["pairs_b"], a["pairs_valid"]),
            "edge_terms": (Ej, dx, ix.pj_sel),
            "backsub": (Ei_m, dx, ix.pm_sel, C, eta, w_m, t_edge,
                        a["disps"], ix.frame_k)}


def rel_err(out, ref):
    """max |out - ref| over max |ref| (1 where ref is all zeros)."""
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    diff = float((out - ref).abs().max()) if ref.numel() else 0.0
    return diff / (scale if scale > 0 else 1.0)


def _outs(x):
    return [t for t in (x if isinstance(x, tuple) else (x,)) if t is not None]


def _graph_equal(fn, want):
    """Whether ``fn()`` captured in a CUDA graph and replayed gives
    ``want`` bit for bit."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = _outs(fn())
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    del graph
    return same


def check(name, reps=0, seed=0):
    """Each kernel at shape ``name`` against its plain version, and the
    whole call; with ``reps`` their times. Returns {kernel: {...}} with
    "err", "bit_stable", "graph_equal" and, timed, "ms" (the kernel's
    two), "plain_ms", "bound_ms", "bound_by", "library_ms"; and "dba":
    the call's poses' and disparities' worst abs/rel difference."""
    E, K, h, w, n_pairs, motion_only = SHAPES[name]
    dev = torch.device("cuda")
    a = inputs(E, K, h, w, n_pairs, dev, seed)
    st = stages(a)
    HW, F = h * w, a["poses"].shape[0]
    kw = {"linearize": dict(motion_only=motion_only)}
    res = {}
    for k in ("linearize", "schur", "edge_terms", "backsub"):
        if motion_only and k != "linearize":
            continue
        args, opts = st[k], kw.get(k, {})
        kern = (lambda args=args, opts=opts, k=k:
                getattr(cuda_dba, k)(*args, **opts))
        ref = _outs(getattr(cuda_dba, k + "_plain")(*args, **opts))
        out = _outs(kern())
        again = _outs(kern())
        res[k] = {"err": max(rel_err(o, r) for o, r in zip(out, ref)),
                  "bit_stable": all(torch.equal(o, g)
                                    for o, g in zip(out, again)),
                  "graph_equal": _graph_equal(kern, out)}
        if reps:
            plain_fn = (lambda args=args, opts=opts, k=k:
                        getattr(cuda_dba, k + "_plain")(*args, **opts))
            times = [kbench.graph_time_ms(f, reps)
                     for f in (kern, plain_fn, plain_fn, kern)]
            res[k].update(ms=[times[0], times[3]],
                          plain_ms=min(times[1:3]))
    # the back-substitution's row is its two passes
    if "edge_terms" in res:
        e, b = res.pop("edge_terms"), res["backsub"]
        b.update(err=max(e["err"], b["err"]),
                 bit_stable=e["bit_stable"] and b["bit_stable"],
                 graph_equal=e["graph_equal"] and b["graph_equal"])
        if reps:
            b.update(ms=[x + y for x, y in zip(e["ms"], b["ms"])],
                     plain_ms=e["plain_ms"] + b["plain_ms"])
    res = {f"dba_{k}": v for k, v in res.items()}
    if reps:
        n_valid = int(a["valid"].sum())
        n_pairs_valid = int(a["pairs_valid"].sum())
        bounds = {
            "dba_linearize": kbench.dba_bound(
                "dba_linearize", E, K, HW, valid_edges=n_valid,
                motion_only=motion_only),
            "dba_schur": kbench.dba_bound(
                "dba_schur", E, K, HW, NP=n_pairs, valid_pairs=n_pairs_valid),
            "dba_backsub": kbench.bounds_sum(
                kbench.dba_bound("dba_backsub_edges", E, K, HW),
                kbench.dba_bound("dba_backsub", E, K, HW, F=F))}
        for k, r in res.items():
            r.update(bound_ms=bounds[k]["ms"], bound_by=bounds[k]["bound_by"],
                     library_ms=None)
        if "dba_schur" in res:
            Ei_m, Ej, C, eta, w_m, m_c = st["schur"][:6]
            Q = 1.0 / (C + eta)
            L = torch.cat([Ei_m, Ei_m[m_c]])
            Qs = torch.cat([Q, Q[m_c]])
            R = torch.cat([Ei_m, Ej])
            res["dba_schur"]["library_ms"] = kbench.graph_time_ms(
                lambda: torch.einsum("xdh,xh,xeh->xde", L, Qs, R), reps)
    with plain():
        p_ref, d_ref = call_dba(a, motion_only=motion_only)
    p, d = call_dba(a, motion_only=motion_only)
    p2, d2 = call_dba(a, motion_only=motion_only)

    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in a.items()}
    p_cpu, d_cpu = call_dba(cpu, motion_only=motion_only)

    def absrel(x, y):
        return float(((x.cpu() - y.cpu()).abs() / (1.0 + y.cpu().abs())).max())
    res["dba"] = {"poses": absrel(p, p_ref), "disps": absrel(d, d_ref),
                  "bit_stable": bool(torch.equal(p, p2) and
                                     torch.equal(d, d2)),
                  "plain_card_cpu": max(absrel(p_cpu, p_ref),
                                        absrel(d_cpu, d_ref)),
                  "limit": TOL if name in STRICT else None}
    if res["dba"]["limit"] is None:
        res["dba"]["limit"] = max(TOL, FLOOR_FACTOR *
                                  res["dba"]["plain_card_cpu"])
    return res


def failures(res):
    """What in :func:`check`'s result breaks its tolerances."""
    bad = []
    for k, r in res.items():
        if k == "dba":
            if not (r["poses"] <= r["limit"] and r["disps"] <= r["limit"]
                    and r["bit_stable"]):
                bad.append((k, r))
        elif not (r["err"] <= TOL and r["bit_stable"] and r["graph_equal"]):
            bad.append((k, r))
    return bad


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("shapes", nargs="*", default=list(SHAPES))
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    kbench.require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"gpu": kbench.gpu_line()}
    for name in args.shapes:
        res = check(name, args.reps)
        out[name] = res
        print(name, json.dumps(res))
        if failures(res):
            raise AssertionError(f"{name}: {failures(res)}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
