"""The DBA's kernels (``csrc/dba.cu``, ``vo/net/cuda_dba.py``) against their
plain versions on the card, at the tracker's shapes.

    python -m pvo_tpu_torch.scripts.dba_probe [shape ...] [--reps N]
        [--parent PATH]
    python -m pvo_tpu_torch.scripts.dba_probe --record_backend [--n_kf 40]
        [--image_size 376 1248]

``SHAPES`` are DBA calls from numpy (:func:`inputs`): the planner's full
regime at 240x808 (E=144 edges, P = K = 32, 2048 pair slots, 30x101)
and at 376x1248 (``planner_wide``: the same at 47x156, 7332 pixels an
edge),
``bench_dba``'s E=48 (512 slots), the 47x156 features of the 376x1248
export and wide streams, a 128x40 stream, one edge, the planner's
shape motion-only, ``odd_hw``: E=48 at 47x155 (376x1240 images, an odd
pixel count), ``backend``: the backend's largest call at 100 keyframes
as it was recorded on the card (``BACKEND_CALL``: its 1008 edges over
K = 100 depth frames and P = 99 pose frames, every pair slot of
``build_edge_pairs``), ``backend40``: the same at 40 keyframes, as many
as ``chip_smoke.py``'s main path tracks (its P on the one-block
solve), ``backend40_wide``: the backend's largest call at 40 keyframes
of a 376x1248 stream (47x156), as many as ``chip_smoke.py``'s wide
terminate tracks, ``backend_wide``: the backend's largest call at 100
keyframes of a 376x1248 stream (P = 99 at 47x156, on the solve's grid
kernel), ``crowded``: E=958 packed into K=32 frames (about 30 edges
a frame; the recorded call's largest frame has 14), whose frames' Grams
span several row tiles, ``filler``: the trajectory filler's motion-only
update of 16 poses, ``solve_max``: P = K = ``cuda_dba.SOLVE_MAX_P``,
the one-block solve's largest, ``multi_49``: P = K = 49, the grid
kernel's smallest, and ``buffer``: P = K = 511, the default buffer's
keyframes less one, as many as the backend's solve can meet in
``test_vo``'s runs, three edges a frame at 30x101. For each kernel
(:func:`stages` makes the inputs of the Schur terms, the solve and the
back-substitution from one plain iteration): the largest difference from the plain version
relative to the largest magnitude of that output (:func:`rel_err`;
within ``TOL``), whether two calls are bit-equal, and whether a
CUDA-graph replay equals the eager call; and the whole ``dba.dba`` (2
iterations) against the same call on the plain versions (poses and
disparities, abs/rel ``TOL``; beside the plain versions' own difference
between the card and the CPU, which sets the limit at shapes outside
``STRICT``), and two calls bit-equal. With times: kernel and plain in
turns (kernel, plain, plain, kernel), each the mean of ``reps`` calls
captured in one CUDA graph (``kbench.graph_time_ms``; with ``cold``
each call after a write that clears the L2, whose own time is taken
off), the bound
(``kbench.dba_bound``, the valid edges and pair slots of the inputs)
and, for the Schur terms, the library call: one ``torch.bmm`` of every
depth frame's weighted Gram (:func:`gram_operands`, stacked and padded
outside the timed call; the port never makes it), whose blocks are all
the Schur rows (:func:`gram_rows`). The back-substitution is the
iteration's update after the solve: its poses are also held to the
plain version's ``se3.retr`` on the card (abs/rel ``POSE_TOL``), and the
motion-only shape runs its retraction alone. The damped solve
(:func:`check_solve`) at P <= ``cuda_dba.SOLVE_MAX_P``: the kernel
against the plain version within ``TOL`` or ``FLOOR_FACTOR`` times the
plain version's card-against-CPU difference, bit-equal to the numpy
emulation of its order (``dba_solve_emul``), its backward error against
the f64 system within twice the plain version's plus
``SOLVE_ETA_FLOOR``; its library yardstick ``cholesky_ex`` +
``cholesky_solve`` timed beside it; at every P: one block up to
``cuda_dba.SOLVE_MAX_P`` (the grid kernel also run there, bit-equal to
it, and timed), the grid kernel above. With ``--parent PATH`` (an
earlier ``dba.cu`` of the same C interface for linearize, the Schur
terms and the back-substitution, or an earlier one whose
back-substitution is the three-launch one (``pvo_dba_backsub_edges``),
:func:`parent_backsub`; for example
``git archive <commit>`` unpacked
into the ignored ``.parent/``) each kernel is also timed against the
parent's in turns (parent, this, this, parent; against a three-launch
source the back-substitution against its three launches, and also
beside them with its eager retraction), the parent's outputs are held
to the plain versions' too, and the back-substitution's disparities
must equal the parent's bit for bit; the solve, which an earlier source
lacks, is timed beside the plain version (the parent's route) and the
library call. One JSON line last. ``--record_backend`` makes
``BACKEND_CALLS[n_kf, image_size]`` (:func:`record_backend`).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.scripts import dba_solve_emul, kbench
from pvo_tpu_torch.vo import dba as dba_mod
from pvo_tpu_torch.vo.net import cuda_corr, cuda_dba, cuda_segsum

# the backend's largest DBA call in bench_terminate's run at 100
# keyframes (240x808), recorded on the card by record_backend: its edges
# (ii, jj, all valid), windows (t0, t1, w0, P, K) and feature size; at
# 40 keyframes, as many as phase 5 of chip_smoke.py tracks (its P on the
# one-block solve); at 40 keyframes of a 376x1248 stream, as many as its
# wide terminate tracks; and at 100 keyframes of that stream (P = 99 on
# the grid solve). Keyed by (keyframes, image size)
NARROW, WIDE = (240, 808), (376, 1248)
BACKEND_CALL = Path(__file__).with_name("dba_backend_call.json")
BACKEND_CALLS = {
    (100, NARROW): BACKEND_CALL,
    (40, NARROW): BACKEND_CALL.with_name("dba_backend40_call.json"),
    (40, WIDE): BACKEND_CALL.with_name("dba_backend40_wide_call.json"),
    (100, WIDE): BACKEND_CALL.with_name("dba_backend_wide_call.json")}


def backend_call(n_kf=100, image_size=NARROW):
    """``BACKEND_CALLS[n_kf, image_size]`` as a dict."""
    return json.loads(BACKEND_CALLS[n_kf, tuple(image_size)].read_text())


_BACKEND, _BACKEND40 = backend_call(), backend_call(40)
_BACKEND40_WIDE = backend_call(40, WIDE)
_BACKEND_WIDE = backend_call(100, WIDE)
# (E, K, h, w, pair slots, motion_only); P = K except at "backend" (its
# recorded P); None: the slots that build_edge_pairs gives, unpadded
SHAPES = {
    "planner": (144, 32, 30, 101, 2048, False),
    # the planner's full regime on a wide stream, 376x1248
    "planner_wide": (144, 32, 47, 156, 2048, False),
    "bench_dba": (48, 32, 30, 101, 512, False),
    "wide": (48, 32, 47, 156, 512, False),
    "tall": (48, 32, 128, 40, 512, False),
    "one": (1, 4, 30, 101, 4, False),
    "motion_only": (144, 32, 30, 101, 2048, True),
    "odd_hw": (48, 32, 47, 155, 512, False),
    "backend": (len(_BACKEND["ii"]), _BACKEND["K"], *_BACKEND["hw"], None,
                False),
    "backend40": (len(_BACKEND40["ii"]), _BACKEND40["K"], *_BACKEND40["hw"],
                  None, False),
    "backend40_wide": (len(_BACKEND40_WIDE["ii"]), _BACKEND40_WIDE["K"],
                       *_BACKEND40_WIDE["hw"], None, False),
    "backend_wide": (len(_BACKEND_WIDE["ii"]), _BACKEND_WIDE["K"],
                     *_BACKEND_WIDE["hw"], None, False),
    "crowded": (958, 32, 30, 101, None, False),
    # the trajectory filler's motion-only update: its batch of 16 frames
    # (P = 16), two edges a frame
    "filler": (32, 16, 30, 101, None, True),
    # the largest P of the one-block solve and the smallest of the grid
    # kernel (the loop's backend reaches both), and P = 511 (the default
    # buffer's 512 keyframes less one): three edges a frame
    "solve_max": (3 * cuda_dba.SOLVE_MAX_P, cuda_dba.SOLVE_MAX_P, 30, 101,
                  None, False),
    "multi_49": (3 * 49, 49, 30, 101, None, False),
    "buffer": (3 * 511, 511, 30, 101, None, False),
}
# the shapes whose edges are a recorded graph, not drawn from the seed
GRAPHS = {"backend": _BACKEND, "backend40": _BACKEND40,
          "backend40_wide": _BACKEND40_WIDE, "backend_wide": _BACKEND_WIDE}
TOL = 1e-4
# the whole call against the plain versions' within TOL at these shapes;
# at the others within TOL or FLOOR_FACTOR times the plain versions'
# own difference between the card and the CPU (the same f32 sums in
# other orders), whichever is larger: with few edges a pose (bench_dba's
# E=48 over 32 frames) the solve amplifies the orders' last bits
STRICT = ("planner", "planner_wide", "motion_only")
FLOOR_FACTOR = 4
# frames of disparities past the window (the back-substitution copies them)
EXTRA_FRAMES = 8
# the back-substitution's retracted poses against se3.retr on the card,
# abs/rel: the same f32 operations, but for the order of the 3x3
# products' sums (cuBLAS's) and its contractions: a few f32 roundings
POSE_TOL = 2e-6
# the solve's backward error (dba_solve_emul.backward_error) at most
# twice the plain version's plus SOLVE_ETA_FLOOR, a few f32 roundings: a
# stable f32 solve keeps it there at any condition, where its forward
# error is the condition (1e5-3e6 at these shapes) times its roundings,
# and two f32 solves' forward errors differ by factors of 0.4-3 by chance
SOLVE_ETA_FLOOR = 1e-7
# the solve held bit-equal to the numpy emulation up to this P (the
# emulation's column steps are Python loops: 3 s at P = 99 on one core,
# minutes at 511)
EMUL_MAX_P = 128


def inputs(E, K, h, w, n_pairs, device, seed=0, graph=None):
    """``dba.dba``'s arguments from numpy: F = w0 + K + EXTRA_FRAMES
    frames, poses with small rotations and 0.05-scale translations,
    disparities about 1, E edges (the last quarter, at most 4, invalid)
    between nearby frames of the window, or those of ``graph`` (a
    recorded call, :func:`backend_call`: its edges, all valid, and its
    t0, t1, w0, P), targets where the true poses and disparities project
    each pixel (plus half-pixel noise) and random weights, the poses and
    disparities given to the DBA off the true ones by noise, the edge
    pairs of ``dba.build_edge_pairs`` in ``n_pairs`` slots (as many as
    there are pairs when None), and t0, t1, w0 as 0-d device tensors
    (the planner's: 1, K, 0)."""
    rng = np.random.RandomState(seed)
    t0, t1, w0, P = 1, K, 0, K
    if graph is not None:
        t0, t1, w0, P = (graph[k] for k in ("t0", "t1", "w0", "P"))
    F = w0 + K + EXTRA_FRAMES
    poses = np.zeros((F, 7), np.float32)
    q = np.concatenate([0.01 * rng.randn(F, 3), np.ones((F, 1))], 1)
    poses[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    poses[:, :3] = 0.05 * rng.randn(F, 3)
    disps = (1.0 + 0.1 * rng.rand(F, h, w)).astype(np.float32)
    intr = np.array([100.0, 100.0, w / 2, h / 2], np.float32)
    if graph is None:
        n_real = E - min(4, E // 4)
        ii = rng.randint(0, K, E)
        jj = (ii + 1 + rng.randint(0, 3, E)) % K
        valid = np.arange(E) < n_real
        ii[~valid] = jj[~valid] = 0
    else:
        ii, jj = np.asarray(graph["ii"]), np.asarray(graph["jj"])
        valid = np.ones(E, bool)
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
                pairs_valid=t(pv), t0=torch.tensor(t0, device=device),
                t1=torch.tensor(t1, device=device),
                w0=torch.tensor(w0, device=device), P=P, K=K)


def shape_inputs(name, device, seed=0, hw=None):
    """:func:`inputs` at ``SHAPES[name]`` (at ``hw`` pixels if given)."""
    E, K, h, w, n_pairs, _ = SHAPES[name]
    h, w = hw or (h, w)
    return inputs(E, K, h, w, n_pairs, device, seed, graph=GRAPHS.get(name))


def record_backend(n_kf=100, path=None, image_size=NARROW):
    """Track ``n_kf`` frames with ``bench_terminate``'s system on the
    card, run ``terminate`` and write the backend's largest ``dba.dba``
    call to ``path`` (``BACKEND_CALLS[n_kf, image_size]`` if None) as
    JSON: its
    edges ``ii``, ``jj`` (every one valid),
    ``t0``, ``t1``, ``w0``, ``P``, ``K``, the feature size ``hw``, the
    frames ``F`` and the edges of each backend call. Returns that dict.
    With random weights the graph differs from run to run: the file
    keeps one run's."""
    from pvo_tpu_torch.scripts import bench_terminate
    dev = torch.device("cuda")
    sysm, frames = bench_terminate.tracked_system(n_kf, image_size, dev)
    inside, calls, real = [False], [], dba_mod.dba
    backend = sysm.backend

    def in_backend(*a, **kw):
        inside[0] = True
        try:
            return backend(*a, **kw)
        finally:
            inside[0] = False

    def recorded(poses, disps, intrinsics, target, weight, eta, ii, jj,
                 valid, pairs_a, pairs_b, pairs_valid, t0, t1, w0, P, K,
                 **kw):
        if inside[0]:
            assert bool(valid.all()) and not kw.get("motion_only")
            calls.append(dict(
                ii=ii.tolist(), jj=jj.tolist(), t0=int(t0), t1=int(t1),
                w0=int(w0), P=int(P), K=int(K),
                hw=list(disps.shape[-2:]), F=int(poses.shape[0])))
        return real(poses, disps, intrinsics, target, weight, eta, ii, jj,
                    valid, pairs_a, pairs_b, pairs_valid, t0, t1, w0, P, K,
                    **kw)

    sysm.backend, dba_mod.dba = in_backend, recorded
    try:
        sysm.terminate(iter(frames))
    finally:
        dba_mod.dba = real
    call = max(calls, key=lambda c: len(c["ii"]))
    call["backend_edges"] = list(dict.fromkeys(len(c["ii"]) for c in calls))
    Path(path or BACKEND_CALLS[n_kf, tuple(image_size)]).write_text(
        json.dumps(call, separators=(",", ":")) + "\n")
    return call


def call_dba(a, iters=2, motion_only=False):
    keys = ("poses", "disps", "intrinsics", "target", "weight", "eta", "ii",
            "jj", "valid", "pairs_a", "pairs_b", "pairs_valid", "t0", "t1",
            "w0")
    return dba_mod.dba(*(a[k] for k in keys), P=a["P"], K=a["K"],
                       iters=iters, motion_only=motion_only)


@contextlib.contextmanager
def plain():
    """Every DBA kernel wrapper swapped for its plain version."""
    names = ("linearize", "schur", "solve", "backsub")
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
    iteration: {"linearize": args, "schur": args, "solve": args,
    "backsub": args}; the solve's summed blocks H, S_sum, v, corr_v and P
    are the iteration's, dx is seeded (P,6), 1e-2 normals."""
    K, P = a["K"], a["P"]
    ix = dba_mod._indices(a["ii"], a["jj"], a["valid"], a["pairs_a"],
                          a["pairs_b"], a["pairs_valid"], a["t0"], a["t1"],
                          a["w0"], P, K, a["poses"].shape[0])
    lin = (a["poses"], a["disps"], a["intrinsics"], a["target"], a["weight"],
           a["ii"], a["jj"], a["valid"])
    Hblk, vblk, Ei, Ej, Ck, wk = cuda_dba.linearize_plain(*lin)
    # the kernel's layout (the plain version's Ej is a permuted view, which
    # the wrappers would copy inside every timed call)
    Ej = Ej.contiguous()
    C, w_m, Ei_m = cuda_segsum.sums([
        cuda_segsum.zero_sum(Ck, ix.m_k, K),
        cuda_segsum.zero_sum(wk, ix.m_k, K),
        cuda_segsum.zero_sum(Ei, ix.m_ki, K)])
    eta = a["eta"].reshape(K, -1)
    g = torch.Generator().manual_seed(seed)
    dx = (1e-2 * torch.randn(P, 6, generator=g)).to(Ei.device)
    schur = (Ei_m, Ej, C, eta, w_m, ix.m_c, a["pairs_a"], a["pairs_b"],
             a["pairs_valid"])
    rows, rc = cuda_dba.schur_plain(*schur)
    H, v, S_sum, corr_v = cuda_segsum.sums([
        cuda_segsum.zero_sum(torch.cat([Hblk[:, :6, :6], Hblk[:, :6, 6:],
                                        Hblk[:, 6:, :6], Hblk[:, 6:, 6:]]),
                             ix.hidx, P * P),
        cuda_segsum.zero_sum(torch.cat([vblk[:, :6], vblk[:, 6:]]), ix.vidx,
                             P),
        cuda_segsum.zero_sum(rows, ix.s_idx, P * P),
        cuda_segsum.zero_sum(rc, ix.ridx, P)])
    return {"linearize": lin,
            "schur": schur,
            "solve": (H, S_sum, v, corr_v, P),
            "backsub": (a["poses"], dx, ix.frame_row, a["disps"], Ej,
                        ix.pj_sel, ix.m_k, Ei_m, ix.pm_sel, C, eta, w_m,
                        ix.frame_k)}


def parent_backsub(lib, poses, dx, frame_row, disps, Ej=None, pj_sel=None,
                   m_k=None, Ei_m=None, pm_sel=None, C=None, eta=None,
                   w_m=None, frame_k=None, retract=True):
    """:func:`cuda_dba.backsub` as an earlier ``dba.cu`` (``lib``, whose C
    interface has the edge pass ``pvo_dba_backsub_edges`` and the depth
    pass ``pvo_dba_backsub``) computed it: ``se3.retr`` of the poses (unless
    not ``retract``: then the poses come back as given), the edge pass,
    the segment sum of its terms and the depth pass, three launches."""
    # bound apart from lib's attributes, which cuda_dba.load bound to
    # the later interface
    vp, i = ctypes.c_void_p, ctypes.c_int
    edges, depth = lib["pvo_dba_backsub_edges"], lib["pvo_dba_backsub"]
    edges.argtypes = [vp, vp, vp, i, i, vp, vp]
    depth.argtypes = [vp] * 9 + [i, i, vp, vp]
    stream = torch.cuda.current_stream().cuda_stream
    # contiguous, as that source's wrappers passed them
    dx, disps, Ej, pj_sel, Ei_m, pm_sel, C, eta, w_m, frame_k = (
        t if t is None else t.contiguous() for t in
        (dx, disps, Ej, pj_sel, Ei_m, pm_sel, C, eta, w_m, frame_k))
    if retract:
        poses = se3.retr(poses, cuda_dba._dx_rows(dx, frame_row))
    if Ej is None:
        return poses, disps
    (E, _, HW), K, F = Ej.shape, Ei_m.shape[0], disps.shape[0]
    te = torch.empty((E, HW), dtype=torch.float32, device=Ej.device)
    cuda_corr.check_rc(edges(Ej.data_ptr(), dx.data_ptr(), pj_sel.data_ptr(),
                             E, HW, te.data_ptr(), stream), "parent edges")
    t_edge, = cuda_segsum.sums([cuda_segsum.zero_sum(te, m_k, K)])
    out = torch.empty(disps.shape, dtype=torch.float32, device=Ej.device)
    cuda_corr.check_rc(depth(*(t.data_ptr() for t in (
        Ei_m, dx, pm_sel, C, eta, w_m, t_edge, disps, frame_k)), F, HW,
        out.data_ptr(), stream), "parent depth pass")
    return poses, out


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


def gram_operands(Ei_m, Ej, C, eta, w_m, m_c):
    """The operands of the library yardstick of the Schur terms: per
    depth frame q the rows M_q = [Ei_m[q]; w_m[q]; Ej[e] for each edge e
    with m_c[e] == q, in edge order], zero-padded to the largest frame's
    rows, and M_q Q_q with Q = 1 / (C + eta) per pixel. Returns (MQ, M,
    groups), groups[q] the edges of frame q; ``torch.bmm(MQ, M^T)`` is
    every frame's weighted Gram."""
    K, _, HW = Ei_m.shape
    m = m_c.cpu().numpy()
    groups = [np.flatnonzero(m == q) for q in range(K)]
    rows = 7 + 6 * max((len(g) for g in groups), default=0)
    M = Ei_m.new_zeros((K, rows, HW))
    M[:, :6] = Ei_m
    M[:, 6] = w_m
    for q, g in enumerate(groups):
        if len(g):
            idx = torch.from_numpy(g).to(Ej.device)
            M[q, 7:7 + 6 * len(g)] = Ej[idx].reshape(-1, HW)
    Q = 1.0 / (C + eta)
    return M * Q[:, None, :], M, groups


def gram_rows(G, groups, m_c, pairs_a, pairs_b, pairs_valid):
    """``cuda_dba.schur``'s rows and rhs correction read from the Grams
    ``G = bmm(MQ, M^T)`` of :func:`gram_operands`: (a) the self block,
    (b) self x edge and its transpose, (c) the pair slot's edge blocks
    (zeros where the slot is not valid), rc the self and edge rows
    against the w_m row. Host loops: for the tests."""
    K, E = G.shape[0], m_c.shape[0]
    rank = np.zeros(E, np.int64)
    for g in groups:
        rank[g] = np.arange(len(g))
    m = m_c.cpu().numpy()

    def rows(e):
        return slice(7 + 6 * rank[e], 13 + 6 * rank[e])
    a_rows = [G[q, :6, :6] for q in range(K)]
    b_rows = [G[m[e], :6, rows(e)] for e in range(E)]
    c_rows = []
    for a, b, ok in zip(pairs_a.tolist(), pairs_b.tolist(),
                        pairs_valid.tolist()):
        c_rows.append(G[m[a], rows(a), rows(b)] if ok else
                      G.new_zeros((6, 6)))
    out = torch.stack(a_rows + b_rows + [r.T for r in b_rows] + c_rows)
    rc = torch.stack([G[q, :6, 6] for q in range(K)] +
                     [G[m[e], rows(e), 6] for e in range(E)])
    return out, rc


@contextlib.contextmanager
def library(lib):
    """``cuda_dba``'s wrappers launching ``lib``'s kernels (an earlier
    ``dba.cu`` bound by ``cuda_dba.load``)."""
    saved, cuda_dba._lib = cuda_dba._lib, lib
    try:
        yield
    finally:
        cuda_dba._lib = saved


def check(name, reps=0, seed=0, parent=None, solve_reps=None,
          cold=False):
    """Each kernel at shape ``name`` against its plain version, and the
    whole call; with ``reps`` their times. Returns {kernel: {...}} with
    "err", "bit_stable", "graph_equal" and, timed, "ms", "plain_ms",
    "bound_ms", "bound_by", "library_ms"; the back-substitution also
    "pose_err" (its poses against the plain version's ``se3.retr`` on the
    card, abs/rel); with ``parent`` (a library of ``cuda_dba.load``)
    "parent_err" and, timed, "parent_ms" and "ms_vs_parent" (the parent's
    two around the kernel's two), and for the back-substitution
    "parent_disps_equal" (its disparities bit-equal to the parent's three
    launches) and "parent_all_ms" (those and the eager retraction);
    "dba_solve": :func:`check_solve`'s, timed with ``solve_reps`` where
    given, else ``reps`` (an earlier source has no solve:
    with ``parent`` the solve is timed beside the plain version, the
    earlier route); and "dba": the call's poses' and disparities' worst
    abs/rel difference. With ``cold`` every time is taken with the L2
    cleared before each call (``kbench.graph_time_ms``'s ``flush``)."""
    E, K, h, w, n_pairs, motion_only = SHAPES[name]
    dev = torch.device("cuda")
    a = shape_inputs(name, dev, seed)
    st = stages(a)
    if motion_only:
        st["backsub"] = st["backsub"][:4]
        H, _, v, _, P = st["solve"]
        st["solve"] = (H, None, v, None, P)
    HW, F = h * w, a["poses"].shape[0]
    NP = a["pairs_a"].shape[0]
    kw = {"linearize": dict(motion_only=motion_only)}
    res = {}
    for k in ("linearize", "schur", "backsub"):
        if motion_only and k == "schur":
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
        if k == "backsub":
            res[k]["pose_err"] = absrel(out[0], ref[0])
        # a source whose back-substitution is three launches
        three = (k == "backsub" and parent is not None and
                 hasattr(parent, "pvo_dba_backsub_edges"))
        if parent is not None:
            if three:
                pout = _outs(parent_backsub(parent, *args))
                res[k]["parent_disps_equal"] = torch.equal(pout[1], out[1])
            else:
                with library(parent):
                    pout = _outs(kern())
                if k == "backsub":
                    res[k]["parent_disps_equal"] = torch.equal(pout[-1],
                                                               out[-1])
            res[k]["parent_err"] = max(rel_err(o, r)
                                       for o, r in zip(pout, ref))
        if reps:
            plain_fn = (lambda args=args, opts=opts, k=k:
                        getattr(cuda_dba, k + "_plain")(*args, **opts))
            times = [kbench.graph_time_ms(f, reps, flush=cold)
                     for f in (kern, plain_fn, plain_fn, kern)]
            res[k].update(ms=[times[0], times[3]],
                          plain_ms=min(times[1:3]))
            if parent is not None:
                if three:
                    # the parent's launches alone (its retraction was
                    # eager torch), then with the retraction
                    def par(args=args):
                        return kbench.graph_time_ms(
                            lambda: parent_backsub(parent, *args,
                                                   retract=motion_only),
                            reps, flush=cold)
                    res[k]["parent_all_ms"] = kbench.graph_time_ms(
                        lambda: parent_backsub(parent, *args), reps,
                        flush=cold)
                else:
                    def par(kern=kern):
                        with library(parent):
                            return kbench.graph_time_ms(kern, reps,
                                                        flush=cold)
                t = [par(), kbench.graph_time_ms(kern, reps, flush=cold),
                     kbench.graph_time_ms(kern, reps, flush=cold), par()]
                res[k].update(parent_ms=[t[0], t[3]], ms_vs_parent=t[1:3])
    res["solve"] = check_solve(st["solve"],
                               reps if solve_reps is None else solve_reps,
                               cold)
    res = {f"dba_{k}": v for k, v in res.items()}
    if reps:
        n_valid = int(a["valid"].sum())
        n_pairs_valid = int(a["pairs_valid"].sum())
        n_summed = 0 if motion_only else int((st["backsub"][6] < K).sum())
        bounds = {
            "dba_linearize": kbench.dba_bound(
                "dba_linearize", E, K, HW, valid_edges=n_valid,
                motion_only=motion_only),
            "dba_schur": kbench.dba_bound(
                "dba_schur", E, K, HW, NP=NP, valid_pairs=n_pairs_valid),
            "dba_backsub": kbench.dba_bound(
                "dba_backsub", E, K, HW, F=F, P=a["P"],
                valid_edges=n_summed, motion_only=motion_only)}
        for k, r in res.items():
            if k in bounds:
                r.update(bound_ms=bounds[k]["ms"],
                         bound_by=bounds[k]["bound_by"], library_ms=None)
        if "dba_schur" in res:
            MQ, M, _ = gram_operands(*st["schur"][:6])
            Mt = M.transpose(1, 2)
            res["dba_schur"]["library_ms"] = kbench.graph_time_ms(
                lambda: torch.bmm(MQ, Mt), reps, flush=cold)
            del MQ, M, Mt
    with plain():
        p_ref, d_ref = call_dba(a, motion_only=motion_only)
    p, d = call_dba(a, motion_only=motion_only)
    p2, d2 = call_dba(a, motion_only=motion_only)

    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in a.items()}
    p_cpu, d_cpu = call_dba(cpu, motion_only=motion_only)
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


def check_solve(args, reps=0, cold=False):
    """The damped solve at ``args`` (H, S_sum, v, corr_v, P of
    :func:`stages`; S_sum, corr_v None: motion-only) on the kernel that
    ``cuda_dba.solve_kernel(P)`` names ("kernel"). The plain version on
    the card against it on the CPU ("plain_card_cpu", relative to the
    largest |dx|), and its forward error against the f64 solve of the
    same f32 system and its backward error ("fwd_plain", "eta_plain",
    ``dba_solve_emul``); the kernel's "err" (against the plain version on
    the card) within "limit" (``TOL``, or ``FLOOR_FACTOR`` times the plain
    version's own card-against-CPU difference where that is larger: the
    f32 solve's spread at this system's condition), "bit_stable",
    "graph_equal", "fwd", "eta" and, at P <= ``EMUL_MAX_P``,
    "emulation_equal" (bit-equal to ``dba_solve_emul.emulate``, the
    kernels' order in numpy; None above). At P <= ``cuda_dba.SOLVE_MAX_P``
    also "grid_equal": the grid kernel, launched below its range, equal
    to the one block's dx bit for bit. With ``reps``: "ms" (the kernel in
    turns with the plain version and the library yardstick), "plain_ms",
    "library_ms" (``torch.linalg.cholesky_ex`` and
    ``torch.cholesky_solve`` on the damped matrix made outside the timed
    call), "bound_ms" and "bound_by" (``kbench.dba_bound``), and at P <=
    ``cuda_dba.SOLVE_MAX_P`` "grid_ms" (the grid kernel there); with
    ``cold`` the L2 cleared before each timed call."""
    H, S_sum, v, corr_v, P = args
    host = [None if t is None else t.cpu().numpy()
            for t in (H, S_sum, v, corr_v)]
    x64 = dba_solve_emul.solve64(*host, P)
    plain = cuda_dba.solve_plain(*args)
    cpu = cuda_dba.solve_plain(*(t.cpu() if torch.is_tensor(t) else t
                                 for t in args))
    r = {"kernel": cuda_dba.solve_kernel(P),
         "plain_card_cpu": rel_err(plain.cpu(), cpu),
         "fwd_plain": dba_solve_emul.forward_error(plain.cpu(), x64),
         "eta_plain": dba_solve_emul.backward_error(*host, P, plain.cpu())}

    def kern():
        return cuda_dba.solve(*args)

    def grid():
        return cuda_dba._solve_launch(*args, 0.1, 1e-4, True)
    out, again = kern(), kern()
    got = out.cpu().numpy()
    r.update(err=rel_err(out, plain),
             limit=max(TOL, FLOOR_FACTOR * r["plain_card_cpu"]),
             bit_stable=torch.equal(out, again),
             graph_equal=_graph_equal(kern, [out]),
             emulation_equal=(bool(np.array_equal(
                 got, dba_solve_emul.emulate(*host, P)))
                 if P <= EMUL_MAX_P else None),
             fwd=dba_solve_emul.forward_error(got, x64),
             eta=dba_solve_emul.backward_error(*host, P, got))
    small = P <= cuda_dba.SOLVE_MAX_P
    if small:
        n0 = cuda_dba.LAUNCHES[cuda_dba.GRID]
        r["grid_equal"] = torch.equal(grid(), out)
        cuda_dba.LAUNCHES[cuda_dba.GRID] = n0
    if reps:
        Sd = cuda_dba.damped(H, S_sum, P)
        b = (v if corr_v is None else v - corr_v).reshape(-1, 1)

        def library():
            return torch.cholesky_solve(b, torch.linalg.cholesky_ex(Sd)[0])

        def plain_fn():
            return cuda_dba.solve_plain(*args)
        t = [kbench.graph_time_ms(f, reps, flush=cold)
             for f in (kern, plain_fn, library, library, plain_fn, kern)]
        bound = kbench.dba_bound("dba_solve", P=P,
                                 motion_only=S_sum is None)
        r.update(ms=[t[0], t[5]], plain_ms=min(t[1], t[4]),
                 library_ms=min(t[2], t[3]), bound_ms=bound["ms"],
                 bound_by=bound["bound_by"])
        if small:
            n0 = cuda_dba.LAUNCHES[cuda_dba.GRID]
            r["grid_ms"] = [kbench.graph_time_ms(f, reps, flush=cold)
                            for f in (grid, kern, kern, grid)]
            cuda_dba.LAUNCHES[cuda_dba.GRID] = n0
    return r


def absrel(x, y):
    """max |x - y| / (1 + |y|)."""
    return float(((x.cpu() - y.cpu()).abs() / (1.0 + y.cpu().abs())).max())


def failures(res):
    """What in :func:`check`'s result breaks its tolerances."""
    bad = []
    for k, r in res.items():
        if k == "dba_solve":
            ok = (r["err"] <= r["limit"] and r["bit_stable"] and
                  r["graph_equal"] and r["emulation_equal"] is not False
                  and r.get("grid_equal", True) and
                  r["eta"] <= 2 * r["eta_plain"] + SOLVE_ETA_FLOOR)
            if not ok:
                bad.append((k, r))
        elif k == "dba":
            if not (r["poses"] <= r["limit"] and r["disps"] <= r["limit"]
                    and r["bit_stable"]):
                bad.append((k, r))
        elif not (r["err"] <= TOL and r["bit_stable"] and r["graph_equal"]
                  and r.get("parent_err", 0.0) <= TOL
                  and r.get("pose_err", 0.0) <= POSE_TOL
                  and r.get("parent_disps_equal", True)):
            bad.append((k, r))
    return bad


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("shapes", nargs="*", default=list(SHAPES))
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--parent", default=None,
                   help="an earlier dba.cu to time in turns with this one")
    p.add_argument("--record_backend", action="store_true",
                   help="track bench_terminate's n_kf keyframes and write "
                        "the backend's largest DBA call to "
                        "BACKEND_CALLS[n_kf, image_size] (nothing else)")
    p.add_argument("--n_kf", type=int, default=100,
                   choices=sorted({n for n, _ in BACKEND_CALLS}))
    p.add_argument("--image_size", type=int, nargs=2, default=list(NARROW))
    args = p.parse_args(argv)
    kbench.require_cuda()
    if args.record_backend:
        key = (args.n_kf, tuple(args.image_size))
        if key not in BACKEND_CALLS:
            p.error(f"no recorded call at {key}: {sorted(BACKEND_CALLS)}")
        call = record_backend(key[0], image_size=key[1])
        print(json.dumps({k: v for k, v in call.items()
                          if k not in ("ii", "jj")}))
        return call
    torch.backends.cuda.matmul.allow_tf32 = False
    parent = cuda_dba.load(args.parent) if args.parent else None
    out = {"gpu": kbench.gpu_line()}
    for name in args.shapes:
        res = check(name, args.reps, parent=parent)
        out[name] = res
        print(name, json.dumps(res))
        if failures(res):
            raise AssertionError(f"{name}: {failures(res)}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
