"""Inference-time dense bundle adjustment (DBA), f32.

Port of :mod:`pvo_tpu.vo.dba`. The reduced camera system is a dense
(6P x 6P) matrix solved with a Cholesky factorization; the depth
(Schur) elimination never forms the (6P x K*HW) E matrix but sums three
structured terms: self x self per depth frame, self x edge, and
edge x edge over pairs of edges sharing a source frame (built on the
host by :func:`build_edge_pairs`, or on the device by the planner).
The contractions are :mod:`cuda_dba`'s kernels on the card (the
linearization, the Schur terms, the damped solve from the summed blocks
to dx, and everything after the solve in one launch: the pose
retraction, the depth back-substitution with its edge terms summed per
depth frame, the disparities; their plain versions on the CPU), called
through the module's attributes. The solve is one kernel at any P: one
block up to ``cuda_dba.SOLVE_MAX_P`` poses (its system fits one block's
shared memory), a grid of blocks above (``cuda_dba.solve_kernel``, a rule
of the Python int P). Scatter-sums are
:func:`cuda_segsum.sums`, which sums in a fixed order on the card as on
the CPU, two launches a full iteration (H, v, C, w, Ei; the Schur sum
and the rhs correction) and one a motion-only one; rows whose index is
masked are dropped. The index lists depend only on the
graph and the windows and are built once a call. ``t0``, ``t1`` and
``w0`` may be Python ints or 0-d device tensors (the planner's), so
nothing here reads the card. Levenberg damping (diag += ep + lm*diag)
and the per-pixel eta damping keep the f32 solve well conditioned.
"""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

from pvo_tpu_torch.vo.net import cuda_dba, cuda_segsum

# the plain version's pair chunk (cuda_dba.schur_plain); the kernel needs none
PAIR_CHUNK = 2048


def build_edge_pairs(ii, valid, max_pairs=None):
    """Host helper: ordered pairs (a, b) of edge indices sharing the
    same source frame ii (including a == b), padded to ``max_pairs``
    (no padding when None). These drive the edge x edge Schur terms."""
    groups = defaultdict(list)
    for e, (i, ok) in enumerate(zip(np.asarray(ii), np.asarray(valid))):
        if ok:
            groups[int(i)].append(e)
    pa, pb = [], []
    for g in groups.values():
        for a in g:
            for b in g:
                pa.append(a)
                pb.append(b)
    n = len(pa)
    if max_pairs is None:
        max_pairs = n
    if n > max_pairs:
        raise ValueError(f"edge-pair overflow: {n} > {max_pairs}")
    pa = np.pad(np.asarray(pa, np.int64), (0, max_pairs - n))
    pb = np.pad(np.asarray(pb, np.int64), (0, max_pairs - n))
    pv = np.zeros(max_pairs, bool)
    pv[:n] = True
    return pa, pb, pv


def dba(poses, disps, intrinsics, target, weight, eta, ii, jj, valid,
        pairs_a, pairs_b, pairs_valid, t0, t1, w0, P, K, iters=2,
        motion_only=False, ep=0.1, lm=1e-4):
    """Run ``iters`` damped Gauss-Newton iterations.

    poses (F,7) w2c, disps (F,h,w), intrinsics (4,), target/weight
    (E,h,w,2), eta (K,h,w) depth damping for frames [w0, w0+K);
    ii/jj/valid (E,); pairs from :func:`build_edge_pairs`; pose window
    [t0, t1) of size <= P, depth window origin w0 of size K.
    Returns updated (poses, disps).
    """
    dev = poses.device
    F = poses.shape[0]
    h, w = disps.shape[-2:]
    HW = h * w
    as_long = (lambda a: torch.as_tensor(a, device=dev).long())
    ii, jj = as_long(ii), as_long(jj)
    valid = torch.as_tensor(valid, device=dev).bool()
    pairs_a, pairs_b = as_long(pairs_a), as_long(pairs_b)
    pairs_valid = torch.as_tensor(pairs_valid, device=dev).bool()
    eta_flat = eta.reshape(K, HW)
    ix = _indices(ii, jj, valid, pairs_a, pairs_b, pairs_valid, t0, t1, w0,
                  P, K, F)

    def one_iteration(poses, disps):
        Hblk, vblk, Ei, Ej, Ck, wk = cuda_dba.linearize(
            poses, disps, intrinsics, target, weight, ii, jj, valid,
            motion_only)

        # one launch: the pose-pose Hessian (P,P,6,6) from the 4E blocks,
        # the gradient from the 2E halves and, for a full iteration, the
        # depth terms C, w and Ei per depth frame
        jobs = [cuda_segsum.zero_sum(torch.cat([
                    Hblk[:, :6, :6], Hblk[:, :6, 6:], Hblk[:, 6:, :6],
                    Hblk[:, 6:, 6:]]), ix.hidx, P * P),
                cuda_segsum.zero_sum(torch.cat([vblk[:, :6], vblk[:, 6:]]),
                                     ix.vidx, P)]
        if not motion_only:
            jobs += [cuda_segsum.zero_sum(Ck, ix.m_k, K),
                     cuda_segsum.zero_sum(wk, ix.m_k, K),
                     cuda_segsum.zero_sum(Ei, ix.m_ki, K)]
        H, v, *depth = cuda_segsum.sums(jobs)

        S_sum = corr_v = None
        if not motion_only:
            C, w_m, Ei_m = depth          # (K, HW), (K, HW), (K, 6, HW)
            # (a) self x self per depth frame, (b) self x edge and its
            # transpose, (c) edge x edge over same-source pairs; the rhs
            # correction v - E Q w (self + edge terms)
            rows, rc = cuda_dba.schur(Ei_m, Ej, C, eta_flat, w_m, ix.m_c,
                                      pairs_a, pairs_b, pairs_valid,
                                      PAIR_CHUNK)
            # one launch: the Schur sum (a), (b), (c) in that order, and
            # the rhs correction
            S_sum, corr_v = cuda_segsum.sums([
                cuda_segsum.zero_sum(rows, ix.s_idx, P * P),
                cuda_segsum.zero_sum(rc, ix.ridx, P)])

        # one launch: the damped dense solve (H - S_sum) dx = v - corr_v
        dx = cuda_dba.solve(H, S_sum, v, corr_v, P, ep, lm)

        # one launch: the pose retraction over [t0, t1) and, for a full
        # iteration, the depth back-substitution (the edge terms summed
        # per depth frame, dz) and the disparities
        if motion_only:
            return cuda_dba.backsub(poses, dx, ix.frame_row, disps)
        return cuda_dba.backsub(poses, dx, ix.frame_row, disps, Ej,
                                ix.pj_sel, ix.m_k, Ei_m, ix.pm_sel, C,
                                eta_flat, w_m, ix.frame_k)

    for _ in range(iters):
        poses, disps = one_iteration(poses, disps)
    return poses, disps


class _Indices(NamedTuple):
    """The index lists of :func:`dba`'s sums and kernels, which depend only
    on the graph, the pairs and the windows: built once a call."""
    hidx: torch.Tensor       # (4E,) Hessian blocks into P*P (P*P: dropped)
    vidx: torch.Tensor       # (2E,) gradient halves into P
    m_k: torch.Tensor        # (E,) depth frame of C, w, the edge term
    m_ki: torch.Tensor       # (E,) depth frame of Ei (pose ii free)
    m_c: torch.Tensor        # (E,) depth frame, clamped into [0, K)
    s_idx: torch.Tensor      # (K + 2E + NP,) Schur rows into P*P
    ridx: torch.Tensor       # (K + E,) rhs correction rows into P
    pj_sel: torch.Tensor     # (E,) pose row of jj, -1 outside the window
    pm_sel: torch.Tensor     # (K,) pose row of each depth frame, or -1
    frame_row: torch.Tensor  # (F,) pose row of each frame, or -1
    frame_k: torch.Tensor    # (F,) depth frame of each frame, or -1


def _indices(ii, jj, valid, pairs_a, pairs_b, pairs_valid, t0, t1, w0, P,
             K, F):
    dev = ii.device
    pi, pj, m = ii - t0, jj - t0, ii - w0
    ok_i = valid & (pi >= 0) & (pi < P)
    ok_j = valid & (pj >= 0) & (pj < P)
    ok_m = valid & (m >= 0) & (m < K)
    pm = torch.arange(K, device=dev) + w0 - t0
    ok_pm = (pm >= 0) & (pm < P)

    def sidx(rows, cols, ok):
        return torch.where(ok, rows * P + cols, torch.full_like(rows, P * P))

    def where(ok, idx, n):
        return torch.where(ok, idx, torch.full_like(idx, n))

    ok_bm = ok_i & ok_j & ok_m
    pj_a, pj_b = pj[pairs_a], pj[pairs_b]
    ok_c = (pairs_valid & (pj_a >= 0) & (pj_a < P) & (pj_b >= 0) &
            (pj_b < P))
    f = torch.arange(F, device=dev)
    k, r = f - w0, f - t0
    return _Indices(
        hidx=torch.cat([sidx(pi, pi, ok_i), sidx(pi, pj, ok_i & ok_j),
                        sidx(pj, pi, ok_i & ok_j), sidx(pj, pj, ok_j)]),
        vidx=torch.cat([where(ok_i, pi, P), where(ok_j, pj, P)]),
        m_k=where(ok_m, m, K), m_ki=where(ok_m & ok_i, m, K),
        m_c=m.clamp(0, K - 1),
        s_idx=torch.cat([sidx(pm, pm, ok_pm), sidx(pi, pj, ok_bm),
                         sidx(pj, pi, ok_bm), sidx(pj_a, pj_b, ok_c)]),
        ridx=torch.cat([where(ok_pm, pm, P), where(ok_j & ok_m, pj, P)]),
        pj_sel=where(ok_j, pj, -1), pm_sel=where(ok_pm, pm, -1),
        frame_row=where((r >= 0) & (r < P) & (f < t1), r, -1),
        frame_k=where((k >= 0) & (k < K) & (f < t1), k, -1))
