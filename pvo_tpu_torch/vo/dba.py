"""Inference-time dense bundle adjustment (DBA), plain PyTorch, f32.

Port of :mod:`pvo_tpu.vo.dba`. The reduced camera system is a dense
(6P x 6P) matrix solved with a Cholesky factorization; the depth
(Schur) elimination never forms the (6P x K*HW) E matrix but sums three
structured terms: self x self per depth frame, self x edge, and
edge x edge over pairs of edges sharing a source frame (built on the
host by :func:`build_edge_pairs`, or on the device by the planner).
Scatter-sums are :func:`cuda_segsum.sums`, which sums in a fixed order
on the card as on the CPU, three launches a full iteration (H, v, C, w,
Ei; the Schur sum and the rhs correction; the depth back-substitution's
edge term) and one a motion-only one; rows whose index is masked are
dropped. ``t0``, ``t1`` and ``w0`` may be Python
ints or 0-d device tensors (the planner's), so nothing here reads the
card. Levenberg damping (diag += ep + lm*diag)
and the per-pixel eta damping keep the f32 solve well conditioned.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from pvo_tpu_torch.geom.ba import _edge_blocks
from pvo_tpu_torch.geom.chol import solve_psd
from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.vo.net import cuda_segsum

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


def _seg(x, idx, ok, n):
    """A zero-start job summing the rows of x into n segments; rows with
    ``ok`` False dropped."""
    idx = torch.where(ok, idx, torch.full_like(idx, n))
    return cuda_segsum.zero_sum(x, idx, n)


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
    D = 6
    as_long = (lambda a: torch.as_tensor(a, device=dev).long())
    ii, jj = as_long(ii), as_long(jj)
    valid = torch.as_tensor(valid, device=dev).bool()
    pairs_a, pairs_b = as_long(pairs_a), as_long(pairs_b)
    pairs_valid = torch.as_tensor(pairs_valid, device=dev).bool()
    vmask = valid.float()
    intr_b = intrinsics.expand(1, F, 4)
    eta_flat = eta.reshape(K, HW)

    pi, pj, m = ii - t0, jj - t0, ii - w0
    ok_i = valid & (pi >= 0) & (pi < P)
    ok_j = valid & (pj >= 0) & (pj < P)
    ok_m = valid & (m >= 0) & (m < K)
    m_c = m.clamp(0, K - 1)
    pm = torch.arange(K, device=dev) + w0 - t0
    ok_pm = (pm >= 0) & (pm < P)

    def sidx(rows, cols, ok):
        return torch.where(ok, rows * P + cols, torch.full_like(rows, P * P))

    def one_iteration(poses, disps):
        Hblk, vblk, Ei, Ej, Ck, wk = _edge_blocks(
            target[None], weight[None], poses[None], disps[None],
            intr_b, ii, jj)
        Hblk = Hblk[0] * vmask[:, None, None]
        vblk = vblk[0] * vmask[:, None]
        Ei = Ei[0] * vmask[:, None, None]
        Ej = Ej[0] * vmask[:, None, None]
        Ck = Ck[0] * vmask[:, None]
        wk = wk[0] * vmask[:, None]

        # one launch: the pose-pose Hessian (P,P,6,6) from the 4E blocks,
        # the gradient from the 2E halves and, for a full iteration, the
        # depth terms C, w and Ei per depth frame
        hidx = torch.cat([sidx(pi, pi, ok_i), sidx(pi, pj, ok_i & ok_j),
                          sidx(pj, pi, ok_i & ok_j), sidx(pj, pj, ok_j)])
        vidx = torch.cat([torch.where(ok_i, pi, torch.full_like(pi, P)),
                          torch.where(ok_j, pj, torch.full_like(pj, P))])
        jobs = [cuda_segsum.zero_sum(torch.cat([
                    Hblk[:, :6, :6], Hblk[:, :6, 6:], Hblk[:, 6:, :6],
                    Hblk[:, 6:, 6:]]), hidx, P * P),
                cuda_segsum.zero_sum(torch.cat([vblk[:, :6], vblk[:, 6:]]),
                                     vidx, P)]
        if not motion_only:
            jobs += [_seg(Ck, m, ok_m, K), _seg(wk, m, ok_m, K),
                     _seg(Ei, m, ok_m & ok_i, K)]
        H, v, *depth = cuda_segsum.sums(jobs)

        if motion_only:
            S, rhs = H, v
        else:
            C, w_m, Ei_m = depth          # (K, HW), (K, HW), (K, 6, HW)
            C = C + eta_flat
            Q = 1.0 / C

            # (a) self x self per depth frame, (b) self x edge
            Ei_e = Ei_m[m_c]
            Q_e = Q[m_c]
            SS = torch.einsum("xdh,xh,xeh->xde",
                              torch.cat([Ei_m, Ei_e]), torch.cat([Q, Q_e]),
                              torch.cat([Ei_m, Ej]))
            SSa, SSb = SS[:K], SS[K:]
            ok_bm = ok_i & ok_j & ok_m
            s_rows = [SSa, SSb, SSb.transpose(-1, -2)]
            s_idx = [sidx(pm, pm, ok_pm), sidx(pi, pj, ok_bm),
                     sidx(pj, pi, ok_bm)]

            # (c) edge x edge over same-source pairs, in chunks: the
            # gathered (pairs, 6, HW) operands grow with the square of
            # the edges per frame at backend scale
            for o in range(0, pairs_a.shape[0], PAIR_CHUNK):
                pa_c = pairs_a[o:o + PAIR_CHUNK]
                pb_c = pairs_b[o:o + PAIR_CHUNK]
                s_rows.append(torch.einsum("pdh,ph,peh->pde", Ej[pa_c],
                                           Q_e[pa_c], Ej[pb_c]))
                pj_a, pj_b = pj[pa_c], pj[pb_c]
                ok_c = (pairs_valid[o:o + PAIR_CHUNK] & (pj_a >= 0) &
                        (pj_a < P) & (pj_b >= 0) & (pj_b < P))
                s_idx.append(sidx(pj_a, pj_b, ok_c))

            # rhs correction: v - E Q w (self + edge terms)
            rc = torch.einsum("xdh,xh,xh->xd", torch.cat([Ei_m, Ej]),
                              torch.cat([Q, Q_e]),
                              torch.cat([w_m, w_m[m_c]]))
            ridx = torch.cat([
                torch.where(ok_pm, pm, torch.full_like(pm, P)),
                torch.where(ok_j & ok_m, pj, torch.full_like(pj, P))])
            # one launch: the Schur sum (a), (b), (c) in that order, and
            # the rhs correction
            S_sum, corr_v = cuda_segsum.sums([
                cuda_segsum.zero_sum(torch.cat(s_rows), torch.cat(s_idx),
                                     P * P),
                cuda_segsum.zero_sum(rc, ridx, P)])
            S = H - S_sum
            rhs = v - corr_v

        # damped dense solve
        Sd = S.reshape(P, P, D, D).permute(0, 2, 1, 3).reshape(P * D, P * D)
        Sd = Sd + torch.diag(ep + lm * torch.diagonal(Sd))
        dx = solve_psd(Sd[None], rhs.reshape(1, P * D, 1)).reshape(P, D)

        # pose retraction over [t0, t1)
        rows = torch.arange(P, device=dev) + t0
        rows = torch.where(rows < t1, rows, torch.full_like(rows, F))
        dx_full = dx.new_zeros((F + 1, D))
        dx_full[rows] = dx
        new_poses = se3.retr(poses, dx_full[:F])
        if motion_only:
            return new_poses, disps

        # depth back-substitution
        dx_pm = torch.where(ok_pm[:, None], dx[pm.clamp(0, P - 1)], 0.0)
        t_self = torch.einsum("kdh,kd->kh", Ei_m, dx_pm)
        dx_pj = torch.where(ok_j[:, None], dx[pj.clamp(0, P - 1)], 0.0)
        t_edge, = cuda_segsum.sums([
            _seg(torch.einsum("edh,ed->eh", Ej, dx_pj), m, ok_m, K)])
        dz = Q * (w_m - t_self - t_edge)
        krows = torch.arange(K, device=dev) + w0
        dz = torch.where((krows < t1)[:, None], dz, 0.0)
        krows = torch.where(krows < t1, krows, torch.full_like(krows, F))
        dz_full = dz.new_zeros((F + 1, HW))
        dz_full[krows] = dz.to(disps.dtype)
        new_disps = disps + dz_full[:F].reshape(F, h, w)
        return new_poses, torch.clamp(new_disps, min=0.001)

    for _ in range(iters):
        poses, disps = one_iteration(poses, disps)
    return poses, disps
