"""Dense bundle adjustment on a static frame graph (port of
:mod:`pvo_tpu.geom.ba`).

One damped Gauss-Newton step on the reprojection objective, the
per-pixel inverse depths eliminated through a dense Schur complement.
:func:`_edge_blocks` is also the linearization the inference DBA
(:mod:`pvo_tpu_torch.vo.dba`) assembles.

The edge lists ``ii``/``jj`` are host arrays (the frame graph is built
on the host). Where the JAX module contracts against constant one-hot
matrices (scatters serialize on the TPU), the assembly here is
``index_add``: it accumulates over repeated indices, and rows whose
index falls outside the free block (fixed poses have negative ones) are
dropped before the scatter, not wrapped. Every op is out of place, so
the step is differentiable; only the forward is tested so far.
"""

from __future__ import annotations

import numpy as np
import torch

from pvo_tpu_torch.lie import se3

from . import projective
from .chol import block_solve, schur_solve


def _as_np(idx):
    return np.asarray(idx).astype(np.int64).reshape(-1)


def _scatter_rows(A, idx, ok, n):
    """Sum rows A[:, e] (B, E, ...) with ``ok[e]`` into slot ``idx[e]``
    of a (B, n, ...) tensor."""
    out = A.new_zeros((A.shape[0], n) + A.shape[2:])
    sel = np.flatnonzero(ok)
    if len(sel) == 0:
        return out
    if len(sel) < len(ok):
        A = A[:, torch.as_tensor(sel, device=A.device)]
    return out.index_add(1, torch.as_tensor(idx[sel], device=A.device), A)


def _smat(A, rows, cols, n, m):
    ok = (rows >= 0) & (cols >= 0) & (rows < n) & (cols < m)
    return _scatter_rows(A, rows * m + cols, ok, n * m)


def _svec(bv, rows, n):
    return _scatter_rows(bv, rows, (rows >= 0) & (rows < n), n)


def _edge_blocks(target, weight, poses, disps, intrinsics, ii, jj):
    """Linearize all edges; return per-edge Hessian/rhs/E/C blocks.

    Shapes: Hblk (B,N,12,12) ordered [xi_i (6), xi_j (6)];
    vblk (B,N,12); Ei/Ej (B,N,6,HW); Ck/wk (B,N,HW).
    """
    B, N = target.shape[0], target.shape[1]
    ht, wd = disps.shape[-2:]
    HW = ht * wd

    coords, valid, Ji_pl, Jj_pl, Jz_pl = \
        projective.projective_jacobian_planes(
            poses, disps, intrinsics, ii, jj)

    r = torch.movedim((target - coords).reshape(B, N, HW, 2), -1, 2)
    w = 0.001 * torch.movedim(
        (valid * weight).reshape(B, N, HW, 2), -1, 2)   # (B,N,2,HW)

    J = torch.cat([Ji_pl, Jj_pl], dim=3)               # (B,N,2,12,HW)
    wJ = w[:, :, :, None] * J

    Hblk = torch.einsum("bncdh,bnceh->bnde", wJ, J)
    vblk = torch.einsum("bncdh,bnch->bnd", wJ, r)
    Ei = torch.einsum("bncdh,bnch->bndh", wJ[:, :, :, :6], Jz_pl)
    Ej = torch.einsum("bncdh,bnch->bndh", wJ[:, :, :, 6:], Jz_pl)
    wk = torch.sum(w * r * Jz_pl, dim=2)
    Ck = torch.sum(w * Jz_pl * Jz_pl, dim=2)
    return Hblk, vblk, Ei, Ej, Ck, wk


def _depth_only_step(target, weight, eta, poses, disps, intrinsics,
                     ii, jj, kx, kk):
    """Exact BA step when every pose is fixed: the Schur system
    degenerates to the depth diagonal, dx is empty and
    dz = w / (C + eta). The flow/depth export runs exactly this case
    (2-frame window, ``fixedp=2``)."""
    B, N = target.shape[0], target.shape[1]
    ht, wd = disps.shape[-2:]
    HW = ht * wd
    M = len(kx)

    coords, valid, _, _, Jz_pl = projective.projective_jacobian_planes(
        poses, disps, intrinsics, ii, jj, pose_jac=False)

    r = torch.movedim((target - coords).reshape(B, N, HW, 2), -1, 2)
    w = 0.001 * torch.movedim(
        (valid * weight).reshape(B, N, HW, 2), -1, 2)   # (B,N,2,HW)

    wk = torch.sum(w * r * Jz_pl, dim=2)                # (B,N,HW)
    Ck = torch.sum(w * Jz_pl * Jz_pl, dim=2)

    C = _svec(Ck, kk, M)
    wv = _svec(wk, kk, M)
    C = C + eta.reshape(C.shape) + 1e-7
    return wv / C                                        # dz (B,M,HW)


def _retract_disps(disps, dz, kx):
    """disps (B,P,H,W) + dz (B,M,HW) at frames ``kx``; disparities above
    10 reset to 0, then clamped at 0."""
    B, P_all, ht, wd = disps.shape
    dz_full = _svec(dz, kx, P_all)
    disps = disps + dz_full.reshape(B, P_all, ht, wd)
    disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
    return torch.clamp(disps, min=0.0)


def _pose_system(Hblk, vblk, ii, jj, fixedp, P):
    """Scatter the per-edge pose blocks into H (B,P,P,6,6), v (B,P,6)
    over the free poses [fixedp, fixedp + P)."""
    B = Hblk.shape[0]
    iis = ii - fixedp
    jjs = jj - fixedp
    Hii, Hij = Hblk[..., :6, :6], Hblk[..., :6, 6:]
    Hji, Hjj = Hblk[..., 6:, :6], Hblk[..., 6:, 6:]
    H = (_smat(Hii, iis, iis, P, P) + _smat(Hij, iis, jjs, P, P) +
         _smat(Hji, jjs, iis, P, P) + _smat(Hjj, jjs, jjs, P, P))
    v = _svec(vblk[..., :6], iis, P) + _svec(vblk[..., 6:], jjs, P)
    return H.reshape(B, P, P, 6, 6), v


def _retract_poses(poses, dx, fixedp):
    dx_full = torch.cat([dx.new_zeros((dx.shape[0], fixedp, 6)), dx], dim=1)
    return se3.retr(poses, dx_full)


def bundle_adjust(target, weight, eta, poses, disps, intrinsics, ii, jj,
                  fixedp=2, ep=0.1, lm=1e-4):
    """One full-BA Gauss-Newton step (poses + inverse depths).

    target, weight (B,N,H,W,2); eta (B,M,H,W) damping of the M distinct
    source frames; poses (B,P,7); disps (B,P,H,W); intrinsics (B,P,4);
    ``ii``/``jj`` host index arrays. The first ``fixedp`` poses stay.
    Returns the updated (poses, disps).
    """
    ii = _as_np(ii)
    jj = _as_np(jj)
    B, P_all, ht, wd = disps.shape
    HW = ht * wd

    kx, kk = np.unique(ii, return_inverse=True)
    M = len(kx)

    if P_all - fixedp <= 0:
        dz = _depth_only_step(target, weight, eta, poses, disps,
                              intrinsics, ii, jj, kx, kk)
        return poses, _retract_disps(disps, dz, kx)

    Hblk, vblk, Ei, Ej, Ck, wk = _edge_blocks(
        target, weight, poses, disps, intrinsics, ii, jj)

    P = P_all - fixedp
    H, v = _pose_system(Hblk, vblk, ii, jj, fixedp, P)
    E = _smat(Ei, ii - fixedp, kk, P, M) + _smat(Ej, jj - fixedp, kk, P, M)
    C = _svec(Ck, kk, M)
    w = _svec(wk, kk, M)
    C = C + eta.reshape(C.shape) + 1e-7

    dx, dz = schur_solve(H, E.reshape(B, P, M, 6, HW), C, v, w, ep=ep,
                         lm=lm)
    return _retract_poses(poses, dx, fixedp), _retract_disps(disps, dz, kx)


def motion_only_ba(target, weight, eta, poses, disps, intrinsics, ii, jj,
                   fixedp=1, ep=0.1, lm=1e-4):
    """Motion-only BA step: poses move, depths stay. Returns poses."""
    del eta
    ii = _as_np(ii)
    jj = _as_np(jj)
    Hblk, vblk, _, _, _, _ = _edge_blocks(
        target, weight, poses, disps, intrinsics, ii, jj)
    H, v = _pose_system(Hblk, vblk, ii, jj, fixedp,
                        poses.shape[1] - fixedp)
    return _retract_poses(poses, block_solve(H, v, ep=ep, lm=lm), fixedp)
