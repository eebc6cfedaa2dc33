"""Plain dense bundle adjustment: DROID-SLAM's damped Gauss-Newton step
over poses and per-pixel inverse depths, with the depths eliminated by
an explicit Schur complement.

The whole pose-depth block E (6P x K*HW) is formed, so the complement is
one matrix product; the program under test never forms it. Conventions
of the inference-time DBA: residual weights 0.001 * confidence * valid;
poses [t0, t1) free, earlier ones fixed; depth frames [w0, w0 + K) with
damping ``eta`` (K, h, w) added to their diagonal; the reduced system
symmetrized, its diagonal damped as d + (ep + lm d), solved by Cholesky
(zeros where the factorization fails); disparities clamped at 0.001.
"""

from __future__ import annotations

import torch

from .geometry import reproject, retr


def _pose_blocks(wJa, Jb):
    return torch.einsum("ecdh,ecfh->edf", wJa, Jb)


def dba(poses, disps, intr, target, weight, eta, ii, jj, t0, t1, w0, K,
        iters=2, ep=0.1, lm=1e-4, motion_only=False):
    """``iters`` iterations. poses (F, 7), disps (F, h, w), intr (4,),
    target/weight (E, h, w, 2), eta (K, h, w), ii/jj (E,) long. Returns
    (poses, disps), new tensors."""
    dev = poses.device
    h, w = disps.shape[-2:]
    HW = h * w
    E = ii.shape[0]
    P = int(t1 - t0)
    pi, pj, m = ii - t0, jj - t0, ii - w0
    ok_i = (pi >= 0) & (pi < P)
    ok_j = (pj >= 0) & (pj < P)
    ok_m = (m >= 0) & (m < K)
    for _ in range(iters):
        coords, valid, Ji, Jj, Jz = reproject(poses, disps, intr, ii, jj,
                                              jacobians=True)
        r = (target - coords).reshape(E, HW, 2).transpose(1, 2)
        wt = 0.001 * (valid[..., None] * weight).reshape(E, HW, 2) \
            .transpose(1, 2)
        Ji = Ji * ok_i[:, None, None, None]
        Jj = Jj * ok_j[:, None, None, None]
        wJi, wJj = wt[:, :, None] * Ji, wt[:, :, None] * Jj
        H = torch.zeros((P, P, 6, 6), device=dev)
        pic, pjc = pi.clamp(0, P - 1), pj.clamp(0, P - 1)
        for a, b, blk in ((pic, pic, _pose_blocks(wJi, Ji)),
                          (pic, pjc, _pose_blocks(wJi, Jj)),
                          (pjc, pic, _pose_blocks(wJj, Ji)),
                          (pjc, pjc, _pose_blocks(wJj, Jj))):
            H.index_put_((a, b), blk, accumulate=True)
        v = torch.zeros((P, 6), device=dev)
        v.index_put_((pic,), torch.einsum("ecdh,ech->ed", wJi, r),
                     accumulate=True)
        v.index_put_((pjc,), torch.einsum("ecdh,ech->ed", wJj, r),
                     accumulate=True)
        Hd = H.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        vd = v.reshape(6 * P, 1)
        if not motion_only:
            mc = m.clamp(0, K - 1)
            okm = ok_m.float()
            C = torch.zeros((K, HW), device=dev)
            C.index_add_(0, mc, (wt * Jz * Jz).sum(1) * okm[:, None])
            wv = torch.zeros((K, HW), device=dev)
            wv.index_add_(0, mc, (wt * r * Jz).sum(1) * okm[:, None])
            Eb = torch.zeros((P * K, 6, HW), device=dev)
            Eb.index_add_(0, pic * K + mc,
                          torch.einsum("ecdh,ech->edh", wJi, Jz) *
                          okm[:, None, None])
            Eb.index_add_(0, pjc * K + mc,
                          torch.einsum("ecdh,ech->edh", wJj, Jz) *
                          okm[:, None, None])
            Ed = Eb.reshape(P, K, 6, HW).permute(0, 2, 1, 3).reshape(
                6 * P, K * HW)
            del Eb
            Q = (1.0 / (C + eta.reshape(K, HW))).reshape(K * HW, 1)
            Hd = Hd - Ed @ (Q * Ed.T)
            vd = vd - Ed @ (Q * wv.reshape(K * HW, 1))
        Sd = 0.5 * (Hd + Hd.T)
        Sd = Sd + torch.diag(ep + lm * torch.diagonal(Sd))
        L, info = torch.linalg.cholesky_ex(Sd)
        dx = torch.cholesky_solve(vd, L)
        if int(info) != 0 or not bool(torch.isfinite(dx).all()):
            dx = torch.zeros_like(dx)
        free = torch.arange(P, device=dev) + int(t0)
        poses = poses.clone()
        poses[free] = retr(poses[free], dx.reshape(P, 6))
        if not motion_only:
            dz = Q.reshape(K, HW) * (wv - (Ed.T @ dx).reshape(K, HW))
            disps = disps.clone()
            frames = torch.arange(K, device=dev) + int(w0)
            keep = frames < int(t1)
            f = frames[keep]
            disps[f] = torch.clamp(disps[f] + dz[keep].reshape(-1, h, w),
                                   min=0.001)
    return poses, disps

