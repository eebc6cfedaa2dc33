"""Damped Cholesky / Schur-complement solves, forward only.

Port of the forward of :func:`pvo_tpu.geom.chol.solve_psd`,
:func:`pvo_tpu.geom.chol.block_solve` and
:func:`pvo_tpu.geom.chol.schur_solve` (inference needs no backward; the
ops are differentiable torch ops, without the JAX module's implicit
backward). As there, a failed factorization yields a zero solution
instead of an error.
"""

from __future__ import annotations

import torch


def solve_psd(H, b):
    """Solve H x = b for PSD H, batched: H (..., M, M), b (..., M, K).
    Returns zeros for a batch entry whose factorization failed."""
    L, info = torch.linalg.cholesky_ex(H)
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    ok = (info == 0)[..., None, None] & \
        torch.isfinite(x).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    return torch.where(ok, x, torch.zeros_like(x))


def block_solve(H, b, ep=0.1, lm=1e-4):
    """Solve the damped normal equations over pose blocks.

    H (B,N,N,D,D) block matrix, b (B,N,D); the diagonal is damped as
    ``H += (ep + lm*H) I``. Returns dx (B,N,D).
    """
    B, N, _, D, _ = H.shape
    eye = torch.eye(N * D, dtype=H.dtype, device=H.device)
    Hd = H.permute(0, 1, 3, 2, 4).reshape(B, N * D, N * D)
    Hd = Hd + (ep + lm * Hd) * eye
    return solve_psd(Hd, b.reshape(B, N * D, 1)).reshape(B, N, D)


def schur_solve(H, E, C, v, w, ep=0.1, lm=1e-4):
    """Dense Schur-complement solve.

    H (B,P,P,D,D) pose blocks, E (B,P,M,D,HW) pose-depth blocks,
    C (B,M,HW) depth diagonal, v (B,P,D), w (B,M,HW).
    Returns (dx (B,P,D), dz (B,M,HW)).
    """
    B, P, M, D, HW = E.shape
    Hd = H.permute(0, 1, 3, 2, 4).reshape(B, P * D, P * D)
    Ed = E.permute(0, 1, 3, 2, 4).reshape(B, P * D, M * HW)
    Q = (1.0 / C).reshape(B, M * HW, 1)
    eye = torch.eye(P * D, dtype=H.dtype, device=H.device)
    Hd = Hd + (ep + lm * Hd) * eye
    vd = v.reshape(B, P * D, 1)
    wd = w.reshape(B, M * HW, 1)
    Et = Ed.transpose(-1, -2)
    S = Hd - torch.matmul(Ed, Q * Et)
    rhs = vd - torch.matmul(Ed, Q * wd)
    dx = solve_psd(S, rhs)
    dz = Q * (wd - torch.matmul(Et, dx))
    return dx.reshape(B, P, D), dz.reshape(B, M, HW)
