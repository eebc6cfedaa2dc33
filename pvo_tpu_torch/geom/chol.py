"""Damped Cholesky / Schur-complement solves with the implicit backward.

Port of :func:`pvo_tpu.geom.chol.solve_psd`,
:func:`pvo_tpu.geom.chol.block_solve` and
:func:`pvo_tpu.geom.chol.schur_solve`. As there, a failed factorization
yields a zero solution instead of an error, and :func:`solve_psd` has
the implicit backward ``dz = (L L^T)^-1 g``, ``dH = -x dz^T``,
``db = dz``, with dz zero where the factorization failed. Autograd
through the factorization and the masking ``where`` would not do: the
untaken branch holds the failed solve's non-finite values, and its
backward sends ``0 * inf = NaN`` into ``H``. The forward factors
``(H + H^T) / 2``, as ``jnp.linalg.cholesky`` (``symmetrize_input``) does
there: the DBA's systems sum the blocks (p, q) and (q, p) apart, so they
are not quite symmetric; the backward, as JAX's custom VJP, does not see
the symmetrization.
"""

from __future__ import annotations

import torch


def _cho_solve(L, b):
    """(L L^T) x = b for lower-triangular L."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


class _SolvePSD(torch.autograd.Function):

    @staticmethod
    def forward(ctx, H, b):
        L, info = torch.linalg.cholesky_ex(0.5 * (H + H.mT))
        x = _cho_solve(L, b)
        ok = (info == 0)[..., None, None] & torch.isfinite(x).all(
            dim=-1, keepdim=True).all(dim=-2, keepdim=True)
        x = torch.where(ok, x, torch.zeros_like(x))
        ctx.save_for_backward(L, x, ok)
        return x

    @staticmethod
    def backward(ctx, g):
        L, x, ok = ctx.saved_tensors
        dz = torch.where(ok, _cho_solve(L, g), torch.zeros_like(g))
        return -torch.matmul(x, dz.transpose(-1, -2)), dz


def solve_psd(H, b):
    """Solve H x = b for PSD H, batched: H (..., M, M), b (..., M, K).
    Returns zeros for a batch entry whose factorization failed."""
    return _SolvePSD.apply(H, b)


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
