"""Sim(3) operations on 8-vectors ``[tx,ty,tz, qx,qy,qz,qw, s]``, PyTorch.

Port of :mod:`pvo_tpu.lie.sim3`. Layout matches reference lietorch
(translation, scalar-last quaternion, scale); tangent layout
``[rho(3), phi(3), sigma(1)]``. Needed by the geodesic training loss
with scale fitting.
"""

from __future__ import annotations

import torch

from . import so3

_EPS = 1e-6


def identity(shape=(), dtype=torch.float32, device=None):
    g = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    g[..., 7] = 1.0
    return g


def from_se3(g_se3):
    """Embed an SE3 7-vector as Sim3 with unit scale."""
    return torch.cat([g_se3, torch.ones_like(g_se3[..., :1])], dim=-1)


def mul(g1, g2):
    t1, q1, s1 = g1[..., :3], g1[..., 3:7], g1[..., 7:8]
    t2, q2, s2 = g2[..., :3], g2[..., 3:7], g2[..., 7:8]
    q = so3.quat_mul(q1, q2)
    t = t1 + s1 * so3.quat_rotate(q1, t2)
    return torch.cat([t, q, s1 * s2], dim=-1)


def inv(g):
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    qi = so3.quat_inv(q)
    si = 1.0 / s
    ti = -si * so3.quat_rotate(qi, t)
    return torch.cat([ti, qi, si], dim=-1)


def act(g, p):
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    return s * so3.quat_rotate(q, p) + t


def act4(g, p):
    xyz, d = p[..., :3], p[..., 3:4]
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    out = s * so3.quat_rotate(q, xyz) + t * d
    return torch.cat([out, d], dim=-1)


def _calcW(phi, sigma):
    """The W matrix of RxSO3/Sim3 exp (Sophus convention), (...,3,3).
    Every branch is evaluated on guarded values so all stay finite."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    small_t = theta_sq < _EPS
    theta = torch.sqrt(torch.where(small_t, torch.ones_like(theta_sq),
                                   theta_sq))
    sig = sigma[..., 0]
    scale = torch.exp(sig)

    small_s = torch.abs(sig) < _EPS
    one = torch.ones_like(sig)

    # coefficients A, B, C with W = A * Phi + B * Phi^2 + C * I
    C = torch.where(small_s, 1.0 + sig / 2.0 + sig * sig / 6.0,
                    (scale - 1.0) / torch.where(small_s, one, sig))

    sig_safe = torch.where(small_s, one, sig)
    th_safe = torch.where(small_t, torch.ones_like(theta), theta)

    # generic-case values
    a_gen = (sig_safe * torch.sin(th_safe)
             + (1.0 - scale * torch.cos(th_safe)) * th_safe) / \
        ((sig_safe * sig_safe + th_safe * th_safe) * th_safe)
    b_gen = (C - ((scale * torch.cos(th_safe) - 1.0) * sig_safe
                  + scale * torch.sin(th_safe) * th_safe) /
             (sig_safe * sig_safe + th_safe * th_safe)) / (th_safe * th_safe)

    # sigma ~ 0 limits
    a_s0 = torch.where(small_t, 0.5 - theta_sq / 24.0,
                       (1.0 - torch.cos(th_safe)) / (th_safe * th_safe))
    b_s0 = torch.where(small_t, 1.0 / 6.0 - theta_sq / 120.0,
                       (th_safe - torch.sin(th_safe)) / (th_safe ** 3))

    # theta ~ 0, sigma != 0 limits
    a_t0 = torch.where(
        small_s, 0.5 * one,
        ((sig_safe - 1.0) * scale + 1.0) / (sig_safe * sig_safe))
    b_t0 = torch.where(
        small_s, one / 6.0,
        (scale * 0.5 * sig_safe * sig_safe + scale - 1.0
         - sig_safe * scale) / (sig_safe ** 3))

    A = torch.where(small_s, a_s0, torch.where(small_t, a_t0, a_gen))
    B = torch.where(small_s, b_s0, torch.where(small_t, b_t0, b_gen))

    Phi = so3.hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Phi.shape)
    return (A[..., None, None] * Phi + B[..., None, None] * (Phi @ Phi)
            + C[..., None, None] * eye)


def exp(tau):
    """Tangent [rho, phi, sigma] -> Sim3 8-vector."""
    rho, phi, sigma = tau[..., :3], tau[..., 3:6], tau[..., 6:7]
    q = so3.exp(phi)
    s = torch.exp(sigma)
    t = (_calcW(phi, sigma) @ rho[..., None])[..., 0]
    return torch.cat([t, q, s], dim=-1)


def log(g):
    """Sim3 8-vector -> tangent [rho, phi, sigma]."""
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    phi = so3.log(q)
    sigma = torch.log(torch.clamp(s, min=1e-24))
    W = _calcW(phi, sigma)
    rho = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma], dim=-1)
