"""SE(3) operations on 7-vectors ``[tx,ty,tz, qx,qy,qz,qw]``, PyTorch.

Port of :mod:`pvo_tpu.lie.se3`: translation first, scalar-last
quaternion; tangent layout ``[rho(3), phi(3)]``. All ops broadcast over
leading dimensions.
"""

from __future__ import annotations

import torch

from . import so3


def identity(shape=(), dtype=torch.float32, device=None):
    g = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    return g


def mul(g1, g2):
    """Group composition g1 * g2."""
    t1, q1 = g1[..., :3], g1[..., 3:]
    t2, q2 = g2[..., :3], g2[..., 3:]
    q = so3.quat_mul(q1, q2)
    t = t1 + so3.quat_rotate(q1, t2)
    return torch.cat([t, q], dim=-1)


def inv(g):
    t, q = g[..., :3], g[..., 3:]
    qi = so3.quat_inv(q)
    ti = -so3.quat_rotate(qi, t)
    return torch.cat([ti, qi], dim=-1)


def act(g, p):
    """Apply to 3-points: R p + t."""
    return so3.quat_rotate(g[..., 3:], p) + g[..., :3]


def act4(g, p):
    """Apply to homogeneous [x,y,z,d]: [R xyz + t d, d]."""
    xyz, d = p[..., :3], p[..., 3:4]
    out = so3.quat_rotate(g[..., 3:], xyz) + g[..., :3] * d
    return torch.cat([out, d], dim=-1)


def exp(tau_phi):
    """Exponential map: tangent [rho, phi] -> SE3 7-vector."""
    rho, phi = tau_phi[..., :3], tau_phi[..., 3:]
    q = so3.exp(phi)
    t = torch.einsum("...ij,...j->...i", so3.left_jacobian(phi), rho)
    return torch.cat([t, q], dim=-1)


def log(g):
    """Logarithm map: SE3 7-vector -> tangent [rho, phi]."""
    t, q = g[..., :3], g[..., 3:]
    phi = so3.log(q)
    rho = torch.einsum("...ij,...j->...i",
                       so3.left_jacobian_inverse(phi), t)
    return torch.cat([rho, phi], dim=-1)


def retr(g, dx):
    """Retraction Exp(dx) * g (left-multiplicative)."""
    return mul(exp(dx), g)


def adj_matrix(g):
    """Adjoint matrix (...,6,6): [[R, [t]x R], [0, R]]."""
    t, q = g[..., :3], g[..., 3:]
    R = so3.quat_to_matrix(q)
    txR = so3.hat(t) @ R
    Z = torch.zeros_like(R)
    top = torch.cat([R, txR], dim=-1)
    bot = torch.cat([Z, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def adj(g, a):
    """Adjoint action on tangent vector a (...,6)."""
    return torch.einsum("...ij,...j->...i", adj_matrix(g), a)


def adjT(g, a):
    """Transposed adjoint action on tangent (co)vector a (...,6)."""
    return torch.einsum("...ji,...j->...i", adj_matrix(g), a)
