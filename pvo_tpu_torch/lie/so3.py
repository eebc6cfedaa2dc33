"""SO(3) operations on scalar-last quaternions, PyTorch.

Port of :mod:`pvo_tpu.lie.so3` (the subset the VO slice uses).
Quaternion layout ``[qx, qy, qz, qw]``; every function broadcasts over
leading dims. Small-angle branches use the same "double-where" guards
as the JAX module so both branches stay finite.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _theta_terms(phi):
    theta_sq = torch.sum(phi * phi, dim=-1)
    small = theta_sq < _EPS
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return small, theta_sq, torch.sqrt(theta_sq_safe)


def quat_mul(q1, q2):
    """Hamilton product, scalar-last layout."""
    v1, w1 = q1[..., :3], q1[..., 3:4]
    v2, w2 = q2[..., :3], q2[..., 3:4]
    w = w1 * w2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
    return torch.cat([v, w], dim=-1)


def quat_inv(q):
    """Conjugate (assumes unit quaternion)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q, p):
    """Rotate 3-vector(s) p by unit quaternion q."""
    v, w = q[..., :3], q[..., 3:4]
    v, p = torch.broadcast_tensors(v, p)
    uv = torch.linalg.cross(v, p, dim=-1)
    uuv = torch.linalg.cross(v, uv, dim=-1)
    return p + 2.0 * (w * uv + uuv)


def quat_to_matrix(q):
    """Unit quaternion -> 3x3 rotation matrix (last two dims)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def hat(phi):
    """so(3) hat operator: 3-vector -> 3x3 skew matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(phi.shape[:-1] + (3, 3))


def exp(phi):
    """SO(3) exponential map: axis-angle 3-vector -> quaternion."""
    small, theta_sq, theta = _theta_terms(phi)
    half = 0.5 * theta
    imag = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    real = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([imag[..., None] * phi, real[..., None]], dim=-1)


def log(q):
    """SO(3) logarithm map: quaternion -> axis-angle 3-vector."""
    v, w = q[..., :3], q[..., 3]
    sq_n = torch.sum(v * v, dim=-1)
    small = sq_n < _EPS * _EPS
    n = torch.sqrt(torch.where(small, torch.ones_like(sq_n), sq_n))
    big = 2.0 * torch.atan2(n, w) / n
    w_safe = torch.where(torch.abs(w) < 1e-12, torch.ones_like(w), w)
    small_val = (2.0 - 2.0 * sq_n / (3.0 * w_safe * w_safe)) / w_safe
    two_atan = torch.where(small, small_val, big)
    return two_atan[..., None] * v


def left_jacobian(phi):
    """SO(3) left Jacobian J_l(phi), (...,3,3)."""
    small, theta_sq, th = _theta_terms(phi)
    c1 = torch.where(small, 0.5 - theta_sq / 24.0,
                     (1.0 - torch.cos(th)) / (th * th))
    c2 = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                     (th - torch.sin(th)) / (th * th * th))
    Phi = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + c1[..., None, None] * Phi + c2[..., None, None] * (Phi @ Phi)


def left_jacobian_inverse(phi):
    """Inverse SO(3) left Jacobian, (...,3,3)."""
    small, theta_sq, th = _theta_terms(phi)
    half = 0.5 * th
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        1.0 / (th * th) - 0.5 * torch.cos(half) / (th * torch.sin(half)))
    Phi = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * Phi + cot_term[..., None, None] * (Phi @ Phi)
