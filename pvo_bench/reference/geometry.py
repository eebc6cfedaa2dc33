"""Plain SE(3) and pinhole geometry of the reference.

Poses are 7-vectors ``[tx, ty, tz, qx, qy, qz, qw]`` (world to camera,
scalar-last quaternion), tangents ``[rho(3), phi(3)]``, as DROID-SLAM's
lietorch lays them out. Every function broadcasts over leading dims.
Nothing here imports the program under test.
"""

from __future__ import annotations

import torch

MIN_DEPTH = 0.2
_EPS = 1e-6


def _theta_terms(phi):
    theta_sq = torch.sum(phi * phi, dim=-1)
    small = theta_sq < _EPS
    safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return small, theta_sq, torch.sqrt(safe)


def quat_mul(q1, q2):
    v1, w1 = q1[..., :3], q1[..., 3:4]
    v2, w2 = q2[..., :3], q2[..., 3:4]
    w = w1 * w2 - torch.sum(v1 * v2, dim=-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
    return torch.cat([v, w], dim=-1)


def quat_rotate(q, p):
    v, w = q[..., :3], q[..., 3:4]
    v, p = torch.broadcast_tensors(v, p)
    uv = torch.linalg.cross(v, p, dim=-1)
    return p + 2.0 * (w * uv + torch.linalg.cross(v, uv, dim=-1))


def quat_to_matrix(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def hat(phi):
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       dim=-1).reshape(phi.shape[:-1] + (3, 3))


def so3_exp(phi):
    small, theta_sq, theta = _theta_terms(phi)
    imag = torch.where(small, 0.5 - theta_sq / 48.0,
                       torch.sin(0.5 * theta) / theta)
    real = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(0.5 * theta))
    return torch.cat([imag[..., None] * phi, real[..., None]], dim=-1)


def so3_log(q):
    v, w = q[..., :3], q[..., 3]
    sq_n = torch.sum(v * v, dim=-1)
    small = sq_n < _EPS * _EPS
    n = torch.sqrt(torch.where(small, torch.ones_like(sq_n), sq_n))
    big = 2.0 * torch.atan2(n, w) / n
    w_safe = torch.where(torch.abs(w) < 1e-12, torch.ones_like(w), w)
    small_val = (2.0 - 2.0 * sq_n / (3.0 * w_safe * w_safe)) / w_safe
    return torch.where(small, small_val, big)[..., None] * v


def left_jacobian(phi):
    small, theta_sq, th = _theta_terms(phi)
    c1 = torch.where(small, 0.5 - theta_sq / 24.0,
                     (1.0 - torch.cos(th)) / (th * th))
    c2 = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                     (th - torch.sin(th)) / (th * th * th))
    Phi = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + c1[..., None, None] * Phi + c2[..., None, None] * (Phi @ Phi)


def left_jacobian_inverse(phi):
    small, theta_sq, th = _theta_terms(phi)
    half = 0.5 * th
    cot = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        1.0 / (th * th) - 0.5 * torch.cos(half) / (th * torch.sin(half)))
    Phi = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * Phi + cot[..., None, None] * (Phi @ Phi)


def se3_mul(g1, g2):
    q = quat_mul(g1[..., 3:], g2[..., 3:])
    t = g1[..., :3] + quat_rotate(g1[..., 3:], g2[..., :3])
    return torch.cat([t, q], dim=-1)


def se3_inv(g):
    qi = torch.cat([-g[..., 3:6], g[..., 6:7]], dim=-1)
    return torch.cat([-quat_rotate(qi, g[..., :3]), qi], dim=-1)


def se3_exp(xi):
    rho, phi = xi[..., :3], xi[..., 3:]
    t = torch.einsum("...ij,...j->...i", left_jacobian(phi), rho)
    return torch.cat([t, so3_exp(phi)], dim=-1)


def se3_log(g):
    phi = so3_log(g[..., 3:])
    rho = torch.einsum("...ij,...j->...i", left_jacobian_inverse(phi),
                       g[..., :3])
    return torch.cat([rho, phi], dim=-1)


def retr(g, dx):
    """Exp(dx) * g."""
    return se3_mul(se3_exp(dx), g)


def adj_matrix(g):
    R = quat_to_matrix(g[..., 3:])
    top = torch.cat([R, hat(g[..., :3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def act4(g, p):
    """[R xyz + t d, d] of homogeneous points [x, y, z, d]."""
    out = quat_rotate(g[..., 3:], p[..., :3]) + g[..., :3] * p[..., 3:4]
    return torch.cat([out, p[..., 3:4]], dim=-1)


def coords_grid(ht, wd, device=None):
    """(ht, wd, 2) pixel grid [x, y]."""
    y, x = torch.meshgrid(torch.arange(ht, dtype=torch.float32,
                                       device=device),
                          torch.arange(wd, dtype=torch.float32,
                                       device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)


def iproj(disps, intr):
    """disps (N, h, w), intr (N, 4) -> points (N, h, w, 4) [X, Y, 1, d]."""
    ht, wd = disps.shape[-2:]
    grid = coords_grid(ht, wd, disps.device)
    k = intr[:, None, None, :]
    X = (grid[..., 0] - k[..., 2]) / k[..., 0]
    Y = (grid[..., 1] - k[..., 3]) / k[..., 1]
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def reproject(poses, disps, intr, ii, jj, jacobians=False):
    """Pixels of frames ii mapped into frames jj (one intrinsics row for
    all frames). Returns coords (E, h, w, 2), valid (E, h, w) and, with
    ``jacobians``, Ji, Jj (E, 2, 6, HW) and Jz (E, 2, HW): the residual's
    derivatives by the left increments of poses ii, jj and by the inverse
    depth of frame ii."""
    E = ii.shape[0]
    h, w = disps.shape[-2:]
    k = intr.expand(E, 4)
    X0 = iproj(disps[ii], k)
    Gij = se3_mul(poses[jj], se3_inv(poses[ii]))
    X1 = act4(Gij[:, None, None], X0)
    X, Y, Z, d = X1.unbind(-1)
    Zc = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    a = 1.0 / Zc
    fx, fy, cx, cy = (k[:, i, None, None] for i in range(4))
    coords = torch.stack([fx * X * a + cx, fy * Y * a + cy], dim=-1)
    valid = (Z > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH)
    if not jacobians:
        return coords, valid
    Xa, Ya = X * a, Y * a
    o = torch.zeros_like(a)
    aZ = a * Z
    Jj = torch.stack([
        fx * a * d, o, -fx * Xa * a * d,
        -fx * Xa * Ya, fx * (aZ + Xa * Xa), -fx * Ya,
        o, fy * a * d, -fy * Ya * a * d,
        -fy * (aZ + Ya * Ya), fy * Xa * Ya, fy * Xa,
    ], dim=-1).reshape(E, h * w, 2, 6).permute(0, 2, 3, 1)
    Ji = -torch.einsum("ncdh,nde->nceh", Jj, adj_matrix(Gij))
    t = Gij[:, None, None, :3]
    Jz = torch.stack([fx * a * (t[..., 0] - Xa * t[..., 2]),
                      fy * a * (t[..., 1] - Ya * t[..., 2])],
                     dim=1).reshape(E, 2, h * w)
    return coords, valid, Ji, Jj, Jz

