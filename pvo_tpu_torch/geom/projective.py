"""Pinhole projective geometry with analytic Jacobians, PyTorch.

Port of :mod:`pvo_tpu.geom.projective` (the ops the VO and export
slices use).
Conventions are the JAX module's: poses are w2c SE3 7-vectors, depth
is inverse depth at 1/8 resolution, homogeneous points are
``[X, Y, 1, d]``, tangent layout ``[rho, phi]``; batched as
(B, N, H, W, ...) with N edges.
"""

from __future__ import annotations

import torch

from pvo_tpu_torch.lie import se3

MIN_DEPTH = 0.2


def coords_grid(ht, wd, dtype=torch.float32, device=None):
    """Pixel coordinate grid, (ht, wd, 2) ordered [x, y]."""
    y, x = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                          torch.arange(wd, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)


def _as_index(idx, device):
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def _split_intrinsics(intrinsics):
    """(B, N, 4) -> four (B, N, 1, 1) planes fx, fy, cx, cy."""
    k = intrinsics[..., None, None, :]
    return k[..., 0], k[..., 1], k[..., 2], k[..., 3]


def iproj(disps, intrinsics):
    """Inverse projection: (B,N,H,W) disps + (B,N,4) intrinsics ->
    homogeneous points (B,N,H,W,4) = [X, Y, 1, d]."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = _split_intrinsics(intrinsics)
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=disps.dtype, device=disps.device),
        torch.arange(wd, dtype=disps.dtype, device=disps.device),
        indexing="ij")
    X = (x - cx) / fx
    Y = (y - cy) / fy
    X, Y, d = torch.broadcast_tensors(X, Y, disps)
    return torch.stack([X, Y, torch.ones_like(d), d], dim=-1)


def proj(Xs, intrinsics, jacobian=False):
    """Pinhole projection of homogeneous points -> coords (B,N,H,W,2)
    and, if ``jacobian``, the 2x4 projection Jacobian."""
    fx, fy, cx, cy = _split_intrinsics(intrinsics)
    X, Y, Z = Xs[..., 0], Xs[..., 1], Xs[..., 2]
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Z
    x = fx * (X * d) + cx
    y = fy * (Y * d) + cy
    coords = torch.stack([x, y], dim=-1)
    if not jacobian:
        return coords, None
    fx, fy = fx.expand_as(d), fy.expand_as(d)
    o = torch.zeros_like(d)
    Jp = torch.stack([
        fx * d, o, -fx * X * d * d, o,
        o, fy * d, -fy * Y * d * d, o,
    ], dim=-1).reshape(coords.shape[:-1] + (2, 4))
    return coords, Jp


def act_se3(Gij, X0, jacobian=False):
    """Apply relative SE3 (B,N,7) to homogeneous points (B,N,H,W,4);
    with ``jacobian`` also the (B,N,H,W,4,6) left-increment Jacobian."""
    X1 = se3.act4(Gij[:, :, None, None], X0)
    if not jacobian:
        return X1, None
    X, Y, Z, d = X1[..., 0], X1[..., 1], X1[..., 2], X1[..., 3]
    o = torch.zeros_like(d)
    Ja = torch.stack([
        d, o, o, o, Z, -Y,
        o, d, o, -Z, o, X,
        o, o, d, Y, -X, o,
        o, o, o, o, o, o,
    ], dim=-1).reshape(X1.shape[:-1] + (4, 6))
    return X1, Ja


def projective_transform(poses, disps, intrinsics, ii, jj, jacobian=False):
    """Map pixels of frames ``ii`` into frames ``jj``.

    poses (B,P,7), disps (B,P,H,W), intrinsics (B,P,4), ii/jj (N,).
    Returns coords (B,N,H,W,2), valid (B,N,H,W,1) and, with
    ``jacobian``, (Ji, Jj, Jz) of shapes (B,N,H,W,2,6) x2, (B,N,H,W,2,1).
    """
    ii = _as_index(ii, disps.device)
    jj = _as_index(jj, disps.device)
    X0 = iproj(disps[:, ii], intrinsics[:, ii])
    Gij = se3.mul(poses[:, jj], se3.inv(poses[:, ii]))
    X1, Ja = act_se3(Gij, X0, jacobian=jacobian)
    x1, Jp = proj(X1, intrinsics[:, jj], jacobian=jacobian)

    valid = ((X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH))
    valid = valid.to(x1.dtype)[..., None]
    if not jacobian:
        return x1, valid

    Jj = torch.matmul(Jp, Ja)
    Adj = se3.adj_matrix(Gij)[:, :, None, None]
    Ji = -torch.matmul(Jj, Adj)
    tij = Gij[..., :3]
    Jz_dir = torch.cat([tij, torch.ones_like(tij[..., :1])],
                       dim=-1)[:, :, None, None, :, None]
    Jz = torch.matmul(Jp, Jz_dir.expand(Jp.shape[:-2] + (4, 1)))
    return x1, valid, (Ji, Jj, Jz)


def projective_jacobian_planes(poses, disps, intrinsics, ii, jj,
                               pose_jac=True):
    """Jacobians of :func:`projective_transform` in plane layout.

    Returns coords (B,N,H,W,2), valid (B,N,H,W,1),
    Ji_pl, Jj_pl (B,N,2,6,HW) and Jz_pl (B,N,2,HW). ``pose_jac=False``
    skips the pose Jacobians (Ji_pl and Jj_pl are None), for depth-only
    solves where every pose is fixed.
    """
    ii = _as_index(ii, disps.device)
    jj = _as_index(jj, disps.device)
    B = disps.shape[0]
    N = ii.shape[0]
    H, W = disps.shape[-2:]
    HW = H * W

    X0 = iproj(disps[:, ii], intrinsics[:, ii])
    Gij = se3.mul(poses[:, jj], se3.inv(poses[:, ii]))
    X1 = se3.act4(Gij[:, :, None, None], X0)

    fx, fy, cx, cy = [intrinsics[:, jj, k][..., None] for k in range(4)]

    Xp = X1[..., 0].reshape(B, N, HW)
    Yp = X1[..., 1].reshape(B, N, HW)
    Zu = X1[..., 2].reshape(B, N, HW)
    hc = X1[..., 3].reshape(B, N, HW)

    Zc = torch.where(Zu < 0.5 * MIN_DEPTH, torch.ones_like(Zu), Zu)
    a = 1.0 / Zc
    x = fx * (Xp * a) + cx
    y = fy * (Yp * a) + cy
    coords = torch.stack([x, y], dim=-1).reshape(B, N, H, W, 2)
    valid = ((X1[..., 2] > MIN_DEPTH) &
             (X0[..., 2] > MIN_DEPTH)).to(coords.dtype)[..., None]

    fx, fy = fx.expand_as(a), fy.expand_as(a)
    Xa = Xp * a
    Ya = Yp * a
    Ji_pl = Jj_pl = None
    if pose_jac:
        o = torch.zeros_like(a)
        aZ = a * Zu
        Jj_pl = torch.stack([
            fx * a * hc, o, -fx * Xa * a * hc,
            -fx * Xa * Ya, fx * (aZ + Xa * Xa), -fx * Ya,
            o, fy * a * hc, -fy * Ya * a * hc,
            -fy * (aZ + Ya * Ya), fy * Xa * Ya, fy * Xa,
        ], dim=2).reshape(B, N, 2, 6, HW)
        Adj = se3.adj_matrix(Gij)
        Ji_pl = -torch.einsum("bncdh,bnde->bnceh", Jj_pl, Adj)

    tij = Gij[..., :3]
    t0 = tij[..., 0][..., None]
    t1 = tij[..., 1][..., None]
    t2 = tij[..., 2][..., None]
    Jz_pl = torch.stack([
        fx * a * (t0 - Xa * t2),
        fy * a * (t1 - Ya * t2),
    ], dim=2)
    return coords, valid, Ji_pl, Jj_pl, Jz_pl


def induced_flow(poses, disps, intrinsics, ii, jj):
    """Optical flow induced by camera motion: (flow (B,N,H,W,2), valid)."""
    ht, wd = disps.shape[-2:]
    coords0 = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1[..., :2] - coords0, valid
